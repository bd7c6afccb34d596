"""Walsh-Hadamard transform of rows on Hopper, its plain version, its plan
and its launch counters (counterpart of ``repro/kernels/hadamard.py``).

The kernel (``csrc/fwht.cu``, CUDA C++ for sm_90a) replaces the TPU kernel
``repro/kernels/hadamard.py::fwht_kernel``: x (M, D) f32 or bf16, D a power
of two, → ``x @ H_D`` (the normalized transform) in x's dtype.  The row
is rotated in f32 and rounded to x's dtype once at the end, as the TPU
kernel does.  It is the rotation of the unfused W4A4+LRC path
(``kernels/ops.py``); the fused and chained paths rotate inside their own
kernels (``csrc/fwht_rows.cuh``).

Every output element is a fixed tree of f32 adds and subtracts (the sweeps
h = 1, 2, ... D/2 in ascending order) followed by one multiply by the f32
value of ``1.0 / D**0.5``, so the kernel is bitwise :func:`fwht_plain`
(``rowops.fwht_rows``) for f32 and bf16 inputs, whichever thread runs
which sweep.

Bound on an H100 SXM (3.35 TB/s): memory, 2·M·D·elt bytes (x read once,
the rotated rows written once); the D·log2(D) adds a row are far below the
f32 rate.

Design (:func:`fwht_plan`; the source's head comment has the whole of
it): each thread loads ``chunks`` 16-byte units; a sweep runs in its
registers where the partner value is in the same thread, by one
``__shfl_xor_sync`` where it is in another lane, and the sweeps over a
row's warp bits (D > 1,024) after one exchange through shared memory.
The rotated values are stored 16 bytes a lane.

:func:`fwht` is the wrapper: a CPU tensor runs :func:`fwht_plain`; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowops import fwht_rows

KERNEL = "fwht"
LAUNCHES = {"fwht": 0, "fwht_plain": 0}
# widest row the kernel takes: one exchange through shared memory a row
MAX_D = 32768
# the source's threads of a block at least, and lane bits of a warp
MIN_BLOCK, LANE_BITS = 256, 5


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check_width(d: int) -> None:
    """The rotation needs a power-of-two row width."""
    if d < 1 or d & (d - 1):
        raise ValueError(f"online rotation needs a power-of-two width, got {d}")


def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: ``rowops.fwht_rows`` on the f32
    rows of x (M, D), cast back to x's dtype."""
    check_width(x.shape[-1])
    LAUNCHES["fwht_plain"] += 1
    return fwht_rows(x.to(torch.float32), x.shape[-1]).to(x.dtype)


class FwhtPlan(NamedTuple):
    """The kernel's plan at width D, as the source plans it (``fwht_plan``).

    ``steps`` holds each sweep in the order it runs, as (h, stage, kind,
    pos): stage 0 before the exchange through shared memory, 1 after it;
    kind 0 in registers, at bit ``pos`` of a thread's register array (e
    bits below log2 N, then unit bits), kind 1 across lanes, at lane bit
    ``pos``."""

    threads: int          # a block
    rows_per_block: int
    chunks: int           # 16-byte units a thread (C)
    exchanges: int        # through shared memory, a row
    smem_bytes: int
    steps: Tuple[Tuple[int, int, int, int], ...]


def _log2(v: int) -> int:
    return v.bit_length() - 1


def fwht_plan(d: int, x_bytes: int = 2) -> FwhtPlan:
    """The kernel's plan at width d (a power of two) for x of ``x_bytes`` a
    value; it depends on d and x's width alone.

    N = 16 / x_bytes values a unit, CMAX = 32 / N units a thread at most.
    Rows of up to 1,024 values lie within a warp (C = d / (32·N) between 1
    and CMAX, 256 threads a block); wider rows take C = CMAX, d / 32
    threads (256 at least) and one exchange, after which the first
    min(ω, log2 C) of the ω = log2(d) - 10 remaining sweeps run in
    registers and the rest on the top lane bits."""
    check_width(d)
    n = 16 // x_bytes
    nb, cmax = _log2(n), 32 // n
    big = _log2(d) > nb + LANE_BITS + _log2(cmax)
    chunks = cmax if big else min(cmax, max(1, d // (32 * n)))
    threads = max(MIN_BLOCK, d // (n * cmax)) if big else MIN_BLOCK
    cb = _log2(chunks)
    omega = max(0, _log2(d) - (nb + LANE_BITS + cb))
    hr = min(omega, cb)
    hl = omega - hr
    steps = []
    for b in range(_log2(d)):
        if b < nb:
            steps.append((1 << b, 0, 0, b))
        elif b < nb + LANE_BITS:
            steps.append((1 << b, 0, 1, b - nb))
        elif b < nb + LANE_BITS + cb:
            steps.append((1 << b, 0, 0, b - LANE_BITS))
        elif b - (nb + LANE_BITS + cb) < hr:
            steps.append((1 << b, 1, 0, nb + b - (nb + LANE_BITS + cb)))
        else:
            steps.append((1 << b, 1, 1, LANE_BITS - hl + b - (nb + LANE_BITS + cb) - hr))
    return FwhtPlan(threads, threads * chunks * n // d, chunks, int(omega > 0),
                    4 * threads * chunks * n if omega else 0, tuple(steps))


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signatures declared (once per name)."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fwht.argtypes = [p, i, p, i, i, p]
    lib.fwht.restype = ctypes.c_int
    lib.fwht_norm.argtypes = [i]
    lib.fwht_norm.restype = ctypes.c_float
    lib.fwht_max_d.argtypes = []
    lib.fwht_max_d.restype = i
    lib.fwht_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.fwht_plan.restype = None
    return lib


def source_plan(d: int, x_bytes: int = 2) -> FwhtPlan:
    """The built kernel's own plan; :func:`fwht_plan` mirrors it."""
    out = (ctypes.c_longlong * (6 + _log2(MAX_D)))()
    _lib(KERNEL).fwht_plan(d, int(x_bytes == 2), out)
    threads, rpb, chunks, exchanges, smem, n_steps = out[:6]
    steps = tuple((1 << (c >> 8), (c >> 6) & 1, (c >> 5) & 1, c & 31)
                  for c in out[6:6 + n_steps])
    return FwhtPlan(threads, rpb, chunks, exchanges, smem, steps)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """One launch of the transform kernel over the rows of x (M, D);
    returns (M, D) in x's dtype.

    A CPU ``x`` runs the plain version; a CUDA ``x`` launches the kernel on
    the current stream, or raises if it cannot."""
    if x.device.type == "cpu":
        return fwht_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("fwht", x)
    build.check_activations(x, 4)
    m, d = x.shape
    check_width(d)
    if d > MAX_D:
        raise ValueError(f"row width {d} exceeds the kernel's MAX_D {MAX_D}")
    build.check_operands(x, [x])
    out = torch.empty_like(x)
    if m == 0:
        return out
    rc = _lib(KERNEL).fwht(x.data_ptr(), int(x.dtype == torch.bfloat16),
                           out.data_ptr(), m, d, build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"fwht launch failed: cudaError {rc} at (M={m}, D={d})")
    LAUNCHES["fwht"] += 1
    return out
