"""Walsh-Hadamard transform of rows on Hopper, its plain version and its
launch counters (counterpart of ``repro/kernels/hadamard.py``).

The kernel (``csrc/fwht.cu``, CUDA C++ for sm_90a) replaces the TPU kernel
``repro/kernels/hadamard.py::fwht_kernel``: x (M, D) f32 or bf16, D a power
of two, → ``x @ H_D`` (the normalized transform) in x's dtype.  The row
is rotated in f32 and rounded to x's dtype once at the end, as the TPU
kernel does.  It is the rotation of the unfused W4A4+LRC path
(``kernels/ops.py``); the fused and chained paths rotate inside their own
kernels with the same butterfly body (``csrc/fwht_rows.cuh``).

Every output element is a fixed tree of f32 adds and subtracts followed by
one multiply by the f32 value of ``1.0 / D**0.5``, so the kernel is bitwise
:func:`fwht_plain` (``rowops.fwht_rows``) for f32 and bf16 inputs.

Bound on an H100 SXM (3.35 TB/s): memory, 2·M·D·elt bytes (x read once,
the rotated rows written once); the D·log2(D) adds a row are far below the
f32 rate.

:func:`fwht` is the wrapper: a CPU tensor runs :func:`fwht_plain`; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowops import fwht_rows

KERNEL = "fwht"
LAUNCHES = {"fwht": 0, "fwht_plain": 0}
# widest row the kernel takes: the row is staged whole in shared memory
MAX_D = 32768


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
    return lib


def fwht(x: torch.Tensor) -> torch.Tensor:
    """One launch of the transform kernel over the rows of x (M, D);
    returns (M, D) in x's dtype.

    A CPU ``x`` runs the plain version; a CUDA ``x`` launches the kernel on
    the current stream, or raises if it cannot."""
    if x.device.type == "cpu":
        return fwht_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
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
