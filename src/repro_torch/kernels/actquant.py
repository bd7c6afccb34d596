"""Activation quantizer on Hopper, its plain version, its launch plan and
its launch counters.

The kernel (``csrc/act_quant.cu``, CUDA C++ for sm_90a) replaces the TPU
kernel ``repro/kernels/actquant.py::act_quant_kernel``: x (M, K) → xq
(M, K) int8 and sx (M, 1) f32, or with ``group`` g (dividing K) the (M,
K/g) scale plane, bitwise the codes and scales of
``rowops.scale_round_quantize`` and of ``fused_prologue`` (both kernels
include ``csrc/quant_rows.cuh``).  It is the quantizer of the unfused path
(``kernels/ops.py``).

Bound on an H100 SXM (3.35 TB/s): memory, (x_bytes + 1)·M·K + 4·M·(K/g,
or 1) bytes (x read once, the codes and scales written once;
``chip_smoke.py::_chain_bounds``).

Design (:func:`act_quant_plan`; the source's head comment has the whole
of it): a group is quantized as a row of g values of its own, so the group
branch is the per-token body over M·K/g rows of width g.  ``tpr`` threads
take a row, each holding its 16-byte units (or single values, for the
element-wise reader) in registers, so x is read once: a lane segment of
one warp for rows of up to ``WARP_MAX_K`` values, a block above that, and
rows too wide for a block's registers staged once in shared memory (up to
``MAX_K`` values).  The plan depends on (K, g, x's width, alignment) alone,
so a row's codes and scale never depend on M.

:func:`act_quant` is the wrapper: a CPU tensor runs
:func:`act_quant_plain`; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowops import check_group, scale_round_quantize

KERNEL = "act_quant"
LAUNCHES = {"act_quant": 0, "act_quant_plain": 0}
# the source's constants: the widest row a warp (or fewer lanes) takes, the
# threads of a block of such rows and of a block-wide row at most, the
# registers of units a block-wide row's thread holds, the widest row
WARP_MAX_K, WARP_BLOCK, MAX_THREADS, HELD_REGS = 2048, 256, 1024, 16
MAX_K = 57344

def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def act_quant_plain(x, bits: int = 4, clip_ratio: float = 1.0, group: int = None):
    """The kernel's function in plain torch (``rowops.scale_round_quantize``
    on the f32 rows).  Returns (xq (M, K) int8, sx (M, 1) f32, or the (M,
    K // group) plane)."""
    LAUNCHES["act_quant_plain"] += 1
    return scale_round_quantize(x.to(torch.float32), 2 ** (bits - 1) - 1,
                                clip_ratio, group)


class ActQuantPlan(NamedTuple):
    """A call of the kernel at (M, K, group), as the source plans it
    (``act_quant_plan``; the fields in its order)."""

    vec: int             # 1: 16-byte units; 0: single values
    staged: int          # 1: the row staged in shared memory
    width: int           # values a row: K, or g
    units: int           # units a row
    tpr: int             # threads a row
    loads: int           # units of a row a thread at most
    chunks: int          # register units of the held body (loads to a power of two)
    rows_per_block: int
    threads: int         # a block
    smem_bytes: int      # dynamic shared memory
    rows: int            # M, or M·K/g
    blocks: int


def _pow2ceil(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def act_quant_plan(m: int, k: int, group: int = None, x_bytes: int = 2,
                   aligned: bool = True) -> ActQuantPlan:
    """The kernel's launch plan at (M, K, group) for x of ``x_bytes`` a value,
    x and xq aligned for 16-byte units or not.  Only ``rows`` and ``blocks``
    depend on M.

    A row is K values, or a group of g (M·K/g rows).  Units are 16 bytes
    (8 bf16, 4 f32) where the row width is a multiple of that and the
    operands are aligned, else single values; a thread holds a 16-byte unit
    in 4 registers, a single value in 1.  Rows of up to ``WARP_MAX_K``
    values: the row's units (at most 32) threads a row, 256 threads a
    block.  Wider
    rows: a block a row, of the power of two of threads (at most 1,024) that
    gives each ``HELD_REGS`` registers of units; where that is not enough
    at 1,024 threads, the row is staged in shared memory."""
    width = group or k
    rows = m * (k // group) if group else m
    n = 16 // x_bytes
    vec = int(bool(aligned) and width % n == 0)
    units = width // (n if vec else 1)
    warp = width <= WARP_MAX_K
    per = HELD_REGS // (4 if vec else 1)
    if warp:
        tpr = min(32, _pow2ceil(units))
    else:
        tpr = min(MAX_THREADS, _pow2ceil(-(-units // per)))
    loads = -(-units // tpr)
    chunks = _pow2ceil(loads)
    staged = int(not warp and chunks > per)
    if staged:
        chunks = 0
    threads = MAX_THREADS if staged else WARP_BLOCK if warp else tpr
    rpb = threads // tpr
    return ActQuantPlan(vec, staged, width, units, tpr, loads, chunks, rpb, threads,
                        4 * width if staged else 0, rows, -(-rows // rpb))


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signatures declared (once per name)."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.act_quant.argtypes = [p, i, p, p, i, i, i, i, ctypes.c_float, p]
    lib.act_quant.restype = ctypes.c_int
    lib.act_quant_plan.argtypes = [ctypes.c_longlong, i, i, i, i,
                                   ctypes.POINTER(ctypes.c_longlong)]
    lib.act_quant_plan.restype = None
    lib.act_quant_max_k.argtypes = []
    lib.act_quant_max_k.restype = i
    return lib


def source_plan(m: int, k: int, group: int = None, x_bytes: int = 2,
                aligned: bool = True) -> ActQuantPlan:
    """The built kernel's own plan; :func:`act_quant_plan` mirrors it."""
    out = (ctypes.c_longlong * len(ActQuantPlan._fields))()
    _lib(KERNEL).act_quant_plan(m, k, group or 0, int(x_bytes == 2), int(bool(aligned)), out)
    return ActQuantPlan(*out)


def act_quant(x, bits: int = 4, clip_ratio: float = 1.0, group: int = None):
    """One launch of the quantizer kernel; returns (xq, sx).

    Arguments as :func:`act_quant_plain`.  A CPU ``x`` runs the plain
    version; a CUDA ``x`` launches the kernel on the current stream, or
    raises if it cannot."""
    if x.device.type == "cpu":
        return act_quant_plain(x, bits, clip_ratio, group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("act_quant", x)
    build.check_activations(x, bits)
    build.check_operands(x, [x])
    m, k = x.shape
    if group is not None:
        check_group(k, group)
    if (group or k) > MAX_K:
        raise ValueError(f"a row of {group or k} values exceeds the kernel's MAX_K {MAX_K}")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1 if group is None else k // group), dtype=torch.float32,
                     device=x.device)
    if m == 0:
        return xq, sx
    rc = _lib(KERNEL).act_quant(
        x.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(),
        sx.data_ptr(), m, k, group or 0, 2 ** (bits - 1) - 1, float(clip_ratio),
        build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"act_quant launch failed: cudaError {rc} at "
                           f"(M={m}, K={k}, group={group})")
    LAUNCHES["act_quant"] += 1
    return xq, sx
