"""Fused activation prologue on Hopper, its plain version and its launch
counters.

The kernel (``csrc/fused_prologue.cu``, CUDA C++ for sm_90a) replaces the
TPU kernel ``repro/kernels/prologue.py::fused_prologue_kernel``: one launch
quantizes the rows of x (M, K) to xq int8 and sx (M, 1) f32 (with
``group`` g, dividing K, the (M, K/g) scale plane of its ``act_group``
branch), and projects ``xv = x·V`` (M, R) f32; with ``rotate`` it
does both on ``x·H_K`` (K a power of two, with V or without), each block
staging and rotating one whole row at a time (``csrc/fwht_rows.cuh``,
bitwise ``rowops.fwht_rows``; the source's head comment says what that
costs).  It is the first kernel of the chained path (``kernels/ops.py``),
whose GEMM is ``kernels/w4a4.py``.

The codes and scales are bitwise those of ``rowops.scale_round_quantize``
(the quantizer is ``csrc/quant_rows.cuh``, shared with ``act_quant``).  x·V
adds its K-chunk partials in ``rowops.project_rows_tiled``'s ascending
order with the same chunk size; only the order inside a chunk differs.

Bound on an H100 SXM (3.35 TB/s): memory; at decode V dominates (2·K·R
bytes in bf16, e.g. 5 MB and 1.5 us at K=8192, R=307).  The grid covers
(K-chunk × R-tile) blocks plus one quantizer block per row, so a 4-row
decode batch still fills the card.

:func:`fused_prologue` is the wrapper: a CPU tensor runs
:func:`fused_prologue_plain`; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hadamard import MAX_D, check_width
from repro_torch.kernels.rowops import (check_group, fwht_rows, project_rows,
                                        scale_round_quantize)

KERNEL = "fused_prologue"
LAUNCHES = {"fused_prologue": 0, "fused_prologue_plain": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def fused_prologue_plain(x, v=None, bits: int = 4, clip_ratio: float = 1.0,
                         rotate: bool = False, group: int = None):
    """The kernel's function in plain torch, in ``rowops``' operation order.

    x (M, K) float; v (K, R) or None; ``rotate`` quantizes and projects the
    f32 rows of ``x·H_K`` (K a power of two); ``group`` (dividing K)
    quantizes them per group.  Returns (xq (M, K) int8, sx (M, 1) f32 or
    the (M, K // group) plane, xv (M, R) f32 or None)."""
    if rotate:
        check_width(x.shape[1])
    if group is not None:
        check_group(x.shape[1], group)
    LAUNCHES["fused_prologue_plain"] += 1
    xf = x.to(torch.float32)
    if rotate:
        xf = fwht_rows(xf, xf.shape[1])
    xq, sx = scale_round_quantize(xf, 2 ** (bits - 1) - 1, clip_ratio, group)
    return xq, sx, None if v is None else project_rows(xf, v)


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signatures declared (once per name)."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_prologue.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i,
                                   ctypes.c_float, i, p]
    lib.fused_prologue.restype = ctypes.c_int
    lib.fused_prologue_scratch_bytes.argtypes = [i, i, i]
    lib.fused_prologue_scratch_bytes.restype = ctypes.c_size_t
    lib.fused_prologue_max_rotate_k.argtypes = []
    lib.fused_prologue_max_rotate_k.restype = i
    return lib


def fused_prologue(x, v=None, bits: int = 4, clip_ratio: float = 1.0,
                   rotate: bool = False, group: int = None):
    """One launch of the prologue kernel; returns (xq, sx, xv-or-None).

    Arguments as :func:`fused_prologue_plain`.  A CPU ``x`` runs the plain
    version; a CUDA ``x`` launches the kernel on the current stream, or
    raises if it cannot."""
    if x.device.type == "cpu":
        return fused_prologue_plain(x, v, bits, clip_ratio, rotate, group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.check_activations(x, bits)
    m, k = x.shape
    if rotate:
        check_width(k)
        if k > MAX_D:
            raise ValueError(f"rotated K={k} exceeds the kernel's {MAX_D}")
    if group is not None:
        check_group(k, group)
    r = 0
    tensors = [x]
    if v is not None:
        r = v.shape[-1]
        if v.dim() != 2 or v.shape[0] != k:
            raise ValueError(f"v must be ({k}, R); got {tuple(v.shape)}")
        if v.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
        tensors.append(v)
    build.check_operands(x, tensors)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1 if group is None else k // group), dtype=torch.float32,
                     device=x.device)
    xv = None if v is None else torch.empty((m, r), dtype=torch.float32,
                                            device=x.device)
    if m == 0:
        return xq, sx, xv
    lib = _lib(KERNEL)
    scratch = torch.empty(lib.fused_prologue_scratch_bytes(m, k, r),
                          dtype=torch.uint8, device=x.device)
    rc = lib.fused_prologue(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        None if v is None else v.data_ptr(),
        int(v is not None and v.dtype == torch.bfloat16), xq.data_ptr(),
        sx.data_ptr(), None if xv is None else xv.data_ptr(),
        scratch.data_ptr() if scratch.numel() else None, m, k, r, group or 0,
        2 ** (bits - 1) - 1, float(clip_ratio), int(rotate), build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"fused_prologue launch failed: cudaError {rc} "
                           f"at (M={m}, K={k}, R={r}, group={group})")
    LAUNCHES["fused_prologue"] += 1
    return xq, sx, xv
