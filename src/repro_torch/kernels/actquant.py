"""Activation quantizer on Hopper, its plain version and its launch
counters.

The kernel (``csrc/act_quant.cu``, CUDA C++ for sm_90a) replaces the TPU
kernel ``repro/kernels/actquant.py::act_quant_kernel``: x (M, K) → xq
(M, K) int8 and sx (M, 1) f32, or with ``group`` g (dividing K) the (M,
K/g) scale plane, bitwise the codes and scales of
``rowops.scale_round_quantize`` and of ``fused_prologue`` (both kernels
include ``csrc/quant_rows.cuh``).  It is the quantizer of the unfused path
(``kernels/ops.py``).

Bound on an H100 SXM (3.35 TB/s): memory (x read, one byte per code
written).  One block per row, so a row's result never depends on M.

:func:`act_quant` is the wrapper: a CPU tensor runs
:func:`act_quant_plain`; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowops import check_group, scale_round_quantize

KERNEL = "act_quant"
LAUNCHES = {"act_quant": 0, "act_quant_plain": 0}


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


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signature declared (once per name)."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.act_quant.argtypes = [p, i, p, p, i, i, i, i, ctypes.c_float, p]
    lib.act_quant.restype = ctypes.c_int
    return lib


def act_quant(x, bits: int = 4, clip_ratio: float = 1.0, group: int = None):
    """One launch of the quantizer kernel; returns (xq, sx).

    Arguments as :func:`act_quant_plain`.  A CPU ``x`` runs the plain
    version; a CUDA ``x`` launches the kernel on the current stream, or
    raises if it cannot."""
    if x.device.type == "cpu":
        return act_quant_plain(x, bits, clip_ratio, group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.check_activations(x, bits)
    build.check_operands(x, [x])
    m, k = x.shape
    if group is not None:
        check_group(k, group)
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
