"""Kernel dispatch for the W4A4+LRC forward (counterpart of
``repro/kernels/ops.py::w4a4_lrc_forward``, fused path only).

There is no plan table and no on-chip memory model: the kernel's tiles are
constants of its CUDA source, and the kernel masks the ragged edges of M, N
and K itself, so nothing is padded here.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantizers import QuantSpec
from repro_torch.kernels.fused_gemm import fused_w4a4_lrc


def w4a4_lrc_forward(x: torch.Tensor, wpacked: torch.Tensor,
                     w_scale: torch.Tensor, u, v, act_spec: QuantSpec,
                     rotate: bool = False, impl: str = None) -> torch.Tensor:
    """The W4A4+LRC serving hot path: x (M, K) float, wpacked (K/2, N)
    uint8, w_scale (N,) f32, u (N, R) / v (K, R) or None.  Returns (M, N)
    f32 from one launch of the fused kernel (its plain version on CPU)."""
    if impl not in (None, "auto", "fused"):
        raise NotImplementedError(
            f"kernel path {impl!r} is not ported; only the fused path is")
    if rotate:
        raise NotImplementedError(
            "online rotation is not ported yet (ROADMAP Queue 1)")
    if act_spec.group_size is not None:
        raise NotImplementedError(
            "group-wise activation scales are not ported yet (ROADMAP Queue 1)")
    r = 0 if v is None else v.shape[-1]
    return fused_w4a4_lrc(
        x.contiguous(), v if r else None, wpacked, w_scale.reshape(-1),
        u if r else None, bits=act_spec.bits, clip_ratio=act_spec.clip_ratio)
