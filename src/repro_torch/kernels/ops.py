"""Kernel dispatch for the W4A4+LRC forward (counterpart of
``repro/kernels/ops.py``, per-token scales, no rotation).

``w4a4_lrc_forward`` runs one of three paths, picked by a
:class:`~repro_torch.kernels.context.KernelContext` (module docstring
there): fused (one kernel), chained (prologue → GEMM kernel) or unfused
(quantizer kernel, x·V in plain torch per row tile, GEMM kernel).  The
kernels mask the ragged edges of M, N, K and R themselves, so nothing is
padded here.  On the CPU every wrapper runs its plain version, and the
three paths give bitwise equal outputs there (the reference's contract for
its interpret mode): they share the quantizer, the K-chunked x·V and the
epilogue bodies of ``rowops``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantizers import QuantSpec
from repro_torch.kernels.actquant import act_quant
from repro_torch.kernels.context import KernelContext
from repro_torch.kernels.fused_gemm import fused_w4a4_lrc
from repro_torch.kernels.prologue import fused_prologue
from repro_torch.kernels.rowops import project_rows
from repro_torch.kernels.w4a4 import w4a4_lowrank_matmul

__all__ = ["KernelContext", "w4a4_lrc_forward", "act_quant", "fused_prologue",
           "w4a4_lowrank_matmul", "fused_w4a4_lrc"]

DEFAULT_CONTEXT = KernelContext()
# rows per x·V tile of the unfused path (the kernels' larger M-tile)
PROJ_ROWS = 16


def _project_tiles(x: torch.Tensor, v: torch.Tensor, bm: int = PROJ_ROWS):
    """(x·V) for the unfused path: per (bm, K) row tile, the K-chunked,
    R-tiled order of ``rowops.project_rows_tiled`` (the reference's jnp
    product outside any kernel; plain torch here as there).  Returns (M, R)
    f32."""
    xf = x.to(torch.float32)
    tiles = [project_rows(xf[t:t + bm], v) for t in range(0, xf.shape[0], bm)]
    return tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=0)


def w4a4_lrc_forward(x: torch.Tensor, wpacked: torch.Tensor,
                     w_scale: torch.Tensor, u, v, act_spec: QuantSpec,
                     rotate: bool = False, impl: str = None,
                     ctx: KernelContext = None,
                     layer: str = None) -> torch.Tensor:
    """The W4A4+LRC serving hot path: x (M, K) float, wpacked (K/2, N)
    uint8, w_scale (N,) f32, u (N, R) / v (K, R) or None.  Returns (M, N)
    f32.

    ``impl=None`` defers to ``ctx.impl`` (``ctx=None`` → the default
    context, ``"auto"``): the fused path where the site fits it, else
    chained, with any per-layer override for ``layer`` (the QLinear's
    name) or the site's shape.  An explicit path is run as asked."""
    if rotate:
        raise NotImplementedError(
            "online rotation is not ported yet (ROADMAP Queue 1)")
    if act_spec.group_size is not None:
        raise NotImplementedError(
            "group-wise activation scales are not ported yet (ROADMAP Queue 1)")
    ctx = DEFAULT_CONTEXT if ctx is None else ctx
    m, k = x.shape
    n = wpacked.shape[1]
    r = 0 if v is None else v.shape[-1]
    path = ctx.resolve_plan(m, k, n, r, layer=layer, impl=impl).path
    x = x.contiguous()
    v, u = (v, u) if r else (None, None)
    sw = w_scale.reshape(-1)
    bits, clip = act_spec.bits, act_spec.clip_ratio
    if path == "fused":
        return fused_w4a4_lrc(x, v, wpacked, sw, u, bits=bits, clip_ratio=clip)
    if path == "chained":
        xq, sx, xv = fused_prologue(x, v, bits=bits, clip_ratio=clip)
    else:  # unfused
        xq, sx = act_quant(x, bits=bits, clip_ratio=clip)
        xv = None if v is None else _project_tiles(x, v)
    return w4a4_lowrank_matmul(xq, sx, wpacked, sw, xv, u)
