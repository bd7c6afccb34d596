"""Kernel dispatch (counterpart of ``repro/kernels/ops.py``): the
W4A4+LRC forward (per-token or group-wise activation scales, with or
without the online rotation),
the Walsh-Hadamard transform of rows, dense causal flash attention over
float and quantized K/V, and paged decode attention over float and
quantized KV pools.

``w4a4_lrc_forward`` runs one of three paths, picked by a
:class:`~repro_torch.kernels.context.KernelContext` (module docstring
there): fused (one kernel), chained (prologue → GEMM kernel) or unfused
(quantizer kernel, x·V in plain torch, GEMM kernel).  The kernels mask the
ragged edges of M, N, K and R themselves, so nothing is padded here.  On the CPU every wrapper runs its plain version, and the
three paths give bitwise equal outputs there (the reference's contract for
its interpret mode): they share the quantizer, the K-chunked x·V and the
epilogue bodies of ``rowops``.

``act_spec.group_size`` g (dividing K; paper Table 2, g = 128) quantizes
each row per group of g contiguous features: every path's quantizer
returns the (M, K/g) scale plane and its GEMM sums the groups in
``rowops.gemm_grouped``'s canonical order, so the three paths stay bitwise
equal on the card too (given the same codes and x·V) and a row's output
does not depend on M.

``rotate=True`` (K a power of two) quantizes and projects ``x·H_K``: the
fused and chained paths rotate the f32 rows inside their kernels, the
unfused path runs the transform kernel (:func:`fwht`) first, whose output
is in x's dtype, as the reference's is.  So with an f32 x the three paths
stay bitwise equal; with a bf16 x the unfused path quantizes the rotated
rows rounded to bf16 and the other two the f32 ones, as in the reference.

``flash_attention`` and ``flash_attention_quant`` keep the reference's
signatures and layouts, q (B, Sq, H, D) and k/v (B, Skv, KH, ·), the
quantized one with its scale planes and the ``KVSpec``; their kernels read
each kv head in place for its query group, where the reference's wrappers
repeat the KV heads.  Both add ``q_start`` (B,) int32, the absolute
position of each sequence's first query row (default 0, the reference's
aligned mask), which a prefill chunk over the paged pool needs.

``paged_flash_attention[_quant]`` keep the reference's signatures and
layouts: q (B, H, D), pages (NP, P, KH, ·), block_table (B, MPB) and
lengths (B,) int32; the quantized one takes the ``KVSpec``.  Their kernels
read the pool in place (``kernels/flash_attn.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.quantizers import QuantSpec
from repro_torch.kernels.actquant import act_quant
from repro_torch.kernels import flash_attn, hadamard
from repro_torch.kernels.context import KernelContext
from repro_torch.kernels.fused_gemm import fused_w4a4_lrc
from repro_torch.kernels.prologue import fused_prologue
from repro_torch.kernels.rowops import project_rows
from repro_torch.kernels.w4a4 import w4a4_lowrank_matmul

__all__ = ["KernelContext", "w4a4_lrc_forward", "act_quant", "fwht", "fused_prologue",
           "w4a4_lowrank_matmul", "fused_w4a4_lrc", "flash_attention",
           "flash_attention_quant", "paged_flash_attention",
           "paged_flash_attention_quant"]

DEFAULT_CONTEXT = KernelContext()


def fwht(x: torch.Tensor) -> torch.Tensor:
    """The normalized Walsh-Hadamard transform ``x @ H_D`` of the rows of x
    (M, D), D a power of two, in x's dtype (the transform kernel)."""
    return hadamard.fwht(x)


def w4a4_lrc_forward(x: torch.Tensor, wpacked: torch.Tensor,
                     w_scale: torch.Tensor, u, v, act_spec: QuantSpec,
                     rotate: bool = False, impl: str = None,
                     ctx: KernelContext = None,
                     layer: str = None) -> torch.Tensor:
    """The W4A4+LRC serving hot path: x (M, K) float, wpacked (K/2, N)
    uint8, w_scale (N,) f32, u (N, R) / v (K, R) or None.  Returns (M, N)
    f32.  ``rotate`` applies the online rotation first (K a power of two,
    else ``ValueError``); ``act_spec.group_size`` (dividing K, else
    ``ValueError``) quantizes per group.

    ``impl=None`` defers to ``ctx.impl`` (``ctx=None`` → the default
    context, ``"auto"``): the fused path where the site fits it, else
    chained, with any per-layer override for ``layer`` (the QLinear's
    name) or the site's shape.  An explicit path is run as asked."""
    ctx = DEFAULT_CONTEXT if ctx is None else ctx
    m, k = x.shape
    n = wpacked.shape[1]
    r = 0 if v is None else v.shape[-1]
    if rotate:
        hadamard.check_width(k)
    group = act_spec.group_size
    path = ctx.resolve_plan(m, k, n, r, layer=layer, impl=impl,
                            rotate=rotate, act_group=group).path
    x = x.contiguous()
    v, u = (v, u) if r else (None, None)
    sw = w_scale.reshape(-1)
    bits, clip = act_spec.bits, act_spec.clip_ratio
    if path == "fused":
        return fused_w4a4_lrc(x, v, wpacked, sw, u, bits=bits, clip_ratio=clip,
                              rotate=rotate, group=group)
    if path == "chained":
        xq, sx, xv = fused_prologue(x, v, bits=bits, clip_ratio=clip,
                                    rotate=rotate, group=group)
    else:  # unfused
        if rotate:
            x = hadamard.fwht(x)
        xq, sx = act_quant(x, bits=bits, clip_ratio=clip, group=group)
        # x·V over all rows in one call, as the fused and chained plain
        # versions project: the same rows then give the same sums at any M
        xv = None if v is None else project_rows(x.to(torch.float32), v)
    return w4a4_lowrank_matmul(xq, sx, wpacked, sw, xv, u, group=group)


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    q_start=None) -> torch.Tensor:
    """GQA flash attention. q: (B, Sq, H, D); k/v: (B, Skv, KH, D[v]);
    causal with query row i of sequence b at position ``q_start[b] + i``
    (None: 0) and key positions from 0.  Returns (B, Sq, H, Dv) in q's
    dtype."""
    return flash_attn.flash_attention(q, k, v, scale, causal, q_start)


def flash_attention_quant(q, k_quant, k_scales, v_quant, v_scales,
                          scale: float, kv_spec, causal: bool = True,
                          q_start=None) -> torch.Tensor:
    """:func:`flash_attention` over quantized K/V (the dense prefill
    layout).  q: (B, Sq, H, D); k/v_quant: (B, Skv, KH, D | D//2) int8 /
    packed uint8 with f32 scale planes (B, Skv, KH, D // group);
    ``kv_spec`` a :class:`~repro_torch.serve.kvquant.KVSpec` (its
    ``group_for(D)``, packed when int4).  Each tile dequantizes inside the
    kernel, so the f32 K/V never reach device memory.  Returns (B, Sq, H,
    D) in q's dtype."""
    return flash_attn.flash_attention_quant(q, k_quant, k_scales, v_quant,
                                            v_scales, scale, kv_spec, causal,
                                            q_start)


def paged_flash_attention(q, k_pages, v_pages, block_table, lengths,
                          scale: float) -> torch.Tensor:
    """Decode attention against the serving engine's paged KV pool.
    q: (B, H, D) one token per sequence; k/v_pages: (NP, P, KH, D[v]);
    block_table: (B, MPB) int32; lengths: (B,) int32 valid kv positions
    including the current token.  The page gather runs inside the kernel:
    no per-request KV copy is made.  Returns (B, H, Dv)."""
    return flash_attn.paged_flash_attention(q, k_pages, v_pages, block_table,
                                            lengths, scale)


def paged_flash_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                                block_table, lengths, scale: float,
                                kv_spec) -> torch.Tensor:
    """:func:`paged_flash_attention` over a QUANTIZED page pool.  q: (B, H,
    D); k/v_pages: (NP, P, KH, D | D//2) int8 / packed uint8; k/v_scales:
    the f32 (NP, P, KH, D // group) scale planes indexed by the SAME block
    table; ``kv_spec`` a :class:`~repro_torch.serve.kvquant.KVSpec`.  Pages
    dequantize per element inside the kernel.  Returns (B, H, D)."""
    return flash_attn.paged_flash_attention_quant(
        q, k_pages, k_scales, v_pages, v_scales, block_table, lengths, scale,
        kv_spec)
