"""Shared transformer building blocks (counterpart of
``repro/models/common.py``: the dense family's blocks and the contiguous
cache update the moe family's latent caches take).

Every linear goes through :func:`repro_torch.quant.qlinear.apply_linear`:
a plain tensor runs a dense matmul; a ``QLinear`` runs the W4A4+LRC path.
Norms and RoPE are plain torch, as the reference leaves them to XLA
outside any Pallas kernel.  Attention against the paged pool takes one of
two routes: the reference's (gather each row's pages into a dense view,
dequantized to f32 for a quantized pool, then :func:`attention`, plain
torch), or the kernels: for a decode step the paged attention kernels
(``ops.paged_flash_attention[_quant]``), which read the pool in place; for
a prefill chunk or a full sequence the dense flash kernels
(``ops.flash_attention[_quant]``) over each row's pages gathered as they
are stored (float rows, or codes and scale planes, no dequant), with the
row's query offset; ``transformer.paged_step`` chooses.  The cache-free
forward's causal attention likewise takes :func:`attention` or the dense
flash-attention kernel (:func:`causal_attention`); so does the dense
family's contiguous-cache prefill and decode
(:func:`gqa_attention_block`'s ``cache``), causal from the cache's offset.
A prefix-LM mask (:func:`prefix_lm_mask`) is not causal: it always takes
:func:`attention`.

Unlike the reference, :func:`paged_cache_update` and
:func:`paged_cache_update_quantized` write the page pool (and its scale
planes) in place (the reference is functional and returns a new pool): a
step's writes land only in pages the writing request owns or in the null
page, so nothing another request reads is touched, and the pool is not
copied every step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.quant.qlinear import apply_linear
from repro_torch.serve.kvquant import dequantize_kv, quantize_kv


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * gamma.to(torch.float32)).to(dt)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """The (cos, sin) tables (..., seq, 1, head_dim/2) of the rotary
    embedding at ``positions`` (..., seq), for :func:`apply_rope`; computed
    once for every tensor and layer rotated at the same positions."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., :, None].to(torch.float32) * freqs
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x: torch.Tensor, table) -> torch.Tensor:
    cos, sin = table
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def cache_update(cache_arr: torch.Tensor, update: torch.Tensor, offset,
                 axis: int = 1, inplace: bool = False) -> torch.Tensor:
    """The reference's ``dynamic_update_slice`` along ``axis`` at
    ``offset``: a new tensor with ``update`` (cast to the cache's dtype)
    written at ``offset``, where, as in ``jax.lax``, a negative offset
    counts from the end and the start is then clamped to ``[0, size - n]``.
    ``inplace`` writes the rows into ``cache_arr`` itself and returns it.
    ``offset`` may be a device tensor: the start index stays on the device,
    so nothing is read back to the host."""
    n, size = update.shape[axis], cache_arr.shape[axis]
    start = torch.as_tensor(offset, device=cache_arr.device).to(torch.long)
    start = torch.clamp(torch.where(start < 0, start + size, start), 0, size - n)
    idx = start.reshape(()) + torch.arange(n, device=cache_arr.device)
    write = cache_arr.index_copy_ if inplace else cache_arr.index_copy
    return write(axis, idx, update.to(cache_arr.dtype))


def causal_mask(q_len: int, kv_len: int, q_offset, device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; query i attends kv j iff j <= i+offset."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return kj <= qi


def prefix_lm_mask(q_len: int, kv_len: int, prefix_len: int, q_offset,
                   device=None) -> torch.Tensor:
    """PaliGemma-style (q_len, kv_len) bool mask: bidirectional over the
    first ``prefix_len`` keys, causal after them."""
    m = causal_mask(q_len, kv_len, q_offset, device=device)
    kj = torch.arange(kv_len, device=device)[None, :]
    return m | (kj < prefix_len)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
              scale: float) -> torch.Tensor:
    """GQA attention: q (B, Sq, H, D) over k/v (B, Skv, K, D).  Returns
    (B, Sq, H, Dv).  Softmax in f32; masked logits are -1e30, so masked
    positions contribute exactly 0.0 and any finite garbage in masked cache
    slots is invisible.  A 2-D mask is shared across the batch; a 3-D mask
    holds one (Sq, Skv) plane per batch row."""
    b, sq, h, dq = q.shape
    kheads = k.shape[2]
    g = h // kheads
    q = q.reshape(b, sq, kheads, g, dq)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(torch.float32) * scale
    if mask is not None:
        m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
        logits = torch.where(m, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def mlp_block(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated MLP: SwiGLU (silu) or GeGLU (gelu)."""
    g = apply_linear(p["wg"], x)
    u = apply_linear(p["wu"], x)
    if act == "silu":
        h = F.silu(g) * u
    else:
        h = F.gelu(g, approximate="tanh") * u
    return apply_linear(p["wd"], h)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, route: str, mask=None) -> torch.Tensor:
    """Attention under the aligned causal mask (query and key positions
    both from 0: a cache-free forward, the calibration walk).  ``route``
    ``"kernel"``: ``ops.flash_attention`` (kernel #7 on the card, its plain
    version on the CPU); any other route: :func:`attention` under
    :func:`causal_mask` (``mask``, where the caller has built it)."""
    if route == "kernel":
        return ops.flash_attention(q, k, v, scale, causal=True)
    if mask is None:
        mask = causal_mask(q.shape[1], k.shape[1], 0, device=q.device)
    return attention(q, k, v, mask, scale)


def gqa_attention_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                        cfg, mask, route: str = "gather", cache=None,
                        q_start=None, rope_cs=None):
    """GQA attention, without a cache (teacher-forced forward) or against
    the contiguous ``cache`` = dict(k (B, Smax, KH, hd), v, offset): this
    step's k/v rows are written at ``offset`` into ``cache``'s k/v in place
    (:func:`cache_update`; the reference returns new arrays, and a decode
    step here moves only its own rows), the new cache holds those tensors
    and ``offset + S``, and the step attends over the whole cache: on the
    gather route in the activations' dtype, as the reference does; #7
    reads an f32 or bf16 cache as it is stored (the same values, as the
    cache holds the activations' rows).
    ``route="kernel"`` is for a causal mask only (``mask`` is then not
    read): kernel #7 (``ops.flash_attention``) with query row i at
    position ``q_start[b] + i`` (``q_start`` (B,) int32 on the device; None:
    0); any other route attends under ``mask``.  ``rope_cs``:
    :func:`rope_table` of ``positions`` (computed here when None).
    Returns (out (B, S, D), new cache or None)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, positions, cfg, rope_cs)
    new_cache = None
    if cache is not None:
        off = cache["offset"]
        k = cache_update(cache["k"], k, off, inplace=True)
        v = cache_update(cache["v"], v, off, inplace=True)
        new_cache = dict(k=k, v=v, offset=off + s)
        if route != "kernel":
            k, v = k.to(x.dtype), v.to(x.dtype)
    if route == "kernel":
        out = ops.flash_attention(q, k, v, 1.0 / (hd**0.5), causal=True,
                                  q_start=q_start)
    else:
        out = attention(q, k, v, mask, scale=1.0 / (hd**0.5))
    return apply_linear(p["wo"], out.reshape(b, s, h * hd)), new_cache


def page_slots(block_table: torch.Tensor, positions: torch.Tensor,
               valid: torch.Tensor, page_size: int):
    """Flat (page ids, slots within the page) for every (b, s) token: the
    token at absolute position p of batch row b lands in page
    ``block_table[b, p // P]`` at slot ``p % P``; invalid rows (padding,
    inactive slots) go to page 0, the null page the allocator never hands
    out.  The same for every layer and for k and v."""
    page = torch.gather(block_table, 1, positions // page_size)
    page = torch.where(valid, page, torch.zeros_like(page))
    return page.reshape(-1), (positions % page_size).reshape(-1)


def paged_cache_update(pages: torch.Tensor, update: torch.Tensor,
                       block_table: torch.Tensor, positions: torch.Tensor,
                       valid: torch.Tensor, slots=None) -> torch.Tensor:
    """Scatter per-token k/v rows (B, S, K, hd) into one layer's page pool
    (NP, P, K, hd), in place, and return it.  ``slots`` is
    :func:`page_slots` of the other arguments, computed here when absent."""
    if slots is None:
        slots = page_slots(block_table, positions, valid, pages.shape[1])
    page, within = slots
    pages[page, within] = update.to(pages.dtype).reshape(
        page.shape[0], *update.shape[2:])
    return pages


def paged_cache_update_quantized(pages: torch.Tensor, scales: torch.Tensor,
                                 update: torch.Tensor,
                                 block_table: torch.Tensor,
                                 positions: torch.Tensor, valid: torch.Tensor,
                                 kv_spec, slots=None):
    """Quantize-then-scatter: this step's k/v rows (B, S, K, hd) quantize
    through ``kvquant.quantize_kv`` and land, codes in ``pages`` (NP, P, K,
    hd | hd/2) and scales in ``scales`` (NP, P, K, n_groups), in place,
    under the page/slot indices of :func:`paged_cache_update`.  A row
    quantizes before placement, so its stored bytes do not depend on the
    page it lands in.  Returns (pages, scales)."""
    if slots is None:
        slots = page_slots(block_table, positions, valid, pages.shape[1])
    page, within = slots
    q, sc = quantize_kv(update, kv_spec)
    pages[page, within] = q.to(pages.dtype).reshape(page.shape[0], *q.shape[2:])
    scales[page, within] = sc.to(scales.dtype).reshape(page.shape[0], *sc.shape[2:])
    return pages, scales


def _project_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
                 rope_cs):
    """q (B,S,H,hd), k and v (B,S,K,hd) of one attention block, RoPE'd."""
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_linear(p["wq"], x).reshape(b, s, h, hd)
    k = apply_linear(p["wk"], x).reshape(b, s, kh, hd)
    v = apply_linear(p["wv"], x).reshape(b, s, kh, hd)
    if cfg.rope_theta > 0:
        if rope_cs is None:
            rope_cs = rope_table(positions, hd, cfg.rope_theta)
        q = apply_rope(q, rope_cs)
        k = apply_rope(k, rope_cs)
    return q, k, v


def _gathered(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Each row's pages as stored, (NP, P, KH, ·) → (B, MPB·P, KH, ·)."""
    b = block_table.shape[0]
    return pages[block_table].reshape(b, -1, *pages.shape[2:])


def _decode_query(q: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, hd) → the kernels' (B, H, hd)."""
    if q.shape[1] != 1:
        raise ValueError(f"the paged attention kernels take one query token "
                         f"per row; this step has {q.shape[1]}")
    return q.reshape(q.shape[0], *q.shape[2:])


def paged_gqa_attention_block(p: dict, x: torch.Tensor,
                              positions: torch.Tensor, valid: torch.Tensor,
                              cfg, mask, pages_k: torch.Tensor,
                              pages_v: torch.Tensor,
                              block_table: torch.Tensor, rope_cs=None,
                              slots=None, decode=None, prefill=None):
    """GQA attention against a paged KV pool: writes this step's k/v into
    the owning pages, then attends.  With ``decode`` and ``prefill`` None,
    the reference's route: gather each row's pages into a dense (B, MPB*P,
    ...) view in the activations' dtype and attend under the caller's
    per-row mask.  With ``decode`` = (block_table int32, lengths int32) of
    a step of one token per row, the paged kernel attends over the pool in
    place.  With ``prefill`` = q_start (B,) int32 of a step whose row b
    holds positions ``q_start[b] + arange(S)``, the rows' pages are
    gathered in the pool's dtype and the dense flash kernel attends
    causally from that offset (the caller's mask is not read).  ``rope_cs``
    and ``slots`` (:func:`rope_table`, :func:`page_slots`) depend only on
    the step, so a caller running many layers computes them once, as it
    does ``decode`` and ``prefill``.  Returns (out (B,S,D), pages_k,
    pages_v)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, positions, cfg, rope_cs)
    if slots is None:
        slots = page_slots(block_table, positions, valid, pages_k.shape[1])
    pages_k = paged_cache_update(pages_k, k, block_table, positions, valid, slots)
    pages_v = paged_cache_update(pages_v, v, block_table, positions, valid, slots)
    if decode is not None:
        out = ops.paged_flash_attention(_decode_query(q), pages_k, pages_v,
                                        *decode, scale=1.0 / (hd**0.5))
    elif prefill is not None:
        out = ops.flash_attention(q.contiguous(), _gathered(pages_k, block_table),
                                  _gathered(pages_v, block_table), 1.0 / (hd**0.5),
                                  causal=True, q_start=prefill)
    else:
        kc = _gathered(pages_k, block_table).to(x.dtype)
        vc = _gathered(pages_v, block_table).to(x.dtype)
        out = attention(q, kc, vc, mask, scale=1.0 / (hd**0.5))
    out = apply_linear(p["wo"], out.reshape(b, s, h * hd))
    return out, pages_k, pages_v


def paged_gqa_attention_block_quantized(p: dict, x: torch.Tensor,
                                        positions: torch.Tensor,
                                        valid: torch.Tensor, cfg, mask,
                                        pages_k: torch.Tensor,
                                        pages_v: torch.Tensor,
                                        scales_k: torch.Tensor,
                                        scales_v: torch.Tensor,
                                        block_table: torch.Tensor, kv_spec,
                                        rope_cs=None, slots=None, decode=None,
                                        prefill=None):
    """The quantized-KV sibling of :func:`paged_gqa_attention_block`: k/v
    quantize at append time (:func:`paged_cache_update_quantized`).  The
    gather route dequantizes each row's pages through
    ``kvquant.dequantize_kv`` and runs the same :func:`attention`; the
    kernel routes (``decode``; ``prefill``, which gathers each row's codes
    and scale planes without dequantizing them) dequantize each element
    inside the kernel with the same single multiply.  Returns (out,
    pages_k, pages_v, scales_k, scales_v)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, positions, cfg, rope_cs)
    if slots is None:
        slots = page_slots(block_table, positions, valid, pages_k.shape[1])
    pages_k, scales_k = paged_cache_update_quantized(
        pages_k, scales_k, k, block_table, positions, valid, kv_spec, slots)
    pages_v, scales_v = paged_cache_update_quantized(
        pages_v, scales_v, v, block_table, positions, valid, kv_spec, slots)
    if decode is not None:
        out = ops.paged_flash_attention_quant(
            _decode_query(q), pages_k, scales_k, pages_v, scales_v, *decode,
            scale=1.0 / (hd**0.5), kv_spec=kv_spec)
    elif prefill is not None:
        out = ops.flash_attention_quant(
            q.contiguous(), _gathered(pages_k, block_table),
            _gathered(scales_k, block_table), _gathered(pages_v, block_table),
            _gathered(scales_v, block_table), 1.0 / (hd**0.5), kv_spec,
            causal=True, q_start=prefill)
    else:
        kc = dequantize_kv(_gathered(pages_k, block_table),
                           _gathered(scales_k, block_table), kv_spec, hd).to(x.dtype)
        vc = dequantize_kv(_gathered(pages_v, block_table),
                           _gathered(scales_v, block_table), kv_spec, hd).to(x.dtype)
        out = attention(q, kc, vc, mask, scale=1.0 / (hd**0.5))
    out = apply_linear(p["wo"], out.reshape(b, s, h * hd))
    return out, pages_k, pages_v, scales_k, scales_v
