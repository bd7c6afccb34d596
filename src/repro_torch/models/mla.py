"""Multi-head Latent Attention (DeepSeek-V2/V3; counterpart of
``repro/models/mla.py``).

KV states are compressed into a small latent c_kv (kv_lora_rank) plus one
shared rope-carrying key head; only (c_kv, k_rope) is cached.  Every call
re-expands per-head K/V from the whole cached latent through ``wkv_b``
(the reference's "naive" path), or, with ``cfg.mla_absorb``, attends
against the latent directly (:func:`mla_attention_absorbed`, einsums).

The naive path's attention takes the route of the caller's
``KernelContext``: ``"kernel"`` is the dense flash kernel (#7, D = nope +
rope, Dv = v_head_dim) with causal masking from ``q_start`` (the
reference's masks: 0 for a cache-free forward and a prefill, the cache
offset at decode); ``"gather"`` is :func:`~repro_torch.models.common.attention`
under the caller's mask.  The absorbed path has no kernel: on the kernel
route it runs its einsums under the causal mask from ``q_start`` that #7
would have applied (:func:`_causal_rows`), on the gather route under the
caller's mask.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (apply_rope, attention, cache_update,
                                       rms_norm, rope_table)
from repro_torch.quant.qlinear import QLinear, _unpack_w, apply_linear

F32 = torch.float32


def init_mla_params(cfg, gen, dtype, device):
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim

    def lin(di, do):
        return (torch.randn((di, do), generator=gen, device=device) * di**-0.5).to(dtype)

    p = {
        "wkv_a": lin(d, cfg.kv_lora_rank + cfg.qk_rope_dim),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=dtype, device=device),
        "wkv_b": lin(cfg.kv_lora_rank, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
        "wo": lin(h * cfg.v_head_dim, d),
    }
    if cfg.q_lora_rank > 0:
        p["wq_a"] = lin(d, cfg.q_lora_rank)
        p["q_norm"] = torch.ones((cfg.q_lora_rank,), dtype=dtype, device=device)
        p["wq_b"] = lin(cfg.q_lora_rank, h * qk)
    else:
        p["wq"] = lin(d, h * qk)
    return p


def mla_rope_table(cfg, positions):
    """The RoPE tables of MLA's rope dims at ``positions`` (queries and the
    shared key head rotate alike); the same for every layer of a step."""
    return rope_table(positions, cfg.qk_rope_dim, cfg.rope_theta)


def _queries(cfg, p, x):
    b, s, _ = x.shape
    if "wq_a" in p:
        cq = rms_norm(apply_linear(p["wq_a"], x), p["q_norm"], cfg.norm_eps)
        q = apply_linear(p["wq_b"], cq)
    else:
        q = apply_linear(p["wq"], x)
    q = q.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _latent(cfg, p, x, rope_cs):
    """(c_kv normed (B, S, R), k_rope roped (B, S, rope))."""
    kv = apply_linear(p["wkv_a"], x)
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], rope_cs)[:, :, 0, :]
    return c_kv, k_rope


def _expand_kv(cfg, p, c_kv):
    """latent (B, S, R) → k_nope (B, S, H, nope), v (B, S, H, v)."""
    b, s, _ = c_kv.shape
    kvb = apply_linear(p["wkv_b"], c_kv).reshape(
        b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    return kvb[..., :cfg.qk_nope_dim], kvb[..., cfg.qk_nope_dim:]


def _effective_weight(w) -> torch.Tensor:
    """Dense (d_in, d_out) view of a weight leaf: a QLinear's dequantized
    matrix plus its low-rank correction, in f32 (the absorbed path reads
    ``wkv_b`` inside the attention math)."""
    if isinstance(w, QLinear):
        mat = _unpack_w(w).to(F32) * w.w_scale[None, :]
        if w.u is not None:
            mat = mat + w.v.to(F32) @ w.u.to(F32).T
        return mat
    return w


def mla_attention_absorbed(cfg, p, q_nope, q_rope, c_kv, k_rope, mask):
    """Weight-absorbed MLA attention:

        scores_h(t) = (W_k,hᵀ q_nope,h)·c_t + q_rope,h·k_rope,t
        out_h       = W_v,h · (probs_h · C)

    the per-head K/V never materialized over the sequence; f32 einsums as
    in the reference."""
    r = cfg.kv_lora_rank
    h = q_nope.shape[2]
    wkv = _effective_weight(p["wkv_b"]).to(F32)
    wkv = wkv.reshape(r, h, cfg.qk_nope_dim + cfg.v_head_dim)
    w_k, w_v = wkv[..., :cfg.qk_nope_dim], wkv[..., cfg.qk_nope_dim:]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(F32), w_k)
    scores = torch.einsum("bshr,btr->bhst", q_abs, c_kv.to(F32))
    scores = scores + torch.einsum("bshp,btp->bhst", q_rope.to(F32), k_rope.to(F32))
    scale = 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
    scores = scores * scale
    if mask is not None:  # (Sq, Skv) shared, or (B, Sq, Skv) per row
        m = mask[None, None] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(m, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, c_kv.to(F32))
    out = torch.einsum("bshr,rhv->bshv", ctx, w_v)
    return out.to(q_nope.dtype)


def _causal_rows(b, sq, skv, q_start, device) -> torch.Tensor:
    """The (B, Sq, Skv) mask of #7's causal attention from ``q_start``
    ((B,) int32; None: 0): query row i of sequence b attends key j iff j <=
    q_start[b] + i."""
    start = (torch.zeros((b,), dtype=torch.long, device=device) if q_start is None
             else q_start.to(torch.long))
    qpos = start[:, None] + torch.arange(sq, device=device)[None, :]
    return torch.arange(skv, device=device)[None, None, :] <= qpos[:, :, None]


def mla_attention_block(cfg, p, x, positions, mask, cache=None,
                        route: str = "gather", rope_cs=None, q_start=None):
    """Returns (out (B, S, D), new_cache): :func:`mla_attention_pre_o`,
    then ``wo``."""
    out, new_cache = mla_attention_pre_o(cfg, p, x, positions, mask, cache, route,
                                         rope_cs, q_start)
    return apply_linear(p["wo"], out), new_cache


def mla_attention_pre_o(cfg, p, x, positions, mask, cache=None,
                        route: str = "gather", rope_cs=None, q_start=None):
    """The attention's output before ``wo``, (B, S, H·v), and the new
    cache (the calibration walk reads ``wo``'s input; the reference gets
    it through an identity ``wo``, which is exact).  ``cache`` = dict(c_kv (B, Smax,
    R), k_rope (B, Smax, rope), offset); the new cache holds this step's
    latents at ``offset`` (:func:`~repro_torch.models.common.cache_update`)
    and ``offset + S``, and the step attends over the whole of it.
    ``route`` "kernel" runs #7 causally from ``q_start`` ((B,) int32 on the
    device; None: 0) and does not read ``mask``; any other route attends
    under ``mask``.  ``rope_cs``: :func:`mla_rope_table` of ``positions``
    (computed here when None)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    if rope_cs is None:
        rope_cs = mla_rope_table(cfg, positions)
    q_nope, q_rope = _queries(cfg, p, x)
    q_rope = apply_rope(q_rope, rope_cs)
    c_kv, k_rope = _latent(cfg, p, x, rope_cs)

    new_cache = None
    if cache is not None:
        off = cache["offset"]
        ckv_c = cache_update(cache["c_kv"], c_kv, off)
        krope_c = cache_update(cache["k_rope"], k_rope, off)
        new_cache = dict(c_kv=ckv_c, k_rope=krope_c, offset=off + s)
        c_kv, k_rope = ckv_c.to(x.dtype), krope_c.to(x.dtype)

    if cfg.mla_absorb:
        if route == "kernel":
            # no kernel computes the absorbed products: they run in torch
            # under the causal mask the kernel would have applied
            mask = _causal_rows(b, s, c_kv.shape[1], q_start, x.device)
        out = mla_attention_absorbed(cfg, p, q_nope, q_rope, c_kv, k_rope, mask)
    else:
        k_nope, v = _expand_kv(cfg, p, c_kv)
        skv = k_nope.shape[1]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, skv, h, cfg.qk_rope_dim)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        scale = 1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)
        if route == "kernel":
            out = ops.flash_attention(q, k, v.contiguous(), scale, causal=True,
                                      q_start=q_start)
        else:
            out = attention(q, k, v, mask, scale)
    return out.reshape(b, s, h * cfg.v_head_dim), new_cache
