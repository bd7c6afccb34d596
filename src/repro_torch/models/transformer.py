"""Dense decoder-only transformer (counterpart of
``repro/models/transformer.py``).

The reference stacks the layers on a leading axis and scans them; here
``params["layers"]`` is a list of per-layer dicts and the layers run in a
Python loop (``bridge.py`` unstacks a reference param tree).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import (causal_mask, gqa_attention_block,
                                       mlp_block, page_slots,
                                       paged_gqa_attention_block, rms_norm,
                                       rope_table)


def _init_linear(gen, d_in, d_out, dtype, device, scale=None):
    scale = scale if scale is not None else d_in**-0.5
    w = torch.randn((d_in, d_out), generator=gen, device=device) * scale
    return w.to(dtype)


def init_layer_params(cfg, gen, dtype, device):
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = cfg.d_model
    return {
        "attn_norm": torch.ones((d,), dtype=dtype, device=device),
        "attn": {
            "wq": _init_linear(gen, d, h * hd, dtype, device),
            "wk": _init_linear(gen, d, kh * hd, dtype, device),
            "wv": _init_linear(gen, d, kh * hd, dtype, device),
            "wo": _init_linear(gen, h * hd, d, dtype, device),
        },
        "mlp_norm": torch.ones((d,), dtype=dtype, device=device),
        "mlp": {
            "wg": _init_linear(gen, d, cfg.d_ff, dtype, device),
            "wu": _init_linear(gen, d, cfg.d_ff, dtype, device),
            "wd": _init_linear(gen, cfg.d_ff, d, dtype, device),
        },
    }


def init_params(cfg, seed: int = 0, max_seq: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a ``torch.Generator`` on the target
    device; the numbers differ from the reference's ``jax.random``)."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device=device) * 0.02).to(dtype)
    params = {
        "embed": embed,
        "layers": [init_layer_params(cfg, gen, dtype, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _init_linear(gen, cfg.d_model, cfg.vocab_size,
                                         dtype, device)
    return params


def decoder_layer(cfg, lp, x, positions, mask):
    """One pre-norm block (no cache)."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + gqa_attention_block(lp["attn"], h, positions, cfg, mask)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + mlp_block(lp["mlp"], h, cfg.act)


def embed_tokens(cfg, params, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def unembed(cfg, params, x):
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    logits = (x @ head.to(x.dtype)).to(torch.float32)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward(cfg, params, tokens):
    """Teacher-forcing forward. tokens: (B, S) integer."""
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    mask = causal_mask(s, s, 0, device=x.device)
    for lp in params["layers"]:
        x = decoder_layer(cfg, lp, x, positions, mask)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)


def init_paged_cache(cfg, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda"):
    """A paged KV pool shared by every in-flight request, (L, NP, P, KH, hd)
    per leaf: page id indexes axis 1, page 0 is the reserved null page."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def paged_step(cfg, params, tokens, positions, valid, cache, block_table,
               sample_row=None):
    """One forward step against the paged KV pool — the single entry point
    for BOTH chunked prefill (B=1, S=chunk) and batched decode (B=slots,
    S=1).

    tokens (B, S) integer; positions (B, S) absolute token positions; valid
    (B, S) bool (False = padding / inactive slot: the KV write goes to the
    null page and the row's output is garbage the caller ignores);
    block_table (B, MPB) page ids.  ``sample_row`` (B,) optionally selects
    one hidden row per batch entry before the unembed.  Returns
    (logits (B, S|1, V), cache); the cache's pages are written in place."""
    x = embed_tokens(cfg, params, tokens)
    block_table = block_table.long()
    positions = positions.long()
    page_size = cache["k"].shape[2]
    kv_len = block_table.shape[1] * page_size
    kj = torch.arange(kv_len, device=x.device)
    mask = (kj[None, None, :] <= positions[:, :, None]) & valid[:, :, None]
    # the same for every layer: computed once per step
    rope_cs = (rope_table(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.rope_theta > 0 else None)
    slots = page_slots(block_table, positions, valid, page_size)
    for li, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        a, _, _ = paged_gqa_attention_block(
            lp["attn"], h, positions, valid, cfg, mask, cache["k"][li],
            cache["v"][li], block_table, rope_cs, slots)
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + mlp_block(lp["mlp"], h, cfg.act)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if sample_row is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, sample_row.long()][:, None]
    return unembed(cfg, params, x), cache
