"""Dense decoder-only transformer (counterpart of
``repro/models/transformer.py``).

The reference stacks the layers on a leading axis and scans them; here
``params["layers"]`` is a list of per-layer dicts and the layers run in a
Python loop (``bridge.py`` unstacks a reference param tree).

Two caches serve decoding: the paged pool of the serving engine
(:func:`init_paged_cache`, :func:`paged_step`) and the reference's
contiguous cache (:func:`init_cache`, :func:`prefill`,
:func:`decode_step`), ``k``/``v`` (L, B, Smax, KH, hd) stacked on the
layer axis as the reference's are, with one int32 ``offset`` shared by the
batch rows, kept on the device.  Unlike the reference's, a step writes its
k/v rows into the cache it is given, in place (as the paged pool is
written), and returns those tensors with the new offset: a step costs its
own rows, not a copy of the cache.  ``forward`` and ``prefill`` take the
reference's ``prefix_len`` and ``embeds`` (precomputed frontend embeddings
prepended to the tokens': the vlm backbone's prefix), under its prefix-LM
mask, which always takes the gather route (``KernelContext.attention_plan``).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import DEFAULT_CONTEXT
from repro_torch.models.common import (causal_mask, gqa_attention_block,
                                       mlp_block, page_slots,
                                       paged_gqa_attention_block,
                                       paged_gqa_attention_block_quantized,
                                       prefix_lm_mask, rms_norm, rope_table)
from repro_torch.models.remat import maybe_remat


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


def decoder_layer(cfg, lp, x, positions, mask, route="gather", cache=None,
                  q_start=None, rope_cs=None):
    """One pre-norm block; ``route``, ``cache`` (one layer's k/v and the
    offset), ``q_start`` and ``rope_cs`` as in
    ``common.gqa_attention_block``.  Returns (x, the layer's new cache or
    None)."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, new_cache = gqa_attention_block(lp["attn"], h, positions, cfg, mask, route,
                                       cache, q_start, rope_cs)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + mlp_block(lp["mlp"], h, cfg.act), new_cache


def run_layers(cfg, layers, x, positions, mask, cache, route, q_start):
    """Every layer against the contiguous ``cache`` (k/v (L, B, Smax, KH,
    hd), offset), each layer's rows written into its slice of k/v in
    place; returns (x, the new cache: the same k/v, offset + S)."""
    offset = cache["offset"]
    rope_cs = (rope_table(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.rope_theta > 0 else None)  # the same for every layer
    for li, lp in enumerate(layers):
        x = decoder_layer(cfg, lp, x, positions, mask, route,
                          dict(k=cache["k"][li], v=cache["v"][li], offset=offset),
                          q_start, rope_cs)[0]
    return x, dict(k=cache["k"], v=cache["v"], offset=offset + positions.shape[-1])


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


def _with_prefix(cfg, params, tokens, prefix_len, embeds):
    """The embedded tokens, ``embeds`` (B, P, D) prepended in their dtype,
    and the prefix length (at least P when ``embeds`` is given)."""
    x = embed_tokens(cfg, params, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        prefix_len = max(prefix_len, embeds.shape[1])
    return x, prefix_len


def _dense_route(cfg, ctx, device, prefix_len) -> str:
    return (DEFAULT_CONTEXT if ctx is None else ctx).attention_route(
        device, cfg.head_dim, prefix=prefix_len > 0)


def _prompt_mask(route, s, kv_len, prefix_len, device):
    """A prompt's mask from position 0 over ``kv_len`` keys: none on the
    kernel route (#7 is causal from ``q_start``), else the reference's
    prefix-LM or causal mask."""
    if route == "kernel":
        return None
    if prefix_len > 0:
        return prefix_lm_mask(s, kv_len, prefix_len, 0, device=device)
    return causal_mask(s, kv_len, 0, device=device)


def forward(cfg, params, tokens, prefix_len: int = 0, embeds=None, ctx=None):
    """Teacher-forcing forward. tokens: (B, S) integer; ``embeds`` (B, P, D)
    optionally prepends precomputed frontend embeddings, and then, or with
    ``prefix_len`` > 0, the mask is the reference's prefix-LM mask over
    that prefix (the gather route), else the causal mask.
    ``ctx.attention`` (a
    :class:`~repro_torch.kernels.context.KernelContext`; None = "auto")
    picks the causal attention's route: the flash-attention kernel or the
    reference's :func:`~repro_torch.models.common.attention`.  Each layer
    runs under ``cfg.remat``'s activation checkpointing
    (:func:`~repro_torch.models.remat.maybe_remat`)."""
    x, prefix_len = _with_prefix(cfg, params, tokens, prefix_len, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    route = _dense_route(cfg, ctx, x.device, prefix_len)
    mask = _prompt_mask(route, s, s, prefix_len, x.device)
    layer = maybe_remat(cfg, decoder_layer)
    for lp in params["layers"]:
        x = layer(cfg, lp, x, positions, mask, route)[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda"):
    """The reference's contiguous cache: ``k``/``v`` zeros (L, B, max_seq,
    KH, hd) of ``dtype`` and an int32 ``offset`` 0, on ``device``."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                offset=torch.zeros((), dtype=torch.int32, device=device))


def prefill(cfg, params, tokens, cache, prefix_len: int = 0, embeds=None,
            ctx=None):
    """The prompt (B, S), ``embeds`` prepended as in :func:`forward`, from
    position 0 into ``cache``; returns (last row's logits (B, 1, V), new
    cache).  The kernel route attends with ``q_start`` 0, the reference's
    ``causal_mask(S, Smax, 0)``; a prefix takes the gather route under
    ``prefix_lm_mask(S, Smax, P, 0)``."""
    x, prefix_len = _with_prefix(cfg, params, tokens, prefix_len, embeds)
    b, s, _ = x.shape
    kv_len = cache["k"].shape[2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    route = _dense_route(cfg, ctx, x.device, prefix_len)
    mask = _prompt_mask(route, s, kv_len, prefix_len, x.device)
    q_start = (torch.zeros((b,), dtype=torch.int32, device=x.device)
               if route == "kernel" else None)
    x, cache = run_layers(cfg, params["layers"], x, positions, mask, cache, route,
                          q_start)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, tokens, cache, ctx=None):
    """tokens (B, 1) at the cache's offset, attending to cache[0:offset] and
    itself; returns (logits (B, 1, V), new cache).  The kernel route runs
    #7 with ``q_start`` = the offset (the reference's mask ``arange(Smax)
    <= offset``); the offset is never read back to the host."""
    x = embed_tokens(cfg, params, tokens)
    b = x.shape[0]
    offset = cache["offset"]
    positions = offset.to(torch.long).expand(b, 1)
    kv_len = cache["k"].shape[2]
    route = _dense_route(cfg, ctx, x.device, 0)
    mask = q_start = None
    if route == "kernel":
        q_start = offset.to(torch.int32).expand(b).contiguous()
    else:
        mask = (torch.arange(kv_len, device=x.device) <= offset)[None, :]
    x, cache = run_layers(cfg, params["layers"], x, positions, mask, cache, route,
                          q_start)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


def init_paged_cache(cfg, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda", kv_spec=None):
    """A paged KV pool shared by every in-flight request, (L, NP, P, KH, hd)
    per leaf: page id indexes axis 1, page 0 is the reserved null page.

    A quantized ``kv_spec`` stores int8 (or pack_int4'd uint8, hd/2 wide)
    pages plus f32 scale-plane leaves ``k_scale``/``v_scale`` shaped
    (L, NP, P, KH, n_groups), on the same page axis.  A float spec sets the
    pool's dtype."""
    device = resolve_device(device)
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    if kv_spec is not None and kv_spec.is_quantized:
        shape = (cfg.n_layers, num_pages, page_size, kh,
                 kv_spec.packed_head_dim(hd))
        sshape = (cfg.n_layers, num_pages, page_size, kh, kv_spec.n_groups(hd))
        return dict(
            k=torch.zeros(shape, dtype=kv_spec.pool_dtype, device=device),
            v=torch.zeros(shape, dtype=kv_spec.pool_dtype, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device))
    if kv_spec is not None:
        dtype = kv_spec.cache_dtype
    shape = (cfg.n_layers, num_pages, page_size, kh, hd)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def decode_operands(block_table, positions, valid):
    """What the paged attention kernels take besides q and the pool, for a
    step of one token per row: the block table as one contiguous int32
    tensor and ``lengths = where(valid, position + 1, 0)`` int32 (a row's
    valid kv positions, its current token included; 0 for an inactive
    slot).  The same for every layer: computed once per step."""
    lengths = torch.where(valid[:, 0], positions[:, 0] + 1,
                          torch.zeros_like(positions[:, 0]))
    return (block_table.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())


def prefill_operands(positions):
    """What the dense flash kernels take besides q and the gathered pages,
    for a prefill step: ``q_start`` (B,) int32, each row's first position,
    the row's tokens sitting at ``q_start + arange(S)`` (a prefill chunk at
    its offset, a full sequence at 0).  The same for every layer: computed
    once per step."""
    return positions[:, 0].to(torch.int32).contiguous()


def paged_step(cfg, params, tokens, positions, valid, cache, block_table,
               sample_row=None, kv_spec=None, ctx=None, is_prefill=None):
    """One forward step against the paged KV pool — the single entry point
    for BOTH chunked prefill (B=1, S=chunk) and batched decode (B=slots,
    S=1).

    tokens (B, S) integer; positions (B, S) absolute token positions; valid
    (B, S) bool (False = padding / inactive slot: the KV write goes to the
    null page and the row's output is garbage the caller ignores);
    block_table (B, MPB) page ids.  ``sample_row`` (B,) optionally selects
    one hidden row per batch entry before the unembed.  ``kv_spec`` (a
    :class:`~repro_torch.serve.kvquant.KVSpec`; None = float) says how the
    pool stores k/v; a quantized spec needs the scale leaves of
    :func:`init_paged_cache`.  ``ctx.attention`` (a
    :class:`~repro_torch.kernels.context.KernelContext`; None = "auto")
    picks the route of the step's attention: the kernels (the paged ones
    for a decode step; the dense flash ones over the gathered pages for a
    prefill step, whose rows must hold consecutive positions, as a prefill
    chunk's and a full sequence's do) or the reference's gather.
    ``is_prefill`` (None: S > 1) says which a step is, so that a one-token
    prefill chunk sums its attention as a wider chunk does.  Returns
    (logits (B, S|1, V), cache); the cache's pages are written in place."""
    x = embed_tokens(cfg, params, tokens)
    ctx = DEFAULT_CONTEXT if ctx is None else ctx
    if is_prefill is None:
        is_prefill = tokens.shape[1] > 1
    decode = prefill = mask = None
    if ctx.attention_route(cache["k"].device, cfg.head_dim,
                           decode=not is_prefill) == "kernel":
        if is_prefill:
            prefill = prefill_operands(positions)
        else:
            decode = decode_operands(block_table, positions, valid)
    block_table = block_table.long()
    positions = positions.long()
    page_size = cache["k"].shape[2]
    if decode is None and prefill is None:
        kv_len = block_table.shape[1] * page_size
        kj = torch.arange(kv_len, device=x.device)
        mask = (kj[None, None, :] <= positions[:, :, None]) & valid[:, :, None]
    # the same for every layer: computed once per step
    rope_cs = (rope_table(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.rope_theta > 0 else None)
    slots = page_slots(block_table, positions, valid, page_size)
    quantized = kv_spec is not None and kv_spec.is_quantized
    for li, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        if quantized:
            a = paged_gqa_attention_block_quantized(
                lp["attn"], h, positions, valid, cfg, mask, cache["k"][li],
                cache["v"][li], cache["k_scale"][li], cache["v_scale"][li],
                block_table, kv_spec, rope_cs, slots, decode, prefill)[0]
        else:
            a = paged_gqa_attention_block(
                lp["attn"], h, positions, valid, cfg, mask, cache["k"][li],
                cache["v"][li], block_table, rope_cs, slots, decode, prefill)[0]
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + mlp_block(lp["mlp"], h, cfg.act)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if sample_row is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, sample_row.long()][:, None]
    return unembed(cfg, params, x), cache
