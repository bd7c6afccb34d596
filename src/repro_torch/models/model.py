"""Model facade: family dispatch (counterpart of ``repro/models/model.py``;
the dense and moe families are ported, each with its training loss and
its contiguous cache, and the dense family with its paged pool)."""

from __future__ import annotations

import torch

from repro_torch.models import deepseek, transformer

# families whose decode state is an attention KV cache with a contiguous
# layout the engine can page (vs. MLA's latent cache, which carries one
# offset for the batch)
PAGED_FAMILIES = ("dense",)
# families whose decode state is per row (batch axis 1 on every leaf) and
# carries no shared offset, so requests stack into one batched decode (the
# reference's ssm; not ported)
STACKED_FAMILIES = ("ssm",)
PORTED_FAMILIES = ("dense", "moe")


def _ported(cfg):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; only {PORTED_FAMILIES} are")


def init_params(cfg, seed: int = 0, max_seq: int = 0, device="cuda"):
    _ported(cfg)
    if cfg.family == "moe":
        return deepseek.init_params(cfg, seed, max_seq, device=device)
    return transformer.init_params(cfg, seed, max_seq, device=device)


def forward(cfg, params, batch, ctx=None):
    """batch: dict(tokens (B, S) [, moe_impl]); ``ctx`` as in
    ``transformer.forward``."""
    _ported(cfg)
    if cfg.family == "moe":
        return deepseek.forward(cfg, params, batch["tokens"],
                                moe_impl=batch.get("moe_impl", "dense"), ctx=ctx)
    return transformer.forward(cfg, params, batch["tokens"], ctx=ctx)


def _ce(logits, labels):
    """Mean next-token cross-entropy, the log-softmax in f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def loss_fn(cfg, params, batch, ctx=None):
    """Next-token CE over the token stream, plus, for a moe config with
    ``mtp_depth`` > 0 and an ``"mtp"`` block, V3's MTP auxiliary term
    ``0.3 · CE`` of the t → t+2 predictions.  The vlm patch prefix comes
    with that family.  ``ctx`` as in :func:`forward`; training passes the
    gather route, since no kernel has a backward."""
    _ported(cfg)
    tokens = batch["tokens"]
    hidden = None
    if cfg.family == "moe" and cfg.mtp_depth > 0 and "mtp" in params:
        logits, hidden = deepseek.forward(
            cfg, params, tokens, moe_impl=batch.get("moe_impl", "dense"), ctx=ctx,
            return_hidden=True)
    else:
        logits = forward(cfg, params, batch, ctx=ctx)
    loss = _ce(logits[:, :-1], tokens[:, 1:])
    if hidden is not None:
        mtp = deepseek.mtp_logits(cfg, params, tokens, hidden, ctx=ctx)
        loss = loss + 0.3 * _ce(mtp[:, :-1], tokens[:, 2:])  # t -> t+2 targets
    return loss


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", kv_spec=None):
    """The contiguous decode cache (dense: k/v (L, B, Smax, KH, hd); moe:
    the latent caches), with one int32 offset.  A float ``kv_spec`` sets
    its dtype; a quantized one needs the paged layout and raises, as in
    the reference."""
    _ported(cfg)
    if kv_spec is not None:
        if kv_spec.is_quantized:
            raise ValueError(
                f"kv dtype {kv_spec.dtype!r} requires the paged cache layout; "
                f"contiguous/{cfg.family!r} caches support f32/bf16 only")
        dtype = kv_spec.cache_dtype
    if cfg.family == "moe":
        return deepseek.init_cache(cfg, batch, max_seq, dtype, device=device)
    return transformer.init_cache(cfg, batch, max_seq, dtype, device=device)


def prefill(cfg, params, batch, cache, ctx=None):
    """The prompt into a contiguous cache; returns (last row's logits (B,
    1, V), cache)."""
    _ported(cfg)
    if cfg.family == "moe":
        return deepseek.prefill(cfg, params, batch["tokens"], cache,
                                moe_impl=batch.get("moe_impl", "dense"), ctx=ctx)
    return transformer.prefill(cfg, params, batch["tokens"], cache, ctx=ctx)


def decode_step(cfg, params, tokens, cache, moe_impl: str = "dense",
                with_stats: bool = False, ctx=None):
    """One token per row against a contiguous cache; ``with_stats``
    appends the EP drop-stats dict (moe only, as in the reference)."""
    if with_stats and cfg.family != "moe":
        raise ValueError(f"with_stats is a moe-family knob, not {cfg.family!r}")
    _ported(cfg)
    if cfg.family == "moe":
        return deepseek.decode_step(cfg, params, tokens, cache, moe_impl=moe_impl,
                                    with_stats=with_stats, ctx=ctx)
    return transformer.decode_step(cfg, params, tokens, cache, ctx=ctx)


def init_paged_cache(cfg, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device="cuda", kv_spec=None):
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged KV serving supports families {PAGED_FAMILIES}, not "
            f"{cfg.family!r}")
    return transformer.init_paged_cache(cfg, num_pages, page_size, dtype,
                                        device=device, kv_spec=kv_spec)


def paged_step(cfg, params, tokens, positions, valid, cache, block_table,
               sample_row=None, kv_spec=None, ctx=None, is_prefill=None):
    """Chunked-prefill / batched-decode step against a paged KV pool; see
    ``transformer.paged_step`` for the contract."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(cfg.family)
    return transformer.paged_step(cfg, params, tokens, positions, valid,
                                  cache, block_table, sample_row,
                                  kv_spec=kv_spec, ctx=ctx, is_prefill=is_prefill)
