"""Model facade: family dispatch (counterpart of ``repro/models/model.py``;
the dense family is the one ported), and the training loss."""

from __future__ import annotations

import torch

from repro_torch.models import transformer

PAGED_FAMILIES = ("dense",)


def _dense_only(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; only 'dense' is")


def init_params(cfg, seed: int = 0, max_seq: int = 0, device="cuda"):
    _dense_only(cfg)
    return transformer.init_params(cfg, seed, max_seq, device=device)


def forward(cfg, params, batch, ctx=None):
    """batch: dict(tokens (B, S)); ``ctx`` as in ``transformer.forward``."""
    _dense_only(cfg)
    return transformer.forward(cfg, params, batch["tokens"], ctx=ctx)


def _ce(logits, labels):
    """Mean next-token cross-entropy, the log-softmax in f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def loss_fn(cfg, params, batch, ctx=None):
    """Next-token CE over the token stream.  The reference's MTP auxiliary
    loss (moe) and its patch prefix (vlm) belong to families that are not
    ported.  ``ctx`` as in :func:`forward`; training passes the gather
    route, since no kernel has a backward."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    logits = forward(cfg, params, batch, ctx=ctx)
    return _ce(logits[:, :-1], tokens[:, 1:])


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
