"""DeepSeek-V2/V3 decoder: MLA attention + (shared + routed top-k) MoE FFN
(counterpart of ``repro/models/deepseek.py``).

The layer stack is ``n_dense_layers`` leading dense-FFN layers
(``params["dense_layers"]``) followed by the MoE layers
(``params["moe_layers"]``); the reference stacks each group on a leading
axis and scans it, the port keeps a list of per-layer dicts and loops
(``bridge.py`` unstacks a reference tree).  V3's multi-token-prediction
block (``params["mtp"]``) runs in training only: :func:`mtp_logits`
predicts token t+2 from the backbone's final-normed hidden state at t
(:func:`forward` with ``return_hidden``), the auxiliary term of
``model.loss_fn``.

The decode state is the reference's contiguous latent cache, per group
``dict(c_kv (n, B, Smax, R), k_rope (n, B, Smax, rope), offset)`` with one
int32 offset shared by the batch rows, which is why the engine serves this
family one request per cache (its per-slot mode).  The offset stays on the
device: a step reads nothing back to the host.

``ctx.attention`` (a :class:`~repro_torch.kernels.context.KernelContext`;
None = "auto") routes MLA's attention: the dense flash kernel (#7) at D =
nope + rope, Dv = v_head_dim (causal from ``q_start`` 0 in ``forward`` and
``prefill``, from the cache offset in ``decode_step``: the reference's
masks), or the reference's gather.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import DEFAULT_CONTEXT
from repro_torch.models.common import causal_mask, mlp_block, rms_norm
from repro_torch.models.mla import (init_mla_params, mla_attention_block,
                                    mla_rope_table)
from repro_torch.models.moe import init_moe_params, moe_block
from repro_torch.models.remat import maybe_remat
from repro_torch.models.transformer import _init_linear, embed_tokens, unembed
from repro_torch.quant.qlinear import apply_linear

# (param group, its cache's key, whether its layers are MoE), in stack order
LAYER_GROUPS = (("dense_layers", "dense", False), ("moe_layers", "moe", True))


def _init_block(cfg, gen, dtype, device, moe: bool):
    p = {
        "attn_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_mla_params(cfg, gen, dtype, device),
        "mlp_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if moe:
        p["moe"] = init_moe_params(cfg, gen, dtype, device)
    else:
        ff = cfg.d_ff_dense or cfg.d_ff
        p["mlp"] = {
            "wg": _init_linear(gen, cfg.d_model, ff, dtype, device),
            "wu": _init_linear(gen, cfg.d_model, ff, dtype, device),
            "wd": _init_linear(gen, ff, cfg.d_model, dtype, device),
        }
    return p


def init_params(cfg, seed: int = 0, max_seq: int = 0, device="cuda"):
    """Random parameters from ``seed`` (a ``torch.Generator`` on the target
    device; the numbers differ from the reference's ``jax.random``)."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    nd = cfg.n_dense_layers
    params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=device) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": _init_linear(gen, cfg.d_model, cfg.vocab_size, dtype, device),
    }
    if nd > 0:
        params["dense_layers"] = [_init_block(cfg, gen, dtype, device, moe=False)
                                  for _ in range(nd)]
    params["moe_layers"] = [_init_block(cfg, gen, dtype, device, moe=True)
                            for _ in range(cfg.n_layers - nd)]
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": _init_linear(gen, 2 * cfg.d_model, cfg.d_model, dtype, device),
            "block": _init_block(cfg, gen, dtype, device, moe=False),
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        }
    return params


def _block_forward(cfg, lp, x, positions, mask, cache, moe: bool,
                   moe_impl: str, route: str, rope_cs, q_start):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, new_cache = mla_attention_block(cfg, lp["attn"], h, positions, mask, cache,
                                       route, rope_cs, q_start)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if moe:
        x = x + moe_block(cfg, lp["moe"], h, impl=moe_impl)
    else:
        x = x + mlp_block(lp["mlp"], h, cfg.act)
    return x, new_cache


def _backbone(cfg, params, x, positions, mask, caches, moe_impl, route,
              q_start):
    """Every layer of both groups; returns (x, new caches or None).  Without
    caches each layer runs under ``cfg.remat``
    (:func:`~repro_torch.models.remat.maybe_remat`), as the reference's
    cache-free stack does."""
    rope_cs = mla_rope_table(cfg, positions)  # the same for every layer
    block = _block_forward if caches is not None else maybe_remat(cfg, _block_forward)
    new_caches = {}
    for group, key, moe in LAYER_GROUPS:
        if group not in params:
            continue
        cache = None if caches is None else caches[key]
        ckv, krope = [], []
        for li, lp in enumerate(params[group]):
            lc = None if cache is None else dict(
                c_kv=cache["c_kv"][li], k_rope=cache["k_rope"][li],
                offset=cache["offset"])
            x, nc = block(cfg, lp, x, positions, mask, lc, moe, moe_impl, route,
                          rope_cs, q_start)
            if nc is not None:
                ckv.append(nc["c_kv"])
                krope.append(nc["k_rope"])
        if cache is not None:
            new_caches[key] = dict(c_kv=torch.stack(ckv), k_rope=torch.stack(krope),
                                   offset=cache["offset"] + positions.shape[-1])
    return x, (new_caches if caches is not None else None)


def _route(cfg, ctx, device) -> str:
    return (DEFAULT_CONTEXT if ctx is None else ctx).attention_route(
        device, cfg.attn_head_dim)


def forward(cfg, params, tokens, moe_impl: str = None, ctx=None,
            return_hidden: bool = False):
    """Teacher-forcing forward. tokens (B, S) → logits (B, S, V) f32, and
    with ``return_hidden`` also the final-normed hidden states (B, S, D)
    that :func:`mtp_logits` reads."""
    moe_impl = moe_impl or cfg.moe_impl
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    route = _route(cfg, ctx, x.device)
    mask = None if route == "kernel" else causal_mask(s, s, 0, device=x.device)
    x, _ = _backbone(cfg, params, x, positions, mask, None, moe_impl, route, None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x)
    if return_hidden:
        return logits, x
    return logits


def mtp_logits(cfg, params, tokens, hidden, ctx=None):
    """V3's MTP head: h'_t = block(proj([norm(h_t); emb(tok_{t+1})]))
    predicts token t+2.  ``hidden``: the backbone's final-normed states (B,
    S, D).  The block is the dense-FFN MLA block, run causally without a
    cache on ``ctx``'s route.  Returns (B, S-1, V) logits for tokens[:,
    2:]."""
    mtp = params["mtp"]
    emb_next = embed_tokens(cfg, params, tokens[:, 1:])  # (B, S-1, D)
    z = torch.cat([rms_norm(hidden[:, :-1], mtp["norm"], cfg.norm_eps), emb_next],
                  dim=-1)
    z = apply_linear(mtp["proj"], z)
    b, s, _ = z.shape
    positions = torch.arange(s, device=z.device).expand(b, s)
    route = _route(cfg, ctx, z.device)
    mask = None if route == "kernel" else causal_mask(s, s, 0, device=z.device)
    z, _ = _block_forward(cfg, mtp["block"], z, positions, mask, None, False,
                          "dense", route, mla_rope_table(cfg, positions), None)
    return unembed(cfg, params, z)


def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda"):
    device = resolve_device(device)

    def stack(n):
        return dict(
            c_kv=torch.zeros((n, batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                             device=device),
            k_rope=torch.zeros((n, batch, max_seq, cfg.qk_rope_dim), dtype=dtype,
                               device=device),
            offset=torch.zeros((), dtype=torch.int32, device=device))

    caches = {"moe": stack(cfg.n_layers - cfg.n_dense_layers)}
    if cfg.n_dense_layers > 0:
        caches["dense"] = stack(cfg.n_dense_layers)
    return caches


def prefill(cfg, params, tokens, caches, moe_impl: str = None, ctx=None):
    """The prompt (B, S) from position 0 into ``caches``; returns (last
    row's logits (B, 1, V), new caches).  The kernel route attends with
    ``q_start`` 0, the reference's ``causal_mask(S, Smax, 0)``."""
    moe_impl = moe_impl or cfg.moe_impl
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    kv_len = caches["moe"]["c_kv"].shape[2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    route = _route(cfg, ctx, x.device)
    mask = q_start = None
    if route == "kernel":
        q_start = torch.zeros((b,), dtype=torch.int32, device=x.device)
    else:
        mask = causal_mask(s, kv_len, 0, device=x.device)
    x, caches = _backbone(cfg, params, x, positions, mask, caches, moe_impl, route,
                          q_start)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x[:, -1:]), caches


def decode_step(cfg, params, tokens, caches, moe_impl: str = None,
                with_stats: bool = False, ctx=None):
    """One token per row (B, 1) at the caches' offset.  The kernel route
    attends with ``q_start`` = the offset (the reference's mask ``arange(
    Smax) <= offset``).  ``with_stats`` also returns ``{"ep_dropped":
    int32}``, the capacity drops of the step's MoE layers: 0 on the dense
    dispatch."""
    moe_impl = moe_impl or cfg.moe_impl
    x = embed_tokens(cfg, params, tokens)
    b = x.shape[0]
    offset = caches["moe"]["offset"]
    positions = offset.to(torch.long).expand(b, 1)
    kv_len = caches["moe"]["c_kv"].shape[2]
    route = _route(cfg, ctx, x.device)
    mask = q_start = None
    if route == "kernel":
        q_start = offset.to(torch.int32).expand(b).contiguous()
    else:
        mask = (torch.arange(kv_len, device=x.device) <= offset)[None, :]
    x, caches = _backbone(cfg, params, x, positions, mask, caches, moe_impl, route,
                          q_start)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(cfg, params, x)
    if with_stats:
        return logits, caches, {"ep_dropped": torch.zeros((), dtype=torch.int32,
                                                          device=x.device)}
    return logits, caches
