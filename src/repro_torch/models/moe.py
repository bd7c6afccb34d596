"""Mixture-of-Experts FFN (DeepSeek-V2/V3: shared + routed top-k;
counterpart of ``repro/models/moe.py``).

The dispatch ported is the reference's single-chip one, ``dense``: every
expert computes every token, and the router's weight matrix (exactly top_k
nonzeros a row) combines them.  ``ep`` (expert-parallel all-to-all
dispatch) waits for the port's ``torch.distributed`` layer (ROADMAP Queue
1 item 6) and raises.

Routed experts are stacked on a leading expert axis: float (E, D, F)
tensors, or one :class:`~repro_torch.quant.qlinear.QLinear` whose arrays
carry that axis (:func:`~repro_torch.quant.qlinear.expert`), applied
expert by expert, so each expert's call is one QLinear call (one kernel
call per kernel of its path).  Shared experts run as one fused MLP of
width ``n_shared * d_expert``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import mlp_block
from repro_torch.quant.qlinear import QLinear, apply_linear, expert

MOE_IMPLS = ("dense", "ep")


def init_moe_params(cfg, gen, dtype, device):
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert

    def lin(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    p = {
        "router": lin((d, e), d**-0.5),
        "experts": {
            "wg": lin((e, d, fe), d**-0.5),
            "wu": lin((e, d, fe), d**-0.5),
            "wd": lin((e, fe, d), fe**-0.5),
        },
    }
    if cfg.n_shared_experts > 0:
        fs = cfg.n_shared_experts * fe
        p["shared"] = {
            "wg": lin((d, fs), d**-0.5),
            "wu": lin((d, fs), d**-0.5),
            "wd": lin((fs, d), fs**-0.5),
        }
    return p


def top_k(scores: torch.Tensor, k: int):
    """The ``k`` largest scores of each row and their indices, largest
    first, equal scores in ascending index order (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_weights(cfg, p, x):
    """x: (..., D) → (weights (..., E) f32 with exactly top_k nonzeros,
    renormalised to sum 1, top_k indices)."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    if cfg.router_fn == "sigmoid":  # deepseek-v3
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(scores, cfg.moe_top_k)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    weights = torch.zeros_like(scores).scatter(-1, top_idx, top_vals)
    return weights, top_idx


def _expert_matmul(w, x):
    """x (T, D) against stacked expert weights (E, D, F) → (T, E, F); a
    QLinear runs one call per expert."""
    if isinstance(w, QLinear):
        n = w.qweight.shape[0]
        return torch.stack([apply_linear(expert(w, e), x) for e in range(n)], dim=1)
    return torch.einsum("td,edf->tef", x, w.to(x.dtype))


def _experts_dense(cfg, p, x, weights):
    """All-experts combine. x: (T, D); weights: (T, E), cast to x's dtype
    before the sum over experts, as in the reference."""
    we = p["experts"]
    g = _expert_matmul(we["wg"], x)
    u = _expert_matmul(we["wu"], x)
    h = F.silu(g) * u
    wd = we["wd"]
    if isinstance(wd, QLinear):
        y = torch.stack([apply_linear(expert(wd, e), h[:, e])
                         for e in range(wd.qweight.shape[0])], dim=1)
    else:
        y = torch.einsum("tef,efd->ted", h, wd.to(x.dtype))
    return torch.einsum("ted,te->td", y, weights.to(x.dtype))


def moe_block(cfg, p, x, impl: str = "dense", return_stats: bool = False):
    """x: (B, S, D) → (B, S, D); with ``return_stats`` also the int32
    count of capacity-dropped (token, slot) assignments (0: the dense
    dispatch has no capacity)."""
    if impl == "ep":
        raise NotImplementedError(
            "expert-parallel MoE dispatch (impl='ep') is not ported; it comes "
            "with the torch.distributed layer (ROADMAP Queue 1 item 6)")
    if impl != "dense":
        raise ValueError(f"unknown moe impl {impl!r}; one of {MOE_IMPLS}")
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    weights, _ = router_weights(cfg, p, xt)
    out = _experts_dense(cfg, p, xt, weights)
    if "shared" in p:
        out = out + mlp_block(p["shared"], xt, cfg.act)
    out = out.reshape(b, s, d)
    if return_stats:
        return out, torch.zeros((), dtype=torch.int32, device=x.device)
    return out
