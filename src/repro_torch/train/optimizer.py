"""AdamW + cosine schedule (counterpart of ``repro/train/optimizer.py``):
pure functions over the port's param trees (dicts and lists of tensors).

``state_dtype`` sets the moments' dtype (float32 by default, or bfloat16);
the moment math, the bias corrections and the clipping are f32 whatever
the parameters' dtype, as in the reference.

Weight decay follows the reference's rule, "decay a leaf of rank >= 2",
applied to the reference's layout.  The reference stacks its decoder
layers on a leading axis, so its per-layer norms are (L, d) leaves and are
decayed, while ``final_norm`` (d,) is not.  The port keeps a list of
per-layer dicts whose norms are (d,); a leaf under a stacked key
(``bridge.STACKED_KEYS``: the dense family's ``"layers"``, the moe
family's ``"dense_layers"`` and ``"moe_layers"``) therefore counts one
dimension more (:func:`decays`), and V3's unstacked MTP block does not.

``global_norm`` sums leaf by leaf in the port's order (per layer), where
the reference sums its sorted, stacked leaves: the two agree to f32
rounding, not bitwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.bridge import STACKED_KEYS


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and lists (``rest``: trees
    of the same structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in its order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def decays(params) -> dict:
    """The tree of booleans saying which leaves weight decay applies to: a
    leaf of rank >= 2 in the reference's stacked layout, where a leaf under
    a stacked key has the extra leading layer axis."""
    return {k: tree_map(lambda p, extra=int(k in STACKED_KEYS): p.dim() + extra >= 2, v)
            for k, v in params.items()}


def adamw_init(params, state_dtype=torch.float32) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_lr(step, base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """The learning rate at ``step`` (an integer tensor) as an f32 tensor:
    linear warmup, then cosine decay to ``min_frac`` of ``base_lr``."""
    step = step.to(torch.float32)
    warm = base_lr * step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0):
    """One AdamW step with global-norm clipping; returns ``(new_params,
    new_state, grad_norm)``.  Nothing is updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    b1c = 1 - b1 ** step.to(torch.float32)
    b2c = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v, decay):
        g = g.to(torch.float32) * scale
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m32 = b1 * m32 + (1 - b1) * g
        v32 = b2 * v32 + (1 - b2) * g * g
        u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + eps)
        if decay:  # decoupled weight decay on matrices only
            u = u + weight_decay * p.to(torch.float32)
        newp = (p.to(torch.float32) - lr * u).to(p.dtype)
        return newp, m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, state.mu, state.nu, decays(params))
    return (_select(out, 0), AdamWState(step=step, mu=_select(out, 1),
                                        nu=_select(out, 2)), gnorm)


def _select(out, i: int):
    """Element ``i`` of every (param, mu, nu) triple of ``out``."""
    if isinstance(out, dict):
        return {k: _select(v, i) for k, v in out.items()}
    if isinstance(out, list):
        return [_select(v, i) for v in out]
    return out[i]
