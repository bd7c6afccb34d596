"""Per-layer activation-checkpoint policies (counterpart of
``repro/models/remat.py``'s ``maybe_remat``).

The reference wraps its scanned layer body in ``jax.checkpoint``; the port
runs its layers in a Python loop and wraps each layer's call in
``torch.utils.checkpoint`` instead:

  none — keep every activation for the backward pass;
  full — keep only the layer's inputs and recompute the layer in backward;
  dots — keep the outputs of the layer's 2-D matmuls (the reference's
         ``checkpoint_dots_with_no_batch_dims``: the projections) and
         recompute the rest (norms, RoPE, the attention's batched products,
         the activations).

Recomputation runs the same operations on the same inputs, so the
gradients are bitwise those of "none".
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_POLICIES = ("none", "full", "dots")

# the matmuls without a batch dimension; aten.matmul of a (B, S, K) by a
# (K, N) operand reaches autograd as one of these on the flattened rows
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(cfg, body):
    """``body`` (a layer's call) wrapped per ``cfg.remat``."""
    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"unknown remat policy {cfg.remat!r}; expected one of "
                     f"{REMAT_POLICIES}")
