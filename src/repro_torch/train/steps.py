"""Train step factory (counterpart of ``repro/train/steps.py``): loss →
grads → AdamW, with optional microbatch gradient accumulation and remat
(``cfg.remat``).

The loss and its gradients come from autograd.  The training forward takes
attention's gather route explicitly (:data:`TRAIN_CONTEXT`): the reference
trains through its jnp attention too, and no kernel of the port has a
backward (their wrappers raise on an input that requires grad).  The
returned step is pure: ``(state, batch) -> (state, metrics)``, the state's
tensors are never updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.context import KernelContext
from repro_torch.models import model as model_lib
from repro_torch.train.optimizer import (AdamWState, adamw_init, adamw_update,
                                         cosine_lr, tree_leaves, tree_map)

TRAIN_CONTEXT = KernelContext(attention="gather")


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState


def init_train_state(cfg, seed: int = 0, device="cuda",
                     state_dtype=torch.float32) -> TrainState:
    params = model_lib.init_params(cfg, seed, device=resolve_device(device))
    return TrainState(params=params, opt=adamw_init(params, state_dtype))


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def value_and_grad(cfg, params, batch):
    """The training loss on ``batch`` and its gradient tree (autograd, the
    layers under ``cfg.remat``), the forward on :data:`TRAIN_CONTEXT`."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = model_lib.loss_fn(cfg, _unflatten(params, live), batch,
                                 ctx=TRAIN_CONTEXT)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), _unflatten(params, grads)


def make_train_step(cfg, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, microbatches: int = 1,
                    remat: str | None = None):
    """The train step of ``cfg``; its layers are rematerialised as
    ``cfg.remat`` says, unless ``remat`` names another mode."""
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)

    def train_step(state: TrainState, batch):
        if microbatches > 1:
            # split the leading batch dim and accumulate in the reference's
            # order: carry + g / microbatches
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
                  for k, v in batch.items()}
            dev = tree_leaves(state.params)[0].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            for i in range(microbatches):
                l, g = value_and_grad(cfg, state.params, {k: v[i] for k, v in mb.items()})
                loss = loss + l / microbatches
                grads = tree_map(lambda a, gi: a + gi / microbatches, grads, g)
        else:
            loss, grads = value_and_grad(cfg, state.params, batch)
        lr = cosine_lr(state.opt.step, base_lr, warmup, total_steps)
        params, opt, gnorm = adamw_update(state.params, grads, state.opt, lr)
        metrics = dict(loss=loss, grad_norm=gnorm, lr=lr)
        return TrainState(params=params, opt=opt), metrics

    return train_step
