"""Move parameters between the reference's layout and the port's.

The reference keeps its parameters as a pytree whose decoder layers are
stacked on a leading axis (scanned) and whose quantized linears are
``QLinear`` pytrees.  The bridge takes that tree as **numpy arrays** —
with each ``QLinear`` given as a plain dict of its fields — and returns the
port's tensors: ``params["layers"]`` (the moe family's ``dense_layers``
and ``moe_layers``) becomes a list of per-layer dicts and every dict that
holds a ``qweight`` becomes a :class:`QLinear`.  The way
back (:func:`params_to_numpy`) restacks the layers.  A paged KV cache has
the same layout in both packages, (L, NP, P, KH, ·) per leaf (``k``,
``v`` and, for a quantized ``KVSpec``, the ``k_scale``/``v_scale`` planes),
and crosses leaf by leaf (:func:`cache_from_jax`, :func:`cache_to_numpy`),
as do the moe family's nested latent caches.

bf16 arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses; they are recognised by the dtype's name and passed through their
16-bit pattern, so the port needs no ``ml_dtypes``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.qlinear import QLinear

_QLINEAR_ARRAYS = ("qweight", "w_scale", "u", "v")
# the kernel context is run-time config, not a parameter: it does not travel
_QLINEAR_STATIC = tuple(f.name for f in dataclasses.fields(QLinear)
                        if f.name not in _QLINEAR_ARRAYS + ("ctx",))


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.c_contiguous:  # (ascontiguousarray would make a 0-d array 1-d)
        a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a jax array: torch needs its own
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """bf16 tensors come back as their uint16 bit pattern, or viewed as
    ``bf16_dtype`` (e.g. ``ml_dtypes.bfloat16``) when the caller gives one."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()


def _to_torch(node, device):
    if node is None:
        return None
    if isinstance(node, dict):
        if "qweight" in node:
            return QLinear(
                **{k: tensor_from_numpy(node[k], device)
                   if node.get(k) is not None else None
                   for k in _QLINEAR_ARRAYS},
                **{k: node[k] for k in _QLINEAR_STATIC if k in node})
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_torch(v, device) for v in node]
    return tensor_from_numpy(node, device)


def _take(node, i: int):
    """Layer ``i`` of a stacked layer tree (leading axis of every array)."""
    if node is None:
        return None
    if isinstance(node, dict):
        if "qweight" in node:
            return {k: (_take(v, i) if k in _QLINEAR_ARRAYS else v)
                    for k, v in node.items()}
        return {k: _take(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _n_layers(node) -> int:
    if isinstance(node, dict):
        for k, v in node.items():
            if v is not None and not (k in _QLINEAR_STATIC and "qweight" in node):
                return _n_layers(v)
        raise ValueError("empty layer tree")
    return np.asarray(node).shape[0]


# the keys whose subtree stacks decoder layers on a leading axis in the
# reference (dense: "layers"; moe: the leading dense-FFN layers, then the
# MoE layers); every other subtree (an MTP block included) is one layer
STACKED_KEYS = ("layers", "dense_layers", "moe_layers")


def params_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's param tree (numpy leaves, QLinears as dicts) → the
    port's params on ``device``, layers unstacked.  A routed expert site
    keeps its (E, …) axis below the layer axis, a QLinear's arrays
    included."""
    device = resolve_device(device)
    out = {}
    for key, node in tree.items():
        if key in STACKED_KEYS:
            n = _n_layers(node)
            out[key] = [_to_torch(_take(node, i), device) for i in range(n)]
        else:
            out[key] = _to_torch(node, device)
    return out


def _to_numpy(node, bf16_dtype):
    if node is None:
        return None
    if isinstance(node, QLinear):
        d = {k: _to_numpy(getattr(node, k), bf16_dtype) for k in _QLINEAR_ARRAYS}
        d.update({k: getattr(node, k) for k in _QLINEAR_STATIC})
        return d
    if isinstance(node, dict):
        return {k: _to_numpy(v, bf16_dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_numpy(v, bf16_dtype) for v in node]
    return tensor_to_numpy(node, bf16_dtype)


def _stack(nodes):
    first = nodes[0]
    if first is None:
        return None
    if isinstance(first, dict):
        if "qweight" in first:
            return {k: (_stack([n[k] for n in nodes]) if k in _QLINEAR_ARRAYS
                        else first[k]) for k in first}
        return {k: _stack([n[k] for n in nodes]) for k in first}
    return np.stack(nodes)


def params_to_numpy(params: dict, bf16_dtype=None) -> dict:
    """The port's params → the reference's layout as numpy (layers stacked
    on a leading axis, QLinears as dicts of their fields)."""
    out = {}
    for key, node in params.items():
        if key in STACKED_KEYS:
            out[key] = _stack([_to_numpy(lp, bf16_dtype) for lp in node])
        else:
            out[key] = _to_numpy(node, bf16_dtype)
    return out


def cache_from_jax(cache: dict, device="cuda") -> dict:
    """The reference's cache as numpy leaves → the port's on ``device``,
    every leaf in its own dtype: a paged pool (scale planes included), or
    the moe family's nested ``{"dense", "moe"}`` latent caches, whose
    int32 ``offset`` stays a 0-d device tensor."""
    device = resolve_device(device)
    return {k: cache_from_jax(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in cache.items()}


def cache_to_numpy(cache: dict, bf16_dtype=None) -> dict:
    """The port's cache → numpy leaves in the reference's layout."""
    return {k: cache_to_numpy(v, bf16_dtype) if isinstance(v, dict)
            else tensor_to_numpy(v, bf16_dtype) for k, v in cache.items()}


def train_state_from_jax(params: dict, mu: dict, nu: dict, step, device="cuda"):
    """The reference's ``TrainState`` given as numpy trees (its params and
    its AdamW moments ``mu``/``nu``, layers stacked) and its step count →
    the port's :class:`~repro_torch.train.steps.TrainState` on ``device``,
    every tree unstacked as :func:`params_from_jax` unstacks the params."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.steps import TrainState

    device = resolve_device(device)
    step = torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device)
    return TrainState(params=params_from_jax(params, device),
                      opt=AdamWState(step=step, mu=params_from_jax(mu, device),
                                     nu=params_from_jax(nu, device)))


def train_state_to_numpy(state, bf16_dtype=None) -> dict:
    """The port's ``TrainState`` → ``dict(params, mu, nu, step)`` as numpy
    in the reference's layout (layers stacked), the inverse of
    :func:`train_state_from_jax`."""
    return dict(params=params_to_numpy(state.params, bf16_dtype),
                mu=params_to_numpy(state.opt.mu, bf16_dtype),
                nu=params_to_numpy(state.opt.nu, bf16_dtype),
                step=np.asarray(int(state.opt.step), np.int32))
