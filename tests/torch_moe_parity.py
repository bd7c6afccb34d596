"""Shared helpers of the moe-family parity tests (``test_torch_moe``,
``test_torch_mla``, ``test_torch_deepseek_serve``,
``test_torch_calibrate_moe``): the reduced DeepSeek-V2 and -V3 of both
packages, their random parameters from the reference, and reference
QLinears on every site the reference's policy quantizes.

Importing :mod:`torch_parity` caps torch at one intra-op thread (see
there)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models.config import reduced as jax_reduced
from repro.quant.policy import QuantPolicy as JaxQuantPolicy
from repro.quant.policy import path_str as jax_path_str
from repro.quant.qlinear import make_qlinear as jax_make_qlinear
from repro_torch.configs import get_config
from repro_torch.models.config import reduced
from torch_parity import RTN_SVD, SEED

ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")
GROUPS = ("dense_layers", "moe_layers")


def ds_configs(arch="deepseek-v2-236b", **overrides):
    """(reference config, port config) of the reduced ``arch`` (2 layers,
    d_model 64, 8 experts top-2, f32), with ``overrides``."""
    return (jax_reduced(jax_get_config(arch), **overrides),
            reduced(get_config(arch), **overrides))


def ds_params(jcfg):
    return jax_model.init_params(jcfg, jax.random.PRNGKey(SEED))


def _rtn_svd(w, rank, impl):
    """A reference QLinear of ``w`` (d_in, d_out): RTN codes and a
    rank-10% SVD correction computed in numpy, unnamed as the reference's
    moe walker leaves its sites."""
    w = np.asarray(w, np.float64).T  # (d_out, d_in)
    amax = np.abs(w).max(axis=1, keepdims=True)
    s = np.where(amax <= 0, 1.0, amax) / 7
    q = np.clip(np.round(w / s), -8, 7)
    uu, ss, vvt = np.linalg.svd(w - q * s, full_matrices=False)
    k = rank(w.shape[1], w.shape[0])
    u = uu[:, :k] * np.sqrt(ss[:k])
    v = vvt[:k].T * np.sqrt(ss[:k])
    return jax_make_qlinear(jnp.asarray(q, jnp.int8), jnp.asarray(s, jnp.float32),
                            jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32),
                            clip_ratio=RTN_SVD["clip_ratio"], impl=impl)


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def ds_qlinears(jcfg, params, impl="int8"):
    """The reference tree with every site of the walked layer groups that
    the reference's policy quantizes (``should_quantize`` on its
    ``path_str``) replaced by a reference QLinear (:func:`_rtn_svd`): a
    routed expert stack becomes one QLinear stacked on the expert axis, as
    the reference's walker stacks it."""
    policy = JaxQuantPolicy(**RTN_SVD)

    def solve(node, path):
        if isinstance(node, dict):
            return {k: solve(v, path + (k,)) for k, v in node.items()}
        if not policy.should_quantize(jax_path_str(path), node.shape):
            return jnp.asarray(node)
        if node.ndim == 3:
            return _stack([_rtn_svd(w, policy.rank, impl) for w in node])
        return _rtn_svd(node, policy.rank, impl)

    out = dict(params)
    for group in GROUPS:
        if group not in params:
            continue
        n = jax.tree.leaves(params[group])[0].shape[0]
        layers = [solve(jax.tree.map(lambda a: np.asarray(a[li]), params[group]),
                        (group,)) for li in range(n)]
        out[group] = _stack(layers)
    return out
