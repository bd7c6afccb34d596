"""Shared helpers of the ``test_torch_*`` parity tests: the reference's
objects as the numpy trees the bridge takes, and the reduced SmolLM both
packages are compared on."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models.config import reduced as jax_reduced
from repro.quant.calibrate import quantize_model as jax_quantize_model
from repro.quant.policy import QuantPolicy as JaxQuantPolicy
from repro.quant.qlinear import QLinear as JaxQLinear
from repro.quant.qlinear import make_qlinear as jax_make_qlinear
from repro_torch.configs import get_config
from repro_torch.models.config import reduced

SEED = 0
RTN_SVD = dict(quant_method="rtn", correction="svd", rank_frac=0.10,
               clip_ratio=0.9)


def to_numpy_tree(tree):
    """A reference param tree with numpy leaves and each QLinear as a plain
    dict of its fields (the bridge's input)."""
    if isinstance(tree, JaxQLinear):
        return {"qweight": np.asarray(tree.qweight),
                "w_scale": np.asarray(tree.w_scale),
                "u": None if tree.u is None else np.asarray(tree.u),
                "v": None if tree.v is None else np.asarray(tree.v),
                "bits": tree.bits, "act_bits": tree.act_bits,
                "act_group": tree.act_group, "clip_ratio": tree.clip_ratio,
                "impl": tree.impl, "name": tree.name}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@contextlib.contextmanager
def x64_restored():
    """The reference's calibration turns on jax_enable_x64 for the whole
    process; put the flag back so no other test in the worker sees it."""
    prev = bool(jax.config.jax_enable_x64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def configs(dtype="float32", n_layers=2):
    """(reference config, port config) of the reduced SmolLM-135M."""
    jcfg = jax_reduced(jax_get_config("smollm-135m"), dtype=dtype,
                       n_layers=n_layers)
    tcfg = reduced(get_config("smollm-135m"), dtype=dtype, n_layers=n_layers)
    return jcfg, tcfg


def jax_params(jcfg):
    return jax_model.init_params(jcfg, jax.random.PRNGKey(SEED))


def jax_quantized(jcfg, params, impl="int8"):
    """The reference's ``quantize_model`` with RTN + SVD (its calibration
    walk: ~20 s here, mostly compilation), jnp QLinears."""
    calib = jnp.asarray(np.random.default_rng(SEED).integers(
        0, jcfg.vocab_size, (2, 16)), jnp.int32)
    with x64_restored():
        return jax_quantize_model(jcfg, params, calib,
                                  JaxQuantPolicy(impl=impl, **RTN_SVD),
                                  rotate=False)


def jax_qlinears(jcfg, params, impl="int8"):
    """Reference QLinears (``make_qlinear``) on every site, with RTN codes
    and a rank-10% SVD correction computed in numpy: the same kind of
    layers as :func:`jax_quantized` in a fraction of the time, for tests
    whose subject is the model or the engine rather than the solver."""
    rank = JaxQuantPolicy(**RTN_SVD).rank
    layers = []
    for li in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: np.asarray(a[li], np.float64), params["layers"])
        qlp = {k: jnp.asarray(v) for k, v in lp.items() if not isinstance(v, dict)}
        for block, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("mlp", ("wg", "wu", "wd"))):
            qlp[block] = {}
            for n in names:
                w = lp[block][n].T  # (d_out, d_in)
                amax = np.abs(w).max(axis=1, keepdims=True)
                s = np.where(amax <= 0, 1.0, amax) / 7
                q = np.clip(np.round(w / s), -8, 7)
                uu, ss, vvt = np.linalg.svd(w - q * s, full_matrices=False)
                k = rank(w.shape[1], w.shape[0])
                u = uu[:, :k] * np.sqrt(ss[:k])
                v = vvt[:k].T * np.sqrt(ss[:k])
                qlp[block][n] = jax_make_qlinear(
                    jnp.asarray(q, jnp.int8), jnp.asarray(s, jnp.float32),
                    jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32),
                    clip_ratio=RTN_SVD["clip_ratio"], impl=impl,
                    name=f"{block}/{n}")
        layers.append(qlp)
    return dict(params, layers=jax.tree.map(lambda *xs: jnp.stack(xs), *layers))


def lr_tolerance(x, v, u, k, r, y):
    """Elementwise bound on two f32 evaluations of the W4A4+LRC output whose
    only difference is the order of the LR sums (K terms of x·V, R terms of
    xv·Uᵀ): twice the recursive-summation bound (K+R+1)·2⁻²⁴ of the sum of
    absolute terms, plus the output's own rounding."""
    mag = np.abs(y).astype(np.float64)
    if r:
        mag = mag + (np.abs(x) @ np.abs(v)) @ np.abs(u).T
    return 2.0 * (k + r + 1) * 2.0 ** -24 * mag + 1e-30


def t(a, dtype=None):
    """numpy → CPU tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)
