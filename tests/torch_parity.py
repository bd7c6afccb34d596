"""Shared helpers of the ``test_torch_*`` parity tests: the reference's
objects as the numpy trees the bridge takes, and the reduced SmolLM both
packages are compared on."""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.core.quantizers import pack_int4
from repro_torch.models.config import reduced

ROOT = Path(__file__).resolve().parents[1]
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


def gemm_tolerance(xv, u, r, y):
    """Elementwise bound on two f32 evaluations of the W4A4 GEMM output from
    the same xq, sx and xv: the integer part and its rescale are exact, only
    the R-term LR sum is ordered differently."""
    mag = np.abs(y).astype(np.float64)
    if r:
        mag = mag + np.abs(xv) @ np.abs(u).T
    return 2.0 * (r + 1) * 2.0 ** -24 * mag + 1e-30


def xv_tolerance(x, v, k, xv):
    """Elementwise bound on two f32 evaluations of x·V that differ only in
    the order of the K-term sum."""
    mag = np.abs(x) @ np.abs(v) + np.abs(xv)
    return 2.0 * (k + 1) * 2.0 ** -24 * mag + 1e-30


def group_terms(xq, sx, w, group):
    """Σ_g |p_g·s_g| per output (M, N) in f64: p_g the exact int partial of
    group g of codes xq (M, K) and w (K, N), s_g its (M, K/g) scale."""
    m, k = xq.shape
    g = k // group
    p = np.einsum("mgk,gkn->mgn", xq.reshape(m, g, group).astype(np.float64),
                  w.reshape(g, group, -1).astype(np.float64))
    return np.einsum("mgn,mg->mn", np.abs(p), sx.astype(np.float64))


def group_tolerance(xq, sx, w, sw, group, scale_ulps=0):
    """Elementwise bound on two f32 evaluations of the group-rescaled GEMM
    ``(Σ_g fl(p_g·s_g))·sw`` that add the G = K/g terms in different
    orders: each is within (G + 1)·2⁻²⁴·Σ_g|p_g·s_g|·|sw| of the exact
    value (G multiplies and G - 1 adds, then sw), so the two within twice
    that; ``scale_ulps`` more ulps for scales that differ by that many
    (the reference's jitted ones)."""
    g = xq.shape[1] // group
    mag = group_terms(xq, sx, w, group) * np.abs(sw.reshape(1, -1)).astype(np.float64)
    return (2.0 * (g + 1) + 2.0 * scale_ulps) * 2.0 ** -24 * mag + 1e-30


def scales_match_jitted(sx, s_jit):
    """The port's scales are bitwise the reference's eager ones
    (``ref.act_quant_ref``, ``rowops.scale_round_quantize``).  Under ``jit``
    XLA folds ``clip·amax/qmax`` into ``amax·c`` with the constant
    ``c = clip/qmax`` rounded once: each side's result is within one ulp
    of the exact value (two roundings of half an ulp each, one of them
    relative to a rounded constant), so the Pallas kernels' scales may
    differ from the port's by up to two ulps."""
    return bool(np.all(np.abs(sx - s_jit) <= 2 * np.spacing(np.abs(s_jit))))


def bf16(a):
    """A numpy array rounded to bf16 (returned as ml_dtypes bfloat16)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def port(a):
    """numpy (bf16 included, through its bit pattern) → CPU tensor."""
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return t(a)


def w4a4_problem(seed, m, k, n, r):
    """Random x (M, K) f32, packed int4 W (K/2, N), sw (N,) and bf16 factors
    u (N, R), v (K, R) (None at R = 0), as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    q = rng.integers(-8, 8, (k, n)).astype(np.int8)
    wp = pack_int4(t(q).T).T.contiguous().numpy()
    sw = (rng.random(n) * 0.02 + 0.001).astype(np.float32)
    u = v = None
    if r:
        u = bf16(rng.standard_normal((n, r)) * 0.05)
        v = bf16(rng.standard_normal((k, r)) * 0.05)
    return x, wp, sw, u, v


_PALLAS_PRELUDE = """
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams  # jax 0.9 renamed it
d = dict(np.load(sys.argv[1]))
out = {}
"""


def run_pallas(tmp_path, script: str, **arrays) -> dict:
    """Runs ``script`` against the reference's Pallas kernels in interpret
    mode, in a subprocess: the jax installed here names the compiler params
    ``CompilerParams``, and the alias that lets the kernels run must never
    reach another test's process.  The script reads its inputs from ``d``
    (the ``arrays``, bf16 ones passed as exact f32) and fills ``out``."""
    np.savez(tmp_path / "in.npz", **{k: np.asarray(a, np.float32)
                                     if a.dtype.name == "bfloat16" else a
                                     for k, a in arrays.items()})
    code = _PALLAS_PRELUDE + script + "\nnp.savez(sys.argv[2], **out)\n"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           str(ROOT)]))
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, env=env, timeout=600)
    return dict(np.load(tmp_path / "out.npz"))


def flash_bound(q, k, v, scale, y, extra_dot=0, q_start=0):
    """Elementwise bound on two f32 evaluations of dense causal attention
    that take the Pallas steps and differ only in the order of three sums
    (the D-term score dot, Σp and p·V), q (B, Sq, H, D), k/v (B, Skv, KH,
    ·): 2·v_max·(2·(D + extra_dot)·u·S + 2·(N + 2·tiles + 4)·u), with u =
    2⁻²⁴, S = Σ_d |q_d·scale|·max_keys |k_d| per query row, N = qpos + 1
    keys (query row i at qpos = q_start + i), tiles = ⌈N/128⌉ and v_max =
    max |v| of the kv head; a bf16 ``y`` adds one bf16 ulp of the larger
    side (2⁻⁶|y|).  ``extra_dot`` counts extra roundings per score.
    Returns (tol, S, v_max), broadcastable to y."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    kmax = np.repeat(np.abs(k).max(axis=1), g, axis=1)  # (B, H, D)
    s_max = np.einsum("bshd,bhd->bsh", np.abs(q * scale), kmax)
    vmax = np.repeat(np.abs(v).max(axis=(1, 3)), g, axis=1)[:, None]  # (B, 1, H)
    n = q_start + np.arange(1, s + 1, dtype=np.float64)[None, :, None]
    rel = (2 * (d + extra_dot) * 2.0 ** -24 * s_max
           + 2 * (n + 2 * np.ceil(n / 128) + 4) * 2.0 ** -24)
    tol = (2 * vmax * rel)[..., None]
    if y.dtype.name == "bfloat16":
        tol = tol + 2.0 ** -6 * np.abs(np.asarray(y, np.float64))
    return tol, s_max[..., None], vmax[..., None]
