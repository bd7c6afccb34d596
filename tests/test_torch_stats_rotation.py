"""The port's calibration inputs and rotation against the reference:
``data`` (tokens), ``core/hadamard.py``, ``core/rotation.py``,
``core/stats.py`` and ``quant/rotate.py``, on the same numpy inputs.

Tolerances (u32 = 2⁻²⁴, u64 = 2⁻⁵³):

* tokens, the numpy rotation matrices, ``fwht`` and Q_a's codes and scales
  on f64 rows: bitwise (the same numpy code; the same butterfly of f32
  adds; true division and round-half-to-even on both sides).
* ``apply_rotation``: the odd factor's m-term f32 sum in another order,
  2·m·u32·Σ|x̂|·|Q| elementwise (x̂ the WHT'd rows).
* Σx, Σy, Σxy: the n-term f64 sums in another order, 2·n·u64·Σ|a||b|
  elementwise; the count exactly; the damping adds (ε/d)·Tr, within the
  same bound scaled by d.
* ``rotate_dense``: each rotated weight is an f32 product over d terms
  (2·d·u32·|R|ᵀ|W| elementwise) rounded to the weight's dtype, so in bf16
  an element may sit one bf16 ulp apart (2⁻⁷ relative) where the two f32
  values straddle a rounding boundary.  The rotated model's logits equal
  the unrotated model's as the reference's own test holds them (rtol 1e-3,
  atol 2e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hadamard as jh
from repro.core import stats as js
from repro.core.quantizers import QuantSpec as JaxQuantSpec
from repro.core.quantizers import quantize_act as jax_quantize_act
from repro.core import rotation as jrot
from repro.core.rotation import incoherence as jax_incoherence
from repro.data.loader import calib_sequences as jax_calib_sequences
from repro.models import model as jax_model
from repro.quant.rotate import rotate_model as jax_rotate_model
from repro_torch import bridge
from repro_torch.core import hadamard as th
from repro_torch.core import rotation
from repro_torch.core import stats as ts
from repro_torch.core.quantizers import QuantSpec, quantize_act
from repro_torch.data.loader import calib_sequences
from repro_torch.models import model
from repro_torch.quant.rotate import rotate_model
from torch_parity import configs, jax_params, t, to_numpy_tree, x64_restored

U32, U64 = 2.0 ** -24, 2.0 ** -53


@pytest.mark.parametrize("n_seq,seq_len,seed", [(16, 64, 1), (3, 200, 2), (2, 2048, 1)])
def test_calib_tokens_bitwise(n_seq, seq_len, seed):
    jcfg, tcfg = configs()
    want = np.asarray(jax_calib_sequences(jcfg, n_seq=n_seq, seq_len=seq_len, seed=seed))
    got = calib_sequences(tcfg, n_seq=n_seq, seq_len=seq_len, seed=seed, device="cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_calib_tokens_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="cuda"):
        calib_sequences(tcfg, n_seq=1, seq_len=4)


@pytest.mark.parametrize("n", [2, 12, 20, 24, 64, 96, 576, 1536, 3072])
def test_hadamard_matrix_bitwise(n):
    got = th.hadamard_matrix(n)
    assert np.array_equal(got, jh.hadamard_matrix(n))
    np.testing.assert_allclose(got @ got.T, np.eye(n), atol=1e-9)


def test_random_orthogonal_and_incoherence():
    assert np.array_equal(th.random_orthogonal(36, seed=3), jh.random_orthogonal(36, seed=3))
    w = np.random.default_rng(0).standard_normal((32, 48)).astype(np.float32)
    assert rotation.incoherence(t(w)) == jax_incoherence(w)
    r = rotation.residual_rotation(48)
    assert torch.equal(r, t(jh.hadamard_matrix(48).astype(np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotation_math_matches_reference(rng, dtype):
    """``core/rotation.py``'s four products, each an f32 sum over d = 48
    terms rounded to the weight's dtype (bound as in ``rotate_dense``)."""
    w = rng.standard_normal((20, 48)).astype(np.float32)
    gamma = (1 + 0.3 * rng.standard_normal(48)).astype(np.float32)
    jw, jg = jnp.asarray(w, dtype), jnp.asarray(gamma, dtype)
    tw = bridge.tensor_from_numpy(np.asarray(jw), "cpu")
    tg = bridge.tensor_from_numpy(np.asarray(jg), "cpu")
    r = rotation.residual_rotation(48)
    jr = jrot.residual_rotation(48)
    ar = np.abs(jh.hadamard_matrix(48))
    aw = np.abs(np.asarray(jw, np.float64))
    cases = [(rotation.rotate_in(tw, r), jrot.rotate_in(jw, jr), aw @ ar),
             (rotation.rotate_embedding(tw, r), jrot.rotate_embedding(jw, jr), aw @ ar),
             (rotation.rotate_out(tw.T.contiguous(), r), jrot.rotate_out(jw.T, jr),
              ar.T @ aw.T)]
    for got, want, mag in cases:
        assert got.dtype == tw.dtype
        assert _close_rounded(bridge.tensor_to_numpy(got, jnp.bfloat16.dtype),
                              np.asarray(want), 2 * 48 * U32 * mag)
    ones, folded = rotation.fold_rmsnorm_gamma(tg, [tw])
    jones, jfolded = jrot.fold_rmsnorm_gamma(jg, [jw])
    assert np.array_equal(bridge.tensor_to_numpy(ones, jnp.bfloat16.dtype), np.asarray(jones))
    assert np.array_equal(bridge.tensor_to_numpy(folded[0], jnp.bfloat16.dtype),
                          np.asarray(jfolded[0]))


@pytest.mark.parametrize("d", [2, 16, 256, 1024])
def test_fwht_bitwise(rng, d):
    x = rng.standard_normal((5, d)).astype(np.float32)
    assert np.array_equal(th.fwht(t(x)).numpy(), np.asarray(jh.fwht(jnp.asarray(x))))


@pytest.mark.parametrize("n", [12, 96, 576, 1536, 3072])
def test_apply_rotation_matches(rng, n):
    x = rng.standard_normal((6, n)).astype(np.float32)
    want = np.asarray(jh.apply_rotation(jnp.asarray(x), n))
    got = th.apply_rotation(t(x), n).numpy()
    m, p2 = th._split_pow2(n)
    xw = np.abs(np.asarray(jh.fwht(jnp.asarray(x.reshape(6, m, p2))))) if p2 > 1 \
        else np.abs(x.reshape(6, m, p2))
    qm = np.abs(th.odd_factor_matrix(m))
    tol = 2 * m * U32 * np.einsum("sab,ac->scb", xw, qm).reshape(6, n) + 1e-30
    assert np.all(np.abs(got - want) <= tol)


def _acts(rng, n, d):
    x = rng.standard_normal((n, d))
    x[:, :: max(1, d // 6)] *= 8.0  # a few outlier channels
    return x


@pytest.mark.parametrize("clip", [1.0, 0.9])
def test_act_quant_f64_bitwise(rng, clip):
    x = _acts(rng, 300, 40)
    x[3] = 0.0  # an all-zero row takes amax 1
    with x64_restored():
        jax.config.update("jax_enable_x64", True)
        jq, jsc = jax_quantize_act(jnp.asarray(x), JaxQuantSpec(bits=4, clip_ratio=clip))
        jq, jsc = np.asarray(jq), np.asarray(jsc)
    q, sc = quantize_act(t(x), QuantSpec(bits=4, clip_ratio=clip))
    assert np.array_equal(q.numpy(), jq) and np.array_equal(sc.numpy(), jsc)


def _stats_bound(a, b, n):
    return 2 * n * U64 * (np.abs(a).T @ np.abs(b)) + 1e-300


def test_stats_match_reference(rng):
    d, n = 48, 2048
    x = _acts(rng, n, d)
    spec = QuantSpec(bits=4, clip_ratio=0.9)
    with x64_restored():
        jax.config.update("jax_enable_x64", True)
        jspec = JaxQuantSpec(bits=4, clip_ratio=0.9)
        st = js.init_stats(d)
        st = js.accumulate_stats(st, jnp.asarray(x[:1000]), jspec)
        st = js.accumulate_stats(st, jnp.asarray(x[1000:]), jspec)
        raw = {f: np.asarray(getattr(st, f)) for f in ("sxx", "syy", "sxy", "count")}
        fin = js.finalize_stats(st)
        fin = {f: np.asarray(getattr(fin, f)) for f in ("sxx", "syy", "sxy", "count")}
        jy = np.asarray(jax_quantize_act(jnp.asarray(x), jspec)[0], np.float64) * \
            np.asarray(jax_quantize_act(jnp.asarray(x), jspec)[1], np.float64)
    tst = ts.init_stats(d)
    tst = ts.accumulate_stats(tst, t(x[:1000]), spec)
    tst = ts.accumulate_stats(tst, t(x[1000:]), spec)
    tfin = ts.finalize_stats(tst)
    assert tst.sxx.dtype == torch.float64 and tst.count.item() == n == raw["count"]
    bounds = {"sxx": _stats_bound(x, x, n), "syy": _stats_bound(jy, jy, n),
              "sxy": _stats_bound(x, jy, n)}
    for f, bound in bounds.items():
        assert np.all(np.abs(getattr(tst, f).numpy() - raw[f]) <= bound), f
        damp = np.eye(d) * (1e-2 * np.trace(bound) + 4 * U64 * np.abs(np.trace(raw[f])))
        assert np.all(np.abs(getattr(tfin, f).numpy() - fin[f]) <= bound + damp), f


def _close_rounded(got, want, bound):
    """Elementwise within the f32 product bound, or (in bf16) within one
    bf16 ulp where the two sides rounded from f32 values that straddle."""
    got64 = np.asarray(got, np.float64)
    want64 = np.asarray(want, np.float64)
    err = np.abs(got64 - want64)
    if want.dtype.name == "bfloat16":
        bound = bound + 2.0 ** -7 * np.maximum(np.abs(got64), np.abs(want64))
    return np.all(err <= bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate_dense_matches_reference(dtype):
    jcfg, tcfg = configs(dtype=dtype)
    jparams = jax_params(jcfg)
    # non-trivial norms, so the γ folds are exercised
    rng = np.random.default_rng(3)
    layers = dict(jparams["layers"])
    for k in ("attn_norm", "mlp_norm"):
        layers[k] = jnp.asarray(1 + 0.3 * rng.standard_normal(layers[k].shape),
                                layers[k].dtype)
    jparams = dict(jparams, layers=layers,
                   final_norm=jnp.asarray(1 + 0.3 * rng.standard_normal(
                       jparams["final_norm"].shape), jparams["final_norm"].dtype))
    want = bridge.params_from_jax(to_numpy_tree(jax_rotate_model(jcfg, jparams)),
                                  device="cpu")
    params = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    got = rotate_model(tcfg, params)
    assert "lm_head" not in params and "lm_head" in got  # untied
    r = np.abs(th.hadamard_matrix(tcfg.d_model))
    for li in range(tcfg.n_layers):
        for block, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wg", "wu", "wd"))):
            for n in names:
                g, w = got["layers"][li][block][n], want["layers"][li][block][n]
                src = np.abs(params["layers"][li][block][n].double().numpy())
                src = src * 1.5  # covers the folded |γ| (< 2 here) and its rounding
                b = (r.T @ src if n in ("wq", "wk", "wv", "wg", "wu") else src @ r)
                assert _close_rounded(bridge.tensor_to_numpy(g, jnp.bfloat16.dtype),
                                      bridge.tensor_to_numpy(w, jnp.bfloat16.dtype),
                                      2 * tcfg.d_model * U32 * 2 * b), (li, n)
        for k in ("attn_norm", "mlp_norm"):
            assert torch.equal(got["layers"][li][k], want["layers"][li][k])
    for k in ("embed", "lm_head", "final_norm"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        mag = 2 * np.abs(want[k].double().numpy()) + 1e-3
        assert _close_rounded(bridge.tensor_to_numpy(got[k], jnp.bfloat16.dtype),
                              bridge.tensor_to_numpy(want[k], jnp.bfloat16.dtype),
                              2 * tcfg.d_model * U32 * 4 * mag), k


def test_rotated_model_keeps_its_logits():
    jcfg, tcfg = configs()
    params = bridge.params_from_jax(to_numpy_tree(jax_params(jcfg)), device="cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, tcfg.vocab_size, (8, 32)))}
    base = model.forward(tcfg, params, batch)
    out = model.forward(tcfg, rotate_model(tcfg, params), batch)
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-3, atol=2e-3)
    want = np.asarray(jax_model.forward(jcfg, jax_rotate_model(jcfg, jax_params(jcfg)),
                                        {"tokens": jnp.asarray(batch["tokens"].numpy())}))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-4)


def test_rotate_model_families():
    import dataclasses

    _, tcfg = configs()
    params = {"embed": torch.zeros(2)}
    for family in ("moe", "hybrid", "encdec"):
        assert rotate_model(dataclasses.replace(tcfg, family=family), params) is params
    with pytest.raises(NotImplementedError):
        rotate_model(dataclasses.replace(tcfg, family="ssm"), params)
