"""The port's RTN + SVD ``quantize_model`` against the reference's
``quantize_model(..., QuantPolicy(quant_method="rtn", correction="svd"),
rotate=False)`` on a reduced SmolLM.

Tolerances: codes and weight scales are bitwise (both cast the weight to
f32 before RTN).  The SVD correction is compared as the product u·vᵀ — the
singular vectors are defined only up to sign — and each factor was rounded
to bf16 from the same f64 factorization, so the products may differ by two
bf16 roundings of the factors: 2⁻⁷ of |u|·|v|ᵀ elementwise."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.quant.policy import QuantPolicy as JaxQuantPolicy
from repro_torch import bridge
from repro_torch.core.quantizers import QuantSpec
from repro_torch.quant.calibrate import collect_stats, quantize_model, solve_site
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qlinear import QLinear
from torch_parity import (RTN_SVD, configs, jax_params, jax_quantized, t,
                          to_numpy_tree)

SITES = [("attn", n) for n in ("wq", "wk", "wv", "wo")] + \
        [("mlp", n) for n in ("wg", "wu", "wd")]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    jq = jax_quantized(jcfg, jparams)
    params = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    tq = quantize_model(tcfg, params, None, QuantPolicy(**RTN_SVD), rotate=False)
    return tcfg, jq, tq


def test_rank_matches_reference_policy():
    for d_in, d_out in [(576, 576), (576, 192), (576, 1536), (1536, 576), (4, 4)]:
        assert (QuantPolicy(**RTN_SVD).rank(d_in, d_out)
                == JaxQuantPolicy(**RTN_SVD).rank(d_in, d_out))
    assert QuantPolicy(**RTN_SVD).rank(576, 576) == 58
    assert QuantPolicy(**RTN_SVD).rank(576, 192) == 19


@pytest.mark.parametrize("block,name", SITES)
def test_codes_and_scales_bitwise(models, block, name):
    tcfg, jq, tq = models
    for li in range(tcfg.n_layers):
        jl = jq["layers"][block][name]
        tl = tq["layers"][li][block][name]
        assert isinstance(tl, QLinear) and tl.name == f"{block}/{name}"
        assert np.array_equal(tl.qweight.numpy(), np.asarray(jl.qweight)[li])
        assert np.array_equal(tl.w_scale.numpy(), np.asarray(jl.w_scale)[li])
        assert (tl.clip_ratio, tl.act_bits, tl.impl) == (jl.clip_ratio, jl.act_bits, jl.impl)


@pytest.mark.parametrize("block,name", SITES)
def test_svd_correction_product(models, block, name):
    tcfg, jq, tq = models
    for li in range(tcfg.n_layers):
        jl = jq["layers"][block][name]
        tl = tq["layers"][li][block][name]
        ju = np.asarray(jl.u, np.float32)[li]
        jv = np.asarray(jl.v, np.float32)[li]
        tu, tv = tl.u.float().numpy(), tl.v.float().numpy()
        assert tl.u.dtype == torch.bfloat16 and tu.shape == ju.shape
        want = ju @ jv.T
        tol = 2.0 ** -7 * (np.abs(ju) @ np.abs(jv).T) + 1e-30
        assert np.all(np.abs(tu @ tv.T - want) <= tol)


def test_none_correction_and_unported_branches(rng):
    """Every branch of ``solve_site`` and ``quantize_model`` that the port
    has runs (LRC, GPTQ, the rotation, grouped activation scales); what is
    still unported raises: the non-dense walkers."""
    w = t(rng.standard_normal((32, 16)).astype(np.float32))
    q = solve_site(w, None, QuantPolicy(quant_method="rtn", correction="none"))
    assert q.u is None and q.v is None and q.d_in == 32 and q.d_out == 16
    x = t(rng.standard_normal((256, 32)))
    stats = collect_stats(x, QuantSpec(bits=4, clip_ratio=0.9))
    for policy in (QuantPolicy(quant_method="rtn", correction="lrc"),
                   QuantPolicy(quant_method="gptq", correction="svd"),
                   QuantPolicy(quant_method="gptq", correction="lrc", lrc_iters=2)):
        q = solve_site(w, stats, policy)
        assert q.u.shape == (16, policy.rank(32, 16)) and q.v.shape[0] == 32
    # grouped activation scales: the QLinear carries its layer's group
    grouped = QuantPolicy(act_group=8, act_group_overrides={"mlp/wd": None})
    assert solve_site(w, stats, grouped, name="attn/wq").act_group == 8
    assert solve_site(w, stats, grouped, name="mlp/wd").act_group is None
    jcfg, tcfg = configs()
    params = bridge.params_from_jax(to_numpy_tree(jax_params(jcfg)), device="cpu")
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 8)))
    rotated = quantize_model(tcfg, params, tokens, QuantPolicy(impl="sim"))
    assert "lm_head" in rotated and "lm_head" not in params
    assert torch.equal(rotated["final_norm"], torch.ones_like(params["final_norm"]))
    grouped = quantize_model(tcfg, params, tokens, QuantPolicy(impl="sim", act_group=8))
    assert {q.act_group for lp in grouped["layers"] for block in ("attn", "mlp")
            for q in lp[block].values()} == {8}
    for family in ("ssm", "moe"):
        with pytest.raises(NotImplementedError):
            quantize_model(dataclasses.replace(tcfg, family=family), params, tokens,
                           QuantPolicy())
    with pytest.raises(ValueError, match="calibration tokens"):
        quantize_model(tcfg, params, None, QuantPolicy())
