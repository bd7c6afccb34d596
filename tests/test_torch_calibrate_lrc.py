"""The port's LRC calibration (``repro_torch/quant/calibrate.py``: QuaRot
rotation, statistics walk, GPTQ, Algorithm 1) against the reference's
``quantize_model`` on the reduced SmolLM (2 layers, d_model 64, f32),
16 calibration sequences of 64 tokens, ``QuantPolicy(rank_frac=0.10,
impl="sim", clip_ratio=0.9)`` (the serving CLI's policy) and three other
policies.  The reference runs once per policy in a module fixture, with
every site's activations, statistics, solve and LRC losses recorded.

Two comparisons, because the walk amplifies rounding:

* **Along the reference's walk** (every site, every policy): the port's
  ``collect_stats`` on the reference's own activations, then its
  ``solve_site``.  Statistics within the f64 summation bound of their n
  tokens; codes bitwise; weight scales within one f32 ulp (the statistics
  differ by f64 ulps, which reach the f32 rounding of amax/qmax only at a
  boundary); U Vᵀ within the two bf16 roundings of the stored factors,
  2⁻⁷·|U||V|ᵀ, plus 1e-9 of its largest element; LRC losses and the
  oracle loss relative 1e-9.
* **The port's own walk** against the reference's.  The two frameworks'
  f32 rms_norm differ by an ulp (another summation order, and XLA's rsqrt
  is not correctly rounded), so the first statistics differ by ~1e-7
  relative.  Layer 0's first three sites are solved from those: their
  codes are held bitwise, their scales within 1e-5 relative and U Vᵀ
  within 1e-4 of its largest element beyond the bf16 rounding (measured
  7e-8 and 2e-6: LRC's eigenvectors move ~25× the statistics' change).
  Past them the walk amplifies rounding: a GPTQ code that flips at a
  rounding boundary, or (with a correction) a U or V element whose bf16
  rounding flips, changes the stream by a whole quantization step, and the
  walk's 4-bit activation quantizer carries that into code changes
  downstream.  Over three weight seeds and both states of jax's x64 flag
  (which change the reference's random weights), layer 0's first three
  sites were bitwise in all 18 calibrations while later sites differed in
  up to 65 % of their codes with LRC, 12 % with SVD and 2.4 % with none; the
  whole models' logits on held-out tokens are held to correlation >= 0.9
  (measured at least 0.944 with LRC, 0.975 with SVD, 0.998 with none)
  against 0.7 relative distance between the float and the quantized model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro.quant import calibrate as jc
from repro.quant.policy import QuantPolicy as JaxQuantPolicy
from repro.quant.qlinear import retag_qlinear_impl as jax_retag
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.core import lrc as tl
from repro_torch.data.loader import calib_sequences
from repro_torch.kernels import flash_attn
from repro_torch.kernels.context import KernelContext
from repro_torch.models import model
from repro_torch.quant import calibrate
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qlinear import QLinear
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import configs, flash_bound, jax_params, t, to_numpy_tree, x64_restored

U64 = 2.0 ** -53
REL = 1e-9
BASE = dict(rank_frac=0.10, impl="sim", clip_ratio=0.9)
POLICIES = {"gptq+lrc": {}, "rtn+lrc": {"quant_method": "rtn"},
            "gptq+svd": {"correction": "svd"}, "gptq+none": {"correction": "none"}}
SITES = [("attn", n) for n in ("wq", "wk", "wv", "wo")] + \
        [("mlp", n) for n in ("wg", "wu", "wd")]


def _record_reference(jcfg, jparams, tokens, policy):
    """The reference's quantize_model, recording per site (in walk order)
    the weight, the activations its statistics came from, the statistics,
    the QLinear and (for LRC) the LRCResult."""
    acts, sites, results = {}, [], []
    collect, solve, lrc = jc.collect_stats, jc.solve_site, jc.lrc_solve

    def rec_collect(a, spec, pre_rot=False):
        st = collect(a, spec, pre_rot)
        acts[id(st)] = (np.asarray(a), st)
        return st

    def rec_solve(w, st, pol, pre_rot=False, name=None):
        n = len(results)
        q = solve(w, st, pol, pre_rot, name)
        sites.append(dict(name=name, w=np.asarray(w), acts=acts[id(st)][0], stats=st,
                          qlinear=q, lrc=results[n] if len(results) > n else None))
        return q

    def rec_lrc(*a, **kw):
        r = lrc(*a, **kw)
        results.append(r)
        return r

    jc.collect_stats, jc.solve_site, jc.lrc_solve = rec_collect, rec_solve, rec_lrc
    try:
        with x64_restored():
            out = jc.quantize_model(jcfg, jparams, tokens, JaxQuantPolicy(**policy))
    finally:
        jc.collect_stats, jc.solve_site, jc.lrc_solve = collect, solve, lrc
    return out, sites


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    with x64_restored():  # jax's random weights depend on the flag
        jax.config.update("jax_enable_x64", False)
        jparams = jax_params(jcfg)
    tokens = calib_sequences(tcfg, n_seq=16, seq_len=64, device="cpu")
    params = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    ref = {k: _record_reference(jcfg, jparams, jnp.asarray(tokens.numpy()),
                                dict(BASE, **v)) for k, v in POLICIES.items()}
    ported = {k: calibrate.quantize_model(tcfg, params, tokens,
                                          QuantPolicy(**BASE, **v))
              for k, v in POLICIES.items()}
    return jcfg, tcfg, jparams, params, tokens, ref, ported


def _stats_bound(x, spec_clip, n):
    """Elementwise bound on two f64 evaluations of Σx, Σy and Σxy over n
    rows: every |y| <= (qmax+1)/qmax·clip·amax of its row, so a = |x| +
    that bounds both factors, and an n-term sum in any order is within
    2·n·u64·aᵀa."""
    x = np.abs(x.reshape(-1, x.shape[-1]).astype(np.float64))
    a = x + (8 / 7) * spec_clip * x.max(axis=1, keepdims=True)
    return 2 * n * U64 * (a.T @ a)


def _uv_bound(uj, vj):
    uj, vj = (np.asarray(a, np.float32).astype(np.float64) for a in (uj, vj))
    prod = uj @ vj.T
    return prod, 2.0 ** -7 * (np.abs(uj) @ np.abs(vj).T) + REL * np.abs(prod).max()


def _same_qlinear(tq: QLinear, jq, scales_rel=2.0 ** -23, uv_rel=REL):
    """Codes bitwise, scales within ``scales_rel`` (one f32 ulp by
    default), U Vᵀ within the bf16 rounding of the factors plus ``uv_rel``
    of its largest element."""
    assert np.array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
    js = np.asarray(jq.w_scale)
    assert np.all(np.abs(tq.w_scale.numpy() - js) <= scales_rel * js)
    assert (tq.u is None) == (jq.u is None)
    if tq.u is not None:
        want, tol = _uv_bound(jq.u, jq.v)
        tol = tol + uv_rel * np.abs(want).max()
        got = tq.u.double().numpy() @ tq.v.double().numpy().T
        assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_sites_on_the_reference_walk(setup, policy):
    _, tcfg, _, _, _, ref, _ = setup
    pol = QuantPolicy(**BASE, **POLICIES[policy])
    spec_a = calibrate._act_spec(pol)
    _, sites = ref[policy]
    assert [s["name"] for s in sites] == [f"{b}/{n}" for b, n in SITES] * tcfg.n_layers
    for site in sites:
        st = calibrate.collect_stats(t(site["acts"]), spec_a)
        n = site["acts"].size // site["acts"].shape[-1]
        assert st.count.item() == n == float(site["stats"].count)
        bound = _stats_bound(site["acts"], pol.clip_ratio, n)
        for f in ("sxx", "syy", "sxy"):
            want = np.asarray(getattr(site["stats"], f))
            damp = np.eye(bound.shape[0]) * (1e-2 * np.trace(bound)
                                             + 4 * U64 * np.abs(want).max())
            assert np.all(np.abs(getattr(st, f).numpy() - want) <= bound + damp), \
                (site["name"], f)
        got = calibrate.solve_site(t(site["w"]), st, pol, name=site["name"])
        assert got.name == site["name"] and got.impl == "sim"
        _same_qlinear(got, site["qlinear"])
        if site["lrc"] is not None:
            w_paper = t(site["w"]).double().T
            k = pol.rank(*site["w"].shape)
            res = tl.lrc_solve(w_paper, st, tl.QuantSpec(bits=4), k=k,
                               iters=pol.lrc_iters, quant_method=pol.quant_method)
            for a, b in zip(res.losses + [res.oracle_loss],
                            site["lrc"].losses + [site["lrc"].oracle_loss]):
                assert abs(a - b) <= REL * abs(b), site["name"]


def _logits(cfg, params, jax_side=False):
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))
    if jax_side:
        return np.asarray(jax_model.forward(cfg, params, {"tokens": jnp.asarray(toks)}))
    return model.forward(cfg, params, {"tokens": torch.from_numpy(toks)}).numpy()


FIRST_SITES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"))


def _logits_correlate(a, b):
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    return np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.9


@pytest.mark.parametrize("policy", list(POLICIES))
def test_quantize_model_end_to_end(setup, policy):
    jcfg, tcfg, jparams, _, _, ref, ported = setup
    jq, _ = ref[policy]
    tq = ported[policy]
    # the rotated float leaves: f32 products over d_model terms
    for k in ("embed", "lm_head", "final_norm"):
        np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]), rtol=1e-5, atol=1e-7)
    for li in range(tcfg.n_layers):
        for k in ("attn_norm", "mlp_norm"):
            assert np.array_equal(tq["layers"][li][k].numpy(), np.asarray(jq["layers"][k])[li])
        for block, name in SITES:
            site = tq["layers"][li][block][name]
            assert isinstance(site, QLinear) and site.name == f"{block}/{name}"
            assert site.impl == "sim" and site.clip_ratio == 0.9
    for block, name in FIRST_SITES:
        jl = jax.tree.map(lambda a: a[0], jq["layers"][block][name])
        _same_qlinear(tq["layers"][0][block][name], jl, scales_rel=1e-5, uv_rel=1e-4)
    assert _logits_correlate(_logits(tcfg, tq), _logits(jcfg, jq, jax_side=True))


def _tensors(node, path=""):
    if isinstance(node, QLinear):
        for f in dataclasses.fields(node):
            yield from _tensors(getattr(node, f.name), f"{path}/{f.name}")
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _tensors(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _tensors(v, f"{path}/{i}")
    else:
        yield path, node


def test_resume_is_bitwise(setup, tmp_path):
    _, tcfg, _, params, tokens, _, ported = setup
    pol = QuantPolicy(**BASE)

    def stop_after_first(layer, n_layers):
        if layer == 0:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        calibrate.quantize_model(tcfg, params, tokens, pol, progress=stop_after_first,
                                 resume_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["layer_000.pt"]
    seen = []
    resumed = calibrate.quantize_model(tcfg, params, tokens, pol, resume_dir=tmp_path,
                                       progress=lambda l, n: seen.append(l))
    assert seen == [0, 1] and len(list(tmp_path.iterdir())) == 2
    got, want = dict(_tensors(resumed)), dict(_tensors(ported["gptq+lrc"]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g == w, k


@pytest.mark.parametrize("impl", ["sim", "int8"])
def test_reference_calibration_serves_through_the_bridge(setup, impl):
    """The JAX-calibrated tree (rotated, so its head is untied although the
    config ties it) bridged into the port serves the JAX engine's greedy
    tokens; ``impl`` retags both trees alike."""
    jcfg, tcfg, _, _, _, ref, _ = setup
    jq = jax_retag(ref["gptq+lrc"][0], impl)
    kw = dict(batch_slots=2, max_seq=32, page_size=4, prefill_chunk=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (7, 3, 10, 5)]
    jeng = JaxServeEngine(jcfg, jq, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
    want = {rid: rec.out_tokens for rid, rec in jeng.run().items()}
    params = bridge.params_from_jax(to_numpy_tree(jq), device="cpu")
    assert tcfg.tie_embeddings and "lm_head" in params
    eng = ServeEngine(tcfg, params, device="cpu", **kw)
    assert "lm_head" in eng.params
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    assert {rid: rec.out_tokens for rid, rec in eng.run().items()} == want
    assert eng.params["layers"][1]["mlp"]["wd"].impl == impl


@pytest.mark.parametrize("policy", ["gptq+lrc", "gptq+svd"])
def test_walk_on_the_kernel_route(setup, policy):
    """The walk with ``KernelContext(attention="kernel")``: one launch of
    the flash-attention plain version per layer.  Layer 0's attention sees
    the same q, k, v on both routes (its projections are solved from the
    same statistics, so they are bitwise equal), and its output is held to
    the flash bound against the reference's ``attention``
    (``torch_parity.flash_bound``).  Past it the walk amplifies the f32
    difference as it does the two frameworks' (module docstring): the
    models' logits are held to correlation >= 0.9."""
    _, tcfg, _, params, tokens, _, ported = setup
    pol = QuantPolicy(**BASE, **POLICIES[policy])
    seen = []
    orig = calibrate.causal_attention

    def capture(q, k, v, scale, route, mask=None):
        out = orig(q, k, v, scale, route, mask)
        seen.append((q, k, v, scale, route, out))
        return out

    calibrate.causal_attention = capture
    flash_attn.reset_launches()
    try:
        got = calibrate.quantize_model(tcfg, params, tokens, pol,
                                       ctx=KernelContext(attention="kernel"))
    finally:
        calibrate.causal_attention = orig
    assert flash_attn.LAUNCHES["flash_attention_plain"] == tcfg.n_layers
    assert flash_attn.LAUNCHES["flash_attention"] == 0
    assert [s[4] for s in seen] == ["kernel"] * tcfg.n_layers
    q, k, v, scale, _, out = seen[0]
    ref_out = orig(q, k, v, scale, "gather")
    tol, _, _ = flash_bound(q.numpy(), k.numpy(), v.numpy(), scale, ref_out.numpy(),
                            extra_dot=1)
    assert np.all(np.abs(out.numpy() - ref_out.numpy()) <= tol)
    want = ported[policy]
    for block, name in FIRST_SITES:
        a, b = got["layers"][0][block][name], want["layers"][0][block][name]
        for f in ("qweight", "w_scale", "u", "v"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
    assert _logits_correlate(_logits(tcfg, got), _logits(tcfg, want))
