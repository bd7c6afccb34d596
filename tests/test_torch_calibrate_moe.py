"""The port's moe calibration walker (``quant/calibrate.py::_quantize_moe``:
MLA projections, the dense FFN, the shared experts and each routed expert
on the tokens the router sends it) against the reference's, on the
reduced DeepSeek-V2 (2 layers, 8 experts top-2, f32), 8 calibration
sequences of 32 tokens.

* **Along the reference's walk** (GPTQ + LRC, the serving CLI's policy):
  the reference runs once with every site's activations, statistics and
  solve recorded; the port's ``collect_stats`` and ``solve_site`` on those
  activations give codes bitwise, weight scales within one f32 ulp and U Vᵀ
  within the bf16 rounding of the stored factors plus 1e-9 of its largest
  element (as ``test_torch_calibrate_lrc`` holds the dense walker).  Every
  routed expert's three sites are among them, in walk order.
* **The port's own walk** against the reference's: its structure (experts
  stacked on the expert axis, unnamed sites, the router and norms float),
  the codes of the sites solved from the first statistics (``wq_a``,
  ``wkv_a``) bitwise, and the two models' logits correlated at least
  0.9 (ROADMAP Queue 3's standard for walks in two frameworks: the walk
  amplifies rounding; measured 0.944 on the card's walk against the CPU's).
  With RTN + SVD no statistics steer the codes: every site's codes are
  bitwise the reference's, in both layers, and the weights-only path
  (``calib_tokens=None``) gives the walk's QLinears bitwise.
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
from repro_torch import bridge
from repro_torch.data.loader import calib_sequences
from repro_torch.models import model
from repro_torch.quant import calibrate
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qlinear import QLinear
from torch_moe_parity import ds_configs, ds_params
from torch_parity import t, to_numpy_tree, x64_restored

U64 = 2.0 ** -53
REL = 1e-9
LRC = dict(rank_frac=0.10, impl="sim", clip_ratio=0.9)
SVD = dict(LRC, quant_method="rtn", correction="svd")
ATTN = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")


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
    jcfg, tcfg = ds_configs("deepseek-v2-236b")
    with x64_restored():  # jax's random weights depend on the flag
        jax.config.update("jax_enable_x64", False)
        jparams = ds_params(jcfg)
    tokens = calib_sequences(tcfg, n_seq=8, seq_len=32, device="cpu")
    params = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    ref = {k: _record_reference(jcfg, jparams, jnp.asarray(tokens.numpy()), pol)
           for k, pol in (("lrc", LRC), ("svd", SVD))}
    ported = {k: calibrate.quantize_model(tcfg, params, tokens, QuantPolicy(**pol))
              for k, pol in (("lrc", LRC), ("svd", SVD))}
    return jcfg, tcfg, jparams, params, tokens, ref, ported


def _stats_bound(x, spec_clip, n):
    x = np.abs(x.reshape(-1, x.shape[-1]).astype(np.float64))
    a = x + (8 / 7) * spec_clip * x.max(axis=1, keepdims=True)
    return 2 * n * U64 * (a.T @ a)


def _same_qlinear(tq: QLinear, jq, scales_rel=2.0 ** -23, uv_rel=REL):
    assert np.array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
    js = np.asarray(jq.w_scale)
    assert np.all(np.abs(tq.w_scale.numpy() - js) <= scales_rel * js)
    assert (tq.u is None) == (jq.u is None)
    if tq.u is not None:
        uj, vj = (np.asarray(a, np.float32).astype(np.float64) for a in (jq.u, jq.v))
        want = uj @ vj.T
        tol = 2.0 ** -7 * (np.abs(uj) @ np.abs(vj).T) + REL * np.abs(want).max()
        tol = tol + uv_rel * np.abs(want).max()
        got = tq.u.double().numpy() @ tq.v.double().numpy().T
        assert np.all(np.abs(got - want) <= tol)


def _n_sites(cfg):
    """Sites of the walk, in order: 5 MLA + 3 FFN in the dense layers; 5 MLA
    + 3 shared + 3 per routed expert in the MoE layers."""
    nd = cfg.n_dense_layers
    shared = 3 if cfg.n_shared_experts else 0
    return nd * 8 + (cfg.n_layers - nd) * (5 + shared + 3 * cfg.n_experts)


def test_sites_on_the_reference_walk(setup):
    _, tcfg, _, _, _, ref, _ = setup
    pol = QuantPolicy(**LRC)
    spec_a = calibrate._act_spec(pol)
    _, sites = ref["lrc"]
    assert len(sites) == _n_sites(tcfg)
    for site in sites:
        assert site["name"] is None  # the reference's moe walker names no site
        st = calibrate.collect_stats(t(site["acts"]), spec_a)
        n = site["acts"].size // site["acts"].shape[-1]
        assert st.count.item() == n == float(site["stats"].count)
        bound = _stats_bound(site["acts"], pol.clip_ratio, n)
        for f in ("sxx", "syy", "sxy"):
            want = np.asarray(getattr(site["stats"], f))
            damp = np.eye(bound.shape[0]) * (1e-2 * np.trace(bound)
                                             + 4 * U64 * np.abs(want).max())
            assert np.all(np.abs(getattr(st, f).numpy() - want) <= bound + damp), f
        got = calibrate.solve_site(t(site["w"]), st, pol)
        assert got.name is None and got.impl == "sim"
        _same_qlinear(got, site["qlinear"])
        if site["lrc"] is not None:
            from repro_torch.core import lrc as tl

            res = tl.lrc_solve(t(site["w"]).double().T, st, tl.QuantSpec(bits=4),
                               k=pol.rank(*site["w"].shape), iters=pol.lrc_iters,
                               quant_method=pol.quant_method)
            for a, b in zip(res.losses + [res.oracle_loss],
                            site["lrc"].losses + [site["lrc"].oracle_loss]):
                assert abs(a - b) <= REL * abs(b)


def _logits(cfg, params, jax_side=False):
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))
    if jax_side:
        return np.asarray(jax_model.forward(cfg, params, {"tokens": jnp.asarray(toks)}))
    return model.forward(cfg, params, {"tokens": torch.from_numpy(toks)}).numpy()


def _jax_site(tree, group, li, path):
    node = jax.tree.map(lambda a: a[li], tree[group])
    for k in path:
        node = node[k]
    return node


@pytest.mark.parametrize("policy", ["lrc", "svd"])
def test_quantize_moe_end_to_end(setup, policy):
    jcfg, tcfg, _, params, _, ref, ported = setup
    jq, _ = ref[policy]
    tq = ported[policy]
    assert [len(tq[g]) for g in ("dense_layers", "moe_layers")] == [1, 1]
    lp = tq["moe_layers"][0]
    experts = lp["moe"]["experts"]
    for name in ("wg", "wu", "wd"):
        q = experts[name]
        assert isinstance(q, QLinear) and q.qweight.shape[0] == tcfg.n_experts
        assert q.name is None and q.impl == "sim"
    assert torch.equal(lp["moe"]["router"], params["moe_layers"][0]["moe"]["router"])
    assert torch.equal(tq["embed"], params["embed"])  # moe trees are not rotated
    # the sites solved from the walk's first statistics (layer 0's input);
    # with RTN + SVD every site of layer 0
    first = ([("attn", "wq_a"), ("attn", "wkv_a")] if policy == "lrc" else
             [("attn", n) for n in ATTN] + [("mlp", n) for n in ("wg", "wu", "wd")])
    for path in first:
        want = _jax_site(jq, "dense_layers", 0, path)
        got = tq["dense_layers"][0][path[0]][path[1]]
        _same_qlinear(got, want, scales_rel=1e-5, uv_rel=1e-4)
    if policy == "svd":  # no statistics steer RTN: every site bitwise
        for path in ([("attn", n) for n in ATTN]
                     + [("moe", b, n) for b in ("shared", "experts")
                        for n in ("wg", "wu", "wd")]):
            want = _jax_site(jq, "moe_layers", 0, path)
            got = lp
            for k in path:
                got = got[k]
            assert np.array_equal(got.qweight.numpy(), np.asarray(want.qweight)), path
    a, b = _logits(tcfg, tq), _logits(jcfg, jq, jax_side=True)
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.9


def _leaves(node, path=""):
    if isinstance(node, QLinear):
        for f in dataclasses.fields(node):
            yield from _leaves(getattr(node, f.name), f"{path}/{f.name}")
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, node


def _bitwise(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        if isinstance(la[k], torch.Tensor):
            assert torch.equal(la[k], lb[k]), k
        else:
            assert la[k] == lb[k], k


def test_weights_only_path_is_the_walk(setup):
    """RTN + SVD reads no statistics: the weights-only path (the card's
    ``--quantize``) gives the walk's QLinears bitwise, on exactly the
    reference's sites (``should_quantize``)."""
    _, tcfg, _, params, _, _, ported = setup
    wo = calibrate.quantize_model(tcfg, params, None, QuantPolicy(**SVD))
    _bitwise(wo, ported["svd"])
    assert "mtp" not in wo
    v3 = ds_configs("deepseek-v3-671b")[1]
    p3 = model.init_params(v3, seed=0, device="cpu")
    q3 = calibrate.quantize_model(v3, p3, None, QuantPolicy(**SVD))
    assert torch.equal(q3["mtp"]["proj"], p3["mtp"]["proj"])  # the walk leaves it
    assert isinstance(q3["moe_layers"][0]["moe"]["experts"]["wd"], QLinear)
    assert torch.is_tensor(q3["moe_layers"][0]["moe"]["router"])


def test_resume_is_bitwise(setup, tmp_path):
    _, tcfg, _, params, tokens, _, ported = setup
    pol = QuantPolicy(**SVD)
    calls = []
    first = calibrate.quantize_model(tcfg, params, tokens, pol, resume_dir=str(tmp_path),
                                     progress=lambda d, n: calls.append((d, n)))
    assert calls == [(1, 2), (2, 2)]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dense_layers_000.pt",
                                                          "moe_layers_000.pt"]
    (tmp_path / "moe_layers_000.pt").unlink()
    again = calibrate.quantize_model(tcfg, params, tokens, pol, resume_dir=str(tmp_path))
    _bitwise(first, again)
    _bitwise(first, ported["svd"])


def test_walk_on_the_kernel_route(setup):
    """The walk's MLA attention through #7 (its plain version here): one
    launch a layer, the codes of layer 0 bitwise the gather route's."""
    from repro_torch.kernels import flash_attn
    from repro_torch.kernels.context import KernelContext

    _, tcfg, _, params, tokens, _, ported = setup
    flash_attn.reset_launches()
    q = calibrate.quantize_model(tcfg, params, tokens, QuantPolicy(**SVD),
                                 ctx=KernelContext(attention="kernel"))
    assert flash_attn.LAUNCHES["flash_attention_plain"] == tcfg.n_layers
    for name in ATTN:
        assert torch.equal(q["dense_layers"][0]["attn"][name].qweight,
                           ported["svd"]["dense_layers"][0]["attn"][name].qweight)
