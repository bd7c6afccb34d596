"""Group-wise activation scales (paper Table 2, g = 128) on the port's
W4A4+LRC stack, against the reference.

On the CPU every wrapper runs its plain version.  Tolerances:

* ``rowops``' group bodies (``group_amax``, ``quantize_rows_grouped``,
  ``scale_round_quantize(group=)``): bitwise the reference's eager jnp
  bodies.
* ``rowops.gemm_grouped`` is the canonical order (ascending groups, one
  rounding per multiply and per add, from 0): bitwise an explicit numpy f32
  loop.  The reference's ``gemm_chunk_grouped`` sums each K-chunk's groups
  in one ``dot_general`` and then adds the chunks, another order: held to
  ``torch_parity.group_tolerance``, 2·(K/g + 1)·2⁻²⁴·Σ_g|p_g·s_g|·|sw|.
* The port's three paths: bitwise equal with an f32 x, rotated or not, at
  any M; g = K bitwise the per-token forward.
* Against the reference's Pallas kernels in interpret mode (one
  subprocess): codes bitwise, scale planes within two ulps
  (``scales_match_jitted``), x·V within its K-term bound, the GEMM within
  the group-sum bound plus the R-term bound on the same operands, the
  paths' outputs within the group-sum bound (two more ulps for the jitted
  scales) plus the LR sums' bound.
* ``QuantPolicy.act_group_overrides`` / ``act_group_for`` equal the
  reference's for every spelling; the calibration's grouped sites along
  the reference's walk are held as in ``test_torch_calibrate_lrc``, with
  the reference's per-layer tags.
* ``paged_step`` of the reduced SmolLM (fused path) and Phi-3-mini
  (chained) at g = 16 with f32 factors against the reference's ``int8``
  impl: each QLinear output within the group-sum and LR bounds, the logits
  within 1e-4 (``test_torch_model``'s tolerance: the frameworks' other
  sums differ by ulps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rowops as jrow
from repro.models import model as jax_model
from repro.quant import qlinear as jql
from repro.quant.policy import QuantPolicy as JaxQuantPolicy
from repro_torch import bridge
from repro_torch.bench import common, latency_kernels
from repro_torch.core.quantizers import QuantSpec
from repro_torch.kernels import actquant, fused_gemm, hadamard, ops, prologue, rowops, w4a4
from repro_torch.kernels.context import KERNEL_PATHS, KernelContext, Plan
from repro_torch.models import model
from repro_torch.quant import calibrate
from repro_torch.quant import qlinear as tql
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve.engine import ServeEngine
from test_torch_calibrate_lrc import _record_reference, _same_qlinear
from test_torch_model import _paged_inputs
from torch_parity import (RTN_SVD, configs, group_tolerance, jax_params, jax_qlinears,
                          lr_tolerance, port, run_pallas, scales_match_jitted, t,
                          to_numpy_tree, w4a4_problem, x64_restored)


def _spec(group):
    return QuantSpec(bits=4, clip_ratio=0.9, group_size=group)


def _forward(x, wp, sw, u, v, group, **kw):
    return ops.w4a4_lrc_forward(x, t(wp), t(sw), port(u), port(v), _spec(group), **kw)


def _codes(wp):
    return rowops.unpack_int4_rows(t(wp)).numpy()


# ---------------------------------------------------------------------------
# the row bodies


@pytest.mark.parametrize("m,k,g", [(5, 192, 64), (3, 256, 256), (7, 96, 8), (4, 3072, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_bodies_bitwise_the_reference_eager(m, k, g, dtype):
    rng = np.random.default_rng(m + k + g)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    x[1, :g] = 0.0  # a zero group takes the guarded scale
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(rowops.group_amax(t(x), g).numpy(),
                          np.asarray(jrow.group_amax(jnp.asarray(x), g)))
    q, s = rowops.scale_round_quantize(t(x), 7, 0.9, group=g)
    qj, sj = jrow.scale_round_quantize(jnp.asarray(x), 7, 0.9, group=g)
    assert s.shape == (m, k // g) and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert np.array_equal(rowops.quantize_rows_grouped(t(x), s, 7, g).numpy(),
                          np.asarray(jrow.quantize_rows_grouped(jnp.asarray(x), sj, 7, g)))
    # g = K is the per-token quantizer, bitwise
    qk, sk = rowops.scale_round_quantize(t(x), 7, 0.9, group=k)
    qt, st = rowops.scale_round_quantize(t(x), 7, 0.9)
    assert torch.equal(qk, qt) and torch.equal(sk, st)


@pytest.mark.parametrize("m,k,n,g", [(5, 192, 33, 64), (4, 512, 40, 128), (3, 96, 17, 8)])
def test_gemm_grouped_is_the_canonical_order(m, k, n, g):
    rng = np.random.default_rng(k)
    xq = rng.integers(-8, 8, (m, k)).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    s = (rng.random((m, k // g)) * 0.5 + 0.01).astype(np.float32)
    got = rowops.gemm_grouped(t(xq), t(w), t(s), g).numpy()
    want = np.zeros((m, n), np.float32)
    for i in range(k // g):
        p = xq[:, i * g:(i + 1) * g].astype(np.int64) @ w[i * g:(i + 1) * g].astype(np.int64)
        want = want + p.astype(np.float32) * s[:, i:i + 1]
    assert np.array_equal(got, want)
    # the reference's order: chunks of two groups, each one dot_general
    bk = 2 * g if k % (2 * g) == 0 else g
    ref = sum(np.asarray(jrow.gemm_chunk_grouped(
        jnp.asarray(xq[:, c:c + bk]), jnp.asarray(w[c:c + bk]),
        jnp.asarray(s[:, c // g:(c + bk) // g]), g)) for c in range(0, k, bk))
    ones = np.ones(n, np.float32)
    assert np.all(np.abs(got - ref) <= group_tolerance(xq, s, w, ones, g))
    # g = K: one term, the per-token rescale
    sk = s[:, :1]
    assert np.array_equal(rowops.gemm_grouped(t(xq), t(w), t(sk), k).numpy(),
                          (rowops.int_matmul(t(xq), t(w)).to(torch.float32) * t(sk)).numpy())
    with pytest.raises(ValueError):
        rowops.gemm_grouped(t(xq), t(w), t(s[:, :1]), g)


# ---------------------------------------------------------------------------
# the three paths


PATH_CASES = ([(m, 256, 40, 9, 64, rot) for m in (1, 13, 17, 64) for rot in (False, True)]
              + [(m, k, n, r, g, rot)
                 for (m, k, n, r, g) in [(16, 256, 100, 16, 64), (13, 192, 80, 5, 64),
                                         (8, 256, 64, 0, 128), (64, 512, 96, 8, 128),
                                         (5, 200, 33, 4, 10), (3, 90, 17, 0, 45)]
                 for rot in (False, True) if not rot or k & (k - 1) == 0])


@pytest.mark.parametrize("m,k,n,r,g,rotate", PATH_CASES)
def test_three_grouped_paths_bitwise_equal(m, k, n, r, g, rotate):
    x, wp, sw, u, v = w4a4_problem(m + k + n + r + g, m, k, n, r)
    ys = {path: _forward(t(x), wp, sw, u, v, g, rotate=rotate, impl=path)
          for path in KERNEL_PATHS}
    assert torch.equal(ys["fused"], ys["chained"])
    assert torch.equal(ys["fused"], ys["unfused"])
    # the groups are there: the per-token forward differs ...
    y0 = _forward(t(x), wp, sw, u, v, None, rotate=rotate, impl="fused")
    assert not torch.equal(y0, ys["fused"])
    # ... and g = K is it, bitwise, on every path
    for path in KERNEL_PATHS:
        assert torch.equal(_forward(t(x), wp, sw, u, v, k, rotate=rotate, impl=path),
                           _forward(t(x), wp, sw, u, v, None, rotate=rotate, impl=path))


def test_grouped_rows_do_not_depend_on_m():
    """A row's output is the same whatever rows share its call (the
    serving contract the canonical order keeps).  Rank 0: on the CPU the
    x·V of a one-row call is an MKL product summed in another order."""
    x, wp, sw, u, v = w4a4_problem(3, 40, 512, 33, 0)
    for path in KERNEL_PATHS:
        whole = _forward(t(x), wp, sw, u, v, 128, impl=path)
        for lo, hi in ((0, 1), (3, 7), (17, 40)):
            assert torch.equal(_forward(t(x[lo:hi]), wp, sw, u, v, 128, impl=path),
                               whole[lo:hi])


def test_each_grouped_path_runs_its_own_wrappers():
    x, wp, sw, u, v = w4a4_problem(1, 4, 64, 48, 8)
    want = {"fused": {"fused_w4a4_lrc_plain": 1},
            "chained": {"fused_prologue_plain": 1, "w4a4_lowrank_matmul_plain": 1},
            "unfused": {"act_quant_plain": 1, "w4a4_lowrank_matmul_plain": 1}}
    mods = (fused_gemm, prologue, w4a4, actquant, hadamard)
    for path, counts in want.items():
        for mod in mods:
            mod.reset_launches()
        _forward(t(x), wp, sw, u, v, 16, ctx=KernelContext(impl=path))
        got = {k: c for mod in mods for k, c in mod.LAUNCHES.items() if c}
        assert got == counts, path


def test_grouped_wrappers_return_the_scale_plane():
    x, wp, sw, u, v = w4a4_problem(2, 6, 192, 40, 7)
    xq, sx = actquant.act_quant(t(x), 4, 0.9, 64)
    pq, psx, pxv = prologue.fused_prologue(t(x), port(v), 4, 0.9, group=64)
    assert sx.shape == psx.shape == (6, 3)
    assert torch.equal(xq, pq) and torch.equal(sx, psx)
    q0, s0, xv0 = prologue.fused_prologue(t(x), None, 4, 0.9, group=64)
    assert xv0 is None and torch.equal(q0, pq) and torch.equal(s0, psx)
    y = w4a4.w4a4_lowrank_matmul(xq, sx, t(wp), t(sw), pxv, port(u), group=64)
    assert torch.equal(y, _forward(t(x), wp, sw, u, v, 64, impl="unfused"))


@pytest.mark.parametrize("group", [5, 0, -64, True, 64.0])
def test_a_group_must_divide_k(group):
    x, wp, sw, u, v = w4a4_problem(4, 3, 192, 16, 4)
    for path in KERNEL_PATHS:
        with pytest.raises(ValueError):
            _forward(t(x), wp, sw, u, v, group, impl=path)
    with pytest.raises(ValueError):
        KernelContext().resolve_plan(3, 192, 16, 4, act_group=group)
    for call in (lambda: actquant.act_quant(t(x), 4, 0.9, group),
                 lambda: prologue.fused_prologue(t(x), None, 4, 0.9, group=group),
                 lambda: fused_gemm.fused_w4a4_lrc(t(x), None, t(wp), t(sw), None,
                                                   group=group)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):
        common.w4a4_problem(torch.Generator().manual_seed(0), 3, 192, 16, 4,
                            torch.float32, torch.float32, "cpu", group)


def _limit_k(r, g):
    """The largest multiple of g whose fused block, with its scale plane,
    fits the shared-memory limit."""
    k = g
    while fused_gemm.smem_bytes(k + g, r, g) <= fused_gemm.SMEM_LIMIT:
        k += g
    return k


@pytest.mark.parametrize("r,g", [(0, 8), (58, 16), (307, 64)])
def test_auto_demotes_a_grouped_site_at_the_shared_memory_limit(r, g):
    ctx = KernelContext()
    k = _limit_k(r, g)
    assert ctx.resolve_plan(4, k, 64, r, act_group=g) == Plan("fused", False, False)
    assert ctx.resolve_plan(4, k + g, 64, r, act_group=g) == Plan("chained", False, True)
    # the plane is what tips it: per-token, the same K still fits
    assert fused_gemm.smem_bytes(k + g, r) < fused_gemm.smem_bytes(k + g, r, g)
    # g = K is one scale per row, as per-token
    assert fused_gemm.smem_bytes(k, r, k) == fused_gemm.smem_bytes(k, r)


def test_the_served_sites_plans():
    ctx = KernelContext()
    # SmolLM-135M at g 64 stays fused, Phi-3-mini at g 128 demotes to chained
    assert {ctx.resolve_plan(4, k, n, r, act_group=64).path for k, n, r in
            [(576, 576, 58), (576, 192, 19), (576, 1536, 58), (1536, 576, 58)]} == {"fused"}
    assert {ctx.resolve_plan(4, k, n, r, act_group=128) for k, n, r in
            [(3072, 3072, 307), (3072, 8192, 307), (8192, 3072, 307)]} == {
                Plan("chained", False, True)}
    # 128 does not divide SmolLM's K = 576
    with pytest.raises(ValueError):
        ctx.resolve_plan(4, 576, 576, 58, act_group=128)


# ---------------------------------------------------------------------------
# against the reference's Pallas kernels (interpret mode)

PALLAS_PROBLEM = (13, 256, 40, 9, 64)


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """The reference's grouped paths, quantizer, prologue and GEMM kernels
    on one problem, from one subprocess.  The GEMM kernel takes the port's
    codes, scale plane and x·V, so both GEMMs see the same operands."""
    m, k, n, r, g = PALLAS_PROBLEM
    x, wp, sw, u, v = w4a4_problem(9, m, k, n, r)
    xq, sx, xv = prologue.fused_prologue(t(x), port(v), 4, 0.9, group=g)
    got = run_pallas(tmp_path_factory.mktemp("groups"), f"""
from repro.core.quantizers import QuantSpec
from repro.kernels import ops
from repro.kernels.w4a4 import w4a4_lowrank_matmul_kernel
g = {g}
spec = QuantSpec(bits=4, clip_ratio=0.9, group_size=g)
u = jnp.asarray(d["u"], jnp.bfloat16)
v = jnp.asarray(d["v"], jnp.bfloat16)
for impl in ("fused", "chained", "unfused"):
    for rot in (False, True):
        y = ops.w4a4_lrc_forward(jnp.asarray(d["x"]), jnp.asarray(d["wp"]),
                                 jnp.asarray(d["sw"]), u, v, spec, rotate=rot, impl=impl)
        out[f"{{impl}}_{{rot}}"] = np.asarray(y)
x = jnp.asarray(d["x"])
out["q_act"], out["s_act"] = (np.asarray(a) for a in ops.act_quant(x, spec, bm=8))
for rot in (False, True):
    q, s, xv = ops.fused_prologue(x, v, spec, rotate=rot, bm=8)
    out[f"q_v_{{rot}}"], out[f"s_v_{{rot}}"], out[f"xv_{{rot}}"] = (
        np.asarray(a) for a in (q, s, xv))
    q, s, _ = ops.fused_prologue(x, None, spec, rotate=rot, bm=8)
    out[f"q_nov_{{rot}}"], out[f"s_nov_{{rot}}"] = np.asarray(q), np.asarray(s)
xqp, sxp, wpp, swp, up, xvp = ops._pad_gemm_operands(
    jnp.asarray(d["xq"]), jnp.asarray(d["sx"]), jnp.asarray(d["wp"]),
    jnp.asarray(d["sw"]), u, jnp.asarray(d["xv"]), 16, 128, 128, 16, act_group=g)
y = w4a4_lowrank_matmul_kernel(xqp, sxp, wpp, swp, xvp, up, bm=16, bn=128, bk=128,
                               group=g)
out["gemm"] = np.asarray(y)[:{m}, :{n}]
""", x=x, wp=wp, sw=sw, u=u, v=v, xq=xq.numpy(), sx=sx.numpy(), xv=xv.numpy())
    return (x, wp, sw, u, v), (xq, sx, xv), got


def test_grouped_quantizers_match_pallas_kernels(pallas):
    """``act_quant_kernel(group=)`` and ``fused_prologue_kernel(act_group=)``
    with V and without, rotated and not."""
    (x, _, _, _, v), _, got = pallas
    m, k, n, r, g = PALLAS_PROBLEM
    xq, sx = actquant.act_quant(t(x), 4, 0.9, g)
    assert np.array_equal(xq.numpy(), got["q_act"])
    assert scales_match_jitted(sx.numpy(), got["s_act"])
    vf = v.astype(np.float32)
    for rot in (False, True):
        rows = hadamard.fwht_plain(t(x)).numpy() if rot else x
        for name, vv in (("v", v), ("nov", None)):
            q, s, xv = prologue.fused_prologue(t(x), port(vv), 4, 0.9, rot, g)
            assert np.array_equal(q.numpy(), got[f"q_{name}_{rot}"]), (name, rot)
            assert scales_match_jitted(s.numpy(), got[f"s_{name}_{rot}"]), (name, rot)
            if vv is not None:
                want = got[f"xv_{rot}"]
                tol = 2.0 * (k + 1) * 2.0 ** -24 * (np.abs(rows) @ np.abs(vf)
                                                    + np.abs(want)) + 1e-30
                assert np.all(np.abs(xv.numpy() - want) <= tol), rot


def test_grouped_gemm_matches_pallas_kernel(pallas):
    """``w4a4_lowrank_matmul_kernel(group=)`` on the port's operands: the
    group sums in another order, the LR term's R-term sum."""
    (_, wp, sw, u, _), (xq, sx, xv), got = pallas
    g, r = PALLAS_PROBLEM[4], PALLAS_PROBLEM[3]
    y = w4a4.w4a4_lowrank_matmul(xq, sx, t(wp), t(sw), xv, port(u), g).numpy()
    want = got["gemm"]
    uf = u.astype(np.float32)
    tol = (group_tolerance(xq.numpy(), sx.numpy(), _codes(wp), sw, g)
           + 2.0 * (r + 1) * 2.0 ** -24 * (np.abs(want) + np.abs(xv.numpy()) @ np.abs(uf).T))
    assert np.all(np.abs(y - want) <= tol), float(np.abs(y - want).max())


@pytest.mark.parametrize("path", KERNEL_PATHS)
@pytest.mark.parametrize("rotate", [False, True])
def test_grouped_paths_match_pallas_kernels(pallas, path, rotate):
    (x, wp, sw, u, v), _, got = pallas
    m, k, n, r, g = PALLAS_PROBLEM
    y = _forward(t(x), wp, sw, u, v, g, rotate=rotate, impl=path).numpy()
    want = got[f"{path}_{rotate}"]
    rows = hadamard.fwht_plain(t(x)).numpy() if rotate else x
    q, s = rowops.scale_round_quantize(t(rows), 7, 0.9, g)
    tol = (group_tolerance(q.numpy(), s.numpy(), _codes(wp), sw, g, scale_ulps=2)
           + lr_tolerance(rows, v.astype(np.float32), u.astype(np.float32), k, r, want))
    assert np.all(np.abs(y - want) <= tol), float(np.abs(y - want).max())


# ---------------------------------------------------------------------------
# the policy


OVERRIDES = [(), {"mlp/wd": None}, [["attn/wo", 32], ["mlp/wd", None]],
             (("mlp/wd", 16), ("attn/wq", 64))]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_act_group_overrides_match_the_reference(overrides):
    ours = QuantPolicy(act_group=128, act_group_overrides=overrides)
    ref = JaxQuantPolicy(act_group=128, act_group_overrides=overrides)
    assert ours.act_group_overrides == ref.act_group_overrides
    for name in (None, "attn/wq", "attn/wo", "mlp/wd", "layers/mlp/wd", "xmlp/wd",
                 "mlp/wd2", "attn/wk"):
        assert ours.act_group_for(name) == ref.act_group_for(name), name
    assert hash(ours) == hash(QuantPolicy(act_group=128, act_group_overrides=overrides))


@pytest.mark.parametrize("bad", [{"mlp/wd": 0}, {"mlp/wd": True}, {"mlp/wd": 1.5},
                                 [("mlp/wd",)], [(3, 16)], ["mlp/wd"]])
def test_bad_act_group_overrides_raise_as_in_the_reference(bad):
    with pytest.raises(ValueError):
        JaxQuantPolicy(act_group_overrides=bad)
    with pytest.raises(ValueError):
        QuantPolicy(act_group_overrides=bad)


# ---------------------------------------------------------------------------
# calibration

GROUPED_POLICY = dict(rank_frac=0.10, impl="sim", clip_ratio=0.9, act_group=16,
                      act_group_overrides={"mlp/wd": None, "attn/wo": 32})


@pytest.fixture(scope="module")
def calibrated():
    """The reference's grouped GPTQ + LRC calibration of the reduced SmolLM,
    every site recorded, and the port's on the same params and tokens."""
    from repro_torch.data.loader import calib_sequences

    jcfg, tcfg = configs()
    with x64_restored():
        jax.config.update("jax_enable_x64", False)
        jparams = jax_params(jcfg)
    tokens = calib_sequences(tcfg, n_seq=8, seq_len=32, device="cpu")
    ref = _record_reference(jcfg, jparams, jnp.asarray(tokens.numpy()), GROUPED_POLICY)
    params = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    ported = calibrate.quantize_model(tcfg, params, tokens, QuantPolicy(**GROUPED_POLICY))
    return tcfg, ref, ported


def test_grouped_solve_site_on_the_reference_walk(calibrated):
    """The statistics quantize with the policy-wide group; each site is
    tagged with its own (the overrides), as the reference tags it."""
    tcfg, (_, sites), _ = calibrated
    pol = QuantPolicy(**GROUPED_POLICY)
    spec_a = calibrate._act_spec(pol)
    assert spec_a.group_size == 16
    assert len(sites) == 7 * tcfg.n_layers
    for site in sites:
        st = calibrate.collect_stats(t(site["acts"]), spec_a)
        got = calibrate.solve_site(t(site["w"]), st, pol, name=site["name"])
        assert got.act_group == site["qlinear"].act_group == pol.act_group_for(site["name"])
        _same_qlinear(got, site["qlinear"])


def test_grouped_quantize_model_tags_every_site(calibrated):
    tcfg, (jq, _), tq = calibrated
    pol = QuantPolicy(**GROUPED_POLICY)
    for li in range(tcfg.n_layers):
        for block in ("attn", "mlp"):
            for name, q in tq["layers"][li][block].items():
                assert q.act_group == pol.act_group_for(f"{block}/{name}")
                assert q.act_group == jq["layers"][block][name].act_group
    assert {q.act_group for q in tq["layers"][0]["mlp"].values()} == {16, None}


def test_retagged_rtn_svd_model_is_bitwise_quantize_model():
    """RTN + SVD reads no statistics: retagging a per-token model with a
    policy's groups is bitwise what ``quantize_model`` gives under it (the
    card script serves its grouped models so)."""
    jcfg, tcfg = configs()
    params = bridge.params_from_jax(to_numpy_tree(jax_params(jcfg)), device="cpu")
    policy = QuantPolicy(**RTN_SVD, act_group=16, act_group_overrides={"mlp/wd": 32})
    want = calibrate.quantize_model(tcfg, params, None, policy, rotate=False)
    base = calibrate.quantize_model(tcfg, params, None, QuantPolicy(**RTN_SVD), rotate=False)
    got = tql.retag_act_group(base, policy)
    for li in range(tcfg.n_layers):
        for block in ("attn", "mlp"):
            for name, a in want["layers"][li][block].items():
                b = got["layers"][li][block][name]
                assert b.act_group == a.act_group == policy.act_group_for(f"{block}/{name}")
                for f in dataclasses.fields(a):
                    x, y = getattr(a, f.name), getattr(b, f.name)
                    assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), f.name


# ---------------------------------------------------------------------------
# the model and the engine

GROUP = 16


def _grouped_trees(arch):
    """The reference's and the port's params of a reduced ``arch`` with RTN
    + SVD QLinears at act_group GROUP and f32 factors, so that the
    reference's ``int8`` impl and the port's kernel path compute the LR
    term alike (in f32, in different orders)."""
    import repro.configs as jconfigs
    from repro.models.config import reduced as jax_reduced
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    jcfg = jax_reduced(jconfigs.get_config(arch), dtype="float32", n_layers=2)
    tcfg = reduced(get_config(arch), dtype="float32", n_layers=2)
    with x64_restored():
        jax.config.update("jax_enable_x64", False)
        jtree = jax_qlinears(jcfg, jax_params(jcfg))

    def regroup(q):
        if not isinstance(q, jql.QLinear):
            return q
        return dataclasses.replace(q, act_group=GROUP, u=q.u.astype(jnp.float32),
                                   v=q.v.astype(jnp.float32))

    jtree = jax.tree.map(regroup, jtree, is_leaf=lambda q: isinstance(q, jql.QLinear))
    return jcfg, tcfg, jtree, bridge.params_from_jax(to_numpy_tree(jtree), device="cpu")


@pytest.mark.parametrize("arch,path", [("smollm-135m", "fused"), ("phi3-mini-3.8b", "chained")])
def test_grouped_paged_step_against_the_reference_int8(arch, path):
    jcfg, tcfg, jtree, params = _grouped_trees(arch)
    params = tql.retag_qlinear_impl(params, "pallas", ctx=KernelContext(impl=path))
    # one QLinear: the group sums and the LR sums in other orders
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((6, tcfg.d_model)) * 2).astype(np.float32)
    jq = jax.tree.map(lambda a: a[0], jtree["layers"]["attn"]["wq"])
    tq = params["layers"][0]["attn"]["wq"]
    assert tq.act_group == GROUP
    want = np.asarray(jql.qlinear_apply(jq, jnp.asarray(x)))
    got = tql.qlinear_apply(tq, t(x)).numpy()
    q, s = rowops.scale_round_quantize(t(x), 7, 0.9, GROUP)
    k, r = x.shape[1], tq.u.shape[1]
    tol = (group_tolerance(q.numpy(), s.numpy(), _codes(tq.qweight.numpy()),
                           tq.w_scale.numpy(), GROUP)
           + lr_tolerance(x, tq.v.numpy(), tq.u.numpy(), k, r, want))
    assert np.all(np.abs(got - want) <= tol)
    # the whole step
    pool, table, tokens, positions, valid, srow = _paged_inputs(jcfg, np.random.default_rng(2))
    want, _ = jax_model.paged_step(
        jcfg, jtree, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(table), jnp.asarray(srow))
    for mod in (fused_gemm, prologue, w4a4):
        mod.reset_launches()
    got, _ = model.paged_step(
        tcfg, params, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(valid), {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        torch.from_numpy(table), torch.from_numpy(srow))
    ran = {k for mod in (fused_gemm, prologue, w4a4) for k, c in mod.LAUNCHES.items() if c}
    assert ran == ({"fused_w4a4_lrc_plain"} if path == "fused"
                   else {"fused_prologue_plain", "w4a4_lowrank_matmul_plain"})
    got = got.numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_engine_reports_the_sites_group():
    _, tcfg, _, params = _grouped_trees("phi3-mini-3.8b")
    params = tql.retag_act_group(params, QuantPolicy(act_group=GROUP,
                                                     act_group_overrides={"mlp/wd": None}))
    eng = ServeEngine(tcfg, params, kernel_impl="pallas", device="cpu", batch_slots=2,
                      max_seq=32, page_size=4, prefill_chunk=4)
    plan = {tuple(sorted(s["layers"])): s for s in eng.health()["decode_plan"]}
    assert plan[("mlp/wd",)]["act_group"] is None
    assert plan[("attn/wk", "attn/wo", "attn/wq", "attn/wv")]["act_group"] == GROUP
    assert {s["path"] for s in plan.values()} == {"fused"}


# ---------------------------------------------------------------------------
# the Tables 6-8 harness


@pytest.mark.parametrize("path", KERNEL_PATHS)
def test_latency_check_path_holds_a_grouped_path(path):
    x, wp, sw, u, v = w4a4_problem(4, 17, 256, 40, 19)
    args = (t(x), t(wp), t(sw), port(u), port(v), True)
    y = ops.w4a4_lrc_forward(*args[:5], _spec(64), rotate=True, impl=path)
    xq, sx, worst = latency_kernels.check_path(*args, path, y, 64)
    assert worst == 0.0
    assert sx is None if path == "fused" else sx.shape == (17, 4)
    y_bad = y.clone()
    y_bad[3, 5] += 1e-3 * y.abs().max()
    with pytest.raises(AssertionError):
        latency_kernels.check_path(*args, path, y_bad, 64)
    # the per-token check refuses the grouped output
    with pytest.raises(AssertionError):
        latency_kernels.check_path(*args, path, y)
