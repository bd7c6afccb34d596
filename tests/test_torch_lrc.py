"""The port's GPTQ and LRC solvers (``core/gptq.py``, ``core/lrc.py``)
against the reference's, on the SAME f64 statistics (built by the
reference and handed to both), so only the solvers are compared.

Tolerances:

* GPTQ codes and scales: bitwise.  Both run the column-serial scan in f64
  with the same operations (the port updates only rows i+1…, which the
  reference's exact-zero mask leaves equal), but their Cholesky factors
  and triangular solves come from different LAPACKs, so T differs by f64
  ulps.  A code can then differ only where col/scale lies within a few ulps
  of a rounding midpoint; :func:`_min_midpoint_margin` re-runs the port's
  scan and shows every pre-round value of these inputs at least 1e-9 away
  from one, so any differing code would be a fault, not rounding.
* ``gptq_quantize_np`` (blocked; sums grouped differently): codes equal,
  scales to rtol 1e-6, as the reference's own test holds its scan.
* f64 results (W̃, losses, oracle loss): relative 1e-9 (measured ~1e-14).
* U, V: their signs (and the basis of a degenerate eigenspace) depend on
  the eigensolver, so U Vᵀ is compared, to 1e-9 of its largest element;
  LRCResult's f32 factors add their own rounding, 2·2⁻²⁴·|U||V|ᵀ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gptq as jg
from repro.core import lrc as jl
from repro.core import stats as js
from repro.core.quantizers import QuantSpec as JaxQuantSpec
from repro_torch.core import gptq as tg
from repro_torch.core import lrc as tl
from repro_torch.core.quantizers import QuantSpec, weight_scales
from repro_torch.core.stats import CalibStats
from torch_parity import t, x64_restored

REL = 1e-9


@pytest.fixture(autouse=True)
def _x64():
    with x64_restored():
        jax.config.update("jax_enable_x64", True)
        yield


def _problem(seed, n, d_in, d_out, outliers=True, act_bits=4):
    """Heavy-tailed activations, a weight (d_out, d_in) and the reference's
    finalized statistics, as (w numpy, jax stats, port stats)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d_in))
    if outliers:
        x[:, :: max(1, d_in // 6)] *= 8.0
    w = rng.standard_normal((d_out, d_in)) / np.sqrt(d_in)
    spec = JaxQuantSpec(bits=act_bits, clip_ratio=0.9)
    st = js.init_stats(d_in)
    st = js.accumulate_stats(st, jnp.asarray(x[: n // 2]), spec)
    st = js.accumulate_stats(st, jnp.asarray(x[n // 2:]), spec)
    st = js.finalize_stats(st)
    port = CalibStats(*(t(np.asarray(getattr(st, f)))
                        for f in ("sxx", "syy", "sxy", "count")))
    return w, st, port


def _min_midpoint_margin(w, h, spec, damp=0.01, act_order=False):
    """The port's scan again, returning the smallest distance of any
    pre-round value col/scale to a rounding midpoint (k + 0.5) inside the
    grid."""
    w = t(w).double()
    h = t(h).double()
    dead = torch.diag(h) <= 0
    h = torch.where(torch.eye(h.shape[0], dtype=torch.bool) & dead[None, :],
                    torch.ones(()).double(), h)
    w = torch.where(dead[None, :], torch.zeros(()).double(), w)
    if act_order:
        perm = torch.argsort(-torch.diag(h), stable=True)
        w, h = w[:, perm], h[perm][:, perm]
    scales = weight_scales(w, spec).double()[:, 0]
    tu = tg._hinv_chol_upper(h, damp)
    wt = w.T.clone()
    margin = np.inf
    for i in range(wt.shape[0]):
        z = wt[i] / scales
        inside = (z > spec.qmin - 0.5) & (z < spec.qmax + 0.5)
        if inside.any():
            margin = min(margin, (z[inside] - torch.floor(z[inside]) - 0.5)
                         .abs().min().item())
        q = torch.clamp(torch.round(z), spec.qmin, spec.qmax)
        err = (wt[i] - q * scales) / tu[i, i]
        wt[i + 1:] -= tu[i, i + 1:, None] * err[None, :]
    return margin


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("d_in,d_out,bits", [(48, 40, 4), (96, 24, 3), (64, 130, 4)])
def test_gptq_matches_reference(d_in, d_out, bits, dead, act_order):
    rng = np.random.default_rng(d_in + d_out + bits)
    x = rng.standard_normal((512, d_in)) @ (np.eye(d_in) + 0.3 * rng.standard_normal((d_in, d_in)))
    if dead:
        x[:, [1, 7]] = 0.0  # inputs that never activate: zero hessian rows
    h = x.T @ x
    w = rng.standard_normal((d_out, d_in))
    spec = QuantSpec(bits=bits)
    q_j, s_j = jg.gptq_quantize(jnp.asarray(w), jnp.asarray(h), JaxQuantSpec(bits=bits),
                                act_order=act_order)
    q_t, s_t = tg.gptq_quantize(t(w), t(h), spec, act_order=act_order)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    assert _min_midpoint_margin(w, h, spec, act_order=act_order) > 1e-9
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    if dead:
        assert not q_t[:, [1, 7]].any()


def test_gptq_matches_numpy_oracle(rng):
    d_in, d_out = 24, 12
    x = rng.standard_normal((512, d_in))
    h = x.T @ x
    w = rng.standard_normal((d_out, d_in))
    spec = QuantSpec(bits=4)
    q_t, s_t = tg.gptq_quantize(t(w), t(h), spec)
    q_n, s_n = tg.gptq_quantize_np(w, h, spec, block=8)
    q_jn, s_jn = jg.gptq_quantize_np(w, h, JaxQuantSpec(bits=4), block=8)
    assert np.array_equal(q_n, q_jn) and np.array_equal(s_n, s_jn)
    np.testing.assert_allclose(s_t.numpy(), s_n, rtol=1e-6)
    np.testing.assert_array_equal(q_t.numpy(), q_n)


def test_rtn_weight_quantize_bitwise(rng):
    w = rng.standard_normal((20, 36))
    q_j, s_j = jg.rtn_weight_quantize(jnp.asarray(w), None, JaxQuantSpec(bits=4))
    q_t, s_t = tg.rtn_weight_quantize(t(w), None, QuantSpec(bits=4))
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))


def _uv_close(u_t, v_t, u_j, v_j, f32=False):
    got = u_t.double().numpy() @ v_t.double().numpy().T
    uj, vj = np.asarray(u_j, np.float64), np.asarray(v_j, np.float64)
    want = uj @ vj.T
    tol = REL * np.abs(want).max()
    if f32:
        tol = tol + 2 * 2.0 ** -24 * (np.abs(uj) @ np.abs(vj).T)
    return np.all(np.abs(got - want) <= tol)


def _rel_close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


def test_init_lr_and_modified_target():
    w, st, port = _problem(0, 2048, 48, 40)
    u_j, v_j = jl.init_lr(jnp.asarray(w), st, 6)
    u_t, v_t = tl.init_lr(t(w), port, 6)
    assert u_t.shape == (40, 6) and v_t.shape == (48, 6)
    np.testing.assert_allclose(u_t.T @ u_t, np.eye(6), atol=1e-12)
    assert _uv_close(u_t, v_t, u_j, v_j)
    for uv in ((None, None), (u_j, v_j)):
        want = np.asarray(jl.modified_target(jnp.asarray(w), *uv, st))
        args = [None if a is None else t(np.asarray(a)) for a in uv]
        got = tl.modified_target(t(w), *args, port).numpy()
        assert np.all(np.abs(got - want) <= REL * np.abs(want).max())


def test_update_lr_and_losses():
    w, st, port = _problem(1, 2048, 48, 40)
    spec = QuantSpec(bits=4)
    u0, v0 = tl.init_lr(t(w), port, 6)
    _, _, w_hat = tl.update_quant(t(w), u0, v0, port, spec)
    u_t, v_t = tl.update_lr(t(w), w_hat, port, 6)
    u_j, v_j = jl.update_lr(jnp.asarray(w), jnp.asarray(w_hat.numpy()), st, 6)
    assert _uv_close(u_t, v_t, u_j, v_j)
    jw, jwh = jnp.asarray(w), jnp.asarray(w_hat.numpy())
    for kw in ({}, {"w_hat": 1}, {"u": 1}, {"w_hat": 1, "u": 1}):
        jkw = {k: jwh for k in kw if k == "w_hat"}
        tkw = {k: w_hat for k in kw if k == "w_hat"}
        if "u" in kw:
            jkw.update(u=u_j, v=v_j)
            tkw.update(u=u_t, v=v_t)
        assert _rel_close(tl.reconstruction_loss(t(w), port, **tkw),
                          jl.reconstruction_loss(jw, st, **jkw)), kw


@pytest.mark.parametrize("quant_method", ["gptq", "rtn"])
@pytest.mark.parametrize("iters", [1, 2])
def test_lrc_solve_matches_reference(iters, quant_method):
    w, st, port = _problem(2 + iters, 2048, 48, 40)
    spec = QuantSpec(bits=4)
    rj = jl.lrc_solve(jnp.asarray(w), st, JaxQuantSpec(bits=4), k=6, iters=iters,
                      quant_method=quant_method)
    rt = tl.lrc_solve(t(w), port, spec, k=6, iters=iters, quant_method=quant_method)
    assert np.array_equal(rt.qweight.numpy(), np.asarray(rj.qweight))
    assert np.array_equal(rt.scales.numpy(), np.asarray(rj.scales))
    assert rt.u.dtype == torch.float32 and _uv_close(rt.u, rt.v, rj.u, rj.v, f32=True)
    assert len(rt.losses) == 2 * iters
    assert all(_rel_close(a, b) for a, b in zip(rt.losses, rj.losses))
    assert _rel_close(rt.oracle_loss, rj.oracle_loss)
    # Prop 3.3: each Update-LR is a global argmin given Ŵ
    for i in range(0, len(rt.losses), 2):
        assert rt.losses[i + 1] <= rt.losses[i] * (1 + 1e-9)
    assert rt.oracle_loss <= rt.losses[-1] + 1e-9


@pytest.mark.parametrize("hessian", ["x", "y"])
def test_quantize_baseline_gptq(hessian):
    w, st, port = _problem(5, 1024, 32, 20)
    q_j, s_j, wh_j = jl.quantize_baseline(jnp.asarray(w), st, JaxQuantSpec(bits=4),
                                          hessian=hessian)
    q_t, s_t, wh_t = tl.quantize_baseline(t(w), port, QuantSpec(bits=4), hessian=hessian)
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    assert np.array_equal(wh_t.numpy(), np.asarray(wh_j))


def test_tri_solve_call_forms(rng):
    """Every (lower, trans) form of the reference's solve_triangular."""
    a = rng.standard_normal((9, 9))
    spd = a @ a.T + 9 * np.eye(9)
    lo = np.linalg.cholesky(spd)
    b = rng.standard_normal((9, 4))
    for lower, m in ((True, lo), (False, lo.T)):
        for trans in (False, True):
            want = np.asarray(jl._tri_solve(jnp.asarray(m), jnp.asarray(b), lower=lower,
                                            trans=trans))
            got = tl._tri_solve(t(m), t(b), lower=lower, trans=trans).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tl._chol_solve(t(lo), t(b)).numpy(),
                               np.linalg.solve(spd, b), rtol=1e-10)
