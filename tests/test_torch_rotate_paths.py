"""The online rotation (``rotate=True``) on the three W4A4+LRC paths, and
the layer-latency harness's smoke rows, against the reference.

On the CPU every wrapper runs its plain version.  With an f32 x the three
paths are then bitwise equal, as the reference promises for its interpret
mode: the fused and chained paths rotate the f32 rows with
``rowops.fwht_rows`` inside their kernels' plain versions, the unfused path
runs the transform kernel's plain version (the same body) first.  With a
bf16 x the unfused path quantizes the rotated rows rounded to bf16 (the
transform returns x's dtype) and the other two the f32 rows, as in the
reference.

Against the reference's own paths (the Pallas kernels in interpret mode,
in a subprocess): the rotated rows and the codes are bitwise; the jitted
kernels' scales may be two ulps off the port's, which match the
reference's eager oracle bitwise (``torch_parity.scales_match_jitted``);
the outputs differ only in the order of the LR sums
(``torch_parity.lr_tolerance`` on the rotated rows) and by those scales
(2⁻²² relative).  Where a rotated bf16 row lands exactly on a rounding tie
of x/s, such a scale flips the reference's code by one: the output is held
to the bound plus those flips, and to the LR bound alone against the
reference's eager oracle on the same rows.  The rotated oracles
(``ref.py``, the dividing transform) hold the paths to rtol/atol 1e-4, as
the reference's own test does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.bench import latency_kernels
from repro_torch.core.quantizers import QuantSpec
from repro_torch.kernels import actquant, fused_gemm, hadamard, ops, prologue, ref, w4a4
from repro_torch.kernels.context import KERNEL_PATHS, KernelContext
from repro_torch.kernels.rowops import fwht_rows, scale_round_quantize, unpack_int4_rows
from torch_parity import (bf16, lr_tolerance, port, run_pallas, scales_match_jitted,
                          t, w4a4_problem)

SPEC = QuantSpec(bits=4, clip_ratio=0.9)
# K a power of two: decode and odd N, one chunk, several chunks (K = 1024,
# M over one 16-row tile), rank 0, Phi-3-mini's mlp/wd K at its rank, one
# row, and a one-row last 16-row tile
SHAPES = [(4, 64, 48, 8), (16, 256, 33, 19), (40, 1024, 17, 9),
          (3, 256, 33, 0), (2, 8192, 24, 307), (1, 128, 40, 19), (17, 512, 40, 19)]
# the problem held against the reference's Pallas paths
PALLAS_SHAPE = (5, 512, 40, 19)


def _forward(x, wp, sw, u, v, **kw):
    return ops.w4a4_lrc_forward(x, t(wp), t(sw), port(u), port(v), SPEC,
                                rotate=True, **kw)


@pytest.mark.parametrize("m,k,n,r", SHAPES)
def test_three_rotated_paths_bitwise_equal(m, k, n, r):
    x, wp, sw, u, v = w4a4_problem(m + k + n + r, m, k, n, r)
    ys = {path: _forward(t(x), wp, sw, u, v, impl=path) for path in KERNEL_PATHS}
    assert torch.equal(ys["fused"], ys["chained"])
    assert torch.equal(ys["fused"], ys["unfused"])
    # the rotation is there: the unrotated forward differs
    y0 = ops.w4a4_lrc_forward(t(x), t(wp), t(sw), port(u), port(v), SPEC)
    assert not torch.equal(y0, ys["fused"])
    # and the dividing oracle agrees to the reference's own tolerance
    want = ref.w4a4_lrc_forward_ref(t(x), t(wp), t(sw), port(u), port(v), bits=4,
                                    clip_ratio=0.9, rotate=True)
    np.testing.assert_allclose(ys["fused"].numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_unfused_path_rounds_the_rotated_rows():
    m, k, n, r = 6, 256, 40, 19
    x, wp, sw, u, v = w4a4_problem(7, m, k, n, r)
    xb = port(bf16(x))
    ys = {path: _forward(xb, wp, sw, u, v, impl=path) for path in KERNEL_PATHS}
    assert torch.equal(ys["fused"], ys["chained"])
    xr = hadamard.fwht_plain(xb)
    assert xr.dtype == torch.bfloat16
    # unfused: the unrotated forward of the bf16 rotated rows
    assert torch.equal(ys["unfused"], ops.w4a4_lrc_forward(
        xr, t(wp), t(sw), port(u), port(v), SPEC, impl="unfused"))
    # fused and chained: the f32 rotated rows
    assert torch.equal(ys["fused"], fused_gemm.fused_w4a4_lrc_plain(
        fwht_rows(xb.to(torch.float32), k), port(v), t(wp), t(sw), port(u), 4, 0.9))


def test_each_rotated_path_runs_its_own_wrappers():
    x, wp, sw, u, v = w4a4_problem(1, 4, 64, 48, 8)
    want = {"fused": {"fused_w4a4_lrc_plain": 1},
            "chained": {"fused_prologue_plain": 1, "w4a4_lowrank_matmul_plain": 1},
            "unfused": {"fwht_plain": 1, "act_quant_plain": 1,
                        "w4a4_lowrank_matmul_plain": 1}}
    mods = (fused_gemm, prologue, w4a4, actquant, hadamard)
    for path, counts in want.items():
        for mod in mods:
            mod.reset_launches()
        _forward(t(x), wp, sw, u, v, ctx=KernelContext(impl=path))
        got = {k: c for mod in mods for k, c in mod.LAUNCHES.items() if c}
        assert got == counts, path


def test_prologue_without_v_rotates():
    x, *_ = w4a4_problem(5, 7, 128, 8, 0)
    xq, sx, xv = prologue.fused_prologue(t(x), None, 4, 0.9, rotate=True)
    q, s = scale_round_quantize(fwht_rows(t(x), 128), 7, 0.9)
    assert xv is None and torch.equal(xq, q) and torch.equal(sx, s)
    q0, _, _ = prologue.fused_prologue(t(x), None, 4, 0.9)
    assert not torch.equal(q0, xq)
    # the oracle (dividing transform) gives the same codes on these rows
    qr, sr, _ = ref.fused_prologue_ref(t(x), None, bits=4, clip_ratio=0.9, rotate=True)
    qj, sj, _ = jref.fused_prologue_ref(jnp.asarray(x), None, bits=4, clip_ratio=0.9,
                                        rotate=True)
    assert np.array_equal(qr.numpy(), np.asarray(qj))
    assert np.array_equal(sr.numpy(), np.asarray(sj))
    np.testing.assert_allclose(sx.numpy(), sr.numpy(), rtol=1e-6)


@pytest.mark.parametrize("k", [96, 200, 8194])
def test_rotation_needs_a_power_of_two_k(k):
    x, wp, sw, u, v = w4a4_problem(2, 3, k, 8, 4)
    for path in KERNEL_PATHS:
        with pytest.raises(ValueError):
            _forward(t(x), wp, sw, u, v, impl=path)
    with pytest.raises(ValueError):
        prologue.fused_prologue(t(x), None, rotate=True)
    with pytest.raises(ValueError):
        fused_gemm.fused_w4a4_lrc(t(x), port(v), t(wp), t(sw), port(u), rotate=True)


@pytest.mark.parametrize("path", KERNEL_PATHS)
def test_latency_check_path_holds_each_step(path):
    """The harness's step-by-step check on the card, run here on the plain
    versions: it accepts the path's own output, restores every launch
    count, and refuses an output moved past its bound."""
    x, wp, sw, u, v = w4a4_problem(4, 17, 256, 40, 19)
    args = (t(x), t(wp), t(sw), port(u), port(v), True)
    y = ops.w4a4_lrc_forward(*args[:5], SPEC, rotate=True, impl=path)
    before = {k: c for mod in latency_kernels.KERNEL_MODULES for k, c in mod.LAUNCHES.items()}
    xq, sx, worst = latency_kernels.check_path(*args, path, y)
    after = {k: c for mod in latency_kernels.KERNEL_MODULES for k, c in mod.LAUNCHES.items()}
    assert after == before and worst == 0.0
    assert (xq is None) == (path == "fused")
    y_bad = y.clone()
    y_bad[3, 5] += 1e-3 * y.abs().max()
    with pytest.raises(AssertionError):
        latency_kernels.check_path(*args, path, y_bad)


def test_latency_smoke_rows_on_the_cpu():
    calls = latency_kernels.Calls()
    hadamard.reset_launches()
    rows = latency_kernels.smoke_rows("cpu", calls)
    assert [row[0] for row in rows] == [
        latency_kernels.smoke_label(*shape) for shape in latency_kernels.SMOKE_SHAPES]
    assert all(len(row) == len(latency_kernels.HEADER) for row in rows)
    # the K = 8192, rank-1024 shape demotes to chained and says why
    widest = [shape[1] for shape in latency_kernels.SMOKE_SHAPES].index(8192)
    assert rows[widest][6].startswith("chained (fused needs")
    # every rotated unfused call ran the transform once, nothing else did
    assert hadamard.LAUNCHES["fwht_plain"] == calls.expected_launches()["fwht"] > 0
    with pytest.raises(RuntimeError):
        latency_kernels.measured_rows("cpu")


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """The reference's rotated paths, prologue and bf16 unfused pieces on
    one problem, from one subprocess."""
    m, k, n, r = PALLAS_SHAPE
    x, wp, sw, u, v = w4a4_problem(3, m, k, n, r)
    got = run_pallas(tmp_path_factory.mktemp("rotate"), """
from repro.core.quantizers import QuantSpec
from repro.kernels import ops
from repro.kernels.prologue import fused_prologue_kernel
spec = QuantSpec(bits=4, clip_ratio=0.9)
for impl in ("fused", "chained", "unfused"):
    for dt in ("float32", "bfloat16"):
        y = ops.w4a4_lrc_forward(
            jnp.asarray(d["x"], dt), jnp.asarray(d["wp"]), jnp.asarray(d["sw"]),
            jnp.asarray(d["u"], jnp.bfloat16), jnp.asarray(d["v"], jnp.bfloat16),
            spec, rotate=True, impl=impl)
        out[impl + "_" + dt] = np.asarray(y)
xp = np.pad(d["x"], ((0, 3), (0, 0)))
for name, vv in (("v", jnp.asarray(d["v"])), ("nov", None)):
    q, s, xv = fused_prologue_kernel(jnp.asarray(xp), vv, bits=4, clip_ratio=0.9,
                                     rotate=True, bm=8)
    out["q_" + name], out["s_" + name] = np.asarray(q)[:5], np.asarray(s)[:5]
    if xv is not None:
        out["xv"] = np.asarray(xv)[:5]
xr = ops.fwht(jnp.asarray(d["x"], jnp.bfloat16), bm=8)
out["xr_bf16"] = np.asarray(xr.astype(jnp.float32))
q, s = ops.act_quant(xr, spec, bm=8)
out["q_bf16"], out["s_bf16"] = np.asarray(q), np.asarray(s)
""", x=x, wp=wp, sw=sw, u=u, v=v)
    return (x, wp, sw, u, v), got


@pytest.mark.parametrize("path", KERNEL_PATHS)
def test_rotated_paths_match_pallas_kernels_in_interpret_mode(pallas, path):
    """The reference's ``w4a4_lrc_forward(rotate=True, impl=path)`` with an
    f32 x."""
    (x, wp, sw, u, v), got = pallas
    k, r = x.shape[1], v.shape[1]
    y = _forward(t(x), wp, sw, u, v, impl=path).numpy()
    want = got[f"{path}_float32"]
    xr = fwht_rows(t(x), k).numpy()
    tol = (lr_tolerance(xr, v.astype(np.float32), u.astype(np.float32), k, r, want)
           + 2.0 ** -22 * np.abs(want))
    assert np.all(np.abs(y - want) <= tol), float(np.abs(y - want).max())


def test_rotated_prologue_matches_pallas_kernel(pallas):
    """``fused_prologue_kernel(rotate=True)`` with V and without it."""
    (x, _, _, _, v), got = pallas
    k = x.shape[1]
    xq, sx, xv = prologue.fused_prologue(t(x), port(v), 4, 0.9, rotate=True)
    assert np.array_equal(xq.numpy(), got["q_v"])
    assert scales_match_jitted(sx.numpy(), got["s_v"])
    xr = fwht_rows(t(x), k).numpy()
    vf = v.astype(np.float32)
    tol = 2.0 * (k + 1) * 2.0 ** -24 * (np.abs(xr) @ np.abs(vf) + np.abs(got["xv"])) + 1e-30
    assert np.all(np.abs(xv.numpy() - got["xv"]) <= tol)
    q0, s0, _ = prologue.fused_prologue(t(x), None, 4, 0.9, rotate=True)
    assert np.array_equal(q0.numpy(), got["q_nov"])
    assert scales_match_jitted(s0.numpy(), got["s_nov"])


def test_bf16_unfused_path_matches_the_reference(pallas):
    """Trap: with a bf16 x the reference's unfused path quantizes the
    rotated rows rounded to bf16 (its transform returns x's dtype).  The
    port's does the same: the rotated rows are bitwise the reference's, the
    codes and scales bitwise its eager oracle's on those rows, and the
    output within the LR bound of that oracle.  The reference's jitted
    quantizer may flip a code where x/s is a tie (bf16 rows make ties
    common); its output is held to the bound plus those flips.  The fused
    and chained paths keep the f32 rows, in both packages."""
    (x, wp, sw, u, v), got = pallas
    k, r = x.shape[1], v.shape[1]
    uf, vf = u.astype(np.float32), v.astype(np.float32)
    xb = port(bf16(x))
    xr = hadamard.fwht(xb)
    rows = got["xr_bf16"]
    assert np.array_equal(xr.to(torch.float32).numpy(), rows)
    xq, sx = actquant.act_quant(xr, 4, 0.9)
    qe, se = jref.act_quant_ref(jnp.asarray(rows), bits=4, clip_ratio=0.9)
    assert np.array_equal(xq.numpy(), np.asarray(qe))
    assert np.array_equal(sx.numpy(), np.asarray(se))
    assert scales_match_jitted(sx.numpy(), got["s_bf16"])
    flips = xq.numpy() != got["q_bf16"]
    ratio = rows / sx.numpy()
    assert np.all(np.abs(ratio - np.trunc(ratio))[flips] == 0.5)  # ties only
    assert np.all(np.abs(xq.numpy().astype(int) - got["q_bf16"])[flips] == 1)

    y = _forward(xb, wp, sw, u, v, impl="unfused").numpy()
    eager = np.asarray(jref.w4a4_lrc_forward_ref(
        jnp.asarray(rows), jnp.asarray(wp), jnp.asarray(sw), jnp.asarray(uf),
        jnp.asarray(vf), bits=4, clip_ratio=0.9))
    assert np.all(np.abs(y - eager) <= lr_tolerance(rows, vf, uf, k, r, eager))
    want = got["unfused_bfloat16"]
    wq = np.abs(unpack_int4_rows(t(wp)).numpy().astype(np.float64))
    flip_mag = (flips.astype(np.float64) @ wq) * sx.numpy() * sw[None, :]
    tol = (lr_tolerance(rows, vf, uf, k, r, want) + 2.0 ** -22 * np.abs(want)
           + 1.001 * flip_mag)
    assert np.all(np.abs(y - want) <= tol)

    frows = fwht_rows(xb.float(), k).numpy()
    for path in ("fused", "chained"):
        y = _forward(xb, wp, sw, u, v, impl=path).numpy()
        want = got[f"{path}_bfloat16"]
        tol = lr_tolerance(frows, vf, uf, k, r, want) + 2.0 ** -22 * np.abs(want)
        assert np.all(np.abs(y - want) <= tol), path
