"""The port's quantizers and row bodies against the reference's.

Every check here is bitwise: integer codes, packed bytes and scales are
the same IEEE operations in the same order on both sides (true division,
round half to even, the amax guard), so nothing may differ in any bit.
Only the (x·V) projection, a float sum, has a tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as jq
from repro.kernels import ref as jref
from repro.kernels import rowops as jrow
from repro_torch.core import quantizers as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rowops as trow
from torch_parity import t


def _rows(rng, m, k):
    """Random rows plus an all-zero row (the amax guard) and a row of exact
    .5 ties: with amax 7 and clip 1, s = 1 and x/s lands on k + 0.5."""
    x = rng.standard_normal((m, k)).astype(np.float32) * 3
    x[0] = 0.0
    ties = np.tile(np.array([7.0, 2.5, -3.5, 0.5, 1.5, -0.5, -6.5, 4.5],
                            np.float32), k // 8 + 1)[:k]
    x[1] = ties
    return x


@pytest.mark.parametrize("shape", [(64, 48), (19, 576), (7, 10)])
def test_pack_unpack_int4_bitwise(rng, shape):
    q = rng.integers(-8, 8, shape).astype(np.int8)
    jp = np.asarray(jq.pack_int4(jnp.asarray(q)))
    tp = tq.pack_int4(t(q)).numpy()
    assert tp.dtype == np.uint8 and np.array_equal(tp, jp)
    assert np.array_equal(tq.unpack_int4(t(tp)).numpy(), q)
    assert np.array_equal(np.asarray(jq.unpack_int4(jnp.asarray(jp))),
                          tq.unpack_int4(t(jp)).numpy())


def test_pack_odd_axis_raises():
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros((3, 5), dtype=torch.int8))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_weight_rtn_bitwise(rng, bits):
    w = rng.standard_normal((48, 96)).astype(np.float32) * 0.05
    w[3] = 0.0  # all-zero output channel: guarded scale
    spec_j, spec_t = jq.QuantSpec(bits=bits), tq.QuantSpec(bits=bits)
    qj, sj = jq.quantize_weight_rtn(jnp.asarray(w), spec_j)
    qt, st = tq.quantize_weight_rtn(t(w), spec_t)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    deq_j = jq.dequantize_weight(qj, sj, spec_j)
    deq_t = tq.dequantize_weight(qt, st, spec_t)
    assert np.array_equal(deq_t.numpy(), np.asarray(deq_j))


@pytest.mark.parametrize("clip", [1.0, 0.9])
@pytest.mark.parametrize("group", [None, 16])
def test_quantize_act_bitwise(rng, clip, group):
    x = _rows(rng, 6, 64)
    spec_j = jq.QuantSpec(bits=4, clip_ratio=clip, group_size=group)
    spec_t = tq.QuantSpec(bits=4, clip_ratio=clip, group_size=group)
    qj, sj = jq.quantize_act(jnp.asarray(x), spec_j)
    qt, st = tq.quantize_act(t(x), spec_t)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    fj = jq.fake_quant_act(jnp.asarray(x), spec_j)
    assert np.array_equal(tq.fake_quant_act(t(x), spec_t).numpy(), np.asarray(fj))


def test_quantize_act_bf16_bitwise(rng):
    """bf16 activations: the scale is computed in bf16 on both sides (the
    clip scalar takes the array's dtype first)."""
    x = (rng.standard_normal((8, 64)) * 2).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = t(x).to(torch.bfloat16)
    spec_j, spec_t = jq.QuantSpec(clip_ratio=0.9), tq.QuantSpec(clip_ratio=0.9)
    qj, sj = jq.quantize_act(xj, spec_j)
    qt, st = tq.quantize_act(xt, spec_t)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("clip", [1.0, 0.9])
@pytest.mark.parametrize("qmax", [7, 127])
def test_rowops_quantize_bitwise(rng, clip, qmax):
    x = _rows(rng, 5, 72)
    a_j = jrow.row_amax(jnp.asarray(x))
    a_t = trow.row_amax(t(x))
    assert np.array_equal(a_t.numpy(), np.asarray(a_j))
    s_j = jrow.amax_to_scale(a_j, qmax, clip)
    s_t = trow.amax_to_scale(a_t, qmax, clip)
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    assert np.array_equal(trow.quantize_rows(t(x), s_t, qmax).numpy(),
                          np.asarray(jrow.quantize_rows(jnp.asarray(x), s_j, qmax)))
    qj, sj = jrow.scale_round_quantize(jnp.asarray(x), qmax, clip)
    qt, st = trow.scale_round_quantize(t(x), qmax, clip)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    # the zero row takes the guarded scale; ties round half to even
    assert np.all(qt.numpy()[0] == 0)
    if clip == 1.0 and qmax == 7:
        assert list(qt.numpy()[1, :8]) == [7, 2, -4, 0, 2, 0, -6, 4]


def test_rowops_tiles_and_unpack(rng):
    for k, r in [(576, 58), (1536, 19), (5, 3), (9000, 700)]:
        assert trow.default_proj_tiles(k, r) == jrow.default_proj_tiles(k, r)
        assert trow.round_pow2(k) == jrow.round_pow2(k)
    wp = rng.integers(0, 256, (36, 19)).astype(np.uint8)
    assert np.array_equal(trow.unpack_int4_rows(t(wp)).numpy(),
                          np.asarray(jrow.unpack_int4_rows(jnp.asarray(wp))))


def test_project_rows_tiled(rng):
    """Float sums: the same per-chunk dots in the same order, within the
    f32 summation bound (MKL and XLA order each dot's terms differently)."""
    x = rng.standard_normal((4, 64)).astype(np.float32)
    v = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    pj = np.asarray(jrow.project_rows_tiled(jnp.asarray(x), jnp.asarray(v), 16, 8))
    pt = trow.project_rows_tiled(t(x), t(v), 16, 8).numpy()
    tol = 2 * 65 * 2.0 ** -24 * (np.abs(x) @ np.abs(v))
    assert np.all(np.abs(pt - pj) <= tol)


@pytest.mark.parametrize("clip", [1.0, 0.9])
def test_prologue_ref_bitwise(rng, clip):
    x = _rows(rng, 6, 96)
    v = (rng.standard_normal((96, 12)) * 0.05).astype(np.float32)
    qj, sj = jref.act_quant_ref(jnp.asarray(x), bits=4, clip_ratio=clip)
    qt, st = tref.act_quant_ref(t(x), bits=4, clip_ratio=clip)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    qj, sj, xvj = jref.fused_prologue_ref(jnp.asarray(x), jnp.asarray(v),
                                          clip_ratio=clip)
    qt, st, xvt = tref.fused_prologue_ref(t(x), t(v), clip_ratio=clip)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    tol = 2 * 97 * 2.0 ** -24 * (np.abs(x) @ np.abs(v)) + 1e-30
    assert np.all(np.abs(xvt.numpy() - np.asarray(xvj)) <= tol)
    # the rotated oracle: its K (96) is no power of two, as in the reference
    with pytest.raises(ValueError):
        tref.fused_prologue_ref(t(x), rotate=True)
    xr, vr = x[:, :64], v[:64]
    qj, sj, xvj = jref.fused_prologue_ref(jnp.asarray(xr), jnp.asarray(vr),
                                          clip_ratio=clip, rotate=True)
    qt, st, xvt = tref.fused_prologue_ref(t(xr), t(vr), clip_ratio=clip, rotate=True)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    rot = np.asarray(jref.fwht_ref(jnp.asarray(xr)))
    tol = 2 * 65 * 2.0 ** -24 * (np.abs(rot) @ np.abs(vr)) + 1e-30
    assert np.all(np.abs(xvt.numpy() - np.asarray(xvj)) <= tol)
