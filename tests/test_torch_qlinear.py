"""The port's QLinear against the reference's, on bridged layers.

Tolerances: ``int8`` codes, scales and the int32 GEMM are bitwise on both
sides, and so is ``sim``'s fake-quant; what differs is the float sums.
  * the f32 GEMM of ``sim`` (K terms): the f32 summation bound;
  * the LR term, multiplied in bf16 by ``sim``/``int8``: each side rounds
    x·V and (x·V)·Uᵀ to bf16 once after an f32 sum, so they may differ by
    one bf16 rounding of each (2⁻⁸ relative) when the f32 sums straddle a
    rounding boundary — bounded here by 2⁻⁶ of the absolute LR terms;
  * the kernel path: the LR sums in f32, as in ``test_torch_fused_gemm``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.quant import qlinear as jql
from repro_torch import bridge
from repro_torch.quant import qlinear as tql
from torch_parity import lr_tolerance, t, to_numpy_tree


def _layers(seed, k, n, r, clip=0.9):
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 8, (n, k)).astype(np.int8)
    s = (rng.random((n, 1)) * 0.02 + 0.001).astype(np.float32)
    u = (rng.standard_normal((n, r)) * 0.05).astype(np.float32) if r else None
    v = (rng.standard_normal((k, r)) * 0.05).astype(np.float32) if r else None
    jq = jql.make_qlinear(jnp.asarray(q), jnp.asarray(s),
                          None if u is None else jnp.asarray(u),
                          None if v is None else jnp.asarray(v),
                          clip_ratio=clip, impl="int8", name="attn/wq")
    tq = tql.make_qlinear(t(q), t(s), None if u is None else t(u),
                          None if v is None else t(v), clip_ratio=clip,
                          impl="int8", name="attn/wq")
    x = (rng.standard_normal((3, 5, k)) * 2).astype(np.float32)
    return jq, tq, x


def _bridged(jq):
    return bridge.params_from_jax({"w": to_numpy_tree(jq)}, device="cpu")["w"]


def _lr_mag(q, x):
    if q.u is None:
        return 0.0
    u = np.asarray(q.u, np.float32)
    v = np.asarray(q.v, np.float32)
    return (np.abs(x) @ np.abs(v)) @ np.abs(u).T


@pytest.mark.parametrize("k,n,r", [(64, 48, 6), (96, 33, 0), (576, 192, 19)])
def test_make_qlinear_and_bridge_bitwise(k, n, r):
    jq, tq, _ = _layers(1, k, n, r)
    bq = _bridged(jq)
    for name in ("qweight", "w_scale", "u", "v"):
        a, b, c = getattr(jq, name), getattr(tq, name), getattr(bq, name)
        if a is None:
            assert b is None and c is None
            continue
        ref = np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else np.asarray(a)
        for got in (b, c):
            arr = bridge.tensor_to_numpy(got)
            assert arr.dtype == ref.dtype and np.array_equal(arr, ref), name
    assert (bq.d_in, bq.d_out, bq.clip_ratio, bq.name) == (k, n, 0.9, "attn/wq")


@pytest.mark.parametrize("impl", ["sim", "int8"])
@pytest.mark.parametrize("k,n,r", [(64, 48, 6), (96, 33, 0), (576, 192, 19)])
def test_plain_impls_match_reference(impl, k, n, r):
    jq, _, x = _layers(2, k, n, r)
    jq = jql.retag_qlinear_impl(jq, impl)
    bq = tql.retag_qlinear_impl(_bridged(jq), impl)
    want = np.asarray(jql.qlinear_apply(jq, jnp.asarray(x)))
    got = tql.qlinear_apply(bq, t(x)).numpy()
    w = np.abs(np.asarray(jql._unpack_w(jq), np.float32) * np.asarray(jq.w_scale))
    gemm = (np.abs(x) @ w) * (2 * (k + 1) * 2.0 ** -24)  # sim's f32 GEMM sum
    tol = gemm + 2.0 ** -6 * _lr_mag(jq, x) + 2.0 ** -23 * np.abs(want) + 1e-30
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("impl", ["pallas", "fused"])
@pytest.mark.parametrize("k,n,r", [(64, 48, 6), (96, 33, 0), (576, 192, 19)])
def test_kernel_path_matches_reference(impl, k, n, r):
    jq, _, x = _layers(3, k, n, r)
    bq = tql.retag_qlinear_impl(_bridged(jq), impl)
    x2 = x.reshape(-1, k)
    want = np.asarray(jref.w4a4_lrc_forward_ref(
        jnp.asarray(x2), jq.qweight, jq.w_scale, jq.u, jq.v, bits=4,
        clip_ratio=0.9)).reshape(*x.shape[:-1], n)
    got = tql.qlinear_apply(bq, t(x)).numpy()
    u = None if jq.u is None else np.asarray(jq.u, np.float32)
    v = None if jq.v is None else np.asarray(jq.v, np.float32)
    tol = lr_tolerance(x, v, u, k, r, want)
    assert got.shape == want.shape and np.all(np.abs(got - want) <= tol)


def test_apply_linear_dense_and_bf16_cast():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    x = rng.standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(jql.apply_linear(jnp.asarray(w), jnp.asarray(x)))
    got = tql.apply_linear(t(w), t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the kernel path returns the activations' dtype, as the reference does
    jq, _, _ = _layers(5, 64, 48, 6)
    bq = tql.retag_qlinear_impl(_bridged(jq), "pallas")
    y = tql.qlinear_apply(bq, torch.ones((2, 64), dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 48)


def test_retag_auto_keeps_impl_on_cpu_and_rejects_typos():
    jq, _, _ = _layers(6, 64, 48, 6)
    tree = {"layers": [{"attn": {"wq": _bridged(jq)}}]}
    assert tql.retag_qlinear_impl(tree, "auto", device="cpu") is tree
    cuda = tql.retag_qlinear_impl(tree, "auto", device="cuda")
    assert cuda["layers"][0]["attn"]["wq"].impl == "pallas"
    with pytest.raises(ValueError):
        tql.retag_qlinear_impl(tree, "palas")
