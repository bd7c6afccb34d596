"""The port's dense causal flash attention (kernel #7's plain version,
``repro_torch/kernels/flash_attn.py::flash_attention_plain``) against the
reference's Pallas ``flash_attention_kernel`` in interpret mode (in
process: it runs on the installed jax) and against the reference's plain
``models/common.py::attention`` under ``causal_mask``, on the same numpy
inputs; and the forced kernel route through the port's ``forward``.

Tolerances (u = 2⁻²⁴, S = Σ_d |q_d·scale|·max_keys |k_d| per query row, N =
qpos + 1 keys, tiles = ⌈N/128⌉, v_max = max |v| of the kv head):

* against Pallas: both take the same f32 steps on the same 128-row key
  tiles and differ only in the order of three sums (the D-term score dot,
  Σp and p·V), so :func:`flash_bound` is 2·v_max·(2·D·u·S + 2·(N + 2·tiles
  + 4)·u); a bf16 output adds one bf16 ulp of the larger side (2⁻⁶|y|).
* against ``attention``: it scales the product instead of q (one more
  rounding per score: D + 1 in place of D) and normalizes once over all N
  keys (covered by the same N-term).  With bf16 inputs it also rounds the
  logits (relative 2⁻⁹ of S per score, which moves the weights by 2·2⁻⁹·S)
  and the probabilities (relative 2⁻⁹ each, at most 2⁻⁹·v_max on the
  output) to bf16 before p·V: :func:`attention_bound`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models import model as jax_model
from repro.models.common import attention as jax_attention
from repro.models.common import causal_mask as jax_causal_mask
from repro_torch import bridge
from repro_torch.kernels import flash_attn, ops
from repro_torch.kernels.context import KernelContext
from repro_torch.models import model
from repro_torch.models.common import causal_attention
from torch_parity import (bf16, configs, flash_bound, jax_params, jax_qlinears, port,
                          to_numpy_tree)

U = 2.0 ** -24
DTYPES = ["float32", "bfloat16"]
HEADS = [(3, 3), (6, 2)]  # (H, KH): G = 1 and G = 3
HEAD_DIMS = [64, 96]


def _inputs(seed, b, s, h, kh, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kh, kh)]
    return [bf16(a) if dtype == "bfloat16" else a for a in arrs]


def attention_bound(q, k, v, scale, y):
    tol, s_max, vmax = flash_bound(q, k, v, scale, y, extra_dot=1)
    if y.dtype.name == "bfloat16":
        tol = tol + 2 * vmax * 2 * 2.0 ** -9 * s_max + 2.0 ** -9 * vmax
    return tol


def _plain(q, k, v, scale, causal=True):
    return flash_attn.flash_attention_plain(port(q), port(k), port(v), scale,
                                            causal)


def _as_np(t):
    return bridge.tensor_to_numpy(t, bf16_dtype=jnp.bfloat16.dtype)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("heads", HEADS, ids=["G1", "G3"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(2, 96), (1, 256)])
def test_plain_matches_pallas(b, s, dtype, heads, d):
    h, kh = heads
    q, k, v = _inputs(s + d + h, b, s, h, kh, d, dtype)
    scale = d ** -0.5
    want = np.asarray(jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), scale))
    got = _plain(q, k, v, scale)
    assert got.dtype == port(q).dtype and tuple(got.shape) == (b, s, h, d)
    tol, _, _ = flash_bound(q, k, v, scale, want)
    err = np.abs(np.asarray(_as_np(got), np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("heads", HEADS, ids=["G1", "G3"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(2, 200), (3, 1), (1, 130), (2, 64)])
def test_plain_matches_attention(b, s, dtype, heads, d):
    """Any S, the last key tile ragged (S = 200, 130), and S = 1."""
    h, kh = heads
    q, k, v = _inputs(7 * s + d + h, b, s, h, kh, d, dtype)
    scale = d ** -0.5
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jax_causal_mask(s, s, 0), scale))
    got = _as_np(_plain(q, k, v, scale))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= attention_bound(q, k, v, scale, want))


def test_plain_non_causal_matches_attention():
    q, k, v = _inputs(5, 2, 150, 6, 2, 64, "float32")
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    None, 0.125))
    got = _plain(q, k, v, 0.125, causal=False).numpy()
    tol, s_max, vmax = flash_bound(q, k, v, 0.125, want, extra_dot=1)
    # every query row sees all 150 keys
    tol = tol + 2 * vmax * 2 * (150 - np.arange(1, 151))[None, :, None, None] * U
    assert np.all(np.abs(got - want) <= tol)


def test_plain_masks_only_later_keys():
    """A query row's result depends on its own keys only: the last query
    of a causal call is the non-causal call over the same keys (to the
    bound: the batched dots sum in another order), and the first is v[0]
    exactly (one key, weight 1)."""
    q, k, v = _inputs(9, 1, 140, 3, 1, 64, "float32")
    full = _plain(q, k, v, 0.125).numpy()
    last = _plain(q[:, -1:], k, v, 0.125, causal=False).numpy()
    tol, _, _ = flash_bound(q, k, v, 0.125, full)
    assert np.all(np.abs(full[:, -1:] - last) <= tol[:, -1:])
    assert np.array_equal(full[:, 0], np.repeat(v[:, 0], 3, axis=1))


def test_route_helper_and_launch_counts():
    q, k, v = (port(a) for a in _inputs(11, 2, 70, 6, 2, 64, "float32"))
    flash_attn.reset_launches()
    kern = causal_attention(q, k, v, 0.125, "kernel")
    ref = causal_attention(q, k, v, 0.125, "gather")
    assert flash_attn.LAUNCHES["flash_attention_plain"] == 1
    assert flash_attn.LAUNCHES["flash_attention"] == 0
    assert torch.equal(ops.flash_attention(q, k, v, 0.125), kern)
    tol, _, _ = flash_bound(q.numpy(), k.numpy(), v.numpy(), 0.125, ref.numpy(),
                            extra_dot=1)
    assert np.all(np.abs(kern.numpy() - ref.numpy()) <= tol)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    trees = {"float": jparams, "int8": jax_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    return jcfg, tcfg, trees, ported


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_forward_on_the_kernel_route(models, kind):
    """``forward`` with ``KernelContext(attention="kernel")`` runs the plain
    version once per layer; "auto" on the CPU keeps the reference's route.
    Logits agree with both the reference route and the JAX forward to the
    1e-4 of ``test_torch_model`` (f32 ulps of the frameworks' sums; with
    ``int8`` QLinears no activation code flips on this seed)."""
    jcfg, tcfg, trees, ported = models
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9))
    batch = {"tokens": torch.from_numpy(toks)}
    flash_attn.reset_launches()
    ref = model.forward(tcfg, ported[kind], batch)
    assert flash_attn.LAUNCHES["flash_attention_plain"] == 0
    got = model.forward(tcfg, ported[kind], batch,
                        ctx=KernelContext(attention="kernel"))
    assert flash_attn.LAUNCHES["flash_attention_plain"] == tcfg.n_layers
    assert flash_attn.LAUNCHES["flash_attention"] == 0
    want = np.asarray(jax_model.forward(jcfg, trees[kind],
                                        {"tokens": jnp.asarray(toks, jnp.int32)}))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attn.flash_attention(q, q, q, 0.25)
