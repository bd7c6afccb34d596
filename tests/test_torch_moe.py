"""The port's moe family (``repro_torch/models/moe.py``, ``deepseek.py``)
against the reference's on bridged parameters of the reduced DeepSeek-V2
(softmax router) and DeepSeek-V3 (sigmoid router, MTP parameters carried):
2 layers (one dense-FFN, one MoE), d_model 64, 8 experts top-2, f32.

* The router: top-k indices bitwise, ties included (rows of zeros, where
  every expert scores alike, and routers whose expert columns come in equal
  pairs); the renormalised weights within 1e-6 (the two frameworks' f32
  softmax and sums round differently by an ulp).
* ``moe_block``, ``forward``, ``prefill`` and ``decode_step``: float and
  ``int8`` W4A4+LRC QLinears (experts stacked on the expert axis), within
  1e-4 absolute of the reference (f32 matmuls, softmax and norms summed in
  another order: a few ulp of their scale per layer, as in
  ``test_torch_model``); the latent caches likewise, their offsets equal.
  Every int8 QLinear is bitwise the reference's on the same input and
  ``moe_block`` holds 1e-4 with them; through the whole model the inputs
  differ by those ulps, and with every expert computing every token a row
  meets 3·E + 11 sites, so a 4-bit activation code that sits at a rounding
  boundary flips somewhere in most rows, moving it by one quantization
  step's product (measured: up to 5.4e-4 on logits of order 2 over six
  token seeds).  The int8 model outputs are held to 2e-3.
* The bridge: a quantized moe tree round-trips bitwise, its layer groups
  unstacked and its experts keeping the (E, …) axis; the nested latent
  caches cross both ways.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import deepseek as jax_deepseek
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.quant.policy import QuantPolicy as JaxQuantPolicy
from repro.quant.policy import path_str as jax_path_str
from repro_torch import bridge
from repro_torch.models import model, moe
from repro_torch.quant.policy import QuantPolicy, path_str
from repro_torch.quant.qlinear import QLinear, expert
from torch_moe_parity import ARCHS, GROUPS, ds_configs, ds_params, ds_qlinears
from torch_parity import to_numpy_tree

ATOL = 1e-4
INT8_ATOL = 2e-3
W_TOL = 1e-6


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = ds_configs(request.param)
    jparams = ds_params(jcfg)
    trees = {"float": jparams, "int8": ds_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    return jcfg, tcfg, trees, ported


def _layer(tree, group, li):
    return jax.tree.map(lambda a: a[li], tree[group])


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _router_cases(d, e):
    """(rows, router) pairs: random rows; rows of zeros (every expert
    scores alike); a router whose expert columns come in equal pairs."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * d**-0.5).astype(np.float32)
    paired = router.copy()
    paired[:, 1::2] = paired[:, 0::2]
    zeros = np.concatenate([x[:3], np.zeros((3, d), np.float32)])
    return [(x, router), (zeros, router), (x, paired)]


@pytest.mark.parametrize("case", range(3))
def test_router_weights_bitwise_indices(setup, case):
    jcfg, tcfg, _, _ = setup
    x, router = _router_cases(tcfg.d_model, tcfg.n_experts)[case]
    jw, jidx = jax_moe.router_weights(jcfg, {"router": jnp.asarray(router)}, jnp.asarray(x))
    tw, tidx = moe.router_weights(tcfg, {"router": torch.from_numpy(router)},
                                  torch.from_numpy(x))
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw, W_TOL)
    assert (tw > 0).sum(-1).eq(tcfg.moe_top_k).all()
    if case == 1:  # a row of zeros: the first top_k experts, in order
        assert tidx[3:].tolist() == [list(range(tcfg.moe_top_k))] * 3


def test_top_k_takes_the_lower_index_first():
    scores = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9], [1.0, 1.0, 1.0, 1.0, 1.0]])
    vals, idx = moe.top_k(scores, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert torch.equal(vals, torch.tensor([[0.9, 0.9, 0.9], [1.0, 1.0, 1.0]]))


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_moe_block(setup, kind):
    jcfg, tcfg, trees, ported = setup
    x = np.random.default_rng(4).standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jp = _layer(trees[kind], "moe_layers", 0)["moe"]
    tp = ported[kind]["moe_layers"][0]["moe"]
    if kind == "int8":
        wg = tp["experts"]["wg"]
        assert isinstance(wg, QLinear) and wg.qweight.shape[0] == tcfg.n_experts
        assert isinstance(tp["shared"]["wd"], QLinear) and torch.is_tensor(tp["router"])
    want = jax_moe.moe_block(jcfg, jp, jnp.asarray(x))
    got = moe.moe_block(tcfg, tp, torch.from_numpy(x))
    _close(got, want)
    got, drops = moe.moe_block(tcfg, tp, torch.from_numpy(x), return_stats=True)
    assert int(drops) == 0 and drops.dtype == torch.int32
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        moe.moe_block(tcfg, tp, torch.from_numpy(x), impl="ep")


def test_expert_view_is_the_stacked_slice(setup):
    _, _, _, ported = setup
    q = ported["int8"]["moe_layers"][0]["moe"]["experts"]["wd"]
    one = expert(q, 3)
    assert torch.equal(one.qweight, q.qweight[3]) and one.qweight.is_contiguous()
    assert torch.equal(one.u, q.u[3]) and torch.equal(one.v, q.v[3])
    assert (one.d_in, one.d_out) == (q.d_in, q.d_out)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_forward_logits(setup, kind):
    jcfg, tcfg, trees, ported = setup
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9))
    want = jax_model.forward(jcfg, trees[kind], {"tokens": jnp.asarray(toks)})
    got = model.forward(tcfg, ported[kind], {"tokens": torch.from_numpy(toks)})
    _close(got, want, ATOL if kind == "float" else INT8_ATOL)


def _caches_close(tc, jc, atol=ATOL):
    for key in jc:
        for leaf in ("c_kv", "k_rope"):
            _close(tc[key][leaf], jc[key][leaf], atol)
        assert int(tc[key]["offset"]) == int(jc[key]["offset"])
        assert tc[key]["offset"].dtype == torch.int32 and tc[key]["offset"].dim() == 0


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_prefill_then_decode_steps(setup, kind):
    """A 7-token prefill into an f32 cache of 16 rows, then three decode
    steps at B = 2: logits and caches each step."""
    jcfg, tcfg, trees, ported = setup
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 7))
    jc = jax_model.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    tc = model.init_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    tol = ATOL if kind == "float" else INT8_ATOL
    jl, jc = jax_model.prefill(jcfg, trees[kind], {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = model.prefill(tcfg, ported[kind], {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, tol)
    _caches_close(tc, jc, tol)
    for _ in range(3):
        step = rng.integers(0, jcfg.vocab_size, (2, 1))
        jl, jc = jax_model.decode_step(jcfg, trees[kind], jnp.asarray(step), jc)
        tl, tc = model.decode_step(tcfg, ported[kind], torch.from_numpy(step), tc)
        _close(tl, jl, tol)
        _caches_close(tc, jc, tol)
    jl, jc, js = jax_model.decode_step(jcfg, trees[kind], jnp.asarray(step), jc,
                                       with_stats=True)
    tl, tc, ts = model.decode_step(tcfg, ported[kind], torch.from_numpy(step), tc,
                                   with_stats=True)
    _close(tl, jl, tol)
    assert int(ts["ep_dropped"]) == int(js["ep_dropped"]) == 0


def test_init_params_and_cache_layout(setup):
    jcfg, tcfg, trees, _ = setup
    params = model.init_params(tcfg, seed=0, device="cpu")
    want = to_numpy_tree(trees["float"])
    assert set(params) == set(want)
    for group in GROUPS:
        assert len(params[group]) == np.asarray(
            jax.tree.leaves(trees["float"][group])[0]).shape[0]
        got = bridge.params_to_numpy({group: params[group]})[group]
        shapes = jax.tree.map(lambda a: a.shape, got)
        assert shapes == jax.tree.map(lambda a: a.shape, want[group])
    assert ("mtp" in params) == (tcfg.mtp_depth > 0)
    cache = model.init_cache(tcfg, 1, 8, device="cpu")
    jcache = jax_model.init_cache(jcfg, 1, 8)
    assert set(cache) == set(jcache)
    for key in cache:
        assert {k: tuple(v.shape) for k, v in cache[key].items()} == \
            {k: tuple(v.shape) for k, v in jcache[key].items()}
    with pytest.raises(ValueError, match="paged"):
        from repro_torch.serve.kvquant import KVSpec

        model.init_cache(tcfg, 1, 8, device="cpu", kv_spec=KVSpec("int8"))
    # the moe training loss is ported (test_torch_moe_train holds it to the
    # reference): a finite f32 scalar
    loss = model.loss_fn(tcfg, params, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert loss.shape == () and loss.dtype == torch.float32 and torch.isfinite(loss)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def test_should_quantize_matches_reference(setup):
    """The port's site patterns and path spelling pick the reference's
    sites on every leaf of the moe tree: the MLA projections, the dense
    and shared FFNs and the experts; not the router, norms, embedding or
    lm head."""
    _, _, trees, _ = setup
    ours, ref = QuantPolicy(), JaxQuantPolicy()
    picked = []
    for path, leaf in _paths(to_numpy_tree(trees["float"])):
        want = ref.should_quantize(jax_path_str(path), leaf.shape)
        assert QuantPolicy().should_quantize(path_str(path), leaf.shape) == want
        assert ours.should_quantize(path_str(path), leaf.shape) == want
        if want:
            picked.append(path[-1])
    assert "router" not in picked and "embed" not in picked and "lm_head" not in picked
    assert {"wq_a", "wq_b", "wkv_a", "wkv_b", "wo", "wg", "wu", "wd"} <= set(picked)


def _leaves_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def test_bridge_round_trip_of_a_quantized_moe_tree(setup):
    jcfg, tcfg, trees, ported = setup
    tree = to_numpy_tree(trees["int8"])
    p = ported["int8"]
    assert [len(p[g]) for g in GROUPS] == [tcfg.n_dense_layers,
                                           tcfg.n_layers - tcfg.n_dense_layers]
    experts = p["moe_layers"][0]["moe"]["experts"]
    assert experts["wg"].qweight.shape == (tcfg.n_experts, tcfg.d_model // 2, tcfg.d_expert)
    assert experts["wd"].v.shape[:2] == (tcfg.n_experts, tcfg.d_expert)
    assert isinstance(p["dense_layers"][0]["attn"]["wkv_b"], QLinear)
    assert torch.is_tensor(p["moe_layers"][0]["moe"]["router"])
    if tcfg.mtp_depth:
        assert torch.is_tensor(p["mtp"]["proj"])  # carried, not quantized
    back = bridge.params_to_numpy(p, bf16_dtype=ml_dtypes.bfloat16)
    _leaves_equal(tree, back)


def test_bridge_carries_the_latent_caches(setup):
    jcfg, tcfg, trees, ported = setup
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (1, 5))
    jc = jax_model.init_cache(jcfg, 1, 12, dtype=jnp.float32)
    _, jc = jax_model.prefill(jcfg, trees["float"], {"tokens": jnp.asarray(toks)}, jc)
    tc = bridge.cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert int(tc["moe"]["offset"]) == 5 and tc["moe"]["offset"].dtype == torch.int32
    back = bridge.cache_to_numpy(tc)
    _leaves_equal(jax.tree.map(np.asarray, jc), back)
    # the port continues from the reference's cache as the reference does
    step = np.array([[3]])
    jl, _ = jax_model.decode_step(jcfg, trees["float"], jnp.asarray(step), jc)
    tl, _ = model.decode_step(tcfg, ported["float"], torch.from_numpy(step), tc)
    _close(tl, jl)


def test_mtp_block_matches_reference_params():
    """V3's MTP parameters: the reference's structure, one unstacked
    block, bridged as it is (its head and loss wait for MoE training)."""
    jcfg, tcfg = ds_configs("deepseek-v3-671b")
    jparams = ds_params(jcfg)
    assert "mtp" in jparams and jcfg.mtp_depth == tcfg.mtp_depth == 1
    p = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    blk = p["mtp"]["block"]
    assert blk["mlp"]["wg"].shape == (tcfg.d_model, tcfg.d_ff_dense)
    assert blk["attn"]["wkv_b"].shape == tuple(jparams["mtp"]["block"]["attn"]["wkv_b"].shape)
    h = np.random.default_rng(8).standard_normal((1, 4, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(4), (1, 4))
    mask = np.tril(np.ones((4, 4), bool))
    want, _, _ = jax_deepseek._block_forward(jcfg, jparams["mtp"]["block"], jnp.asarray(h),
                                             jnp.asarray(pos), jnp.asarray(mask), None,
                                             False, "dense")
    from repro_torch.models import deepseek

    got, _ = deepseek._block_forward(tcfg, blk, torch.from_numpy(h),
                                     torch.from_numpy(pos.copy()),
                                     torch.from_numpy(mask), None, False, "dense",
                                     "gather", None, None)
    _close(got, want)
