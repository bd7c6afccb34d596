"""The port's Multi-head Latent Attention (``repro_torch/models/mla.py``)
and its contiguous cache update against the reference's, on bridged
parameters of the reduced DeepSeek-V2 and -V3 (f32, 4 heads, q_lora 32,
kv_lora 16, rope 8, nope 8, v 16).

* ``mla_attention_block`` cache-free under the causal mask, with a
  contiguous cache (a prefill, then three decode steps: outputs, both
  latent caches and the offset), and weight-absorbed (``cfg.mla_absorb``,
  float and with an ``int8`` QLinear ``wkv_b``, whose effective weight the
  absorbed path reads): within 1e-5 absolute of the reference (f32
  products and softmax summed in another order; measured ≤ 1e-6 on outputs
  of order 4).
* The kernel route (#7's plain version on the CPU) against the gather
  route at D != Dv (v_head_dim 24 against nope + rope 16): every call
  through #7 (its launches counted), cache-free, at prefill (``q_start``
  0) and at decode (``q_start`` the offset), within 1e-5 of the gather
  route and of the reference (the online softmax sums in 128-row key
  tiles; ``torch_parity.flash_bound`` is ~1e-6 at these sizes).
* ``cache_update``: the reference's ``dynamic_update_slice``, bitwise, at
  the last offset that fits, past it and below 0 (``jax.lax`` counts a
  negative start from the end, then clamps it; the engine keeps its bounds
  so that neither is reached).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jax_common
from repro.models import mla as jax_mla
from repro.models import model as jax_model
from repro_torch import bridge
from repro_torch.kernels import flash_attn
from repro_torch.kernels.context import KernelContext
from repro_torch.models import common, deepseek, mla, model
from torch_moe_parity import ARCHS, ds_configs, ds_params, ds_qlinears
from torch_parity import to_numpy_tree

ATOL = 1e-5
S, SMAX = 7, 16


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = ds_configs(request.param)
    jparams = ds_params(jcfg)
    trees = {"float": jparams, "int8": ds_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    return jcfg, tcfg, trees, ported


def _attn(tree, li=0, group="moe_layers"):
    return jax.tree.map(lambda a: a[li], tree[group])["attn"]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _inputs(d, b=2, s=S, seed=0):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return x, pos


def _run_both(jcfg, tcfg, jp, tp, x, pos, mask, jcache=None, tcache=None, **kw):
    mask = None if mask is None else np.array(mask)
    want, jc = jax_mla.mla_attention_block(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                           None if mask is None else jnp.asarray(mask),
                                           jcache)
    got, tc = mla.mla_attention_block(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                      None if mask is None else torch.from_numpy(mask),
                                      tcache, **kw)
    return want, jc, got, tc


def test_cache_free_block(setup):
    jcfg, tcfg, trees, ported = setup
    x, pos = _inputs(tcfg.d_model)
    mask = np.tril(np.ones((S, S), bool))
    want, _, got, _ = _run_both(jcfg, tcfg, _attn(trees["float"]),
                                ported["float"]["moe_layers"][0]["attn"], x, pos, mask)
    _close(got, want)


def _fresh_caches(jcfg, tcfg, b=2):
    jc = dict(c_kv=jnp.zeros((b, SMAX, jcfg.kv_lora_rank), jnp.float32),
              k_rope=jnp.zeros((b, SMAX, jcfg.qk_rope_dim), jnp.float32),
              offset=jnp.zeros((), jnp.int32))
    tc = dict(c_kv=torch.zeros((b, SMAX, tcfg.kv_lora_rank)),
              k_rope=torch.zeros((b, SMAX, tcfg.qk_rope_dim)),
              offset=torch.zeros((), dtype=torch.int32))
    return jc, tc


def _cache_close(tc, jc):
    _close(tc["c_kv"], jc["c_kv"])
    _close(tc["k_rope"], jc["k_rope"])
    assert int(tc["offset"]) == int(jc["offset"]) and tc["offset"].dtype == torch.int32


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_cached_prefill_then_three_decode_steps(setup, kind):
    jcfg, tcfg, trees, ported = setup
    jp, tp = _attn(trees[kind], 0, "dense_layers"), ported[kind]["dense_layers"][0]["attn"]
    jc, tc = _fresh_caches(jcfg, tcfg)
    x, pos = _inputs(tcfg.d_model, seed=1)
    mask = np.asarray(jax_common.causal_mask(S, SMAX, 0))
    want, jc, got, tc = _run_both(jcfg, tcfg, jp, tp, x, pos, mask, jc, tc)
    _close(got, want)
    _cache_close(tc, jc)
    for step in range(3):
        off = S + step
        x1, _ = _inputs(tcfg.d_model, s=1, seed=10 + step)
        p1 = np.full((2, 1), off)
        m1 = (np.arange(SMAX) <= off)[None, :]
        want, jc, got, tc = _run_both(jcfg, tcfg, jp, tp, x1, p1, m1, jc, tc)
        _close(got, want)
        _cache_close(tc, jc)
    assert int(tc["offset"]) == S + 3


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_absorbed_block(setup, kind):
    jcfg, tcfg, trees, ported = setup
    jcfg, tcfg = (dataclasses.replace(c, mla_absorb=True) for c in (jcfg, tcfg))
    jp, tp = _attn(trees[kind]), ported[kind]["moe_layers"][0]["attn"]
    x, pos = _inputs(tcfg.d_model, seed=2)
    mask = np.tril(np.ones((S, S), bool))
    want, _, got, _ = _run_both(jcfg, tcfg, jp, tp, x, pos, mask)
    _close(got, want)
    np.testing.assert_allclose(mla._effective_weight(tp["wkv_b"]).numpy(),
                               np.asarray(jax_mla._effective_weight(jp["wkv_b"])),
                               rtol=0, atol=1e-6)
    # cached: a prefill and one decode step
    jc, tc = _fresh_caches(jcfg, tcfg)
    cmask = np.asarray(jax_common.causal_mask(S, SMAX, 0))
    want, jc, got, tc = _run_both(jcfg, tcfg, jp, tp, x, pos, cmask, jc, tc)
    _close(got, want)
    x1, _ = _inputs(tcfg.d_model, s=1, seed=3)
    want, jc, got, tc = _run_both(jcfg, tcfg, jp, tp, x1, np.full((2, 1), S),
                                  (np.arange(SMAX) <= S)[None, :], jc, tc)
    _close(got, want)
    _cache_close(tc, jc)


def test_absorbed_agrees_with_naive(setup):
    """The absorbed path computes the naive path's function."""
    _, tcfg, _, ported = setup
    tp = ported["float"]["moe_layers"][0]["attn"]
    x, pos = _inputs(tcfg.d_model, seed=4)
    mask = torch.from_numpy(np.tril(np.ones((S, S), bool)))
    naive, _ = mla.mla_attention_block(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                       mask)
    absorbed, _ = mla.mla_attention_block(dataclasses.replace(tcfg, mla_absorb=True), tp,
                                          torch.from_numpy(x), torch.from_numpy(pos), mask)
    _close(absorbed, naive.numpy())


@pytest.fixture(scope="module")
def wide_v():
    """Reduced DeepSeek-V2 with v_head_dim 24 != nope + rope = 16."""
    jcfg, tcfg = ds_configs("deepseek-v2-236b", v_head_dim=24)
    jparams = ds_params(jcfg)
    return jcfg, tcfg, jparams, bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")


KERNEL = KernelContext(attention="kernel")
GATHER = KernelContext(attention="gather")


def test_kernel_route_against_gather_at_d_ne_dv(wide_v):
    jcfg, tcfg, jparams, params = wide_v
    assert tcfg.attn_head_dim == 16 and tcfg.v_head_dim == 24
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 9))
    flash_attn.reset_launches()
    k = model.forward(tcfg, params, {"tokens": torch.from_numpy(toks)}, ctx=KERNEL)
    assert flash_attn.LAUNCHES["flash_attention_plain"] == tcfg.n_layers
    g = model.forward(tcfg, params, {"tokens": torch.from_numpy(toks)}, ctx=GATHER)
    want = jax_model.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    _close(k, g.numpy())
    _close(k, want)
    # prefill (q_start 0) then two decode steps (q_start the offset)
    caches = {r: model.init_cache(tcfg, 2, SMAX, dtype=torch.float32, device="cpu")
              for r in ("kernel", "gather")}
    jc = jax_model.init_cache(jcfg, 2, SMAX, dtype=jnp.float32)
    step = toks[:, :5]
    flash_attn.reset_launches()
    for i in range(3):
        out = {}
        for route, ctx in (("kernel", KERNEL), ("gather", GATHER)):
            fn = model.prefill if i == 0 else None
            if i == 0:
                out[route], caches[route] = fn(tcfg, params, {"tokens": torch.from_numpy(step)},
                                               caches[route], ctx=ctx)
            else:
                out[route], caches[route] = model.decode_step(
                    tcfg, params, torch.from_numpy(step), caches[route], ctx=ctx)
        if i == 0:
            want, jc = jax_model.prefill(jcfg, jparams, {"tokens": jnp.asarray(step)}, jc)
        else:
            want, jc = jax_model.decode_step(jcfg, jparams, jnp.asarray(step), jc)
        _close(out["kernel"], out["gather"].numpy())
        _close(out["kernel"], want)
        assert flash_attn.LAUNCHES["flash_attention_plain"] == tcfg.n_layers * (i + 1)
        step = toks[:, 5 + i:6 + i]
    for key in ("dense", "moe"):
        _close(caches["kernel"][key]["c_kv"], caches["gather"][key]["c_kv"].numpy())


def test_decode_kernel_route_passes_the_offset_as_q_start(wide_v, monkeypatch):
    """At decode the kernel gets q_start = the cache offset, (B,) int32 on
    the device of the activations; at prefill 0."""
    _, tcfg, _, params = wide_v
    seen = []
    real = flash_attn.flash_attention

    def spy(q, k, v, scale, causal=True, q_start=None):
        seen.append((q.shape[1], k.shape[1], None if q_start is None else q_start.tolist(),
                     None if q_start is None else q_start.dtype))
        return real(q, k, v, scale, causal, q_start)

    monkeypatch.setattr(flash_attn, "flash_attention", spy)
    cache = model.init_cache(tcfg, 2, SMAX, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 4)))
    _, cache = model.prefill(tcfg, params, {"tokens": toks}, cache, ctx=KERNEL)
    _, cache = model.decode_step(tcfg, params, toks[:, :1], cache, ctx=KERNEL)
    assert seen[0] == (4, SMAX, [0, 0], torch.int32)
    assert seen[-1] == (1, SMAX, [4, 4], torch.int32)
    assert len(seen) == 2 * tcfg.n_layers


@pytest.mark.parametrize("offset", [0, SMAX - 3, SMAX - 1, SMAX + 5, -2])
def test_cache_update_is_dynamic_update_slice(offset):
    rng = np.random.default_rng(7)
    cache = rng.standard_normal((2, SMAX, 5)).astype(np.float32)
    upd = rng.standard_normal((2, 3, 5)).astype(np.float32)
    want = np.asarray(jax_common.cache_update(jnp.asarray(cache), jnp.asarray(upd),
                                              jnp.asarray(offset, jnp.int32)))
    got = common.cache_update(torch.from_numpy(cache), torch.from_numpy(upd),
                              torch.tensor(offset, dtype=torch.int32))
    assert np.array_equal(got.numpy(), want)
    # the input cache is left as it was (functional, as the reference)
    assert not np.shares_memory(got.numpy(), cache)
    got = common.cache_update(torch.from_numpy(cache), torch.from_numpy(upd), offset)
    assert np.array_equal(got.numpy(), want)


def test_deepseek_routes_by_the_mla_head_dim(wide_v):
    _, tcfg, _, _ = wide_v
    assert deepseek._route(tcfg, None, torch.device("cpu")) == "gather"
    assert deepseek._route(tcfg, KERNEL, torch.device("cpu")) == "kernel"
