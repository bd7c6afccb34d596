"""Quantized-KV serving in the port against the reference: ``KVSpec``
geometry and meta, the quantize / dequantize spellings (bitwise), the
quantized page scatter (bitwise), ``paged_step`` with every spec on the
gather route, the engine's token streams and ``health()["kv"]``, the
scale-plane sidecar of the allocator (property-tested), and the forced
kernel route of the decode attention (the kernels' plain versions here).

Tolerances: logits and float pools against the reference within ATOL =
1e-4 (``test_torch_model``: the frameworks order their f32 sums
differently, 4e-7 measured).  For the same reason the k/v rows that enter
the pool differ by ulps between the two packages: a bf16 page may then
round to the neighbouring bf16 value (one bf16 ulp, 2⁻⁷ relative, beside
ATOL), a scale amax/qmax moves by at most ATOL/qmax (plus its own two
roundings), and a code could flip at a rounding boundary (none does with
these seeds).  On identical rows codes and scales are bitwise
(:func:`test_quantized_scatter_bitwise`)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import model as jax_model
from repro.models.common import (
    paged_cache_update_quantized as jax_paged_cache_update_quantized)
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kvquant import KVSpec as JaxKVSpec
from repro.serve.kvquant import dequantize_kv as jax_dequantize_kv
from repro.serve.kvquant import quantize_kv as jax_quantize_kv
from repro_torch import bridge
from repro_torch.kernels import flash_attn
from repro_torch.kernels.context import KernelContext
from repro_torch.models import model
from repro_torch.models.common import paged_cache_update_quantized
from repro_torch.serve.engine import Request, RequestState, ServeEngine
from repro_torch.serve.kvquant import KVSpec, dequantize_kv, quantize_kv
from repro_torch.serve.paging import NULL_PAGE, PageAllocator
from torch_parity import bf16, configs, jax_params, jax_qlinears, port, to_numpy_tree

ATOL = 1e-4
KW = dict(batch_slots=2, max_seq=32, page_size=4, prefill_chunk=4)
SPECS = [KVSpec(), KVSpec("bf16"), KVSpec("int8"), KVSpec("int8", group=8),
         KVSpec("int4"), KVSpec("int4", group=8)]
KERNEL_ROUTE = KernelContext(attention="kernel")


def jspec(spec):
    return JaxKVSpec(spec.dtype, spec.group)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    trees = {"float": jparams, "int8": jax_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    return jcfg, tcfg, trees, ported


def _prompts(cfg, seed=3, lengths=(7, 3, 10, 5)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]


def _serve(cfg, params, prompts, new_tokens=6, **kw):
    eng = ServeEngine(cfg, params, device="cpu", **{**KW, **kw})
    for i, p in enumerate(prompts):
        assert eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    done = eng.run()
    assert all(rec.status is RequestState.FINISHED for rec in done.values())
    return eng, {rid: rec.out_tokens for rid, rec in done.items()}


# ---------------------------------------------------------------------------
# KVSpec and the quantize / dequantize spellings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS + [KVSpec("int4", group=128),
                                          KVSpec("int8", group=32)],
                         ids=lambda s: s.describe())
def test_kvspec_geometry_and_meta_match_reference(spec):
    ref = jspec(spec)
    assert spec.is_quantized == ref.is_quantized
    assert spec.describe() == ref.describe()
    assert spec.to_meta() == ref.to_meta()
    assert KVSpec.from_meta(spec.to_meta()) == spec
    assert KVSpec.from_flags(spec.dtype, spec.group) == spec
    assert str(spec.pool_dtype).split(".")[-1] == str(jnp.dtype(ref.pool_dtype))
    if spec.is_quantized:
        assert (spec.bits, spec.qmax) == (ref.bits, ref.qmax)
    for hd in (16, 32, 64, 96, 128):
        for kh in (1, 3, 32):
            assert spec.kv_bytes_per_token(kh, hd) == ref.kv_bytes_per_token(kh, hd)
        assert spec.n_groups(hd) == ref.n_groups(hd)
        assert spec.packed_head_dim(hd) == ref.packed_head_dim(hd)
        if hd % min(spec.group or hd, hd) == 0:
            assert spec.group_for(hd) == ref.group_for(hd)
    assert KVSpec.from_meta({}) == KVSpec()


@pytest.mark.parametrize("bad, call", [
    (dict(dtype="fp8"), None), (dict(dtype="f32", group=64), None),
    (dict(dtype="int8", group=-4), None),
    (dict(dtype="int8", group=48), lambda s: s.group_for(128)),
    (dict(dtype="int4"), lambda s: s.packed_head_dim(33)),
    (dict(dtype="int8"), lambda s: s.cache_dtype),
])
def test_kvspec_rejects_what_the_reference_rejects(bad, call):
    msgs = []
    for cls in (KVSpec, JaxKVSpec):
        with pytest.raises(ValueError) as e:
            spec = cls(**bad)
            call(spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec", SPECS[2:], ids=lambda s: s.describe())
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_and_dequantize_bitwise(spec, dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 2, 32)) * 4).astype(np.float32)
    x[0, 1] = 0.0  # an all-zero row: the zero-guarded scale
    x[1, 2, 0, :8] = 0.0  # and an all-zero group
    if dtype == "bf16":
        x = bf16(x)
    jq, js = jax_quantize_kv(jnp.asarray(x), jspec(spec))
    tq, ts = quantize_kv(port(x), spec)
    assert tq.dtype == spec.pool_dtype and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    want = np.asarray(jax_dequantize_kv(jq, js, jspec(spec), 32))
    got = dequantize_kv(tq, ts, spec, 32).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("spec", SPECS[2:], ids=lambda s: s.describe())
def test_quantized_scatter_bitwise(spec):
    """The same float k rows through both packages' quantized scatter:
    codes and scales land bitwise alike, under the same pages and slots,
    and nothing else in the pool moves."""
    rng = np.random.default_rng(2)
    kh, hd, page = 2, 16, 4
    shape = (9, page, kh, spec.packed_head_dim(hd))
    pages = rng.integers(0, 120, shape).astype(
        np.uint8 if spec.dtype == "int4" else np.int8)
    scales = rng.standard_normal((9, page, kh, spec.n_groups(hd))).astype(np.float32)
    update = rng.standard_normal((2, 3, kh, hd)).astype(np.float32)
    table = np.array([[3, 5, 0], [7, 0, 0]], np.int32)
    positions = np.array([[3, 4, 5], [0, 1, 2]], np.int32)
    valid = np.array([[1, 1, 1], [1, 1, 0]], bool)  # one padding row → page 0
    jp, js = jax_paged_cache_update_quantized(
        jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(update),
        jnp.asarray(table), jnp.asarray(positions), jnp.asarray(valid), jspec(spec))
    tp, ts = paged_cache_update_quantized(
        port(pages), port(scales), port(update), port(table).long(),
        port(positions).long(), port(valid), spec)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# paged_step and the engine on the gather route
# ---------------------------------------------------------------------------


def _pools_match(tpool, jpool, spec, owned):
    """Codes bitwise; scales, f32 and bf16 pages to the module's bounds."""
    port_pool = bridge.cache_to_numpy(tpool, bf16_dtype=ml_dtypes.bfloat16)
    for leaf in tpool:
        got = port_pool[leaf][:, owned]
        want = np.asarray(jpool[leaf])[:, owned]
        assert got.dtype == want.dtype, leaf
        if leaf in ("k", "v") and spec.is_quantized:
            assert np.array_equal(got, want), leaf
            continue
        got, want = got.astype(np.float64), want.astype(np.float64)
        if leaf.endswith("_scale"):
            limit = ATOL / spec.qmax + 2 * np.spacing(np.abs(want).astype(np.float32))
        elif spec.dtype == "bf16":
            limit = ATOL + 2.0 ** -7 * np.abs(want)
        else:
            limit = ATOL
        assert np.all(np.abs(got - want) <= limit), leaf


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.describe())
def test_paged_step_gather_route_matches_reference(setup, spec):
    """A prefill chunk, then a batched decode step with an inactive row,
    through both packages' ``paged_step`` on the same pool: the pools
    (codes, scales and float pages) and the logits agree."""
    jcfg, tcfg, trees, ported = setup
    pool = jax_model.init_paged_cache(jcfg, 9, 4, dtype=jnp.float32,
                                      kv_spec=jspec(spec))
    jpool = dict(pool)
    tpool = bridge.cache_from_jax({k: np.asarray(v) for k, v in pool.items()},
                                  device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tpool.items()} == \
        {k: (tuple(t.shape), str(t.dtype)) for k, t in model.init_paged_cache(
            tcfg, 9, 4, device="cpu", kv_spec=spec).items()}
    rng = np.random.default_rng(2)
    table = np.array([[3, 5, 0], [7, 0, 0]], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    steps = [(tokens, np.tile(np.arange(6, dtype=np.int32), (2, 1)),
              np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 0, 0]], bool), False),
             (tokens[:, :1], np.array([[5], [3]], np.int32),
              np.array([[1], [0]], bool), True)]
    for tok, pos, val, decode in steps:
        want, jpool = jax_model.paged_step(
            jcfg, trees["float"], jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(val), jpool, jnp.asarray(table), kv_spec=jspec(spec))
        got, tpool = model.paged_step(
            tcfg, ported["float"], port(tok), port(pos), port(val), tpool,
            port(table), kv_spec=spec, ctx=KernelContext(attention="gather"))
        got, want = got.numpy(), np.asarray(want)
        if decode:  # the inactive row's output is garbage both sides ignore
            got, want = got[:1], want[:1]
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the null page may differ: both write padding rows there
    _pools_match(tpool, jpool, spec, table[table > 0])


@pytest.mark.parametrize("spec, kind", [
    (KVSpec(), "int8"), (KVSpec("int8"), "float"), (KVSpec("int8"), "int8"),
    (KVSpec("int4", group=8), "int8")], ids=lambda v: getattr(v, "describe", lambda: v)())
def test_engine_token_streams_match_reference(setup, spec, kind):
    """Greedy streams on the gather route equal the JAX engine's with the
    same spec (the check is exact; logits agree to ~1e-6 and these seeds
    give no near-tie)."""
    jcfg, tcfg, trees, ported = setup
    prompts = _prompts(tcfg)
    jeng = JaxServeEngine(jcfg, trees[kind], kv_spec=jspec(spec), **KW)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
    want = {rid: rec.out_tokens for rid, rec in jeng.run().items()}
    eng, got = _serve(tcfg, ported[kind], prompts, kv_spec=spec)
    assert got == want
    assert eng.health()["kv"] == jeng.health()["kv"]
    assert eng.health()["decode_attention"]["route"] == "gather"
    assert eng.counters["decode_calls"] == jeng.counters["decode_calls"]
    assert eng.alloc.sidecar == spec.is_quantized
    assert set(eng.pool) == set(jeng.pool)
    assert eng.alloc.free_pages == eng.alloc.capacity
    eng.alloc.check()


def test_engine_validates_geometry_eagerly(setup):
    _, tcfg, _, ported = setup
    with pytest.raises(ValueError, match="does not divide"):
        ServeEngine(tcfg, ported["float"], device="cpu",
                    kv_spec=KVSpec("int8", group=12), **KW)
    odd = type(tcfg)(**{**tcfg.__dict__, "head_dim": 15})
    with pytest.raises(ValueError, match="even head_dim"):
        ServeEngine(odd, ported["float"], device="cpu", kv_spec=KVSpec("int4"), **KW)


# ---------------------------------------------------------------------------
# the forced kernel route (the kernels' plain versions on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [KVSpec(), KVSpec("bf16"), KVSpec("int8"),
                                  KVSpec("int4", group=8)], ids=lambda s: s.describe())
def test_kernel_route_launch_counts(setup, spec):
    """Every decode step's attention goes through the spec's paged kernel
    wrapper once per layer, and every prefill chunk's through the spec's
    dense flash kernel wrapper once per layer (their plain versions here,
    the tensors being on the CPU); no other wrapper runs."""
    _, tcfg, _, ported = setup
    flash_attn.reset_launches()
    eng, _ = _serve(tcfg, ported["int8"], _prompts(tcfg), kv_spec=spec,
                    ctx=KERNEL_ROUTE)
    name = ("paged_flash_attention_quant" if spec.is_quantized
            else "paged_flash_attention")
    prefill = name[len("paged_"):]
    want = {k: 0 for k in flash_attn.LAUNCHES}
    want[name + "_plain"] = tcfg.n_layers * eng.counters["decode_calls"]
    want[prefill + "_plain"] = tcfg.n_layers * eng.counters["prefill_calls"]
    assert eng.counters["decode_calls"] > 0
    assert flash_attn.LAUNCHES == want
    assert eng.health()["decode_attention"] == {
        "route": "kernel", "kernel": name, "kv": spec.describe(), "demoted": None}
    assert eng.health()["prefill_attention"] == {
        "route": "kernel", "kernel": prefill, "kv": spec.describe(), "demoted": None}


@pytest.mark.parametrize("spec", [KVSpec(), KVSpec("int8")], ids=lambda s: s.describe())
def test_kernel_route_invariant_to_slot_placement(setup, spec):
    """Same requests with another slot count, in reverse order, on a pool
    fragmented before admission, and one slot without chunking: the same
    tokens on the kernel route."""
    _, tcfg, _, ported = setup
    prompts = _prompts(tcfg)
    kw = dict(kv_spec=spec, ctx=KERNEL_ROUTE)
    _, want = _serve(tcfg, ported["int8"], prompts, **kw)
    eng = ServeEngine(tcfg, ported["int8"], device="cpu",
                      **{**KW, "batch_slots": 3}, **kw)
    eng.alloc.ensure(99, 9)  # three pages held by nobody the engine serves
    for i in reversed(range(len(prompts))):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=6))
    assert {rid: rec.out_tokens for rid, rec in eng.run().items()} == want
    _, one = _serve(tcfg, ported["int8"], prompts, batch_slots=1,
                    prefill_chunk=None, **kw)
    assert one == want


# the kernel route computes attention in f32 from the pool, the gather route
# casts the gathered pages to the model's bf16 and runs bf16 einsums: their
# bf16 logits differ by bf16 roundings; allowed: four bf16 ulps (2⁻⁷
# relative each) at the logits' scale (measured: about one, 4.9e-3 on
# logits of 0.61)
BF16_LOGIT_TOL = 4 * 2.0 ** -7


@pytest.mark.parametrize("spec", [KVSpec(), KVSpec("int8")], ids=lambda s: s.describe())
def test_kernel_route_logits_near_gather_route(spec):
    """One prefill chunk, then one decode step on each route, on a bf16
    model: the decode logits agree to BF16_LOGIT_TOL · max |logits|; on the
    f32 model (both routes in f32) to ATOL."""
    rng = np.random.default_rng(4)
    for dtype, tol in (("bfloat16", None), ("float32", ATOL)):
        jcfg, tcfg = configs(dtype=dtype)
        params = bridge.params_from_jax(to_numpy_tree(jax_params(jcfg)), device="cpu")
        table = torch.tensor([[3, 5, 0], [7, 0, 0]], dtype=torch.int32)
        tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 6)))
        out = {}
        for route in ("gather", "kernel"):
            ctx = KernelContext(attention=route)
            pool = model.init_paged_cache(tcfg, 9, 4, dtype=torch.float32,
                                          device="cpu", kv_spec=spec)
            model.paged_step(tcfg, params, tokens, torch.arange(6).expand(2, 6),
                             torch.ones((2, 6), dtype=torch.bool), pool, table,
                             kv_spec=spec, ctx=ctx)
            out[route], _ = model.paged_step(
                tcfg, params, tokens[:, :1], torch.tensor([[6], [6]]),
                torch.ones((2, 1), dtype=torch.bool), pool, table,
                kv_spec=spec, ctx=ctx)
        got, want = out["kernel"].numpy(), out["gather"].numpy()
        assert np.all(np.isfinite(got))
        limit = tol if tol is not None else BF16_LOGIT_TOL * np.abs(want).max()
        assert np.abs(got - want).max() <= limit, (dtype, np.abs(got - want).max())


def test_attention_route_choice():
    hd = 64
    assert KernelContext().attention_route("cpu", hd) == "gather"
    assert KernelContext().attention_route(torch.device("cuda", 0), hd) == "kernel"
    assert KERNEL_ROUTE.attention_route("cpu", hd) == "kernel"
    assert KernelContext(attention="gather").attention_route("cuda", hd) == "gather"
    assert KERNEL_ROUTE.with_layer_overrides({"mlp/wd": "unfused"}).attention == "kernel"
    with pytest.raises(ValueError, match="attention route"):
        KernelContext(attention="flash")


def test_cache_bridge_round_trip():
    rng = np.random.default_rng(5)
    cache = {"k": rng.integers(0, 255, (2, 3, 4, 2, 8)).astype(np.uint8),
             "v": bf16(rng.standard_normal((2, 3, 4, 2, 16))),
             "k_scale": rng.standard_normal((2, 3, 4, 2, 2)).astype(np.float32)}
    back = bridge.cache_to_numpy(bridge.cache_from_jax(cache, device="cpu"))
    assert back["k"].dtype == np.uint8 and np.array_equal(back["k"], cache["k"])
    assert np.array_equal(back["v"], cache["v"].view(np.uint16))
    assert np.array_equal(back["k_scale"], cache["k_scale"])


# ---------------------------------------------------------------------------
# the allocator's scale-plane sidecar
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(num_pages=st.integers(2, 48), page_size=st.integers(1, 8),
       seed=st.integers(0, 2**31 - 1), sidecar=st.booleans())
def test_allocator_sidecar_stays_in_lockstep(num_pages, page_size, seed, sidecar):
    """Random ensure/free interleavings: every invariant holds after every
    operation, a refused ensure commits nothing, and with ``sidecar`` the
    scale-plane accounting stays in lockstep with the pages."""
    alloc = PageAllocator(num_pages, page_size, sidecar=sidecar)
    rng = np.random.default_rng(seed)
    mirror = {}
    for _ in range(60):
        rid = int(rng.integers(0, 6))
        if rng.integers(2) and mirror:
            victim = int(rng.choice(sorted(mirror)))
            assert alloc.free(victim) == mirror.pop(victim)
            assert alloc.free(victim) == 0
        else:
            n_tokens = int(rng.integers(0, 8 * page_size + 1))
            before = (alloc.free_pages, alloc.holds(rid))
            got = alloc.ensure(rid, n_tokens)
            need = alloc.pages_for(n_tokens) - before[1]
            if got is None:
                assert need > before[0]
                assert (alloc.free_pages, alloc.holds(rid)) == before
            else:
                assert len(got) == max(need, 0) and NULL_PAGE not in got
                if alloc.holds(rid):
                    mirror[rid] = alloc.holds(rid)
                assert alloc.ensure(rid, n_tokens) == []
        alloc.check()
        assert alloc.used_pages == sum(mirror.values())
        assert alloc.stats()["sidecar"] == sidecar
    for rid in list(mirror):
        alloc.free(rid)
    alloc.check()
    assert alloc.free_pages == alloc.capacity and alloc.used_pages == 0
    if sidecar:
        assert alloc._side_free == alloc._free and alloc._side_owned == {}


def test_sidecar_divergence_is_caught():
    alloc = PageAllocator(8, 2, sidecar=True)
    alloc.ensure(1, 4)
    alloc.ensure(2, 3)
    alloc.check()
    # a scale plane sneaks back onto the sidecar free list
    alloc._side_free.append(alloc._side_owned[1][0])
    with pytest.raises(AssertionError):
        alloc.check()
    with pytest.raises(ValueError, match="scale-plane double free"):
        alloc.free(1)
    assert alloc.holds(1) == 2  # the failed free changed neither list
    fresh = PageAllocator(8, 2, sidecar=True)
    fresh.ensure(1, 4)
    fresh._side_owned[1].reverse()  # ownership drifts from the page lists
    with pytest.raises(AssertionError, match="diverged"):
        fresh.check()
