"""The dense family's contiguous cache and prefix-LM entry points, and
Phi-4-mini, in the port against the reference: ``model.init_cache`` /
``prefill`` / ``decode_step`` (the cache's leaves too), ``forward`` and
``prefill`` with ``prefix_len`` and with random ``embeds``, on the reduced
SmolLM, Phi-4-mini (GQA 4/2 here) and Gemma (GeGLU, ``embed_scale``, tied
head), in f32 and bf16, with weights bridged from the JAX package's init.

Tolerances:

* f32: ATOL = 1e-4 on logits and cache leaves, as ``test_torch_model``
  (the frameworks order their f32 sums differently: a few ulps of values
  of order 1 per layer; measured <= 2e-6).
* bf16: the model runs every matmul, norm and residual in bf16, whose
  roundings differ where the frameworks' orders do, one bf16 ulp (2⁻⁸
  relative) at a time; BF16_ATOL = 0.1 on logits of order 1-3 and on the
  cache leaves (the projections' outputs, of order 1-3; a second layer's
  inputs carry the first's roundings, measured <= 3.2e-2).
* The port against itself (prefill + decode against ``forward``, the
  kernel route's plain #7 against the gather route): SELF_ATOL = 1e-5
  in f32 (measured <= 2e-6: the same operations in other groupings); with
  ``int8`` QLinears ATOL_QUANT = 1e-3, as ``test_torch_gemma``: an
  activation that falls within an ulp of a rounding tie gets a code one
  step apart on the two routes (measured: 4.2e-4 on one logit).

The card's phase 18(b) (``chip_smoke.py``) compares the contiguous
path's logits with the paged engine's for the same request; on these
reduced models with f32 weights the two paths' logits agree within
SELF_ATOL too (checked below), and so must the card's with f32 weights;
the card's W4A4 model carries the attention kernels' different f32 orders
through its 4-bit codes, so there the gates are the held kernel calls,
the attention calls' inputs walked in order and the gather route bitwise.

A step writes its k/v rows into the cache it is given, in place (the
reference returns new arrays), and #7 reads an f32 cache as stored: with
bf16 activations its logits are bitwise those over a bf16 cache (checked
below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro.models.common import prefix_lm_mask as jax_prefix_lm_mask
from repro.models.config import reduced as jax_reduced
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.context import PREFIX_LM_REASON, KernelContext
from repro_torch.models import model, transformer
from repro_torch.models.common import prefix_lm_mask
from repro_torch.models.config import reduced
from repro_torch.serve.engine import Request, ServeEngine
from torch_parity import SEED, jax_qlinears, to_numpy_tree

ATOL = 1e-4
BF16_ATOL = 0.1
SELF_ATOL = 1e-5
ATOL_QUANT = 1e-3
ARCHS = ("smollm-135m", "phi4-mini-3.8b", "gemma-7b")
KERNEL = KernelContext(attention="kernel")
GATHER = KernelContext(attention="gather")
B, SMAX, PROMPT, DECODES = 2, 16, 6, 3


def _setup(arch, dtype):
    jcfg = jax_reduced(jax_get_config(arch), dtype=dtype)
    tcfg = reduced(get_config(arch), dtype=dtype)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(SEED))
    return jcfg, tcfg, jparams, bridge.params_from_jax(to_numpy_tree(jparams),
                                                       device="cpu")


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def dense(request):
    return _setup(*request.param)


def _np(t):
    return bridge.tensor_to_numpy(t, ml_dtypes.bfloat16).astype(np.float32)


def _close(got, want, dtype, what=""):
    got, want = _np(got) if isinstance(got, torch.Tensor) else got, np.asarray(
        want, np.float32)
    assert got.shape == want.shape, what
    assert np.all(np.isfinite(got)), what
    atol = ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_phi4_config_is_the_reference_s():
    """Field by field the reference's Phi-4-mini (full rotary, untied head,
    as the reference models it), registered in ``ARCH_IDS``."""
    want = dataclasses.asdict(jax_get_config("phi4-mini-3.8b"))
    got = dataclasses.asdict(get_config("phi4-mini-3.8b"))
    assert got == {k: want[k] for k in got}
    assert "phi4-mini-3.8b" in ARCH_IDS
    cfg = get_config("phi4-mini-3.8b")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size,
            cfg.tie_embeddings) == (24, 8, 128, 200064, False)


def test_phi4_params_cross_the_bridge():
    jcfg, tcfg, jparams, ported = _setup("phi4-mini-3.8b", "float32")
    assert len(ported["layers"]) == jcfg.n_layers and "lm_head" in ported
    init = model.init_params(tcfg, seed=0, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)
    assert shapes(bridge.params_to_numpy(init)) == shapes(to_numpy_tree(jparams))
    back = bridge.params_to_numpy(ported)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(to_numpy_tree(jparams))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_phi4_served_stream_is_the_reference_s(kind):
    """Reduced Phi-4-mini through the paged engine: greedy streams bitwise
    the reference engine's, float and with ``int8`` QLinears."""
    from repro.serve.engine import Request as JaxRequest
    from repro.serve.engine import ServeEngine as JaxServeEngine

    jcfg, tcfg, jparams, _ = _setup("phi4-mini-3.8b", "float32")
    tree = jparams if kind == "float" else jax_qlinears(jcfg, jparams)
    ported = bridge.params_from_jax(to_numpy_tree(tree), device="cpu")
    kw = dict(batch_slots=2, max_seq=32, page_size=4, prefill_chunk=4)
    prompts = [np.random.default_rng(3 + i).integers(0, jcfg.vocab_size, n).astype(np.int32)
               for i, n in enumerate((7, 3, 10))]
    jeng = JaxServeEngine(jcfg, tree, **kw)
    eng = ServeEngine(tcfg, ported, device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    want = {rid: rec.out_tokens for rid, rec in jeng.run().items()}
    got = {rid: rec.out_tokens for rid, rec in eng.run().items()}
    assert got == want


def test_init_prefill_decode_match_reference(dense):
    """``init_cache`` / ``prefill`` / ``decode_step`` and every cache leaf
    against the reference's, a prompt of PROMPT tokens then DECODES
    steps."""
    jcfg, tcfg, jparams, ported = dense
    dtype = tcfg.dtype
    jc = jax_model.init_cache(jcfg, B, SMAX, jnp.dtype(dtype))
    tc = model.init_cache(tcfg, B, SMAX, tcfg.torch_dtype, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tc["k"].dtype == tcfg.torch_dtype and tc["offset"].dtype == torch.int32
    toks = _tokens(tcfg, PROMPT + DECODES)
    jl, jc = jax_model.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jc)
    tl, tc = model.prefill(tcfg, ported, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, tc)
    _close(tl, jl, dtype, "prefill")
    for i in range(PROMPT, PROMPT + DECODES):
        jl, jc = jax_model.decode_step(jcfg, jparams, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = model.decode_step(tcfg, ported, torch.from_numpy(toks[:, i:i + 1]), tc)
        _close(tl, jl, dtype, f"decode at {i}")
    assert int(tc["offset"]) == int(jc["offset"]) == PROMPT + DECODES
    back = bridge.cache_to_numpy(tc, ml_dtypes.bfloat16)
    for leaf in ("k", "v"):
        want = np.asarray(jc[leaf], np.float32)
        got = back[leaf].astype(np.float32)
        tol = ATOL if dtype == "float32" else BF16_ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=leaf)
        assert not got[:, :, PROMPT + DECODES:].any()  # never written


@pytest.mark.parametrize("route", ["gather", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_equal_forward(arch, route):
    """Prefill then decode gives ``forward``'s logits row by row (f32), on
    the gather route and on the kernel route (#7's plain version with
    ``q_start`` 0, then at the offset)."""
    _, tcfg, _, ported = _setup(arch, "float32")
    ctx = KernelContext(attention=route)
    toks = torch.from_numpy(_tokens(tcfg, PROMPT + DECODES, seed=4))
    full = model.forward(tcfg, ported, {"tokens": toks}, ctx=ctx)
    cache = model.init_cache(tcfg, B, SMAX, torch.float32, device="cpu")
    logits, cache = model.prefill(tcfg, ported, {"tokens": toks[:, :PROMPT]}, cache, ctx=ctx)
    rows = [logits[:, 0]]
    for i in range(PROMPT, PROMPT + DECODES - 1):
        logits, cache = model.decode_step(tcfg, ported, toks[:, i:i + 1], cache, ctx=ctx)
        rows.append(logits[:, 0])
    got = torch.stack(rows, 1)
    want = full[:, PROMPT - 1:PROMPT + DECODES - 1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=SELF_ATOL)


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_kernel_route_equals_gather_route(kind):
    """The kernel route on the CPU (the plain #7 with ``q_start``) against
    the gather route through prefill and decode, float and ``int8``
    QLinears, on the reduced Phi-4-mini."""
    jcfg, tcfg, jparams, _ = _setup("phi4-mini-3.8b", "float32")
    tree = jparams if kind == "float" else jax_qlinears(jcfg, jparams)
    ported = bridge.params_from_jax(to_numpy_tree(tree), device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, PROMPT + DECODES, seed=5))
    out = {}
    for route, ctx in (("kernel", KERNEL), ("gather", GATHER)):
        cache = model.init_cache(tcfg, B, SMAX, torch.float32, device="cpu")
        logits, cache = model.prefill(tcfg, ported, {"tokens": toks[:, :PROMPT]}, cache,
                                      ctx=ctx)
        rows = [logits]
        for i in range(PROMPT, PROMPT + DECODES):
            logits, cache = model.decode_step(tcfg, ported, toks[:, i:i + 1], cache, ctx=ctx)
            rows.append(logits)
        out[route] = (torch.cat(rows, 1), cache)
    atol = SELF_ATOL if kind == "float" else ATOL_QUANT
    np.testing.assert_allclose(out["kernel"][0].numpy(), out["gather"][0].numpy(),
                               rtol=0, atol=atol)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(out["kernel"][1][leaf].numpy(),
                                   out["gather"][1][leaf].numpy(), rtol=0, atol=atol)


def test_contiguous_agrees_with_the_paged_engine():
    """One request through the paged engine (kernel route: #7 for the
    prefill chunk, #6 for each decode step, plain versions) and through the
    contiguous cache (kernel route: #7 throughout), teacher-forced with the
    engine's greedy tokens: each step's logits within SELF_ATOL (phase
    18(b)'s comparison, here with f32 weights)."""
    _, tcfg, _, ported = _setup("phi4-mini-3.8b", "float32")
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, PROMPT).astype(np.int32)
    eng = ServeEngine(tcfg, ported, batch_slots=1, max_seq=SMAX, page_size=4,
                      prefill_chunk=8, device="cpu", ctx=KERNEL)
    paged, inner = [], eng._paged

    def kept(*a, **kw):
        out = inner(*a, **kw)
        paged.append(out[0][:, -1])
        return out

    eng._paged = kept
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=DECODES + 1))
    stream = eng.run()[0].out_tokens
    cache = model.init_cache(tcfg, 1, SMAX, torch.float32, device="cpu")
    logits, cache = model.prefill(tcfg, ported, {"tokens": torch.from_numpy(prompt[None])},
                                  cache, ctx=KERNEL)
    rows = [logits[:, -1]]
    for t in stream[:-1]:
        logits, cache = model.decode_step(tcfg, ported, torch.tensor([[t]]), cache, ctx=KERNEL)
        rows.append(logits[:, -1])
    assert len(rows) == len(paged) == DECODES + 1
    for a, b in zip(rows, paged):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=SELF_ATOL)


def test_prefix_lm_mask_is_the_reference_s():
    for q_len, kv_len, p, off in ((5, 5, 2, 0), (3, 9, 4, 0), (4, 12, 0, 3), (6, 6, 6, 0)):
        want = np.asarray(jax_prefix_lm_mask(q_len, kv_len, p, off))
        assert np.array_equal(prefix_lm_mask(q_len, kv_len, p, off).numpy(), want)


@pytest.mark.parametrize("mode", ["prefix_len", "embeds"])
def test_forward_and_prefill_with_a_prefix(dense, mode):
    """``forward`` and ``prefill`` with ``prefix_len`` 3, or with random
    ``embeds`` (B, 3, D) prepended, against the reference (the gather
    route: a prefix-LM mask is not causal)."""
    jcfg, tcfg, jparams, ported = dense
    toks = _tokens(tcfg, PROMPT, seed=7)
    kw_j, kw_t = {}, {}
    if mode == "prefix_len":
        kw_j = kw_t = {"prefix_len": 3}
    else:
        emb = np.random.default_rng(8).standard_normal((B, 3, tcfg.d_model)).astype(np.float32)
        kw_j, kw_t = {"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)}
    want = jax_transformer.forward(jcfg, jparams, jnp.asarray(toks), **kw_j)
    got = transformer.forward(tcfg, ported, torch.from_numpy(toks), **kw_t)
    _close(got, want, tcfg.dtype, "forward")
    jc = jax_transformer.init_cache(jcfg, B, SMAX, jnp.dtype(jcfg.dtype))
    tc = transformer.init_cache(tcfg, B, SMAX, tcfg.torch_dtype, device="cpu")
    jl, jc = jax_transformer.prefill(jcfg, jparams, jnp.asarray(toks), jc, **kw_j)
    tl, tc = transformer.prefill(tcfg, ported, torch.from_numpy(toks), tc, **kw_t)
    _close(tl, jl, tcfg.dtype, "prefill")
    assert int(tc["offset"]) == int(jc["offset"])
    # on the CPU "auto" is the gather route anyway; an explicit kernel route
    # with a prefix would compute a causal mask, so it raises
    with pytest.raises(ValueError, match="prefix-LM"):
        transformer.forward(tcfg, ported, torch.from_numpy(toks), ctx=KERNEL, **kw_t)
    with pytest.raises(ValueError, match="prefix-LM"):
        transformer.prefill(tcfg, ported, torch.from_numpy(toks),
                            transformer.init_cache(tcfg, B, SMAX, device="cpu"),
                            ctx=KERNEL, **kw_t)


def test_prefix_route_plan_says_why():
    """Under "auto" a prefix-LM attention on the card is demoted to the
    gather route with the reason stated; on the CPU it is gather anyway;
    an explicit kernel route raises; an explicit gather route runs."""
    auto = KernelContext()
    plan = auto.attention_plan("cuda", 128, prefix=True)
    assert plan.route == "gather" and plan.demoted == PREFIX_LM_REASON
    assert auto.attention_plan("cpu", 128, prefix=True) == ("gather", None)
    assert auto.attention_plan("cuda", 128).route == "kernel"
    assert GATHER.attention_plan("cuda", 128, prefix=True) == ("gather", None)
    with pytest.raises(ValueError, match="no prefix argument"):
        KERNEL.attention_plan("cpu", 128, prefix=True)


def test_quantized_kv_spec_needs_the_paged_layout():
    from repro_torch.serve.kvquant import KVSpec

    _, tcfg, _, _ = _setup("smollm-135m", "float32")
    with pytest.raises(ValueError, match="paged"):
        model.init_cache(tcfg, 1, 8, device="cpu", kv_spec=KVSpec("int8"))
    cache = model.init_cache(tcfg, 1, 8, device="cpu", kv_spec=KVSpec("bf16"))
    assert cache["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("route", ["gather", "kernel"])
def test_steps_write_the_cache_in_place(route):
    """Prefill and decode return the k/v tensors they were given, written
    in place, with the offset advanced; a bf16 model over an f32 cache
    (read as stored on the kernel route, cast on the gather route) gives
    bitwise the logits and cache values of a bf16 cache."""
    _, tcfg, _, ported = _setup("phi4-mini-3.8b", "bfloat16")
    ctx = KernelContext(attention=route)
    toks = torch.from_numpy(_tokens(tcfg, PROMPT + DECODES, seed=9))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cache = model.init_cache(tcfg, B, SMAX, dtype, device="cpu")
        k, v = cache["k"], cache["v"]
        logits, cache = model.prefill(tcfg, ported, {"tokens": toks[:, :PROMPT]}, cache,
                                      ctx=ctx)
        rows = [logits]
        for i in range(PROMPT, PROMPT + DECODES):
            logits, cache = model.decode_step(tcfg, ported, toks[:, i:i + 1], cache, ctx=ctx)
            rows.append(logits)
            assert cache["k"] is k and cache["v"] is v
        assert int(cache["offset"]) == PROMPT + DECODES
        assert k[:, :, :PROMPT + DECODES].abs().sum(-1).all()
        assert not k[:, :, PROMPT + DECODES:].any()
        out[dtype] = torch.cat(rows, 1), k, v
    assert torch.equal(out[torch.float32][0], out[torch.bfloat16][0])
    for a, b in zip(out[torch.float32][1:], out[torch.bfloat16][1:]):
        assert torch.equal(a, b.to(torch.float32))
