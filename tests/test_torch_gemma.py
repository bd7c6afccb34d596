"""Gemma-7b's features in the port against the reference: a reduced Gemma
(2 layers, d_model 128, 2 heads of head_dim 256 over 2 or 1 KV heads,
GeGLU, ``embed_scale``, the tied head, f32) with weights bridged from the
JAX package's init; its ``forward`` and ``paged_step`` (prefill chunks,
then decode) on the gather route and on the kernel route's plain
versions, float and with ``int8`` W4A4+LRC QLinears; the plain dense
flash kernels (#7, #8) at head_dim 256 and at D 192 / Dv 128 against the
reference's Pallas kernels in interpret mode; and the "auto" attention
route at head dims 256 and 320.

Tolerances: float weights over an f32 pool within ATOL = 1e-4, as
``test_torch_model`` (the frameworks order their f32 sums differently: a
few ulps of logits of order 1 per layer; measured <= 9e-7).  A path with a
quantizer in it (``int8`` QLinears, or an int8 KV pool) within ATOL_QUANT
= 1e-3: both frameworks compute every code bitwise alike from inputs that
differ by those ulps, but at head_dim 256 a few inputs fall within an ulp
of a rounding tie and their codes differ by one (an activation code of a
QLinear, or two V codes of the pool on this seed), which moves a logit by
up to ~1.4e-4 here; the pool's codes are held to that one step.  The
flash kernels against Pallas: ``torch_parity.flash_bound`` (the same f32
steps on the same 128-row key tiles; only the order of the D-term score
dot, Σp and p·V differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.models import model as jax_model
from repro.models.config import reduced as jax_reduced
from repro.models.transformer import embed_tokens as jax_embed_tokens
from repro.serve.kvquant import KVSpec as JaxKVSpec
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn
from repro_torch.kernels.context import KernelContext
from repro_torch.models import model
from repro_torch.models.config import reduced
from repro_torch.models.transformer import embed_tokens, unembed
from repro_torch.serve.engine import attention_report
from repro_torch.serve.kvquant import KVSpec, dequantize_kv, quantize_kv
from torch_parity import (SEED, bf16, flash_bound, jax_qlinears, port,
                          to_numpy_tree)

ATOL = 1e-4
ATOL_QUANT = 1e-3
KERNEL_ROUTE = KernelContext(attention="kernel")
SMALL = dict(n_layers=2, d_model=128, n_heads=2, head_dim=256, d_ff=256,
             vocab_size=256, dtype="float32")


def _configs(n_kv_heads, dtype="float32"):
    over = dict(SMALL, n_kv_heads=n_kv_heads, dtype=dtype)
    return (jax_reduced(jax_get_config("gemma-7b"), **over),
            reduced(get_config("gemma-7b"), **over))


@pytest.fixture(scope="module", params=[2, 1], ids=["KH2", "KH1"])
def gemma(request):
    """(reference config, port config, reference trees, port params) for
    float weights and ``int8`` QLinears."""
    jcfg, tcfg = _configs(request.param)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(SEED))
    trees = {"float": jparams, "int8": jax_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    return jcfg, tcfg, trees, ported


def test_config_is_the_reference_s():
    want = dataclasses.asdict(jax_get_config("gemma-7b"))
    got = dataclasses.asdict(get_config("gemma-7b"))
    assert got == {k: want[k] for k in got}
    assert (got["act"], got["tie_embeddings"], got["embed_scale"]) == ("gelu", True, True)


def test_tied_params_cross_the_bridge(gemma):
    """The tied tree has no ``lm_head``: the head reads the embedding, and
    the bridge keeps it so."""
    _, tcfg, trees, ported = gemma
    assert "lm_head" not in trees["float"] and "lm_head" not in ported["float"]
    assert set(ported["float"]) == {"embed", "layers", "final_norm"}
    x = torch.randn((3, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    want = (x @ ported["float"]["embed"].T).to(torch.float32)
    assert torch.equal(unembed(tcfg, ported["float"], x), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_in_the_model_dtype(dtype):
    """``embed * sqrt(d_model)`` with the factor rounded to the model's
    dtype first, as the reference's ``jnp.asarray(d**0.5, x.dtype)``:
    bitwise, f32 and bf16."""
    jcfg, tcfg = _configs(2, dtype)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(SEED))
    params = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 7))
    want = np.asarray(jax_embed_tokens(jcfg, jparams, jnp.asarray(toks, jnp.int32)))
    got = embed_tokens(tcfg, params, torch.from_numpy(toks))
    assert got.dtype == tcfg.torch_dtype
    got = bridge.tensor_to_numpy(got, bf16_dtype=jnp.bfloat16.dtype)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("route", ["gather", "kernel"])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_forward_matches_reference(gemma, kind, route):
    jcfg, tcfg, trees, ported = gemma
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 9))
    want = np.asarray(jax_model.forward(jcfg, trees[kind],
                                        {"tokens": jnp.asarray(toks, jnp.int32)}))
    flash_attn.reset_launches()
    got = model.forward(tcfg, ported[kind], {"tokens": torch.from_numpy(toks)},
                        ctx=KernelContext(attention=route))
    assert flash_attn.LAUNCHES["flash_attention_plain"] == (
        tcfg.n_layers if route == "kernel" else 0)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL if kind == "float" else ATOL_QUANT)


@pytest.mark.parametrize("route", ["gather", "kernel"])
@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_paged_step_matches_reference(gemma, kind, route, pool):
    """A first chunk (one row padded), a second chunk at each row's own
    offset, then a decode step, through the reference's ``paged_step`` and
    the port's on the same pool: every valid row's logits and every page a
    row owns agree."""
    jcfg, tcfg, trees, ported = gemma
    spec = KVSpec() if pool == "f32" else KVSpec("int8")
    jspec = JaxKVSpec(spec.dtype, spec.group)
    jpool = jax_model.init_paged_cache(jcfg, 9, 4, dtype=jnp.float32, kv_spec=jspec)
    tpool = bridge.cache_from_jax({k: np.asarray(v) for k, v in jpool.items()},
                                  device="cpu")
    rng = np.random.default_rng(6)
    table = np.array([[3, 5, 0], [7, 2, 0]], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    steps = [
        (tokens, np.tile(np.arange(6, dtype=np.int32), (2, 1)),
         np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]], bool)),
        (tokens[:, :4], np.array([[6, 7, 8, 9], [3, 4, 5, 6]], np.int32),
         np.ones((2, 4), bool)),
        (tokens[:, :1], np.array([[10], [7]], np.int32), np.ones((2, 1), bool)),
    ]
    ctx = KernelContext(attention=route)
    atol = ATOL if kind == "float" and pool == "f32" else ATOL_QUANT
    flash_attn.reset_launches()
    for tok, pos, val in steps:
        want, jpool = jax_model.paged_step(
            jcfg, trees[kind], jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(val),
            jpool, jnp.asarray(table), kv_spec=jspec)
        got, tpool = model.paged_step(tcfg, ported[kind], port(tok), port(pos), port(val),
                                      tpool, port(table), kv_spec=spec, ctx=ctx)
        got, want = got.numpy(), np.asarray(want)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got[val], want[val], rtol=0, atol=atol)
    owned = table[table > 0]
    for leaf in tpool:
        got, want = tpool[leaf].numpy(), np.asarray(jpool[leaf])
        if got.dtype == np.int8:  # codes: bitwise but for a flip at a tie
            assert np.abs(got[:, owned].astype(int) - want[:, owned]).max() <= 1
        else:
            np.testing.assert_allclose(got[:, owned], want[:, owned], rtol=0, atol=atol)
    quant = "_quant" if spec.is_quantized else ""
    want = {k: 0 for k in flash_attn.LAUNCHES}
    if route == "kernel":
        want[f"flash_attention{quant}_plain"] = 2 * tcfg.n_layers
        want[f"paged_flash_attention{quant}_plain"] = tcfg.n_layers
    assert flash_attn.LAUNCHES == want


def _inputs(seed, b, s, h, kh, d, dv, q_dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = (rng.standard_normal((b, s, kh, dv)) * 1.5).astype(np.float32)
    return (bf16(q) if q_dtype == "bfloat16" else q), k, v


def _as_np(t):
    return np.asarray(bridge.tensor_to_numpy(t, bf16_dtype=jnp.bfloat16.dtype), np.float64)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 256, 2, 2, 256, 256), (2, 128, 4, 1, 256, 256),
                                   (1, 256, 4, 2, 192, 128)],
                         ids=["D256", "D256-MQA", "D192-Dv128"])
def test_flash_plain_matches_pallas_wide(shape, q_dtype):
    """Kernel #7's plain version at head_dim 256 (GQA and MQA) and at D 192
    / Dv 128 against the reference's Pallas ``flash_attention_kernel``."""
    b, s, h, kh, d, dv = shape
    q, k, v = _inputs(d + dv + kh, b, s, h, kh, d, dv, q_dtype)
    scale = d ** -0.5
    want = np.asarray(jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), scale))
    got = flash_attn.flash_attention_plain(port(q), port(k), port(v), scale)
    assert got.dtype == port(q).dtype and tuple(got.shape) == (b, s, h, dv)
    tol, _, _ = flash_bound(q, k, v, scale, want)
    assert np.all(np.abs(_as_np(got) - np.asarray(want, np.float64)) <= tol)


@pytest.mark.parametrize("spec", [KVSpec("int8"), KVSpec("int4", group=32)],
                         ids=lambda s: s.describe())
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_flash_quant_plain_matches_pallas_wide(spec, q_dtype):
    """Kernel #8's plain version at head_dim 256 against the reference's
    Pallas ``flash_attention_quant_kernel``, and bitwise #7's plain version
    on the dequantized codes."""
    b, s, h, kh, d = 1, 256, 4, 2, 256
    q, k, v = _inputs(11, b, s, h, kh, d, d, q_dtype)
    kv = [*quantize_kv(torch.from_numpy(k), spec), *quantize_kv(torch.from_numpy(v), spec)]
    kd, vd = (dequantize_kv(kv[i], kv[i + 1], spec, d) for i in (0, 2))
    scale = d ** -0.5
    want = np.asarray(jax_ops.flash_attention_quant(
        jnp.asarray(q), *(jnp.asarray(t.numpy()) for t in kv), scale,
        JaxKVSpec(spec.dtype, spec.group)))
    got = flash_attn.flash_attention_quant_plain(port(q), *kv, scale, spec)
    assert torch.equal(got, flash_attn.flash_attention_plain(port(q), kd, vd, scale))
    tol, _, _ = flash_bound(q, kd.numpy(), vd.numpy(), scale, want)
    assert np.all(np.abs(_as_np(got) - np.asarray(want, np.float64)) <= tol)


WIDE = flash_attn.MAX_D + 64  # 320: wider than the kernels take


def test_auto_route_at_head_dim_256_and_320():
    """Under "auto" a CUDA device keeps the kernel route for Gemma's 256
    and demotes 320 to gather from shapes, saying why; nothing is built."""
    cuda = torch.device("cuda")
    auto = KernelContext()
    assert flash_attn.MAX_D == 256
    assert auto.attention_plan(cuda, 256) == ("kernel", None)
    plan = auto.attention_plan(cuda, WIDE)
    assert plan.route == "gather" and f"head_dim {WIDE}" in plan.demoted
    assert auto.attention_plan(cuda, WIDE, decode=True) == ("kernel", None)
    assert attention_report(auto, cuda, 256, KVSpec("int8"), decode=False) == {
        "route": "kernel", "kernel": "flash_attention_quant", "kv": "int8",
        "demoted": None}


def test_explicit_kernel_route_raises_above_max_d():
    """A CUDA-typed call (fake tensors: no card is needed) at head dim 320
    raises in the wrappers of #7 and #8 before anything is built; at 256 it
    passes the width check."""
    spec = KVSpec("int8")
    with FakeTensorMode(allow_non_fake_inputs=True):
        for d in (WIDE, 256):
            q = torch.empty((1, 4, 2, d), device="cuda")
            codes = torch.empty((1, 4, 2, d), dtype=torch.int8, device="cuda")
            scales = torch.empty((1, 4, 2, 1), device="cuda")
            for call in (lambda: flash_attn.flash_attention(q, q, q, 0.1),
                         lambda: flash_attn.flash_attention_quant(
                             q, codes, scales, codes, scales, 0.1, spec)):
                with pytest.raises(Exception) as err:
                    call()
                wide = "exceed" in str(err.value)
                assert wide == (d == WIDE), str(err.value)
                if wide:
                    assert err.type is ValueError
