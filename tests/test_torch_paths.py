"""The three W4A4+LRC kernel paths (fused, chained, unfused) and the plan
that picks one, against the reference.

On the CPU every wrapper runs its plain version.  The three paths then give
bitwise equal outputs, as the reference's docstring promises for its
interpret mode: they share the quantizer, the K-chunked x·V and the
epilogue bodies.  Against the reference's own paths (the Pallas kernels in
interpret mode, in a subprocess) the outputs differ only in the order of the
LR sums, held to ``torch_parity.lr_tolerance``; greedy token streams are
compared exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.config import reduced as jax_reduced
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.quantizers import QuantSpec
from repro_torch.kernels import actquant, fused_gemm, ops, prologue, w4a4
from repro_torch.kernels.context import KERNEL_PATHS, IMPLS, KernelContext, Plan
from repro_torch.models.config import reduced
from repro_torch.quant import qlinear as tql
from repro_torch.serve.engine import Request, RequestState, ServeEngine
from torch_parity import (jax_params, jax_qlinears, lr_tolerance, port,
                          run_pallas, t, to_numpy_tree, w4a4_problem,
                          x64_restored)

SPEC = QuantSpec(bits=4, clip_ratio=0.9)
SHAPES = [(4, 3072, 64, 307), (16, 8192, 24, 307), (13, 200, 97, 7),
          (40, 520, 17, 9), (3, 90, 33, 0), (1, 3072, 5, 922)]


def _forward(x, wp, sw, u, v, **kw):
    return ops.w4a4_lrc_forward(t(x), t(wp), t(sw), port(u), port(v), SPEC, **kw)


@pytest.mark.parametrize("m,k,n,r", SHAPES)
def test_three_plain_paths_bitwise_equal(m, k, n, r):
    x, wp, sw, u, v = w4a4_problem(m + k + n + r, m, k, n, r)
    ys = {path: _forward(x, wp, sw, u, v, impl=path) for path in KERNEL_PATHS}
    assert torch.equal(ys["fused"], ys["chained"])
    assert torch.equal(ys["fused"], ys["unfused"])


def test_each_path_runs_its_own_wrappers():
    x, wp, sw, u, v = w4a4_problem(1, 4, 64, 48, 8)
    want = {"fused": {"fused_w4a4_lrc_plain": 1},
            "chained": {"fused_prologue_plain": 1, "w4a4_lowrank_matmul_plain": 1},
            "unfused": {"act_quant_plain": 1, "w4a4_lowrank_matmul_plain": 1}}
    mods = (fused_gemm, prologue, w4a4, actquant)
    for path, counts in want.items():
        for mod in mods:
            mod.reset_launches()
        _forward(x, wp, sw, u, v, ctx=KernelContext(impl=path))
        got = {k: c for mod in mods for k, c in mod.LAUNCHES.items() if c}
        assert got == counts, path


@pytest.mark.parametrize("path", ["chained", "unfused"])
def test_paths_match_pallas_kernels_in_interpret_mode(tmp_path, path):
    """The reference's ``w4a4_lrc_forward(impl=path)``: its prologue or
    quantizer kernel, then ``w4a4_lowrank_matmul_kernel``."""
    m, k, n, r = 5, 576, 192, 19
    x, wp, sw, u, v = w4a4_problem(21, m, k, n, r)
    got = run_pallas(tmp_path, f"""
from repro.core.quantizers import QuantSpec
from repro.kernels import ops
y = ops.w4a4_lrc_forward(jnp.asarray(d["x"]), jnp.asarray(d["wp"]),
                         jnp.asarray(d["sw"]), jnp.asarray(d["u"], jnp.bfloat16),
                         jnp.asarray(d["v"], jnp.bfloat16),
                         QuantSpec(bits=4, clip_ratio=0.9), impl="{path}")
out["y"] = np.asarray(y)
""", x=x, wp=wp, sw=sw, u=u, v=v)
    y = _forward(x, wp, sw, u, v, impl=path).numpy()
    # the jitted kernels' scales may be two ulps off the port's (see
    # torch_parity.scales_match_jitted): 2⁻²² relative to the GEMM term more
    tol = (lr_tolerance(x, v.astype(np.float32), u.astype(np.float32), k, r, got["y"])
           + 2.0 ** -22 * np.abs(got["y"]))
    assert np.all(np.abs(y - got["y"]) <= tol), float(np.abs(y - got["y"]).max())


# ---------------------------------------------------------------------------
# the plan


def _limit_k(r):
    """The largest even K whose fused block fits the shared-memory limit."""
    k = 2
    while fused_gemm.smem_bytes(k + 2, r) <= fused_gemm.SMEM_LIMIT:
        k += 2
    return k


@pytest.mark.parametrize("r", [0, 58, 307])
def test_auto_demotes_exactly_at_the_shared_memory_limit(r):
    ctx = KernelContext()
    k = _limit_k(r)
    assert fused_gemm.smem_bytes(k, r) <= fused_gemm.SMEM_LIMIT
    assert ctx.resolve_plan(4, k, 64, r) == Plan("fused", False, False)
    assert ctx.resolve_plan(4, k + 2, 64, r) == Plan("chained", False, True)
    # M does not enter
    assert ctx.resolve_plan(4096, k, 64, r).path == "fused"


def test_plan_rank_limit_pins_and_overrides():
    ctx = KernelContext()
    # above MAX_RANK the fused kernel's V chunks hold too few rows
    assert ctx.resolve_plan(4, 64, 64, fused_gemm.MAX_RANK + 1) == Plan("chained", False, True)
    # SmolLM-135M's sites fit the fused kernel, Phi-3-mini's do not
    assert {ctx.resolve_plan(4, k, n, r).path for k, n, r in
            [(576, 576, 58), (576, 192, 19), (576, 1536, 58), (1536, 576, 58)]} == {"fused"}
    assert {ctx.resolve_plan(4, k, n, r) for k, n, r in
            [(3072, 3072, 307), (3072, 8192, 307), (8192, 3072, 307)]} == {
                Plan("chained", False, True)}
    # an explicit impl, or a context's, pins the path as it is
    for impl in KERNEL_PATHS:
        assert ctx.resolve_plan(4, 8192, 64, 307, impl=impl) == Plan(impl, True, False)
        assert ctx.with_impl(impl).resolve_plan(4, 64, 64, 8) == Plan(impl, True, False)
    # overrides by layer name, (K, N, R) and "KxNrR", the name first
    ov = ctx.with_layer_overrides({"mlp/wd": {"path": "unfused"},
                                   (64, 48, 8): {"path": "chained"}})
    ov = ov.with_layer_overrides({"576x576r58": {"path": "unfused"}})
    assert ov.resolve_plan(4, 64, 48, 8) == Plan("chained", True, False)
    assert ov.resolve_plan(4, 64, 48, 8, layer="mlp/wd") == Plan("unfused", True, False)
    assert ov.resolve_plan(4, 576, 576, 58) == Plan("unfused", True, False)
    assert ov.resolve_plan(4, 576, 577, 58) == Plan("fused", False, False)
    # a fused override still demotes when the site does not fit, as in the reference
    big = ctx.with_layer_overrides({"attn/wq": {"path": "fused"}})
    assert big.resolve_plan(4, 3072, 3072, 307, layer="attn/wq") == Plan("chained", True, True)
    assert IMPLS == ("auto", "fused", "chained", "unfused")
    assert hash(ov) == hash(KernelContext(overrides=dict(ov.overrides)))


def test_plan_rejects_tile_keys_and_unknown_values():
    with pytest.raises(NotImplementedError, match="tiles"):
        KernelContext().with_layer_overrides({"mlp/wd": {"path": "chained", "bm": 8}})
    with pytest.raises(NotImplementedError):
        KernelContext(overrides={(64, 48, 8): {"bk": 256}})
    with pytest.raises(ValueError):
        KernelContext(impl="pallas")
    with pytest.raises(ValueError):
        KernelContext().with_layer_overrides({"mlp/wd": {"path": "fast"}})
    with pytest.raises(ValueError):
        KernelContext().resolve_plan(4, 64, 48, 8, impl="fast")
    with pytest.raises(ValueError):
        ops.w4a4_lrc_forward(torch.zeros(1, 4), torch.zeros(2, 3, dtype=torch.uint8),
                             torch.ones(3), None, None, SPEC, impl="fast")


def test_qlinear_kernel_impls_follow_their_context():
    x, wp, sw, u, v = w4a4_problem(2, 3, 3072, 16, 307)
    q = tql.QLinear(qweight=t(wp), w_scale=t(sw), u=port(u), v=port(v),
                    clip_ratio=0.9, impl="pallas", name="mlp/wd")
    mods = (fused_gemm, prologue, w4a4, actquant)

    def ran(layer):
        for mod in mods:
            mod.reset_launches()
        tql.qlinear_apply(layer, t(x))
        return {k for mod in mods for k, c in mod.LAUNCHES.items() if c}

    # "pallas" defers to the context: auto demotes this K to chained
    assert ran(q) == {"fused_prologue_plain", "w4a4_lowrank_matmul_plain"}
    ctx = KernelContext().with_layer_overrides({"mlp/wd": {"path": "unfused"}})
    assert ran(dataclasses.replace(q, ctx=ctx)) == {"act_quant_plain",
                                                   "w4a4_lowrank_matmul_plain"}
    # "fused" pins the one-kernel path whatever the context says
    assert ran(dataclasses.replace(q, impl="fused", ctx=ctx)) == {"fused_w4a4_lrc_plain"}


def test_retag_attaches_the_context_and_auto_reads_the_tensors_device():
    q = tql.QLinear(qweight=torch.zeros((32, 8), dtype=torch.uint8),
                    w_scale=torch.ones(8), u=None, v=None, impl="int8")
    tree = {"layers": [{"mlp": {"wd": q}}]}
    # no device given: the QLinear tensors are on the CPU, so "auto" keeps
    # the calibrated impl (the reference keeps it on its CPU backend)
    assert tql.retag_qlinear_impl(tree, "auto") is tree
    ctx = KernelContext(impl="chained")
    got = tql.retag_qlinear_impl(tree, "auto", ctx=ctx)["layers"][0]["mlp"]["wd"]
    assert (got.impl, got.ctx) == ("int8", ctx)
    got = tql.retag_qlinear_impl(tree, "pallas", ctx=ctx)["layers"][0]["mlp"]["wd"]
    assert (got.impl, got.ctx) == ("pallas", ctx)
    assert tql.retag_qlinear_impl(tree, None) is tree


# ---------------------------------------------------------------------------
# Phi-3-mini


def test_phi3_config_matches_reference():
    assert "phi3-mini-3.8b" in ARCH_IDS
    cfg, jcfg = get_config("phi3-mini-3.8b"), jax_get_config("phi3-mini-3.8b")
    for field in dataclasses.fields(cfg):
        assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (32, 3072, 32, 32, 96, 8192, 32064)


KW = dict(batch_slots=2, max_seq=32, page_size=4, prefill_chunk=4)
LENGTHS = (7, 3, 10, 5)


def _phi3_params():
    """The reduced Phi-3-mini's reference params, made as a fresh process
    makes them: with jax_enable_x64 off, whatever an earlier test in this
    worker left it at (the flag changes ``jax.random``'s draws)."""
    jcfg = jax_reduced(jax_get_config("phi3-mini-3.8b"), dtype="float32", n_layers=2)
    tcfg = reduced(get_config("phi3-mini-3.8b"), dtype="float32", n_layers=2)
    with x64_restored():
        jax.config.update("jax_enable_x64", False)
        jtree = to_numpy_tree(jax_qlinears(jcfg, jax_params(jcfg)))
    return tcfg, bridge.params_from_jax(jtree, device="cpu")


def test_reduced_phi3_streams_match_reference_engine(tmp_path):
    """Greedy token streams of the reduced Phi-3-mini through the port's
    engine with every QLinear on the chained path, and on the unfused path,
    equal the reference engine's on its own chained and unfused Pallas
    paths (interpret mode, same params)."""
    got = run_pallas(tmp_path, f"""
import json
from repro.configs import get_config
from repro.kernels.context import KernelContext
from repro.models.config import reduced
from repro.serve.engine import Request, ServeEngine
from torch_parity import jax_params, jax_qlinears
cfg = reduced(get_config("phi3-mini-3.8b"), dtype="float32", n_layers=2)
params = jax_qlinears(cfg, jax_params(cfg))
rng = np.random.default_rng(3)
prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in {LENGTHS}]
for path in ("chained", "unfused"):
    eng = ServeEngine(cfg, params, kernel_impl="pallas",
                      ctx=KernelContext(impl=path), **{KW})
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = eng.run()
    out[path] = np.asarray([done[i].out_tokens for i in range(len(prompts))])
""")
    tcfg, params = _phi3_params()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in LENGTHS]
    for path in ("chained", "unfused"):
        eng = ServeEngine(tcfg, params, kernel_impl="pallas",
                          ctx=KernelContext(impl=path), device="cpu", **KW)
        for i, p in enumerate(prompts):
            assert eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        done = eng.run()
        assert all(rec.status is RequestState.FINISHED for rec in done.values())
        streams = [done[i].out_tokens for i in range(len(prompts))]
        assert streams == got[path].tolist(), path
        plan = eng.health()["decode_plan"]
        assert {(s["path"], s["pinned"]) for s in plan} == {(path, True)}
        assert sum(len(s["layers"]) for s in plan) == 7


def test_engine_reports_the_decode_plan_per_site():
    tcfg, params = _phi3_params()
    # auto on the CPU keeps the calibrated int8 impl, and says so
    eng = ServeEngine(tcfg, params, device="cpu", **KW)
    assert {s["path"] for s in eng.health()["decode_plan"]} == {"int8"}
    # the kernel paths with the default context: these reduced widths fit
    # the fused kernel, so nothing is demoted; pin one site by name
    ctx = KernelContext().with_layer_overrides({"mlp/wd": {"path": "unfused"}})
    eng = ServeEngine(tcfg, params, kernel_impl="pallas", ctx=ctx, device="cpu", **KW)
    plan = {tuple(sorted(s["layers"])): s for s in eng.health()["decode_plan"]}
    assert plan[("mlp/wd",)]["path"] == "unfused"
    assert plan[("attn/wk", "attn/wo", "attn/wq", "attn/wv")]["path"] == "fused"
    assert {s["m"] for s in plan.values()} == {KW["batch_slots"]}
    assert eng.ctx is ctx
    assert eng.params["layers"][1]["mlp"]["wd"].ctx is ctx
