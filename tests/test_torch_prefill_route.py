"""Prefill attention over the paged pool on the kernel route (the dense
flash kernels' plain versions here, the tensors being on the CPU): the
port's ``paged_step`` against the reference's (which always gathers), the
engine's greedy streams across prefill chunk widths and page sizes, the
launch counts, the "auto" route's demotion of wide heads, and the port's
``kv_sweep`` pass against the reference's ``benchmarks/kv_sweep.py``.

Tolerances: logits within ATOL = 1e-4 on the f32 model
(``test_torch_model``: the frameworks and the two routes order their f32
sums differently; the gather route also rounds the gathered K/V to the
activations' dtype, which is f32 here, so it rounds nothing).  PPL within
2·ATOL relative: a log-softmax moves by at most twice the largest change
of its logits, so the mean log-likelihood, and log PPL, move by at most
2·ATOL.  Greedy streams compare token ids, exactly: the logits of the
compared runs agree far below any gap between the top two on these seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import eval_batches as jax_eval_batches
from benchmarks.kv_sweep import paged_ppl_and_acc as jax_paged_ppl_and_acc
from repro.models import model as jax_model
from repro.serve.kvquant import KVSpec as JaxKVSpec
from repro_torch import bridge
from repro_torch.bench import kv_sweep
from repro_torch.kernels import flash_attn
from repro_torch.kernels.context import KernelContext
from repro_torch.models import model
from repro_torch.models.config import reduced
from repro_torch.serve.engine import (Request, RequestState, ServeEngine,
                                      attention_report)
from repro_torch.serve.kvquant import KVSpec
from torch_parity import configs, jax_params, jax_qlinears, port, to_numpy_tree

ATOL = 1e-4
KERNEL_ROUTE = KernelContext(attention="kernel")
SPECS = [KVSpec(), KVSpec("int8"), KVSpec("int4", group=8)]


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


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.describe())
def test_paged_step_kernel_route_matches_reference(setup, spec):
    """A first chunk (a padding row), a second chunk at each row's own
    offset, then a decode step, through the reference's ``paged_step`` and
    the port's on the kernel route, on the same pool: every valid row's
    logits agree."""
    jcfg, tcfg, trees, ported = setup
    pool = jax_model.init_paged_cache(jcfg, 9, 4, dtype=jnp.float32,
                                      kv_spec=jspec(spec))
    jpool = dict(pool)
    tpool = bridge.cache_from_jax({k: np.asarray(v) for k, v in pool.items()},
                                  device="cpu")
    rng = np.random.default_rng(5)
    table = np.array([[3, 5, 0], [7, 2, 0]], np.int32)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    steps = [
        (tokens, np.tile(np.arange(6, dtype=np.int32), (2, 1)),
         np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]], bool)),
        (tokens[:, :4], np.array([[6, 7, 8, 9], [3, 4, 5, 6]], np.int32),
         np.ones((2, 4), bool)),
        (tokens[:, :1], np.array([[10], [7]], np.int32), np.ones((2, 1), bool)),
    ]
    flash_attn.reset_launches()
    for tok, pos, val in steps:
        want, jpool = jax_model.paged_step(
            jcfg, trees["float"], jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(val), jpool, jnp.asarray(table), kv_spec=jspec(spec))
        got, tpool = model.paged_step(
            tcfg, ported["float"], port(tok), port(pos), port(val), tpool,
            port(table), kv_spec=spec, ctx=KERNEL_ROUTE)
        got, want = got.numpy(), np.asarray(want)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got[val], want[val], rtol=0, atol=ATOL)
    name = "flash_attention_quant" if spec.is_quantized else "flash_attention"
    paged = "paged_" + name
    want = {k: 0 for k in flash_attn.LAUNCHES}
    want[name + "_plain"] = 2 * tcfg.n_layers
    want[paged + "_plain"] = tcfg.n_layers
    assert flash_attn.LAUNCHES == want


def _streams(cfg, params, prompts, **kw):
    eng = ServeEngine(cfg, params, device="cpu",
                      **{**dict(batch_slots=2, max_seq=32), **kw})
    for i, p in enumerate(prompts):
        assert eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = eng.run()
    assert all(rec.status is RequestState.FINISHED for rec in done.values())
    return eng, {rid: rec.out_tokens for rid, rec in done.items()}


@pytest.mark.parametrize("spec", SPECS + [KVSpec("bf16")], ids=lambda s: s.describe())
def test_streams_invariant_to_chunking_and_pages(setup, spec):
    """The reference's ``test_outputs_invariant_to_pages_batch_and_chunking``
    on the kernel route: every prefill chunk, whatever its offset and width
    (one token included), goes through the dense flash kernel, so the
    greedy streams are the same for prefill_chunk None, 1, 3 and 4 and
    page sizes 4 and 5; each run launches the prefill kernel once per layer
    and prefill call, the decode kernel once per layer and decode call, and
    nothing else."""
    _, tcfg, _, ported = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (7, 3, 10, 5, 9)]
    name = "flash_attention_quant" if spec.is_quantized else "flash_attention"
    runs = []
    for page in (4, 5):
        for chunk in (None, 1, 3, 4):
            flash_attn.reset_launches()
            eng, got = _streams(tcfg, ported["int8"], prompts, page_size=page,
                                prefill_chunk=chunk, kv_spec=spec, ctx=KERNEL_ROUTE)
            want = {k: 0 for k in flash_attn.LAUNCHES}
            want[name + "_plain"] = tcfg.n_layers * eng.counters["prefill_calls"]
            want["paged_" + name + "_plain"] = (tcfg.n_layers
                                                * eng.counters["decode_calls"])
            assert flash_attn.LAUNCHES == want
            assert eng.counters["prefill_calls"] >= len(prompts)
            runs.append(got)
    assert all(r == runs[0] for r in runs[1:])
    assert eng.health()["prefill_attention"] == {
        "route": "kernel", "kernel": name, "kv": spec.describe(), "demoted": None}


def test_auto_route_demotes_wide_heads(setup):
    """Under "auto" a CUDA device takes the kernel route; a dense
    attention (prefill, forward, walk) only for head dims the flash kernels
    take (``flash_attn.MAX_D``, 256), wider heads (here MAX_D + 64)
    demoting to gather from shapes, with the reason in ``attention_plan``
    and in the engine's report.  Decode keeps the paged kernels, which have
    no such limit; an explicit route is kept (its wrapper raises on the
    card).  Nothing here needs a card."""
    cuda = torch.device("cuda")
    auto = KernelContext()
    wide = flash_attn.MAX_D + 64
    assert auto.attention_route(cuda, head_dim=wide) == "gather"
    assert auto.attention_route(cuda, head_dim=flash_attn.MAX_D) == "kernel"
    assert auto.attention_route(cuda, head_dim=wide, decode=True) == "kernel"
    plan = auto.attention_plan(cuda, wide)
    assert plan.route == "gather" and "MAX_D" in plan.demoted
    assert KERNEL_ROUTE.attention_plan(cuda, wide) == ("kernel", None)
    assert auto.attention_plan("cpu", wide) == ("gather", None)
    rep = attention_report(auto, cuda, wide, KVSpec("int8"), decode=False)
    assert rep["route"] == "gather" and rep["kernel"] is None
    assert f"head_dim {wide}" in rep["demoted"]
    assert attention_report(auto, cuda, wide, KVSpec("int8"), decode=True) == {
        "route": "kernel", "kernel": "paged_flash_attention_quant",
        "kv": "int8", "demoted": None}
    for decode, kernel in ((False, "flash_attention"),
                           (True, "paged_flash_attention")):
        assert attention_report(auto, cuda, 64, KVSpec("int8"), decode) == {
            "route": "kernel", "kernel": kernel + "_quant", "kv": "int8",
            "demoted": None}
        assert attention_report(auto, cuda, 64, KVSpec(), decode)["kernel"] == kernel
    _, tcfg, _, ported = setup
    eng = ServeEngine(tcfg, ported["float"], device="cpu")
    health = eng.health()
    assert health["prefill_attention"] == {"route": "gather", "kernel": None,
                                           "kv": "f32", "demoted": None}
    assert health["decode_attention"]["route"] == "gather"


def test_wide_head_model_serves_on_the_gather_route():
    """A head_dim-256 model (as Gemma's) under "auto" on the CPU, where
    "auto" takes the gather route: the routes are planned from shapes, and
    the engine serves it (its kernel route: ``test_torch_gemma``)."""
    cfg = reduced(configs()[1], head_dim=256)
    params = model.init_params(cfg, seed=0, device="cpu")
    eng, got = _streams(cfg, params, [np.arange(5, dtype=np.int32)], page_size=4)
    assert len(got[0]) == 6
    assert eng.health()["prefill_attention"]["route"] == "gather"


def test_eval_batches_match_reference(setup):
    jcfg, tcfg, _, _ = setup
    want = jax_eval_batches(jcfg, n=2, bsz=3, seq=16)
    got = kv_sweep.eval_batches(tcfg, n=2, bsz=3, seq=16, device="cpu")
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w["tokens"]), g["tokens"].numpy())


@pytest.mark.parametrize("spec", [KVSpec(), KVSpec("int8"), KVSpec("int4", group=128)],
                         ids=lambda s: s.describe())
def test_paged_ppl_and_acc_match_reference(setup, spec):
    """The port's ``paged_ppl_and_acc`` (gather and kernel route) against
    ``benchmarks.kv_sweep.paged_ppl_and_acc`` on the same bridged float
    model and batches: PPL within 2·ATOL relative, ACC equal."""
    jcfg, tcfg, trees, ported = setup
    jevals = jax_eval_batches(jcfg, n=2, bsz=3, seq=24)
    tevals = kv_sweep.eval_batches(tcfg, n=2, bsz=3, seq=24, device="cpu")
    want = jax_paged_ppl_and_acc(jcfg, trees["float"], jevals, jspec(spec))
    for ctx in (None, KERNEL_ROUTE):
        ppl, acc = kv_sweep.paged_ppl_and_acc(tcfg, ported["float"], tevals, spec, ctx)
        assert abs(np.log(ppl) - np.log(want[0])) <= 2 * ATOL
        assert acc == want[1]


def test_sweep_table(setup):
    """``run`` gives the reference's rows: the forward, then each pool with
    its bytes per token here and at the reference geometry."""
    _, tcfg, _, ported = setup
    evals = kv_sweep.eval_batches(tcfg, n=1, bsz=2, seq=16, device="cpu")
    header, rows, results = kv_sweep.run(tcfg, ported["float"], evals)
    assert header == kv_sweep.HEADER and [r[0] for r in rows] == [
        "fp-forward", "f32", "int8", "int4-g128"]
    assert rows[1][5] == tcfg.n_layers * 2 * tcfg.n_kv_heads * 4 * tcfg.head_dim
    assert [r[6] for r in rows[1:]] == [8192, 2 * 8 * (128 + 4), 2 * 8 * (64 + 4)]
    assert abs(results["f32"][0] - rows[0][1]) <= 2 * ATOL * rows[0][1]
