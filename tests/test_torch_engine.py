"""The port's paged serving engine against the reference's, and its own
contracts: greedy token streams equal to the JAX ``ServeEngine``'s on the
same bridged parameters (float, and ``int8`` W4A4+LRC QLinears), one model
call per decode step, page conservation, invariance to slot placement, and
the device rule (no card, no engine, unless told ``device="cpu"``).

Greedy decoding compares token ids, so the check is exact: the two
engines' logits agree to ~1e-6 (``test_torch_model``), and the seed below
gives no near-tie that this could flip."""

import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.serve.engine import Request, RequestState, ServeEngine
from repro_torch.serve.paging import NULL_PAGE, PageAllocator
from repro_torch.serve.sampling import (NonFiniteLogitsError, sample_token,
                                        sampling_generator)
from torch_parity import configs, jax_params, jax_qlinears, to_numpy_tree

KW = dict(batch_slots=2, max_seq=32, page_size=4, prefill_chunk=4)


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
    return eng, eng.run()


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_token_streams_match_reference(setup, kind):
    jcfg, tcfg, trees, ported = setup
    prompts = _prompts(tcfg)
    jeng = JaxServeEngine(jcfg, trees[kind], **KW)
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
    want = {rid: rec.out_tokens for rid, rec in jeng.run().items()}
    eng, done = _serve(tcfg, ported[kind], prompts)
    assert all(rec.status is RequestState.FINISHED for rec in done.values())
    got = {rid: rec.out_tokens for rid, rec in done.items()}
    assert got == want
    # on the CPU "auto" keeps the calibrated impl, as the reference does
    if kind == "int8":
        assert eng.params["layers"][0]["attn"]["wq"].impl == "int8"
    assert eng.counters["decode_calls"] == jeng.counters["decode_calls"]


def test_one_model_call_per_decode_step(setup):
    _, tcfg, _, ported = setup
    eng = ServeEngine(tcfg, ported["int8"], device="cpu", **KW)
    for i, p in enumerate(_prompts(tcfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    calls = []
    inner, step = eng._paged, eng._step

    def paged(params, tokens, *rest, **kw):
        calls.append(tuple(tokens.shape))
        return inner(params, tokens, *rest, **kw)

    per_step = []

    def counted_step():
        before = len(calls)
        out = step()
        per_step.append(len(calls) - before)
        return out

    eng._paged, eng._step = paged, counted_step
    done = eng.run()
    assert all(rec.new_tokens == 5 for rec in done.values())
    decodes = [c for c in calls if c == (KW["batch_slots"], 1)]
    assert max(per_step) == 1  # the decode step makes ONE batched call
    assert len(decodes) == sum(per_step) == eng.counters["decode_calls"]
    assert len(calls) == eng.counters["decode_calls"] + eng.counters["prefill_calls"]


def test_page_conservation_through_a_run(setup):
    _, tcfg, _, ported = setup
    eng = ServeEngine(tcfg, ported["float"], device="cpu", **KW)
    for i, p in enumerate(_prompts(tcfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=7))
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng._admit()
        eng._prefill_tick()
        eng._step()
        eng.alloc.check()
        held = sum(eng.alloc.holds(r.rid) for r in eng.slot_req if r is not None)
        assert held == eng.alloc.used_pages
        for i, r in enumerate(eng.slot_req):
            row = eng.block_tables[i]
            if r is None:
                assert not row.any()
            else:
                assert list(row[row > 0]) == eng.alloc.pages_of(r.rid)
    assert eng.alloc.free_pages == eng.alloc.capacity
    assert eng.health()["kv_pages"]["used"] == 0


def test_outputs_invariant_to_slot_placement(setup):
    """Same requests with a different slot count, in reverse submission
    order, and on a pool fragmented before admission: same tokens."""
    _, tcfg, _, ported = setup
    prompts = _prompts(tcfg)
    _, base = _serve(tcfg, ported["int8"], prompts)
    want = {rid: rec.out_tokens for rid, rec in base.items()}

    eng = ServeEngine(tcfg, ported["int8"], device="cpu", **{**KW, "batch_slots": 3})
    eng.alloc.ensure(99, 9)  # three pages held by nobody the engine serves
    for i in reversed(range(len(prompts))):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=6))
    got = {rid: rec.out_tokens for rid, rec in eng.run().items()}
    assert got == want
    _, one = _serve(tcfg, ported["int8"], prompts, batch_slots=1,
                    prefill_chunk=None)
    assert {rid: rec.out_tokens for rid, rec in one.items()} == want


def test_engine_needs_a_card_unless_told_cpu(setup):
    _, tcfg, _, ported = setup
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tcfg, ported["float"])
    assert ServeEngine(tcfg, ported["float"], device="cpu").health()["device"] == "cpu"


def test_admission_rejects(setup):
    _, tcfg, _, ported = setup
    eng = ServeEngine(tcfg, ported["float"], device="cpu", **KW)
    ok = np.arange(5, dtype=np.int32)
    assert eng.submit(Request(rid=0, prompt=ok))
    assert not eng.submit(Request(rid=0, prompt=ok))  # duplicate rid
    cases = {1: (np.arange(40, dtype=np.int32), "prompt_too_long"),
             2: (np.array([tcfg.vocab_size], np.int32), "bad_token_ids"),
             3: (np.array([], np.int32), "empty_prompt")}
    for rid, (prompt, kind) in cases.items():
        assert not eng.submit(Request(rid=rid, prompt=prompt))
        assert eng.records[rid].status is RequestState.REJECTED
        assert eng.records[rid].error_kind == kind
    assert not eng.submit(Request(rid=4, prompt=ok, max_new_tokens=0))
    assert eng.records[4].error_kind == "bad_token_budget"
    small = ServeEngine(tcfg, ported["float"], device="cpu", kv_pages=3, **KW)
    assert not small.submit(Request(rid=0, prompt=np.arange(12, dtype=np.int32)))
    assert small.records[0].error_kind == "kv_capacity"


def test_non_finite_logits_fail_the_request(setup):
    _, tcfg, _, ported = setup
    params = dict(ported["float"], final_norm=torch.full_like(
        ported["float"]["final_norm"], float("nan")))
    eng, done = _serve(tcfg, params, _prompts(tcfg)[:2])
    assert {rec.status for rec in done.values()} == {RequestState.FAILED}
    assert {rec.error_kind for rec in done.values()} == {"non_finite_logits"}
    # each went through the default retry budget before it failed
    assert {rec.retries for rec in done.values()} == {2}
    assert eng.alloc.free_pages == eng.alloc.capacity


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("page_size", [1, 3, 8])
def test_allocator_never_leaks_or_double_allocates(seed, page_size):
    alloc = PageAllocator(20, page_size)
    rng = np.random.default_rng(seed)
    held = {}
    for _ in range(60):
        rid = int(rng.integers(0, 5))
        if rng.integers(2) and held:
            victim = int(rng.choice(sorted(held)))
            assert alloc.free(victim) == held.pop(victim)
            assert alloc.free(victim) == 0  # a second free refunds nothing
        else:
            n = int(rng.integers(0, 6 * page_size + 1))
            before = (alloc.free_pages, alloc.holds(rid))
            got = alloc.ensure(rid, n)
            if got is None:
                assert alloc.pages_for(n) - before[1] > before[0]
                assert (alloc.free_pages, alloc.holds(rid)) == before
            else:
                assert NULL_PAGE not in got
                if alloc.holds(rid):
                    held[rid] = alloc.holds(rid)
        alloc.check()
        assert alloc.used_pages == sum(held.values())


def test_sampling_keys_and_guard():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 3.0, 0.0]])
    assert sample_token(logits).tolist() == [1, 0]  # ties: the first index
    draws = [sample_token(logits, sampling_generator(7, 3, 2, "cpu"),
                          temperature=1.0).tolist() for _ in range(2)]
    assert draws[0] == draws[1]
    many = {tuple(sample_token(logits.repeat(8, 1),
                               sampling_generator(7, rid, 0, "cpu"),
                               temperature=5.0).tolist()) for rid in range(8)}
    assert len(many) > 1  # the key depends on the rid
    with pytest.raises(NonFiniteLogitsError):
        sample_token(torch.tensor([[float("nan"), 1.0]]), check_finite=True)
