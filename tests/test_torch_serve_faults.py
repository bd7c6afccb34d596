"""The port's fault injection, deferred retries, queue bound, cancel and
liveness against the reference's: the same requests and the same fault
specs through the JAX ``ServeEngine`` and the port's, on the reduced SmolLM
bridged from the reference (float and ``int8`` W4A4+LRC QLinears).

Each scenario compares the records (status, error kind, retries, tokens)
and the counters the two engines share; greedy tokens compare exactly, as
in ``test_torch_engine``.  On top of the reference's own chaos contract
(K targeted requests fail structurally, the other N-K finish bitwise as a
fault-free run), the port writes its page pool in place, so a failed
attempt must also leave no trace in the pool: the victim's pages, and in a
prefill attempt the null page, are written back."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.faults import FaultInjector as JaxFaultInjector
from repro.serve.faults import FaultSpec as JaxFaultSpec
from repro.serve.kvquant import KVSpec as JaxKVSpec
from repro_torch import bridge
from repro_torch.serve import (FaultInjector, FaultSpec, InjectedFault,
                               KVSpec, Request, RequestState, ServeEngine)
from repro_torch.serve.faults import FAULT_KINDS, HARD_KINDS, SimulatedCrash
from repro_torch.serve.paging import NULL_PAGE
from repro_torch.serve.sampling import NonFiniteLogitsError
from torch_parity import configs, jax_params, jax_qlinears, to_numpy_tree

N_REQ = 4
NEW_TOKENS = 5
KW = dict(batch_slots=2, max_seq=32)


class FakeClock:
    """A clock that moves only when slept on."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float):
        self.t += s


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    trees = {"float": jparams, "int8": jax_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 6).astype(np.int32)
               for _ in range(N_REQ)]
    return jcfg, tcfg, trees, ported, prompts


def _specs(specs, cls):
    return [cls(*s) for s in specs]


def _pair(setup, kind="float", specs=(), kv=None, inject_clock=False,
          deadlines=None, prepare=None, **kw):
    """Serve the same requests through both engines, each with its own
    injector built from ``specs`` ((kind, phase, rid, at_call, repeat,
    seconds) tuples); with ``inject_clock`` each engine and its injector
    share a :class:`FakeClock` of their own; ``prepare(engine)`` runs
    before the submits.  Returns (reference engine, port engine)."""
    jcfg, tcfg, trees, ported, prompts = setup
    engines = []
    for ref in (True, False):
        clock = FakeClock() if inject_clock else None
        inj_cls, spec_cls = ((JaxFaultInjector, JaxFaultSpec) if ref
                             else (FaultInjector, FaultSpec))
        inj_kw = {"sleep_fn": clock.sleep} if clock else {}
        inj = inj_cls(_specs(specs, spec_cls), **inj_kw) if specs else None
        eng_kw = dict(KW, injector=inj, **kw)
        if clock:
            eng_kw.update(clock=clock, sleep_fn=clock.sleep)
        if kv is not None:
            eng_kw["kv_spec"] = (JaxKVSpec if ref else KVSpec)(*kv)
        if ref:
            eng = JaxServeEngine(jcfg, trees[kind], **eng_kw)
        else:
            eng = ServeEngine(tcfg, ported[kind], device="cpu", **eng_kw)
        if prepare is not None:
            prepare(eng)
        req_cls = JaxRequest if ref else Request
        for i, p in enumerate(prompts):
            eng.submit(req_cls(rid=i, prompt=p.copy(), max_new_tokens=NEW_TOKENS,
                               deadline_s=(deadlines or {}).get(i)))
        eng.run(max_steps=500)
        engines.append(eng)
    return engines


def _records(eng):
    return {rid: (rec.status.value, None if rec.error_kind is None else str(rec.error_kind),
                  rec.retries, list(rec.out_tokens))
            for rid, rec in eng.records.items()}


def _assert_same(jeng, teng):
    assert _records(teng) == _records(jeng)
    shared = set(jeng.counters) & set(teng.counters)
    assert {k: teng.counters[k] for k in shared} == {k: jeng.counters[k] for k in shared}
    teng.alloc.check()


@pytest.fixture(scope="module")
def baseline(setup):
    """Fault-free streams of both param kinds, equal in the two engines."""
    out = {}
    for kind in ("float", "int8"):
        jeng, teng = _pair(setup, kind)
        _assert_same(jeng, teng)
        assert all(rec.ok for rec in teng.records.values())
        out[kind] = {rid: list(rec.out_tokens) for rid, rec in teng.records.items()}
    return out


# -- the injector itself ----------------------------------------------------


def test_spec_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultSpec("meteor", "decode", 0)
    with pytest.raises(ValueError, match="phase"):
        FaultSpec("exception", "epilogue", 0)
    with pytest.raises(ValueError, match="sampling"):
        FaultSpec("nan_logits", "sampling", 0)
    with pytest.raises(ValueError, match="repeat"):
        FaultSpec("exception", "decode", 0, repeat=0)
    with pytest.raises(ValueError, match="seconds"):
        FaultSpec("slow_step", "decode", 0, seconds=-1.0)
    assert set(HARD_KINDS) == set(FAULT_KINDS) - {"slow_step", "process_crash"}
    assert issubclass(InjectedFault, RuntimeError)
    assert not issubclass(SimulatedCrash, Exception)
    assert issubclass(NonFiniteLogitsError, FloatingPointError)


def test_poll_schedule_is_positional():
    spec = FaultSpec("exception", "decode", rid=1, at_call=2, repeat=2)
    inj = FaultInjector([spec])
    hits = [inj.poll(1, "decode") for _ in range(6)]
    assert [h is not None for h in hits] == [False, False, True, True, False, False]
    assert inj.poll(0, "decode") is None
    assert inj.poll(1, "prefill") is None
    assert inj.fired == [(spec, 2), (spec, 3)]
    assert inj.summary() == {"specs": 1, "targets": [1],
                             "fired": [("exception", "decode", 1, 2),
                                       ("exception", "decode", 1, 3)]}


@pytest.mark.parametrize("seed", range(8))
def test_sample_matches_reference(seed):
    """One seed targets the same rids with the same kinds and calls."""
    for kw in ({}, {"kinds": ("exception", "nan_logits"), "phase": "prefill",
                    "at_call_max": 5, "repeat": 3}):
        got = FaultInjector.sample(range(8), k=3, seed=seed, **kw)
        want = JaxFaultInjector.sample(range(8), k=3, seed=seed, **kw)
        assert [dataclasses.astuple(s) for s in got.specs] == \
            [dataclasses.astuple(s) for s in want.specs]
        assert got.targets == want.targets
    with pytest.raises(ValueError):
        FaultInjector.sample(range(4), k=5, seed=seed)


def test_corrupt_payloads():
    logits = torch.zeros((1, 32))
    nan = FaultInjector.corrupt_logits(logits, "nan_logits")
    inf = FaultInjector.corrupt_logits(logits, "inf_logits")
    assert torch.isnan(nan[0, ::7]).all() and int(torch.isnan(nan).sum()) == 5
    assert torch.isinf(inf).sum() == 5 and not logits.isnan().any()  # a clone
    cache = {"k": torch.ones(2, 3), "offset": torch.tensor(7)}
    bad = FaultInjector.corrupt_cache(cache)
    assert bad["k"].isnan().all() and int(bad["offset"]) == 7
    assert not cache["k"].isnan().any()
    rows = FaultInjector.corrupt_rows({"s": torch.ones(2, 3, 4)}, 1)["s"]
    assert rows[:, 1].isnan().all() and not rows[:, [0, 2]].isnan().any()
    # pages: in place, float leaves only (a quantized pool's scale planes)
    pool = {"k": torch.zeros(2, 5, 4, 1, 2, dtype=torch.int8),
            "k_scale": torch.ones(2, 5, 4, 1, 1)}
    assert FaultInjector.corrupt_pages(pool, [1, 3]) is pool
    assert not pool["k"].any()
    assert pool["k_scale"][:, [1, 3]].isnan().all()
    assert not pool["k_scale"][:, [0, 2, 4]].isnan().any()
    FaultInjector.corrupt_pages(pool, [])  # no pages: nothing to do


# -- the chaos matrix -------------------------------------------------------

MATRIX = [
    ("exception", "prefill"),
    ("exception", "decode"),
    ("exception", "sampling"),
    ("nan_logits", "prefill"),
    ("nan_logits", "decode"),
    ("inf_logits", "decode"),
    ("cache_corruption", "decode"),
]


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("fault,phase", MATRIX, ids=[f"{k}-{p}" for k, p in MATRIX])
def test_chaos_matrix_matches_reference(setup, baseline, kind, fault, phase):
    """K = 2 targeted requests fail structurally, the other N-K finish
    bitwise as the fault-free run, and every record and counter is the
    reference's."""
    targets = {1, 3}
    specs = [(fault, phase, rid, rid % 2 if phase != "prefill" else 0, 16)
             for rid in targets]
    jeng, teng = _pair(setup, kind, specs, max_retries=1)
    _assert_same(jeng, teng)
    for rid, rec in teng.records.items():
        if rid in targets:
            assert rec.status is RequestState.FAILED
            assert rec.error_kind in ("injected", "non_finite_logits")
            assert rec.retries == 1 and rec.error
        else:
            assert rec.ok and rec.out_tokens == baseline[kind][rid]
    assert teng.counters["retries"] == len(targets)
    assert teng.alloc.free_pages == teng.alloc.capacity
    assert not any(leaf.isnan().any() for leaf in teng.pool.values()
                   if leaf.is_floating_point())
    assert teng.injector.fired


def test_sampled_injector_matches_reference(setup, baseline):
    jcfg, tcfg, trees, ported, prompts = setup
    specs = [dataclasses.astuple(s)
             for s in FaultInjector.sample(range(N_REQ), k=2, seed=3).specs]
    jeng, teng = _pair(setup, "int8", specs, max_retries=2)
    _assert_same(jeng, teng)
    failed = {r for r, rec in teng.records.items() if rec.status is RequestState.FAILED}
    assert failed == {s[2] for s in specs} and len(failed) == 2
    for rid in set(range(N_REQ)) - failed:
        assert teng.records[rid].out_tokens == baseline["int8"][rid]


# -- transient faults: the retry restarts from clean state -----------------


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("fault,phase,at_call", [
    ("exception", "decode", 1), ("cache_corruption", "decode", 0),
    ("cache_corruption", "prefill", 1), ("nan_logits", "prefill", 0)])
def test_transient_fault_recovers_bitwise(setup, baseline, pool, fault, phase, at_call):
    """A fault that fires once is absorbed by the retry budget: every
    stream is the fault-free one.  The prefill rows poison the second of
    two 4-token chunks, whose padding rows write the null page."""
    kv = None if pool == "f32" else ("int8", None)
    clean_j, clean_t = _pair(setup, "int8", kv=kv, prefill_chunk=4)
    jeng, teng = _pair(setup, "int8", [(fault, phase, 2, at_call, 1)], kv=kv,
                       prefill_chunk=4, max_retries=2)
    _assert_same(jeng, teng)
    assert all(rec.ok for rec in teng.records.values())
    assert _records(clean_t) == _records(clean_j)
    assert {r: rec.out_tokens for r, rec in teng.records.items()} == \
        {r: rec.out_tokens for r, rec in clean_t.records.items()}
    assert teng.records[2].retries == 1 and teng.counters["retries"] == 1
    assert not any(leaf.isnan().any() for leaf in teng.pool.values()
                   if leaf.is_floating_point())


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("phase", ["decode", "prefill"])
def test_failed_attempt_leaves_no_trace(setup, pool, phase):
    """One attempt poisoned by ``cache_corruption`` and failed: the
    victim's pages and the null page hold exactly what they held before
    it, and no NaN is left anywhere in the pool."""
    _, tcfg, _, ported, prompts = setup
    kv = KVSpec() if pool == "f32" else KVSpec("int8")
    at_call = 1 if phase == "prefill" else 0
    inj = FaultInjector([FaultSpec("cache_corruption", phase, 0, at_call, 1)])
    eng = ServeEngine(tcfg, ported["int8"], device="cpu", injector=inj,
                      prefill_chunk=4, kv_spec=kv, **KW)
    eng.submit(Request(rid=0, prompt=prompts[0].copy(), max_new_tokens=NEW_TOKENS))
    eng.submit(Request(rid=1, prompt=prompts[1].copy(), max_new_tokens=NEW_TOKENS))
    eng._admit()  # both admitted; the first chunk of each prefilled
    if phase == "decode":
        eng._prefill_tick()  # the last chunks: both decoding now
    before = {n: leaf.clone() for n, leaf in eng.pool.items()}
    pages = eng.alloc.pages_of(0) + [NULL_PAGE]
    if phase == "decode":
        eng._step()
    else:
        eng._prefill_advance(0)
    assert inj.fired and eng.slot_req[0].retries == 1
    for name, leaf in eng.pool.items():
        assert torch.equal(leaf[:, pages], before[name][:, pages]), name
        if leaf.is_floating_point():
            assert not leaf.isnan().any()
    if phase == "decode":  # the co-tenant's step committed
        assert eng.slot_req[1].out_tokens and len(eng.slot_req[0].out_tokens) == 1
    eng.run()
    assert all(rec.ok for rec in eng.records.values())


# -- retries, backoff, deadlines --------------------------------------------


@pytest.mark.parametrize("repeat", [2, 3])
def test_retry_budget_boundary(setup, repeat):
    """repeat == max_retries recovers on the last attempt; one more fails."""
    jeng, teng = _pair(setup, "float", [("exception", "decode", 0, 0, repeat)],
                       max_retries=2)
    _assert_same(jeng, teng)
    assert teng.records[0].ok is (repeat == 2)
    assert teng.records[0].retries == 2


def test_retry_backoff_is_exponential(setup):
    slept = []  # the reference's two sleeps, then the port's
    jeng, teng = _pair(setup, "float", [("exception", "decode", 0, 0, 2)],
                       max_retries=3, retry_backoff_s=0.1, sleep_fn=slept.append)
    _assert_same(jeng, teng)
    assert teng.records[0].ok
    assert slept == pytest.approx([0.1, 0.2, 0.1, 0.2])


def test_slow_step_trips_deadline(setup, baseline):
    """A slow fault alone fails nothing; with a deadline it times out."""
    specs = [("slow_step", "decode", 1, 0, 1, 60.0)]
    jeng, teng = _pair(setup, "float", specs, inject_clock=True,
                       deadlines={1: 30.0})
    _assert_same(jeng, teng)
    assert teng.records[1].status is RequestState.TIMED_OUT
    assert teng.records[1].error_kind == "deadline"
    for rid in (0, 2, 3):
        assert teng.records[rid].out_tokens == baseline["float"][rid]
    jeng, teng = _pair(setup, "float", [("slow_step", "decode", 1, 0, 3, 60.0)],
                       inject_clock=True)
    _assert_same(jeng, teng)
    assert {r: rec.out_tokens for r, rec in teng.records.items()} == baseline["float"]


# -- slot quarantine and the stall watchdog --------------------------------


def test_slot_death_and_stall_watchdog(setup):
    """Permanent prefill faults kill both slots (limit 1); the watchdog
    stops run() with a report, the queued survivors TIMED_OUT 'stall'."""
    specs = [("exception", "prefill", rid, 0, 999) for rid in (0, 1)]
    jeng, teng = _pair(setup, "float", specs, max_retries=0, slot_failure_limit=1)
    _assert_same(jeng, teng)
    for rid in (2, 3):
        assert teng.records[rid].status is RequestState.TIMED_OUT
        assert teng.records[rid].error_kind == "stall"
    assert "slots dead" in teng.stall_report["reason"]
    h = teng.health()
    assert h["dead_slots"] == 2 and h["stalled"]
    assert [s["state"] for s in h["slots"]] == ["dead", "dead"]
    assert teng.counters["steps"] < 500


def test_stall_patience(setup):
    """No progress for ``stall_patience`` steps stops the run: the queue
    head waits for pages held by no request the engine serves."""
    jeng, teng = _pair(setup, "float", kv_pages=3, stall_patience=3,
                       prepare=lambda eng: eng.alloc.ensure(99, 32))
    _assert_same(jeng, teng)
    assert teng.stall_report["reason"] == jeng.stall_report["reason"]
    assert "no progress for 4 steps" in teng.stall_report["reason"]
    assert {rec.error_kind for rec in teng.records.values()} == {"stall"}
    assert teng.counters["steps"] == jeng.counters["steps"] == 4


def test_failure_streak_resets_on_success(setup):
    jeng, teng = _pair(setup, "float", [("exception", "decode", 0, 0, 16)],
                       max_retries=0, slot_failure_limit=2)
    _assert_same(jeng, teng)
    assert teng.records[0].status is RequestState.FAILED
    assert not any(teng.slot_dead)
    assert all(s["fail_streak"] <= 1 for s in teng.health()["slots"])


# -- the queue bound, cancel and health ---------------------------------------


@pytest.mark.parametrize("policy", ["reject_new", "drop_oldest"])
def test_queue_bound(setup, policy):
    jeng, teng = _pair(setup, "float", queue_limit=2, queue_policy=policy)
    _assert_same(jeng, teng)
    gone = {2, 3} if policy == "reject_new" else {0, 1}
    kind = "queue_full" if policy == "reject_new" else "queue_evicted"
    for rid, rec in teng.records.items():
        if rid in gone:
            assert rec.status is RequestState.REJECTED and rec.error_kind == kind
        else:
            assert rec.ok
    with pytest.raises(ValueError, match="queue_policy"):
        ServeEngine(setup[1], setup[3]["float"], device="cpu", queue_policy="lifo")


def test_cancel_and_health(setup):
    """cancel() of a queued, an in-flight, an unknown and a terminal rid,
    and ``health()``'s liveness fields, against the reference."""
    jcfg, tcfg, trees, ported, prompts = setup
    pair = []
    for ref in (True, False):
        eng = (JaxServeEngine(jcfg, trees["float"], **KW) if ref
               else ServeEngine(tcfg, ported["float"], device="cpu", **KW))
        req_cls = JaxRequest if ref else Request
        for i, p in enumerate(prompts):
            eng.submit(req_cls(rid=i, prompt=p.copy(), max_new_tokens=NEW_TOKENS))
        assert eng.cancel(3)              # queued
        eng.counters["steps"] += 1
        eng._admit()
        eng._step()
        assert eng.cancel(0)              # in flight, tokens kept
        assert not eng.cancel(99)         # unknown
        assert not eng.cancel(3)          # already terminal
        pair.append((eng, eng.health()))
        eng.run()
    (jeng, jh), (teng, th) = pair
    _assert_same(jeng, teng)
    assert teng.records[3].status is RequestState.CANCELLED
    assert teng.records[3].error == "cancelled while queued"
    assert teng.records[0].status is RequestState.CANCELLED
    assert teng.records[0].new_tokens == 2
    for key in ("slots", "queue_depth", "dead_slots", "steps_since_progress",
                "stalled", "journal_seq"):
        assert th[key] == jh[key], key
    assert th["journal_seq"] is None and th["slots"][0]["fail_streak"] == 0
