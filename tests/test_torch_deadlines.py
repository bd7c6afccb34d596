"""The port's engine clock and deadlines against the reference engine's:
the same requests on the same bridged model (reduced SmolLM, f32), each
engine with its own fake clock.

``Ticking`` advances by one unit at every read, so two engines agree on
every timestamp only if they read their clocks at the same points in the
same order (submit, admission, the first token, decoding, every terminal
state, the deadline check at the top of each step), as the port's engine
does the reference's.  ``Manual`` is set by the test, as the reference's
own lifecycle tests do.  Records compare exactly: status, error kind and
message, tokens (greedy, exact as in ``test_torch_engine``) and the
``timings`` values, which are differences of the fake clocks' floats."""

import numpy as np
import pytest

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.serve.engine import Request, RequestState, ServeEngine
from torch_parity import configs, jax_params, to_numpy_tree

KW = dict(batch_slots=2, max_seq=32, page_size=4, prefill_chunk=4)
TIMING_KEYS = {"queue_s", "first_token_s", "total_s"}


class Ticking:
    """A clock that moves one unit forward at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


class Manual:
    """A clock that stands still until the test moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    return jcfg, tcfg, jparams, bridge.params_from_jax(to_numpy_tree(jparams),
                                                       device="cpu")


def _prompts(cfg, lengths=(7, 3, 10, 5)):
    rng = np.random.default_rng(4)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]


def _engines(setup, clock=Ticking, **kw):
    """(reference engine, port engine), each with its own ``clock()``."""
    jcfg, tcfg, jparams, ported = setup
    jclock, tclock = clock(), clock()
    jeng = JaxServeEngine(jcfg, jparams, clock=jclock, **{**KW, **kw})
    teng = ServeEngine(tcfg, ported, device="cpu", clock=tclock, **{**KW, **kw})
    return (jeng, jclock), (teng, tclock)


def _submit(engines, prompts, overrides=None):
    """Submit request i (with ``overrides[i]``'s fields) to both engines;
    the two must accept or refuse alike."""
    (jeng, _), (teng, _) = engines
    for i, p in enumerate(prompts):
        kw = {"max_new_tokens": 6, **(overrides or {}).get(i, {})}
        assert jeng.submit(JaxRequest(rid=i, prompt=p, **kw)) \
            == teng.submit(Request(rid=i, prompt=p, **kw))


def _records(eng):
    return {rid: (rec.status.value, rec.error_kind, rec.error, rec.out_tokens,
                  rec.timings) for rid, rec in eng.records.items()}


def _assert_same(engines):
    (jeng, jclock), (teng, tclock) = engines
    assert _records(teng) == _records(jeng)
    shared = set(jeng.counters) & set(teng.counters)
    assert {k: teng.counters[k] for k in shared} == {k: jeng.counters[k] for k in shared}
    assert tclock.t == jclock.t
    assert teng.alloc.free_pages == teng.alloc.capacity


@pytest.mark.parametrize("deadline", [-1.0, 0.0])
def test_bad_deadline_rejected(setup, deadline):
    engines = _engines(setup)
    _submit(engines, _prompts(setup[1])[:2], {1: {"deadline_s": deadline}})
    for eng, _ in engines:
        eng.run()
    _assert_same(engines)
    rec = engines[1][0].records[1]
    assert rec.status is RequestState.REJECTED and rec.error_kind == "bad_deadline"
    assert rec.timings == {"total_s": 1.0}  # one clock read from submit to rejection


def test_expires_while_queued(setup):
    """One slot: request 1 waits behind request 0 and its deadline passes
    before a slot frees."""
    engines = _engines(setup, batch_slots=1)
    _submit(engines, _prompts(setup[1])[:3], {1: {"deadline_s": 5.0}})
    for eng, _ in engines:
        eng.run()
    _assert_same(engines)
    rec = engines[1][0].records[1]
    assert rec.status is RequestState.TIMED_OUT and rec.error_kind == "deadline"
    assert rec.error.endswith("expired while queued") and rec.new_tokens == 0
    assert set(rec.timings) == {"total_s"}


def test_expires_while_decoding(setup):
    """Request 0 times out mid-decode with its tokens kept; its pages go
    back and request 2, queued behind it, then runs to the end."""
    engines = _engines(setup)
    _submit(engines, _prompts(setup[1])[:3],
            {0: {"deadline_s": 25.0, "max_new_tokens": 20}})
    for eng, _ in engines:
        eng.run()
    _assert_same(engines)
    recs = engines[1][0].records
    assert recs[0].status is RequestState.TIMED_OUT and recs[0].error_kind == "deadline"
    assert 1 < recs[0].new_tokens < 20 and "expired after" in recs[0].error
    assert set(recs[0].timings) == TIMING_KEYS
    assert recs[1].ok and recs[2].ok


def test_default_deadline(setup):
    """``default_deadline_s`` applies to a request that sets none; one that
    sets its own keeps it."""
    engines = _engines(setup, batch_slots=1, default_deadline_s=8.0)
    _submit(engines, _prompts(setup[1])[:3], {2: {"deadline_s": 500.0}})
    for eng, _ in engines:
        eng.run()
    _assert_same(engines)
    recs = engines[1][0].records
    assert recs[0].status is RequestState.TIMED_OUT
    assert recs[1].status is RequestState.TIMED_OUT
    assert recs[2].ok


def test_timings_keys_and_values(setup):
    """Finished records carry queue, first-token and total seconds, equal to
    the reference's under the ticking clock, in order."""
    engines = _engines(setup)
    _submit(engines, _prompts(setup[1]))
    for eng, _ in engines:
        eng.run()
    _assert_same(engines)
    for rec in engines[1][0].records.values():
        assert rec.ok and set(rec.timings) == TIMING_KEYS
        t = rec.timings
        assert 0 < t["queue_s"] < t["first_token_s"] < t["total_s"]


def test_manual_clock_expiry(setup):
    """The reference's lifecycle scenarios on a clock the test moves: a
    request expires in flight once the clock passes its deadline, and one
    submitted with a deadline already past expires queued."""
    engines = _engines(setup, clock=Manual, batch_slots=1, prefill_chunk=None)
    _submit(engines, _prompts(setup[1])[:2], {0: {"deadline_s": 5.0, "max_new_tokens": 50},
                                                1: {"deadline_s": 3.0}})
    for eng, clock in engines:
        eng._admit()  # request 0 prefills whole at t = 0, one token out
        clock.t = 6.0
        eng.run()
    _assert_same(engines)
    recs = engines[1][0].records
    assert recs[0].status is RequestState.TIMED_OUT and recs[0].new_tokens == 1
    assert recs[1].status is RequestState.TIMED_OUT
    assert recs[1].error.endswith("expired while queued")
    assert recs[0].timings == {"queue_s": 0.0, "first_token_s": 0.0, "total_s": 6.0}
