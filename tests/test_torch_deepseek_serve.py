"""The port's per-slot engine mode (``ServeEngine`` on the moe family)
against the reference's "slots" mode, on the reduced DeepSeek-V2 bridged
from the reference (float and ``int8`` W4A4+LRC QLinears): the same
requests through both engines give the same records (status, error kind,
retries, greedy tokens, exactly) and the same counters, and
``health()["mode"]`` is ``"slots"`` in both (the counterpart of the
reference's ``tests/test_serve_paging.py`` mode check).

Faults: the reference's chaos matrix (K = 2 of 4 requests targeted past
the retry budget, the others bitwise the fault-free run), its
``cache_corruption`` rows poisoning a copy of the victim's cache (the
slot's own cache is kept, so a transient corruption's retry is bitwise
the fault-free stream), the queue bound, cancel and a deadline.  Crash
recovery: a crash mid-decode restored from a snapshot (slots resume in
place) and from the journal alone, every stream bitwise the reference
engine's uninterrupted run and every rid terminal once.  A request whose
journal ran ahead of the snapshot re-prefills its prompt and feeds its
journaled tokens through the decode call (the reference re-prefills
prompt + tokens in one pass): the streams are the same.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.faults import FaultInjector as JaxFaultInjector
from repro.serve.faults import FaultSpec as JaxFaultSpec
from repro_torch import bridge
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import (FaultInjector, FaultSpec, JournalWriter, KVSpec,
                               Request, RequestState, ServeEngine, SimulatedCrash,
                               collate, read_journal)
from torch_moe_parity import ds_configs, ds_params, ds_qlinears
from torch_parity import to_numpy_tree

N_REQ = 4
NEW_TOKENS = 5
KW = dict(batch_slots=2, max_seq=32)
KINDS = ["float", "int8"]


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
    jcfg, tcfg = ds_configs("deepseek-v2-236b")
    jparams = ds_params(jcfg)
    trees = {"float": jparams, "int8": ds_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 6).astype(np.int32)
               for _ in range(N_REQ)]
    return jcfg, tcfg, trees, ported, prompts


def _pair(setup, kind="float", specs=(), deadlines=None, inject_clock=False,
          prepare=None, **kw):
    """Serve the same requests through both engines, each with its own
    injector built from ``specs`` ((kind, phase, rid, at_call, repeat,
    seconds) tuples).  Returns (reference engine, port engine)."""
    jcfg, tcfg, trees, ported, prompts = setup
    engines = []
    for ref in (True, False):
        clock = FakeClock() if inject_clock else None
        inj_cls, spec_cls = ((JaxFaultInjector, JaxFaultSpec) if ref
                             else (FaultInjector, FaultSpec))
        inj_kw = {"sleep_fn": clock.sleep} if clock else {}
        inj = inj_cls([spec_cls(*s) for s in specs], **inj_kw) if specs else None
        eng_kw = dict(KW, injector=inj, **kw)
        if clock:
            eng_kw.update(clock=clock, sleep_fn=clock.sleep)
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
    assert teng.health()["mode"] == jeng.health()["mode"] == "slots"
    # every slot holds a fresh cache once its request is done
    for cache in teng.slot_caches:
        assert int(cache["moe"]["offset"]) == 0
        assert not any(bool(leaf.isnan().any()) for c in cache.values()
                       for leaf in c.values() if leaf.is_floating_point())


@pytest.fixture(scope="module")
def baseline(setup):
    """Fault-free streams of both param kinds, equal in the two engines."""
    out = {}
    for kind in KINDS:
        jeng, teng = _pair(setup, kind)
        _assert_same(jeng, teng)
        assert all(rec.ok for rec in teng.records.values())
        out[kind] = {rid: list(rec.out_tokens) for rid, rec in teng.records.items()}
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_slots_engine_matches_reference(setup, baseline, kind):
    jeng, teng = _pair(setup, kind)
    _assert_same(jeng, teng)
    assert {r: list(rec.out_tokens) for r, rec in teng.records.items()} == baseline[kind]
    # one B=1 decode call per slot per step, one prefill per request
    assert teng.counters["decode_calls"] == N_REQ * (NEW_TOKENS - 1)
    assert teng.counters["prefill_calls"] == N_REQ
    h = teng.health()
    assert h["kv_pages"] is None and h["kv"]["bytes_per_token"] == (
        setup[1].n_layers * 4 * (setup[1].kv_lora_rank + setup[1].qk_rope_dim))
    assert h["decode_attention"] == h["prefill_attention"] == {
        "route": "gather", "kernel": None, "kv": "f32", "demoted": None}


def test_decode_plan_lists_expert_stacks_once(setup):
    _, tcfg, _, ported, _ = setup
    eng = ServeEngine(tcfg, ported["int8"], device="cpu", kernel_impl="pallas", **KW)
    plan = eng.health()["decode_plan"]
    expert = [p for p in plan if (p["k"], p["n"]) == (tcfg.d_model, tcfg.d_expert)]
    assert expert and all(p["m"] == 1 and p["path"] == "fused" for p in plan)
    assert {p["r"] for p in expert} == {max(1, round(0.1 * tcfg.d_expert))}


def test_bitwise_alone_and_with_cotenants(setup, baseline):
    """Each request served alone gives its co-tenant stream."""
    _, tcfg, _, ported, prompts = setup
    for rid, p in enumerate(prompts):
        eng = ServeEngine(tcfg, ported["int8"], device="cpu", **KW)
        eng.submit(Request(rid=rid, prompt=p.copy(), max_new_tokens=NEW_TOKENS))
        assert eng.run()[rid].out_tokens == baseline["int8"][rid]


MATRIX = [
    ("exception", "prefill"),
    ("exception", "decode"),
    ("exception", "sampling"),
    ("nan_logits", "prefill"),
    ("nan_logits", "decode"),
    ("inf_logits", "decode"),
    ("cache_corruption", "decode"),
    ("cache_corruption", "prefill"),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault,phase", MATRIX, ids=[f"{k}-{p}" for k, p in MATRIX])
def test_chaos_matrix_matches_reference(setup, baseline, kind, fault, phase):
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
    assert teng.injector.fired


@pytest.mark.parametrize("fault,phase,at_call", [
    ("exception", "decode", 1), ("cache_corruption", "decode", 0),
    ("cache_corruption", "prefill", 0), ("nan_logits", "prefill", 0),
    ("exception", "sampling", 2)])
def test_transient_fault_recovers_bitwise(setup, baseline, fault, phase, at_call):
    """A fault that fires once is absorbed by the retry budget: the slot
    kept its own cache, so every stream is the fault-free one."""
    jeng, teng = _pair(setup, "int8", [(fault, phase, 2, at_call, 1)])
    _assert_same(jeng, teng)
    assert {r: list(rec.out_tokens) for r, rec in teng.records.items()} == baseline["int8"]
    assert teng.records[2].retries == 1


def test_sampled_injector_matches_reference(setup, baseline):
    specs = [dataclasses.astuple(s)
             for s in FaultInjector.sample(range(N_REQ), k=2, seed=3).specs]
    jeng, teng = _pair(setup, "int8", specs, max_retries=2)
    _assert_same(jeng, teng)
    failed = {r for r, rec in teng.records.items() if rec.status is RequestState.FAILED}
    assert failed == {s[2] for s in specs}


def test_queue_bound_cancel_and_deadlines_match_reference(setup):
    def cancel_after_admit(eng):
        eng.cancel(99)  # unknown: False in both

    jeng, teng = _pair(setup, "float", queue_limit=1, queue_policy="drop_oldest",
                       prepare=cancel_after_admit)
    _assert_same(jeng, teng)
    jeng, teng = _pair(setup, "float", queue_limit=2)
    _assert_same(jeng, teng)
    assert sum(r.status is RequestState.REJECTED for r in teng.records.values()) == 2
    # a slow step under a fake clock times a deadlined request out in both
    jeng, teng = _pair(setup, "float", [("slow_step", "decode", 1, 1, 1, 5.0)],
                       deadlines={1: 2.0}, inject_clock=True)
    _assert_same(jeng, teng)
    assert teng.records[1].status is RequestState.TIMED_OUT
    # cancel in flight: the slot is released with a fresh cache
    _, tcfg, _, ported, prompts = setup
    eng = ServeEngine(tcfg, ported["float"], device="cpu", **KW)
    for i, p in enumerate(prompts[:2]):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=NEW_TOKENS))
    eng._admit()
    assert int(eng.slot_caches[0]["moe"]["offset"]) == len(prompts[0])
    assert eng.cancel(0) and eng.records[0].status is RequestState.CANCELLED
    assert eng.slot_req[0] is None and int(eng.slot_caches[0]["moe"]["offset"]) == 0


def test_slot_failure_limit_and_watchdog_match_reference(setup):
    specs = [("exception", "prefill", rid, 0, 16) for rid in range(N_REQ)]
    jeng, teng = _pair(setup, "float", specs, max_retries=0, slot_failure_limit=1)
    _assert_same(jeng, teng)
    assert teng.stall_report is not None or all(
        r.status is not RequestState.FINISHED for r in teng.records.values())


def test_slots_mode_refuses_paged_options(setup):
    _, tcfg, _, ported, _ = setup
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServeEngine(tcfg, ported["float"], device="cpu", prefill_chunk=4, **KW)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(tcfg, ported["float"], device="cpu", kv_spec=KVSpec("int8"), **KW)
    with pytest.raises(NotImplementedError, match="stacked"):
        ServeEngine(dataclasses.replace(tcfg, family="ssm"), ported["float"],
                    device="cpu", **KW)
    eng = ServeEngine(tcfg, ported["float"], device="cpu", kv_spec=KVSpec("bf16"), **KW)
    assert eng.slot_caches[0]["moe"]["c_kv"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine(tcfg, ported["float"], **KW)


# -- crash recovery ----------------------------------------------------------


def _engine(setup, kind, tmp_path, injector=None, snapshots=True, snapshot_every=2):
    _, tcfg, _, ported, _ = setup
    return ServeEngine(
        tcfg, ported[kind], device="cpu", injector=injector,
        journal=JournalWriter(tmp_path / "wal.log", fsync=False, overwrite=True),
        snapshot_dir=str(tmp_path / "snaps") if snapshots else None,
        snapshot_every=snapshot_every if snapshots else 0, **KW)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("snapshots", [True, False], ids=["snapshot", "journal-only"])
def test_crash_restore_is_bitwise(setup, baseline, tmp_path, kind, snapshots):
    """Rid 1 dies at its third decode call, one step after the snapshot of
    step 2: with snapshots rid 0 (which decoded in that step) is replayed
    from the journal and rid 1 resumes in place; journal-only, both
    replay.  Every stream is the reference engine's uninterrupted one."""
    _, tcfg, _, ported, prompts = setup
    spec = FaultSpec(kind="process_crash", phase="decode", rid=1, at_call=2)
    eng = _engine(setup, kind, tmp_path, FaultInjector([spec]), snapshots)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=NEW_TOKENS))
    with pytest.raises(SimulatedCrash):
        eng.run()
    eng.journal.close()
    eng2 = ServeEngine.restore(tcfg, ported[kind], tmp_path / "wal.log",
                               snapshot_dir=str(tmp_path / "snaps") if snapshots else None,
                               fsync=False, device="cpu")
    assert eng2.mode == "slots"
    marker = collate(read_journal(tmp_path / "wal.log").records).recovers[-1]
    if snapshots:
        assert marker["snapshot_step"] == 2 and 1 in marker["resumed"]
        assert 0 in marker["requeued"]
    else:
        assert marker["snapshot_step"] is None and not marker["resumed"]
    recs = eng2.run()
    eng2.journal.close()
    assert {r: list(rec.out_tokens) for r, rec in recs.items()} == baseline[kind]
    col = collate(read_journal(tmp_path / "wal.log").records)
    assert sorted(col.terminals) == list(range(N_REQ))
    assert all(col.tokens[r] == baseline[kind][r] for r in range(N_REQ))


def test_restore_refuses_a_paged_journal(setup, tmp_path):
    _, tcfg, _, ported, _ = setup
    with JournalWriter(tmp_path / "wal.log", fsync=False) as w:
        w.append("open", mode="paged", family="dense", batch_slots=2, max_seq=32,
                 eos_id=None, seed=0, page_size=16, kv_pages=5,
                 prefill_chunk=None, kv_dtype="f32", kv_group=None)
    from repro_torch.serve import JournalError

    with pytest.raises(JournalError, match="mode"):
        ServeEngine.restore(tcfg, ported["float"], tmp_path / "wal.log", fsync=False,
                            device="cpu")


def test_serve_cli_runs_deepseek(capsys, tmp_path):
    assert serve_cli.main(["--arch", "deepseek-v2-236b", "--device", "cpu",
                           "--requests", "3", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "slots mode" in out and "3 requests (3 finished)" in out
    assert serve_cli.main(["--arch", "deepseek-v3-671b", "--device", "cpu", "--quantize",
                           "--requests", "3", "--new-tokens", "3", "--inject-faults", "1",
                           "--parity-check"]) == 0
    assert serve_cli.main(["--arch", "deepseek-v2-236b", "--device", "cpu",
                           "--requests", "3", "--new-tokens", "4", "--crash-after", "1",
                           "--ckpt-dir", str(tmp_path), "--snapshot-every", "2",
                           "--parity-check"]) == 0
    with pytest.raises(SystemExit):  # one layer keeps no MoE layer
        serve_cli.main(["--arch", "deepseek-v2-236b", "--device", "cpu", "--layers", "1"])
