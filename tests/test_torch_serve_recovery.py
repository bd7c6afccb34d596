"""The port's write-ahead journal, snapshots and crash recovery against the
reference's: after a crash mid-flight, ``ServeEngine.restore`` finishes
every request exactly once with the token streams of the JAX engine's
uninterrupted run, on the reduced SmolLM bridged from the reference (float
and ``int8`` W4A4+LRC QLinears; f32, int8 and int4-g16 pools).

The journal is a copy of the reference's, so its unit tests here are the
reference's run against the port's module, and the two packages must read
each other's journals to the same truth: on the same run the port writes
the very bytes the reference writes.

A recovered request whose journal ran ahead of the snapshot re-prefills
its prompt and feeds its journaled tokens through the decode step (the
reference re-prefills prompt + tokens in one pass); the streams still
equal the uninterrupted run's, and the journal shows each token once."""

import json

import numpy as np
import pytest
import torch

from repro.serve import journal as jax_journal
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.faults import FaultInjector as JaxFaultInjector
from repro.serve.faults import FaultSpec as JaxFaultSpec
from repro.serve.kvquant import KVSpec as JaxKVSpec
from repro_torch import bridge
from repro_torch.serve import (ErrorKind, FaultInjector, FaultSpec,
                               JournalCorruption, JournalError, JournalWriter,
                               KVSpec, Request, RequestState, ServeEngine,
                               SimulatedCrash, collate, read_journal)
from torch_parity import configs, jax_params, jax_qlinears, to_numpy_tree

KW = dict(batch_slots=2, max_seq=64, seed=3)


# ---------------------------------------------------------------------------
# journal unit tests (the port's module)
# ---------------------------------------------------------------------------


def _write_records(path, n=5):
    with JournalWriter(path, fsync=False) as w:
        w.append("open", mode="paged", seed=0)
        for i in range(n - 1):
            w.append("submit", rid=i, prompt=[1, 2], max_new_tokens=4,
                     temperature=0.0, deadline_s=None)
    return path


def test_journal_roundtrip_and_seq(tmp_path):
    p = _write_records(tmp_path / "wal.log")
    rep = read_journal(p)
    assert rep.torn_tail is None
    assert [r["seq"] for r in rep.records] == list(range(5))
    assert rep.next_seq == 5 and rep.good_bytes == p.stat().st_size
    w = JournalWriter.reopen(p, rep, fsync=False)
    assert w.append("terminal", rid=0, status="finished", error_kind=None,
                    error=None, retries=0, n_tokens=0) == 5
    w.close()
    assert len(read_journal(p).records) == 6
    with pytest.raises(JournalError, match="unknown record kind"):
        JournalWriter(tmp_path / "x.log", fsync=False).append("meteor")


def test_journal_refuses_clobber_but_overwrites_on_request(tmp_path):
    p = _write_records(tmp_path / "wal.log")
    with pytest.raises(JournalError, match="already exists"):
        JournalWriter(p, fsync=False)
    JournalWriter(p, fsync=False, overwrite=True).close()
    assert read_journal(p).records == []
    with pytest.raises(JournalError, match="no journal"):
        read_journal(tmp_path / "missing.log")


def test_torn_tail_is_salvaged_and_truncated(tmp_path):
    p = _write_records(tmp_path / "wal.log")
    whole = p.read_bytes()
    last = whole.splitlines(keepends=True)[-1]
    for cut in (1, 10, len(last) - 1):
        p.write_bytes(whole[:-cut])
        rep = read_journal(p)
        assert rep.torn_tail is not None and len(rep.records) == 4
        w = JournalWriter.reopen(p, fsync=False)
        assert w.seq == 4
        w.close()
        assert p.stat().st_size == rep.good_bytes
        p.write_bytes(whole)
    lines = whole.splitlines(keepends=True)
    p.write_bytes(b"".join(lines[:-1]) + b"deadbeef garbage\n")
    rep = read_journal(p)
    assert rep.torn_tail is not None and len(rep.records) == 4


def test_mid_journal_corruption_refuses_replay(tmp_path):
    p = _write_records(tmp_path / "wal.log")
    lines = p.read_bytes().splitlines(keepends=True)
    bad = lines[2][:20] + b"X" + lines[2][21:]
    p.write_bytes(b"".join(lines[:2] + [bad] + lines[3:]))
    with pytest.raises(JournalCorruption, match="salvage point"):
        read_journal(p)
    p.write_bytes(b"".join(lines[:2] + lines[3:]))
    with pytest.raises(JournalCorruption, match="sequence gap"):
        read_journal(p)


def test_collate_enforces_delivery_invariants():
    def recs(*events):
        return [dict(seq=i, **e) for i, e in enumerate(events)]

    sub = {"kind": "submit", "rid": 1, "prompt": [1], "max_new_tokens": 4,
           "temperature": 0.0, "deadline_s": None}
    tok = lambda idx: {"kind": "token", "rid": 1, "idx": idx, "token": 9}
    term = {"kind": "terminal", "rid": 1, "status": "finished",
            "error_kind": None, "error": None, "retries": 0, "n_tokens": 1}
    col = collate(recs(sub, tok(0), tok(1), term))
    assert col.tokens[1] == [9, 9] and col.pending() == []
    with pytest.raises(JournalCorruption, match="contiguity"):
        collate(recs(sub, tok(0), tok(2)))
    with pytest.raises(JournalCorruption, match="exactly once"):
        collate(recs(sub, term, dict(term)))
    with pytest.raises(JournalCorruption, match="after its terminal"):
        collate(recs(sub, term, tok(0)))
    with pytest.raises(JournalCorruption, match="unknown rid"):
        collate(recs(tok(0)))
    with pytest.raises(JournalCorruption, match="duplicate submit"):
        collate(recs(sub, dict(sub)))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    trees = {"float": jparams, "int8": jax_qlinears(jcfg, jparams)}
    ported = {k: bridge.params_from_jax(to_numpy_tree(v), device="cpu")
              for k, v in trees.items()}
    return jcfg, tcfg, trees, ported


def _requests(cfg, cls=Request, n=4, base_len=5, new=6):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt=rng.integers(1, cfg.vocab_size, base_len + i).astype(np.int32),
                max_new_tokens=new)
            for i in range(n)]


_CLEAN = {}


def _clean_streams(setup, kind, kv=None):
    """The JAX engine's uninterrupted streams (computed once per kind and
    pool)."""
    key = (kind, kv)
    if key not in _CLEAN:
        jcfg, _, trees, _ = setup
        kw = dict(KW) if kv is None else dict(KW, kv_spec=JaxKVSpec(*kv))
        eng = JaxServeEngine(jcfg, trees[kind], **kw)
        for r in _requests(jcfg, JaxRequest):
            eng.submit(r)
        recs = eng.run()
        assert all(r.status.value == "finished" for r in recs.values())
        _CLEAN[key] = {rid: list(r.out_tokens) for rid, r in recs.items()}
    return _CLEAN[key]


def _engine(setup, kind, tmp_path, *, injector=None, snapshots=True,
            snapshot_every=2, kv=None, **kw):
    _, tcfg, _, ported = setup
    if kv is not None:
        kw["kv_spec"] = KVSpec(*kv)
    return ServeEngine(
        tcfg, ported[kind], device="cpu", injector=injector,
        journal=JournalWriter(tmp_path / "wal.log", fsync=False, overwrite=True),
        snapshot_dir=(str(tmp_path / "snaps") if snapshots else None),
        snapshot_every=(snapshot_every if snapshots else 0), **KW, **kw)


def _tick(eng, n=1):
    """n steps of the engine loop without run()'s drain at the end."""
    for _ in range(n):
        eng.counters["steps"] += 1
        eng._expire_deadlines()
        eng._admit()
        eng._prefill_tick()
        eng._step()


def _restore(setup, kind, tmp_path, snapshots=True, **kw):
    _, tcfg, _, ported = setup
    return ServeEngine.restore(
        tcfg, ported[kind], tmp_path / "wal.log",
        snapshot_dir=(str(tmp_path / "snaps") if snapshots else None),
        fsync=False, device="cpu", **kw)


def _finish_and_check(eng2, tmp_path, clean):
    recs = eng2.run()
    eng2.journal.close()
    assert set(recs) == set(clean)
    for rid, toks in clean.items():
        assert recs[rid].status is RequestState.FINISHED
        assert recs[rid].out_tokens == toks, f"rid {rid} diverged"
    col = collate(read_journal(tmp_path / "wal.log").records)
    assert sorted(col.terminals) == sorted(clean)  # exactly once each
    for rid, toks in clean.items():
        assert col.tokens[rid] == toks
    assert len(col.recovers) == 1
    assert eng2.alloc.free_pages == eng2.alloc.capacity
    return col


def _crash_restore_and_check(setup, kind, tmp_path, spec, snapshots=True,
                             kv=None, **engine_kw):
    clean = _clean_streams(setup, kind, kv)
    eng = _engine(setup, kind, tmp_path, injector=FaultInjector([spec]),
                  snapshots=snapshots, kv=kv, **engine_kw)
    for r in _requests(setup[1]):
        eng.submit(r)
    with pytest.raises(SimulatedCrash):
        eng.run()
    eng.journal.close()
    eng2 = _restore(setup, kind, tmp_path, snapshots)
    return eng2, _finish_and_check(eng2, tmp_path, clean)


KINDS = ["float", "int8"]


@pytest.mark.parametrize("kind", KINDS)
def test_crash_mid_decode_recovers_bitwise(setup, tmp_path, kind):
    eng2, col = _crash_restore_and_check(
        setup, kind, tmp_path,
        FaultSpec(kind="process_crash", phase="decode", rid=2, at_call=2))
    assert col.recovers[0]["snapshot_step"] is not None


@pytest.mark.parametrize("kind", KINDS)
def test_crash_mid_prefill_chunked_recovers_bitwise(setup, tmp_path, kind):
    """A crash inside a chunked prefill: the snapshot may hold a partial
    prompt (prefill_off > 0); recovery resumes the remaining chunks."""
    _crash_restore_and_check(
        setup, kind, tmp_path,
        FaultSpec(kind="process_crash", phase="prefill", rid=3, at_call=1),
        prefill_chunk=4, snapshot_every=1)


@pytest.mark.parametrize("kind", KINDS)
def test_crash_recovers_without_any_snapshot(setup, tmp_path, kind):
    """Journal-only recovery: every pending request re-prefills its prompt
    and feeds its journaled tokens."""
    eng2, col = _crash_restore_and_check(
        setup, kind, tmp_path,
        FaultSpec(kind="process_crash", phase="decode", rid=1, at_call=3),
        snapshots=False)
    assert eng2._ckpt is None and col.recovers[0]["snapshot_step"] is None
    assert col.recovers[0]["requeued"]


@pytest.mark.parametrize("kind,kv", [("float", None), ("int8", None),
                                     ("int8", ("int8", None))])
def test_stale_snapshot_degrades_to_replay(setup, tmp_path, kind, kv):
    """A snapshot the journal then outruns: the in-flight requests must not
    resume from its stale KV; they replay from the journal, into a fresh
    (quantized) pool too, and still match bitwise."""
    clean = _clean_streams(setup, kind, kv)
    eng = _engine(setup, kind, tmp_path, snapshot_every=0, kv=kv)
    for r in _requests(setup[1]):
        eng.submit(r)
    _tick(eng, 2)
    eng.snapshot()
    _tick(eng, 2)
    assert any(r is not None and r.out_tokens for r in eng.slot_req)
    eng.journal.close()  # abandoned mid-flight: the "crash"
    eng2 = _restore(setup, kind, tmp_path)
    col = _finish_and_check(eng2, tmp_path, clean)
    assert col.recovers[0]["requeued"]


@pytest.mark.parametrize("dtype,group", [("int8", None), ("int4", 16)])
def test_quantized_kv_crash_recovery_bitwise(setup, tmp_path, dtype, group):
    """The snapshot carries the quantized pool and its scale planes
    bitwise; the journal's open record carries the spec, so restore()
    takes none."""
    eng2, _ = _crash_restore_and_check(
        setup, "int8", tmp_path,
        FaultSpec(kind="process_crash", phase="decode", rid=2, at_call=2),
        kv=(dtype, group))
    assert eng2.kv_spec == KVSpec(dtype, group) and eng2.alloc.sidecar
    assert eng2.health()["kv"]["dtype"] == dtype
    with pytest.raises(JournalError, match="kv_spec"):
        _restore(setup, "int8", tmp_path, kv_spec=KVSpec(dtype, group))


@pytest.mark.parametrize("kind", KINDS)
def test_terminal_before_crash_is_not_replayed(setup, tmp_path, kind):
    clean = _clean_streams(setup, kind)
    eng = _engine(setup, kind, tmp_path, injector=FaultInjector([FaultSpec(
        kind="process_crash", phase="decode", rid=3, at_call=4)]))
    for r in _requests(setup[1]):
        eng.submit(r)
    eng.cancel(1)
    with pytest.raises(SimulatedCrash):
        eng.run()
    eng.journal.close()
    eng2 = _restore(setup, kind, tmp_path)
    assert eng2.records[1].status is RequestState.CANCELLED
    assert eng2.records[1].error_kind == ErrorKind.CANCELLED
    recs = eng2.run()
    eng2.journal.close()
    assert recs[1].status is RequestState.CANCELLED
    for rid in (0, 2, 3):
        assert recs[rid].out_tokens == clean[rid]
    assert len(collate(read_journal(tmp_path / "wal.log").records).terminals) == 4


@pytest.mark.parametrize("kind", KINDS)
def test_already_satisfied_stream_finalizes_without_decoding(setup, tmp_path, kind):
    clean = _clean_streams(setup, kind)
    jpath = tmp_path / "wal.log"
    eng0 = _engine(setup, kind, tmp_path, snapshots=False)
    for r in _requests(setup[1]):
        eng0.submit(r)
    eng0.run()
    eng0.journal.close()
    keep = [r for r in read_journal(jpath).records
            if not (r["kind"] == "terminal" and r["rid"] == 0)]
    with JournalWriter(jpath, fsync=False, overwrite=True) as w:
        for r in keep:
            w.append(r["kind"], **{k: v for k, v in r.items() if k not in ("seq", "kind")})
    eng2 = _restore(setup, kind, tmp_path, snapshots=False)
    assert eng2.records[0].status is RequestState.FINISHED
    assert eng2.records[0].out_tokens == clean[0]
    assert all(q.rid != 0 for q in eng2.queue)
    recs = eng2.run()
    eng2.journal.close()
    assert recs[0].out_tokens == clean[0]
    assert sorted(collate(read_journal(jpath).records).terminals) == [0, 1, 2, 3]


@pytest.mark.parametrize("kind,kv", [("float", None), ("int8", ("int8", None))])
def test_snapshot_restore_roundtrip_preserves_engine_state(setup, tmp_path, kind, kv):
    """Snapshot, then restore with no crash between: slots resume in
    place, and the pool (scale planes included), allocator, block tables,
    lengths and counters come back bitwise."""
    clean = _clean_streams(setup, kind, kv)
    eng = _engine(setup, kind, tmp_path, snapshot_every=0, kv=kv)
    for r in _requests(setup[1]):
        eng.submit(r)
    _tick(eng, 3)
    eng.snapshot()
    saved = {n: leaf.clone() for n, leaf in eng.pool.items()}
    eng.journal.close()
    eng2 = _restore(setup, kind, tmp_path)
    assert [r is not None for r in eng2.slot_req] == [r is not None for r in eng.slot_req]
    assert any(r is not None for r in eng2.slot_req)
    for name, leaf in saved.items():
        assert eng2.pool[name].dtype == leaf.dtype
        assert torch.equal(eng2.pool[name], leaf), name
    assert eng2.alloc.to_state() == eng.alloc.to_state()
    assert np.array_equal(eng2.block_tables, eng.block_tables)
    assert np.array_equal(eng2.lengths, eng.lengths)
    assert eng2.counters == eng.counters
    eng2.alloc.check()
    _finish_and_check(eng2, tmp_path, clean)


def test_restore_requires_open_record_matching_mode_and_device(setup, tmp_path):
    _, tcfg, _, ported = setup
    jpath = tmp_path / "wal.log"
    with JournalWriter(jpath, fsync=False) as w:
        w.append("submit", rid=0, prompt=[1], max_new_tokens=1,
                 temperature=0.0, deadline_s=None)
    with pytest.raises(JournalError, match="no open record"):
        ServeEngine.restore(tcfg, ported["float"], jpath, fsync=False, device="cpu")
    with JournalWriter(jpath, fsync=False, overwrite=True) as w:
        w.append("open", mode="stacked", family="ssm", batch_slots=2, max_seq=64,
                 eos_id=None, seed=3, page_size=16, kv_pages=None,
                 prefill_chunk=None, kv_dtype="f32", kv_group=None)
    with pytest.raises(JournalError, match="mode"):
        ServeEngine.restore(tcfg, ported["float"], jpath, fsync=False, device="cpu")
    with pytest.raises(JournalError, match="owns the journal"):
        ServeEngine.restore(tcfg, ported["float"], jpath, journal=None)
    if not torch.cuda.is_available():
        eng = _engine(setup, "float", tmp_path, snapshots=False)
        eng.journal.close()
        with pytest.raises(RuntimeError, match="cuda"):
            ServeEngine.restore(tcfg, ported["float"], jpath, fsync=False)


def test_damaged_snapshot_falls_back(setup, tmp_path):
    """A snapshot whose newest step lost a leaf file falls back to the
    older step; with every step damaged, recovery is journal-only."""
    clean = _clean_streams(setup, "float")
    eng = _engine(setup, "float", tmp_path, snapshot_every=0)
    for r in _requests(setup[1]):
        eng.submit(r)
    _tick(eng, 2)
    eng.snapshot()
    _tick(eng, 1)
    newest = eng.snapshot()
    eng.journal.close()
    manifest = json.loads((tmp_path / "snaps" / newest.split("/")[-1] / "manifest.json").read_text())
    pool_leaf = next(e for e in manifest["leaves"] if e["name"] == "state__pool__k")
    (tmp_path / "snaps" / newest.split("/")[-1] / pool_leaf["file"]).write_bytes(b"torn")
    with pytest.warns(UserWarning, match="falling back to step 2"):
        eng2 = _restore(setup, "float", tmp_path)
    col = _finish_and_check(eng2, tmp_path, clean)
    assert col.recovers[0]["snapshot_step"] == 2


# ---------------------------------------------------------------------------
# the two packages' journals
# ---------------------------------------------------------------------------


def _journaled_run(setup, kind, path, ref):
    """One run with a cancel, a failing target and a transient fault,
    journaled by the reference engine (``ref``) or the port's."""
    jcfg, tcfg, trees, ported = setup
    specs = [("nan_logits", "decode", 1, 1, 16), ("exception", "decode", 2, 0, 1)]
    if ref:
        eng = JaxServeEngine(jcfg, trees[kind], max_retries=1,
                             injector=JaxFaultInjector([JaxFaultSpec(*s) for s in specs]),
                             journal=jax_journal.JournalWriter(path, fsync=False), **KW)
    else:
        eng = ServeEngine(tcfg, ported[kind], device="cpu", max_retries=1,
                          injector=FaultInjector([FaultSpec(*s) for s in specs]),
                          journal=JournalWriter(path, fsync=False), **KW)
    for r in _requests(jcfg, JaxRequest if ref else Request):
        eng.submit(r)
    eng.cancel(3)
    eng.run()
    eng.journal.close()
    return path


def _truth(col):
    return (col.opens, col.submits, col.tokens, col.terminals)


@pytest.mark.parametrize("kind", KINDS)
def test_journals_read_across_packages(setup, tmp_path, kind):
    """Each package reads the other's journal to the same collated truth,
    and on the same run the port writes the reference's very bytes."""
    ours = _journaled_run(setup, kind, tmp_path / "port.wal", ref=False)
    theirs = _journaled_run(setup, kind, tmp_path / "ref.wal", ref=True)
    truth = _truth(collate(read_journal(theirs).records))
    assert _truth(jax_journal.collate(jax_journal.read_journal(ours).records)) == truth
    assert _truth(collate(read_journal(ours).records)) == truth
    assert _truth(jax_journal.collate(jax_journal.read_journal(theirs).records)) == truth
    assert ours.read_bytes() == theirs.read_bytes()
    terms = truth[3]
    assert terms[1]["status"] == "failed" and terms[1]["error_kind"] == "non_finite_logits"
    assert terms[2]["retries"] == 1 and terms[3]["status"] == "cancelled"


def test_port_restores_a_reference_journal(setup, tmp_path):
    """A journal the reference wrote up to a crash is recovered by the
    port (journal only): the streams are the reference's uninterrupted
    ones."""
    jcfg, tcfg, trees, ported = setup
    clean = _clean_streams(setup, "float")
    path = tmp_path / "wal.log"
    eng = JaxServeEngine(jcfg, trees["float"], injector=JaxFaultInjector([JaxFaultSpec(
        "process_crash", "decode", 2, 2)]),
        journal=jax_journal.JournalWriter(path, fsync=False), **KW)
    for r in _requests(jcfg, JaxRequest):
        eng.submit(r)
    with pytest.raises(BaseException, match="simulated crash"):
        eng.run()
    eng.journal.close()
    eng2 = ServeEngine.restore(tcfg, ported["float"], path, fsync=False, device="cpu")
    _finish_and_check(eng2, tmp_path, clean)


# ---------------------------------------------------------------------------
# the serving CLI's two harnesses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--inject-faults", "2", "--parity-check"],
    ["--crash-after", "2", "--snapshot-every", "4", "--parity-check"],
    ["--crash-after", "1", "--crash-phase", "prefill", "--prefill-chunk", "4",
     "--snapshot-every", "1", "--kv-dtype", "int8", "--parity-check"],
], ids=["chaos", "crash-decode", "crash-prefill-int8"])
def test_cli_harnesses_on_cpu(tmp_path, argv, capsys):
    from repro_torch.launch.serve import main

    common = ["--device", "cpu", "--quantize", "--requests", "4",
              "--new-tokens", "6", "--ckpt-dir", str(tmp_path)]
    assert main(common + argv) == 0
    out = capsys.readouterr().out
    assert "parity OK" in out
    assert ("chaos split OK" in out) or ("recovery chaos OK" in out)
