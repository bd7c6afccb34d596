"""Write-ahead request journal for crash-safe serving.

A copy of ``repro/serve/journal.py`` (which imports no JAX), kept here so
that the port imports nothing of the reference package.  The framing and
the records are byte for byte the reference's, so either package reads a
journal the other wrote.

The journal is the engine's durability boundary: every externally visible
request effect — a submission accepted, a token committed, a terminal
record emitted — is appended (and fsync'd) here BEFORE the in-memory
effect happens.  After a crash, ``read_journal`` + ``collate`` reconstruct
the exact request truth: which requests exist, which tokens were already
delivered, which requests reached a terminal state.  Combined with an
engine snapshot (``ServeEngine.snapshot``) this gives bitwise replay
recovery — see docs/serving.md ("Crash recovery").

Record framing (append-only text, one record per line)::

    <crc32:8 hex> <json>\n

The CRC covers the JSON payload bytes, and every payload carries a
contiguous ``seq`` number.  On replay:

- a **torn tail** — an unterminated final line, or a final line whose CRC
  / JSON does not verify (a write cut mid-record by the crash) — is
  salvaged: the damaged tail is discarded and reported via
  ``JournalReplay.torn_tail``, and ``JournalWriter.reopen`` truncates the
  file back to the salvage point before appending continues;
- **mid-file damage** (a bad CRC, undecodable JSON, or a ``seq`` gap
  anywhere before the final record) raises :class:`JournalCorruption`
  naming the salvage point — replaying past lost records could
  double-deliver or drop tokens, so recovery refuses.

Record kinds (the full schema table lives in docs/serving.md):

``open``      engine construction: mode + the shape config a restored
              engine must be rebuilt with (batch_slots, max_seq, seed, …)
``submit``    full request payload (rid, prompt, budgets) — written before
              the request enters the queue
``admit``     rid -> slot placement (audit only; placement never affects
              outputs)
``token``     one committed token (rid, contiguous idx, token id) —
              written before the token is appended / delivered
``terminal``  one per rid, ever: status, error kind/message, retry count —
              written before the RequestRecord becomes visible
``snapshot``  marker that an engine snapshot completed (step, path)
``recover``   a restored engine re-attached to this journal (audit trail)
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from pathlib import Path
from typing import Dict, List, Optional

RECORD_KINDS = ("open", "submit", "admit", "token", "terminal", "snapshot",
                "recover")


class JournalError(RuntimeError):
    """Journal misuse or an unreplayable journal."""


class JournalCorruption(JournalError):
    """Damage before the final record — replaying past it could
    double-deliver or silently drop committed tokens, so recovery refuses
    and the message names the salvage point instead."""


@dataclasses.dataclass
class JournalReplay:
    """Result of :func:`read_journal`: every verified record plus the
    salvage point (``good_bytes`` / ``next_seq``) a writer may resume
    from.  ``torn_tail`` describes a discarded crash-torn final record
    (None for a cleanly terminated journal)."""

    records: List[dict]
    good_bytes: int
    next_seq: int
    torn_tail: Optional[str]


def _parse_line(line: bytes):
    """-> (record dict) or raises ValueError describing the damage."""
    if len(line) < 10 or line[8:9] != b" ":
        raise ValueError(f"malformed framing ({len(line)} byte line)")
    crc_hex, payload = line[:8], line[9:]
    try:
        want = int(crc_hex, 16)
    except ValueError:
        raise ValueError(f"non-hex checksum {crc_hex!r}")
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != want:
        raise ValueError(f"checksum mismatch (stored {crc_hex.decode()}, "
                         f"computed {got:08x})")
    try:
        rec = json.loads(payload)
    except json.JSONDecodeError as e:
        raise ValueError(f"checksummed payload is not JSON: {e}")
    if not isinstance(rec, dict) or "kind" not in rec or "seq" not in rec:
        raise ValueError("record missing 'kind'/'seq'")
    return rec


def read_journal(path) -> JournalReplay:
    """Replay a journal, verifying framing, checksums and seq contiguity.

    Returns every verified record; a damaged FINAL record (the classic
    crash-torn tail) is discarded and reported, damage anywhere earlier
    raises :class:`JournalCorruption` naming the salvage point."""
    path = Path(path)
    if not path.exists():
        raise JournalError(f"no journal at {path}")
    data = path.read_bytes()
    records: List[dict] = []
    pos = 0
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl == -1:
            return JournalReplay(
                records, pos, len(records),
                f"unterminated final record at byte {pos} "
                f"({len(data) - pos} trailing byte(s) discarded)")
        try:
            rec = _parse_line(data[pos:nl])
        except ValueError as why:
            if nl == len(data) - 1:
                # damage confined to the final record: a torn write
                return JournalReplay(
                    records, pos, len(records),
                    f"corrupt final record at byte {pos}: {why}")
            raise JournalCorruption(
                f"corrupt journal record {len(records)} at byte {pos} of "
                f"{path}: {why}; salvage point is the {len(records)} intact "
                f"record(s) / {pos} bytes before the damage — refusing to "
                f"replay past it") from None
        if rec["seq"] != len(records):
            # a seq gap means a WHOLE record vanished while later ones
            # survived — that is mid-file damage even on the final line
            raise JournalCorruption(
                f"journal sequence gap at byte {pos} of {path}: expected "
                f"seq {len(records)}, found {rec['seq']}; salvage point is "
                f"the {len(records)} record(s) before the gap")
        records.append(rec)
        pos = nl + 1
    return JournalReplay(records, pos, len(records), None)


class JournalWriter:
    """Append-only, fsync-per-record journal writer.

    A fresh writer refuses to clobber an existing non-empty journal
    (``overwrite=True`` to discard it); :meth:`reopen` resumes an existing
    journal after a crash, truncating any torn tail back to the salvage
    point first.  ``fsync=False`` drops the per-record fsync (tests);
    production keeps it — the WAL contract is that a record returned from
    :meth:`append` survives a process crash."""

    def __init__(self, path, *, fsync: bool = True, overwrite: bool = False):
        self.path = Path(path)
        self.fsync = fsync
        if self.path.exists() and self.path.stat().st_size and not overwrite:
            raise JournalError(
                f"journal {self.path} already exists and is non-empty; "
                f"recover with ServeEngine.restore / JournalWriter.reopen, "
                f"or pass overwrite=True to discard it")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self.seq = 0

    @classmethod
    def reopen(cls, path, replay: Optional[JournalReplay] = None,
               *, fsync: bool = True) -> "JournalWriter":
        """Resume appending to an existing journal: verify it (or reuse a
        :func:`read_journal` result), truncate any torn tail, continue the
        seq numbering."""
        if replay is None:
            replay = read_journal(path)
        w = cls.__new__(cls)
        w.path = Path(path)
        w.fsync = fsync
        w._f = open(w.path, "r+b")
        w._f.truncate(replay.good_bytes)
        w._f.seek(replay.good_bytes)
        w.seq = replay.next_seq
        return w

    def append(self, kind: str, **fields) -> int:
        """Durably append one record; returns its seq.  The record is on
        disk (fsync'd) before this returns — callers apply the in-memory
        effect only afterwards."""
        if kind not in RECORD_KINDS:
            raise JournalError(f"unknown record kind {kind!r}; "
                               f"one of {RECORD_KINDS}")
        seq = self.seq
        payload = json.dumps({"seq": seq, "kind": kind, **fields},
                             separators=(",", ":")).encode()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(b"%08x " % crc + payload + b"\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.seq = seq + 1
        return seq

    def close(self):
        if not self._f.closed:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass
class Collated:
    """Request truth extracted from a verified record stream (see
    :func:`collate`): insertion-ordered submits, per-rid delivered token
    streams, at-most-one terminal per rid, plus the open/snapshot/recover
    audit trail."""

    opens: List[dict]
    submits: Dict[int, dict]      # rid -> submit record, submission order
    tokens: Dict[int, List[int]]  # rid -> delivered tokens, idx order
    terminals: Dict[int, dict]    # rid -> terminal record
    snapshots: List[dict]
    recovers: List[dict]

    def pending(self) -> List[int]:
        """Non-terminal rids in submission order — the work a recovery
        must finish."""
        return [rid for rid in self.submits if rid not in self.terminals]


def collate(records: List[dict]) -> Collated:
    """Fold a verified record stream into per-request truth, enforcing the
    delivery invariants recovery depends on: token indices are contiguous
    per rid (a duplicate or gap would double-deliver or drop a committed
    token), at most one terminal per rid, and no event precedes its
    submit or follows its terminal."""
    out = Collated([], {}, {}, {}, [], [])
    for rec in records:
        kind, seq = rec["kind"], rec["seq"]
        if kind == "open":
            out.opens.append(rec)
        elif kind == "submit":
            rid = rec["rid"]
            if rid in out.submits:
                raise JournalCorruption(
                    f"record {seq}: duplicate submit for rid {rid}")
            out.submits[rid] = rec
        elif kind == "token":
            rid = rec["rid"]
            if rid not in out.submits:
                raise JournalCorruption(
                    f"record {seq}: token for unknown rid {rid}")
            if rid in out.terminals:
                raise JournalCorruption(
                    f"record {seq}: token for rid {rid} after its terminal "
                    f"record — double delivery")
            stream = out.tokens.setdefault(rid, [])
            if rec["idx"] != len(stream):
                raise JournalCorruption(
                    f"record {seq}: token idx {rec['idx']} for rid {rid} "
                    f"breaks contiguity (have {len(stream)} token(s)) — "
                    f"replay would double-deliver or drop a committed token")
            stream.append(int(rec["token"]))
        elif kind == "terminal":
            rid = rec["rid"]
            if rid not in out.submits:
                raise JournalCorruption(
                    f"record {seq}: terminal for unknown rid {rid}")
            if rid in out.terminals:
                raise JournalCorruption(
                    f"record {seq}: second terminal record for rid {rid} — "
                    f"a request terminates exactly once")
            out.terminals[rid] = rec
        elif kind == "snapshot":
            out.snapshots.append(rec)
        elif kind == "recover":
            out.recovers.append(rec)
        # "admit" records are audit-only: placement never affects outputs
    return out
