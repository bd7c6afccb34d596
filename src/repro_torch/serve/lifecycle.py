"""Request lifecycle for the serving engine: states, transitions, records.

A copy of ``repro/serve/lifecycle.py`` (which imports no JAX), kept here so
that the port imports nothing of the reference package.

Every request moves along this state machine — and ONLY along it; the
engine routes every status change through :meth:`Request.advance`, which
raises :class:`IllegalTransition` on any other edge:

    QUEUED ──> PREFILLING ──> DECODING ──> FINISHED
      │            │              ├──> FAILED / CANCELLED / TIMED_OUT
      │            ├──> FINISHED  (termination predicate already met by
      │            │               the prefill-sampled token: EOS at
      │            │               prefill, max_new_tokens == 1, seq cap)
      │            └──> FAILED / CANCELLED / TIMED_OUT
      └──> CANCELLED / TIMED_OUT / REJECTED

Terminal states are absorbing.  ``REJECTED`` is only reachable from
``QUEUED`` — admission control refuses bad input (oversized prompt,
out-of-vocab ids, non-positive token budget, full queue) at ``submit()``
time, before it can touch a slot cache.

This contract is what the upcoming batched-decode / paged-KV refactors
must preserve: however the caches are laid out, a request's observable
life is exactly one path through this graph, finalized as one
:class:`RequestRecord`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, FrozenSet, List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    REJECTED = "rejected"

    def __str__(self):  # "finished", not "RequestState.FINISHED", in reports
        return self.value


class ErrorKind(str, enum.Enum):
    """The error-kind taxonomy for ``RequestRecord.error_kind``.

    One documented vocabulary instead of string literals scattered through
    ``_classify_error`` and the tests.  Members are ``str`` subclasses, so
    ``record.error_kind == "kv_pages_exhausted"`` keeps working and the
    values serialize verbatim into journal terminal records.

    Admission kinds (``REJECTED`` at ``submit()`` time, never retried):
    ``duplicate_rid``, ``empty_prompt``, ``bad_token_ids``,
    ``prompt_too_long``, ``kv_capacity``, ``bad_token_budget``,
    ``bad_deadline``, ``queue_full``, ``queue_evicted``.

    Attempt-failure kinds (**retryable** within the engine's bounded retry
    budget — see :data:`RETRYABLE_KINDS` — then terminal as ``FAILED``):
    ``injected``, ``non_finite_logits``, ``kv_pages_exhausted``,
    ``exception``.

    Terminal-cause kinds (stamped directly on CANCELLED / TIMED_OUT /
    crash-drained records, never retried): ``cancelled``, ``deadline``,
    ``stall``, ``step_limit``, ``simulated_crash``.
    """

    # -- admission (REJECTED) ------------------------------------------------
    DUPLICATE_RID = "duplicate_rid"
    EMPTY_PROMPT = "empty_prompt"
    BAD_TOKEN_IDS = "bad_token_ids"
    PROMPT_TOO_LONG = "prompt_too_long"
    KV_CAPACITY = "kv_capacity"
    BAD_TOKEN_BUDGET = "bad_token_budget"
    BAD_DEADLINE = "bad_deadline"
    QUEUE_FULL = "queue_full"
    QUEUE_EVICTED = "queue_evicted"
    # -- attempt failures (retryable, then FAILED) ---------------------------
    INJECTED = "injected"
    NON_FINITE_LOGITS = "non_finite_logits"
    KV_PAGES_EXHAUSTED = "kv_pages_exhausted"
    EXCEPTION = "exception"
    # -- terminal causes -----------------------------------------------------
    CANCELLED = "cancelled"
    DEADLINE = "deadline"
    STALL = "stall"
    STEP_LIMIT = "step_limit"
    SIMULATED_CRASH = "simulated_crash"

    # plain-string rendering ("deadline", not "ErrorKind.DEADLINE") in
    # reports, f-strings and json payloads
    __str__ = str.__str__
    __format__ = str.__format__


RETRYABLE_KINDS: FrozenSet[ErrorKind] = frozenset({
    ErrorKind.INJECTED,
    ErrorKind.NON_FINITE_LOGITS,
    ErrorKind.KV_PAGES_EXHAUSTED,
    ErrorKind.EXCEPTION,
})


TERMINAL_STATES: FrozenSet[RequestState] = frozenset({
    RequestState.FINISHED,
    RequestState.FAILED,
    RequestState.CANCELLED,
    RequestState.TIMED_OUT,
    RequestState.REJECTED,
})

LEGAL_TRANSITIONS: Dict[RequestState, FrozenSet[RequestState]] = {
    RequestState.QUEUED: frozenset({
        RequestState.PREFILLING,
        RequestState.CANCELLED,
        RequestState.TIMED_OUT,
        RequestState.REJECTED,
    }),
    RequestState.PREFILLING: frozenset({
        RequestState.DECODING,
        RequestState.FINISHED,
        RequestState.FAILED,
        RequestState.CANCELLED,
        RequestState.TIMED_OUT,
    }),
    RequestState.DECODING: frozenset({
        RequestState.FINISHED,
        RequestState.FAILED,
        RequestState.CANCELLED,
        RequestState.TIMED_OUT,
    }),
    **{s: frozenset() for s in TERMINAL_STATES},
}


class IllegalTransition(RuntimeError):
    """A request was asked to move along an edge the state machine forbids."""


@dataclasses.dataclass
class Request:
    """One generation request plus its live lifecycle bookkeeping.

    ``deadline_s`` is a wall-clock budget measured from ``submit()``; the
    engine expires the request (wherever it is — queued, prefilling or
    decoding) once the engine clock passes ``submitted_at + deadline_s``.
    """

    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    out_tokens: list = dataclasses.field(default_factory=list)
    state: RequestState = RequestState.QUEUED
    # engine-clock timestamps (None until stamped)
    submitted_at: Optional[float] = None
    started_at: Optional[float] = None  # prefill start
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None  # any terminal state
    retries: int = 0
    error_kind: Optional[str] = None
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def deadline_at(self) -> Optional[float]:
        if self.deadline_s is None or self.submitted_at is None:
            return None
        return self.submitted_at + self.deadline_s

    def advance(self, new_state: RequestState, now: Optional[float] = None):
        """Move to ``new_state``, enforcing the transition graph and
        stamping the phase timestamps."""
        if new_state not in LEGAL_TRANSITIONS[self.state]:
            raise IllegalTransition(
                f"request {self.rid}: {self.state.value} -> {new_state.value} "
                f"is not a legal transition (legal: "
                f"{sorted(s.value for s in LEGAL_TRANSITIONS[self.state]) or 'none — terminal'})"
            )
        self.state = new_state
        if new_state is RequestState.PREFILLING and self.started_at is None:
            self.started_at = now
        if new_state in TERMINAL_STATES and self.finished_at is None:
            self.finished_at = now


@dataclasses.dataclass
class RequestRecord:
    """Immutable-by-convention terminal record of one request.

    This is what ``ServeEngine.run()`` returns per rid: the terminal
    status, the emitted tokens, the captured error (for FAILED /
    TIMED_OUT / REJECTED), retry count, and coarse phase timings — the
    structured replacement for the old bare ``finished`` dict of live
    ``Request`` objects.
    """

    rid: int
    status: RequestState
    out_tokens: List[int]
    prompt_tokens: int
    new_tokens: int
    retries: int = 0
    error_kind: Optional[str] = None
    error: Optional[str] = None
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status is RequestState.FINISHED

    @classmethod
    def from_request(cls, req: Request) -> "RequestRecord":
        if req.state not in TERMINAL_STATES:
            raise IllegalTransition(
                f"request {req.rid}: cannot build a terminal record in "
                f"non-terminal state {req.state.value}"
            )
        timings = {}
        if req.submitted_at is not None:
            if req.started_at is not None:
                timings["queue_s"] = req.started_at - req.submitted_at
            if req.first_token_at is not None:
                timings["first_token_s"] = req.first_token_at - req.submitted_at
            if req.finished_at is not None:
                timings["total_s"] = req.finished_at - req.submitted_at
        return cls(
            rid=req.rid,
            status=req.state,
            out_tokens=list(req.out_tokens),
            prompt_tokens=int(len(req.prompt)),
            new_tokens=len(req.out_tokens),
            retries=req.retries,
            error_kind=req.error_kind,
            error=req.error,
            timings=timings,
        )
