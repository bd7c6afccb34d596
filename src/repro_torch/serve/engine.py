"""Continuous-batching serving engine (counterpart of
``repro/serve/engine.py``): the paged mode of the dense family and the
per-slot mode of the moe family.

- **One model call per decode step.**  All decoding slots advance through a
  single batched ``paged_step`` — tokens ``(B, 1)`` with an active-slot
  ``valid`` mask — and ``counters["decode_calls"]`` counts exactly one per
  step with any decoder.
- **Paged KV cache.**  Slots share one page pool (``model.init_paged_cache``);
  ``serve/paging.py`` owns the free-list allocator, the engine keeps a host
  ``(B, pages_per_slot)`` block table.  Page 0 is the null page that
  padding and inactive slots write to.
- **Chunked prefill** (``prefill_chunk=``): one fixed-width padded chunk per
  step per prefilling slot, through the same ``paged_step``; non-final
  chunks run a finite-logits check, only the final chunk samples.
- **Admission.**  ``submit()`` validates prompts (length vs ``max_seq``,
  pool capacity in pages, token ids, budget, deadline, unique rid) with a
  bounded queue (``queue_limit``; ``queue_policy`` "reject_new" refuses the
  newcomer, "drop_oldest" evicts the head); ``_admit`` holds the queue FIFO
  until the free list covers the head's prompt (plus its journaled tokens
  for a recovered request) and never fills a dead slot.  ``cancel(rid)``
  ends a queued or in-flight request at once.
- **Deadlines and the clock** (``clock=``, default ``time.monotonic``;
  ``default_deadline_s=`` for requests that set none).  ``submit`` stamps
  ``submitted_at``, admission ``started_at``, the prefill-sampled token
  ``first_token_at``, and every terminal state ``finished_at``, so each
  record's ``timings`` carries ``queue_s``, ``first_token_s`` and
  ``total_s``.  A ``deadline_s <= 0`` is rejected ``bad_deadline``; at the
  top of every ``run`` step a request past ``submitted_at + deadline_s``
  times out (``ErrorKind.DEADLINE``), queued or in flight, its slot and
  pages released as a failure's are.  The clock is read where the
  reference reads it, so one fake clock gives both engines the same
  timings.
- **Failure isolation and deferred retries.**  Faults (``injector=``, a
  :class:`~repro_torch.serve.faults.FaultInjector`) apply per slot: an
  injected decode exception drops the slot from the step's ``valid`` mask
  (its KV write goes to the null page), cache corruption poisons ONLY the
  victim's pages, and sampling is per row.  A failed attempt commits
  nothing: its length and tokens do not advance, and since the pool is
  written in place, the victim's pages are copied on the device before they
  are poisoned and written back when its attempt fails (in a poisoned
  prefill attempt the null page too, which the chunk's padding rows write).
  The same phase is retried on the next engine step (``max_retries``, with
  ``retry_backoff_s · 2^n`` sleeps through ``sleep_fn``), then the request
  fails and its slot's failure streak grows; ``slot_failure_limit``
  consecutive failures kill the slot.  Every attempt that runs the model
  counts in ``decode_calls`` / ``prefill_calls``.
- **Liveness.**  ``run`` tracks progress; with every slot dead, or
  ``stall_patience`` steps without progress, it stops, sets
  ``stall_report`` and returns the survivors as ``stall`` TIMED_OUT
  records.

Sampling generators derive only from (engine seed, rid, token index) and
masked attention positions weigh exactly zero, so a request's tokens do not
depend on its slot, its pages, its co-tenants or its retries.

- **KV storage** (``kv_spec=``, a :class:`~repro_torch.serve.kvquant.KVSpec`;
  default f32): f32 and bf16 pools, or int8 / packed-int4 pools with f32
  scale planes that the allocator accounts in lockstep with the pages
  (``sidecar``).  The spec's geometry is checked when the engine is built.
  ``health()["kv"]`` reports the scheme and its bytes per token.

**Crash safety** (``journal=`` a
:class:`~repro_torch.serve.journal.JournalWriter`, ``snapshot_dir=``,
``snapshot_every=``):

- every externally visible effect — an accepted submit, a committed token,
  a terminal record — is appended (fsync'd) to the write-ahead journal
  BEFORE the in-memory effect happens;
- ``snapshot()`` persists the pool, block tables, lengths, allocator,
  slot states, prefill offsets, queue and counters through
  ``checkpoint/ckpt.py`` (atomic ``.tmp``-rename, keep-k), at engine-step
  boundaries only;
- ``ServeEngine.restore`` = the newest restorable snapshot + journal
  replay: slots whose journaled token count matches the snapshot resume in
  place; anything newer than the snapshot (or with no usable snapshot)
  re-enqueues.  A re-enqueued request with journaled tokens re-prefills its
  PROMPT exactly as the uninterrupted run did (same chunks, from offset 0)
  and then feeds its journaled tokens one a step through the ordinary
  batched decode step, sampling and committing nothing until the last one
  has been fed.  The reference re-prefills over prompt + tokens instead;
  here each token's K/V, and the next sampled token, come from the same
  kernels at the same M as in the uninterrupted run, whose W4A4 codes a
  chunk-wide recomputation could flip.

- **Per-slot mode** (``"slots"``: the moe family, whose contiguous latent
  caches carry one offset for the batch rows, ``model.init_cache``).  Each
  slot owns a B=1 cache (``_fresh_cache``, f32 or the float ``kv_spec``'s
  dtype); admission prefills the whole prompt at B=1
  (:meth:`_slot_prefill`), and each engine step runs one B=1 decode call
  per decoding slot (:meth:`_step_slots`), so ``decode_calls`` counts one
  per slot attempt, as in the reference.  Every contract above holds in
  this mode too: faults (``cache_corruption`` poisons a copy of the slot's
  cache, :meth:`FaultInjector.corrupt_cache`), deferred retries (a failed
  attempt commits nothing: the slot keeps its cache), cancel, the queue
  bound, the stall watchdog, the journal, and snapshots of the slot caches
  with ``restore``; a re-enqueued request with journaled tokens prefills
  its prompt and feeds its tokens through the decode call, as in paged
  mode.  A quantized ``kv_spec`` and ``prefill_chunk`` need the paged
  layout and raise, as in the reference.

Not ported yet (ROADMAP Queue 1): meshes, and the stacked mode (ssm).

``device=`` defaults to ``"cuda"`` and raises when no card is present; with
``kernel_impl="auto"`` every QLinear is retagged to the kernel paths on the
card and keeps its calibrated impl on the CPU, as the reference does on its
CPU backend.  ``ctx=`` (a :class:`~repro_torch.kernels.context.KernelContext`)
is attached to every QLinear and picks each site's path: fused where the
site fits the one-kernel path, else chained, unless pinned.
``health()["decode_plan"]`` lists the path each distinct (K, N, R,
act_group) site resolves to at decode (M = ``batch_slots``), so a run shows which sites
went where.  ``ctx.attention`` routes the attention of every model call:
``"auto"`` takes the kernels on the card and the reference's gather route
on the CPU, and demotes a prefill's attention to gather, from shapes,
for a head dim the flash kernels cannot take (decode keeps its kernels).  On the kernel route each decode step's attention launches a
paged attention kernel and each prefill chunk's (every chunk, whatever its
offset or width, one token included) a dense flash kernel over the slot's
gathered pages, so a token's K/V, and the greedy stream, do not depend on
the chunk width.
``health()["decode_attention"]`` and ``health()["prefill_attention"]``
name the route, the kernel it launches and the reason of a demotion.
"""

from __future__ import annotations

import functools
import json
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (CheckpointError, CheckpointManager,
                                         load_leaf)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.quant.qlinear import (KERNEL_IMPLS, QLinear,
                                       retag_qlinear_impl)
from repro_torch.serve.faults import (FaultInjector, InjectedFault,
                                      SimulatedCrash)
from repro_torch.serve.journal import (JournalError, JournalWriter, collate,
                                       read_journal)
from repro_torch.serve.kvquant import KVSpec
from repro_torch.serve.lifecycle import (ErrorKind, Request, RequestRecord,
                                         RequestState)
from repro_torch.serve.paging import NULL_PAGE, PageAllocator
from repro_torch.serve.sampling import (NonFiniteLogitsError, sample_token,
                                        sampling_generator)

__all__ = ["PagesExhausted", "Request", "RequestRecord", "RequestState",
           "ServeEngine", "attention_report"]


class PagesExhausted(RuntimeError):
    """The free list could not cover a page allocation; retried like any
    transient fault (a co-tenant finishing frees pages), then a FAILED
    record with ``error_kind == 'kv_pages_exhausted'``."""


def attention_report(ctx, device, head_dim: int, kv_spec: KVSpec,
                     decode: bool) -> dict:
    """``health()["decode_attention"]`` (``decode``) or
    ``["prefill_attention"]``: the route ``ctx.attention_plan`` gives on
    ``device`` for ``head_dim``, the kernel it launches
    ("paged_flash_attention" for decode, "flash_attention" for prefill; its
    ``_quant`` sibling for a quantized pool; None on the gather route), the
    KV scheme, and why "auto" demoted the kernel route (None when it did
    not)."""
    plan = ctx.attention_plan(device, head_dim, decode)
    kernel = None
    if plan.route == "kernel":
        kernel = "paged_flash_attention" if decode else "flash_attention"
        if kv_spec.is_quantized:
            kernel += "_quant"
    return {"route": plan.route, "kernel": kernel,
            "kv": kv_spec.describe(), "demoted": plan.demoted}


def _classify_error(e: BaseException) -> Tuple[ErrorKind, str]:
    if isinstance(e, InjectedFault):
        kind = ErrorKind.INJECTED
    elif isinstance(e, NonFiniteLogitsError):
        kind = ErrorKind.NON_FINITE_LOGITS
    elif isinstance(e, PagesExhausted):
        kind = ErrorKind.KV_PAGES_EXHAUSTED
    elif isinstance(e, SimulatedCrash):
        # a crash unwinds run(); this fires only for a caller that catches
        # it and asks for a classification
        kind = ErrorKind.SIMULATED_CRASH
    else:
        kind = ErrorKind.EXCEPTION
    return kind, f"{type(e).__name__}: {e}"[:500]


class ServeEngine:
    def __init__(self, cfg, params, batch_slots: int = 4, max_seq: int = 256,
                 eos_id: Optional[int] = None, seed: int = 0,
                 kernel_impl: Optional[str] = "auto", ctx=None, *,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_spec: Optional[KVSpec] = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 queue_limit: Optional[int] = None,
                 queue_policy: str = "reject_new",
                 default_deadline_s: Optional[float] = None,
                 slot_failure_limit: int = 3, stall_patience: int = 64,
                 injector: Optional[FaultInjector] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 journal: Optional[JournalWriter] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0, snapshot_keep: int = 3,
                 device="cuda"):
        self.device = resolve_device(device)
        # family -> decode-state layout; see the module docstring
        if cfg.family in model_lib.PAGED_FAMILIES:
            self.mode = "paged"
        elif cfg.family in model_lib.STACKED_FAMILIES:
            raise NotImplementedError(
                f"the stacked engine mode (family {cfg.family!r}) is not "
                f"ported; the paged {model_lib.PAGED_FAMILIES} and per-slot "
                f"{model_lib.PORTED_FAMILIES} families are")
        elif cfg.family in model_lib.PORTED_FAMILIES:
            self.mode = "slots"
        else:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported; only "
                f"{model_lib.PORTED_FAMILIES} are")
        if queue_policy not in ("reject_new", "drop_oldest"):
            raise ValueError(f"unknown queue_policy {queue_policy!r}; "
                             f"one of ('reject_new', 'drop_oldest')")
        if max_retries < 0 or retry_backoff_s < 0:
            raise ValueError("max_retries and retry_backoff_s must be >= 0")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if snapshot_every < 0:
            raise ValueError(f"snapshot_every must be >= 0, got {snapshot_every}")
        if snapshot_every and snapshot_dir is None:
            raise ValueError("snapshot_every > 0 requires snapshot_dir")
        if prefill_chunk is not None and self.mode != "paged":
            raise ValueError(
                f"prefill_chunk requires a paged family "
                f"{model_lib.PAGED_FAMILIES}, not {cfg.family!r}")
        self.kv_spec = kv_spec if kv_spec is not None else KVSpec()
        if self.kv_spec.is_quantized:
            if self.mode != "paged":
                raise ValueError(
                    f"kv dtype {self.kv_spec.dtype!r} requires the paged KV "
                    f"cache (families {model_lib.PAGED_FAMILIES}); "
                    f"{cfg.family!r} serves in {self.mode!r} mode")
            # bad geometry (odd head_dim for int4, a group that does not
            # divide head_dim) raises here, not at the first prefill
            self.kv_spec.packed_head_dim(cfg.head_dim)
            self.kv_spec.group_for(cfg.head_dim)
        if kernel_impl is not None or ctx is not None:
            # kernel_impl=None attaches ctx without touching the impls
            params = retag_qlinear_impl(params, kernel_impl, ctx=ctx,
                                        device=self.device)
        self.cfg = cfg
        self.params = params
        self.ctx = ctx
        self.b = batch_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.seed = seed

        # crash safety: the write-ahead journal and the snapshot schedule
        self.journal = journal
        self.snapshot_every = snapshot_every
        self._ckpt = (CheckpointManager(snapshot_dir, keep=snapshot_keep)
                      if snapshot_dir is not None else None)
        self._journaled_submits: set = set()
        self._journaled_terminals: set = set()

        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.queue_limit = queue_limit
        self.queue_policy = queue_policy
        self.default_deadline_s = default_deadline_s
        self.slot_failure_limit = slot_failure_limit
        self.stall_patience = stall_patience
        self.injector = injector
        self.clock = clock
        self.sleep_fn = sleep_fn
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        # tokens in each slot's cache (its pages, or its contiguous cache)
        self.lengths = np.zeros((batch_slots,), np.int32)
        self._prefill_off = [0] * batch_slots
        self.alloc: Optional[PageAllocator] = None
        self.pool = None
        self.slot_caches: List = []
        if self.mode == "paged":
            # the default pool covers every slot at full length, so the free
            # list only runs dry when the caller shrinks kv_pages
            self.pages_per_slot = -(-max_seq // page_size)
            num_pages = (kv_pages if kv_pages is not None
                         else batch_slots * self.pages_per_slot + 1)
            self.alloc = PageAllocator(num_pages, page_size,
                                       sidecar=self.kv_spec.is_quantized)
            self.pool = model_lib.init_paged_cache(
                cfg, num_pages, page_size, dtype=torch.float32,
                device=self.device, kv_spec=self.kv_spec)
            self.block_tables = np.zeros((batch_slots, self.pages_per_slot),
                                         np.int32)
        else:
            # per-slot B=1 caches: the family's cache carries one offset for
            # its batch rows, so slots cannot share a batched cache
            self.slot_caches = [self._fresh_cache() for _ in range(batch_slots)]

        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_fail_streak: List[int] = [0] * batch_slots
        self.slot_dead: List[bool] = [False] * batch_slots
        self.queue: List[Request] = []
        self.records: Dict[int, RequestRecord] = {}
        self.counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "steps": 0, "retries": 0,
            "finished": 0, "failed": 0, "rejected": 0, "cancelled": 0,
            "timed_out": 0, "slot_failures": 0, "decode_calls": 0,
            "prefill_calls": 0,
        }
        # rid -> consecutive failed attempts; a failed attempt retries on
        # the NEXT engine step, so the batched step stays one forward
        self._attempt_streak: Dict[int, int] = {}
        self._steps_since_progress = 0
        self.stall_report: Optional[dict] = None
        self._paged = functools.partial(model_lib.paged_step, cfg,
                                        kv_spec=self.kv_spec, ctx=ctx)
        self._prefill = functools.partial(model_lib.prefill, cfg, ctx=ctx)
        self._decode = functools.partial(model_lib.decode_step, cfg, ctx=ctx)
        self.decode_plan = self._resolve_decode_plan()
        route_ctx = ctx if ctx is not None else ops.DEFAULT_CONTEXT
        if self.mode == "paged":
            self.decode_attention = attention_report(
                route_ctx, self.device, cfg.head_dim, self.kv_spec, decode=True)
            self.prefill_attention = attention_report(
                route_ctx, self.device, cfg.head_dim, self.kv_spec, decode=False)
        else:
            # both phases attend over the slot's whole contiguous cache with
            # the dense flash kernel (#7), causally from the cache offset
            self.decode_attention = self.prefill_attention = attention_report(
                route_ctx, self.device, cfg.attn_head_dim, self.kv_spec,
                decode=False)

        self._journal("open", mode=self.mode, family=cfg.family,
                      batch_slots=batch_slots, max_seq=max_seq,
                      eos_id=eos_id, seed=seed, page_size=page_size,
                      kv_pages=None if self.alloc is None else self.alloc.num_pages,
                      prefill_chunk=prefill_chunk, **self.kv_spec.to_meta())

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Validate and enqueue; returns False (with a ``REJECTED`` record)
        when admission control refuses the request."""
        now = self.clock()
        req.submitted_at = now
        if req.deadline_s is None:
            req.deadline_s = self.default_deadline_s
        err = self._validate(req)
        if err is not None:
            if err[0] is ErrorKind.DUPLICATE_RID:
                # reject the duplicate in place; the original's record stays
                req.error_kind, req.error = err
                req.advance(RequestState.REJECTED, now)
                self.counters["rejected"] += 1
                return False
            self._finalize(req, RequestState.REJECTED, *err)
            return False
        if self.queue_limit is not None and len(self.queue) >= self.queue_limit:
            if self.queue_policy == "drop_oldest":
                oldest = self.queue.pop(0)
                self._finalize(oldest, RequestState.REJECTED,
                               ErrorKind.QUEUE_EVICTED,
                               f"evicted by rid {req.rid} under drop_oldest "
                               f"(queue_limit={self.queue_limit})")
            else:
                self._finalize(req, RequestState.REJECTED, ErrorKind.QUEUE_FULL,
                               f"queue at limit {self.queue_limit}")
                return False
        # WAL: the submit record is durable BEFORE the request becomes
        # engine state.  Rejected submits are not journaled: their record
        # was returned at once, so recovery owes them nothing
        if self.journal is not None:
            self.journal.append(
                "submit", rid=req.rid,
                prompt=[int(t) for t in np.asarray(req.prompt)],
                max_new_tokens=int(req.max_new_tokens),
                temperature=float(req.temperature),
                deadline_s=req.deadline_s)
            self._journaled_submits.add(req.rid)
        self.counters["submitted"] += 1
        self.queue.append(req)
        return True

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request; False if unknown or
        terminal."""
        for qi, req in enumerate(self.queue):
            if req.rid == rid:
                self.queue.pop(qi)
                self._finalize(req, RequestState.CANCELLED, ErrorKind.CANCELLED,
                               "cancelled while queued")
                return True
        for i, req in enumerate(self.slot_req):
            if req is not None and req.rid == rid:
                # applied at once: free the slot and its pages, keep the
                # emitted tokens
                self._release_slot(i)
                self._finalize(req, RequestState.CANCELLED, ErrorKind.CANCELLED,
                               "cancelled in flight")
                return True
        return False

    def run(self, max_steps: int = 1024) -> Dict[int, RequestRecord]:
        """Drive until queue and slots drain; never raises for per-request
        failures.  Exhausting ``max_steps`` returns the survivors as
        ``TIMED_OUT`` records; a detected stall stops with
        ``self.stall_report`` set."""
        self.stall_report = None
        for _ in range(max_steps):
            self.counters["steps"] += 1
            progressed = self._expire_deadlines()
            progressed |= self._admit()
            if not any(r is not None for r in self.slot_req) and not self.queue:
                break
            progressed |= self._prefill_tick()
            progressed |= self._step()
            self._steps_since_progress = (
                0 if progressed else self._steps_since_progress + 1)
            stall = self._stall_reason()
            if stall is not None:
                self.stall_report = {"reason": stall, "health": self.health()}
                self._drain_unfinished(ErrorKind.STALL, f"run() aborted: {stall}")
                return self.records
            # snapshot at the step boundary only: no forward is in flight,
            # and lengths, pool and allocator agree
            if (self.snapshot_every and self._ckpt is not None
                    and self.counters["steps"] % self.snapshot_every == 0):
                self.snapshot()
        else:
            self._drain_unfinished(ErrorKind.STEP_LIMIT,
                                   f"engine step budget ({max_steps}) exhausted")
        return self.records

    def health(self) -> dict:
        """Slot states, queue depth, counters, liveness, page-pool
        accounting and the kernel plans."""
        slots = []
        for i in range(self.b):
            req = self.slot_req[i]
            slots.append({
                "slot": i,
                "state": ("dead" if self.slot_dead[i]
                          else req.state.value if req is not None else "idle"),
                "rid": None if req is None else req.rid,
                "tokens": 0 if req is None else len(req.out_tokens),
                "fail_streak": self.slot_fail_streak[i],
            })
        return {
            "slots": slots,
            "queue_depth": len(self.queue),
            "dead_slots": sum(self.slot_dead),
            "counters": dict(self.counters),
            "steps_since_progress": self._steps_since_progress,
            "stalled": self.stall_report is not None,
            "mode": self.mode,
            "device": str(self.device),
            "kv_pages": None if self.alloc is None else self.alloc.stats(),
            "kv": self._kv_health(),
            "decode_plan": self.decode_plan,
            "decode_attention": self.decode_attention,
            "prefill_attention": self.prefill_attention,
            "journal_seq": None if self.journal is None else self.journal.seq,
        }

    def _kv_health(self) -> dict:
        """``health()["kv"]``: the KV storage scheme and ``bytes_per_token``,
        the all-layer device bytes of one token: paged K+V (data plus scale
        planes, ``KVSpec.kv_bytes_per_token``), or in per-slot mode the
        latent cache's c_kv and k_rope rows."""
        if self.mode == "paged":
            per_token = self.cfg.n_layers * self.kv_spec.kv_bytes_per_token(
                self.cfg.n_kv_heads, self.cfg.head_dim)
        else:
            item = torch.empty((), dtype=self.kv_spec.cache_dtype).element_size()
            per_token = self.cfg.n_layers * item * (self.cfg.kv_lora_rank
                                                    + self.cfg.qk_rope_dim)
        return {"dtype": self.kv_spec.dtype, "group": self.kv_spec.group,
                "layout": self.kv_spec.describe(), "bytes_per_token": per_token}

    # -- kernel-plan introspection ------------------------------------------

    def _resolve_decode_plan(self) -> List[dict]:
        """The path each distinct (K, N, R, act_group) QLinear site runs at
        decode: the batched step flattens (B, 1, K) activations to an (M =
        batch_slots, K) GEMM (per-slot mode: M = 1 a call), and the site's
        activation group (None: per-token) enters the plan as it does in
        the forward.  A routed expert stack is one site.  A site on a plain
        impl (sim, int8) reports that impl as its path.  Empty for float
        params."""
        sites: Dict[tuple, dict] = {}
        m = self.b if self.mode == "paged" else 1

        def visit(node):
            if isinstance(node, QLinear):
                r = 0 if node.u is None else int(node.u.shape[-1])
                entry = {"m": m, "k": node.d_in, "n": node.d_out, "r": r,
                         "act_group": node.act_group, "impl": node.impl,
                         "path": node.impl, "pinned": False, "demoted": False}
                if node.impl in KERNEL_IMPLS:
                    ctx = ops.DEFAULT_CONTEXT if node.ctx is None else node.ctx
                    entry.update(ctx.resolve_plan(
                        m, node.d_in, node.d_out, r, layer=node.name,
                        impl=None if node.impl == "pallas" else node.impl,
                        act_group=node.act_group)._asdict())
                site = sites.setdefault(tuple(entry.values()),
                                        dict(entry, layers=[]))
                if node.name not in site["layers"]:
                    site["layers"].append(node.name)
            elif isinstance(node, dict):
                for child in node.values():
                    visit(child)
            elif isinstance(node, list):
                for child in node:
                    visit(child)

        visit(self.params)
        return list(sites.values())

    # -- admission ----------------------------------------------------------

    def _validate(self, req: Request) -> Optional[Tuple[ErrorKind, str]]:
        if (req.rid in self.records
                or any(q.rid == req.rid for q in self.queue)
                or any(r is not None and r.rid == req.rid for r in self.slot_req)):
            return (ErrorKind.DUPLICATE_RID,
                    f"rid {req.rid} already known to the engine")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            return (ErrorKind.EMPTY_PROMPT,
                    f"prompt must be a non-empty 1-D token array, got shape "
                    f"{prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            return (ErrorKind.BAD_TOKEN_IDS,
                    f"prompt dtype {prompt.dtype} is not integral")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            return (ErrorKind.BAD_TOKEN_IDS,
                    f"token ids outside [0, {self.cfg.vocab_size})")
        if len(prompt) >= self.max_seq:
            return (ErrorKind.PROMPT_TOO_LONG,
                    f"prompt length {len(prompt)} >= max_seq {self.max_seq}")
        if self.mode == "paged":
            need = self.alloc.pages_for(len(prompt) + 1)
            if need > self.alloc.capacity:
                return (ErrorKind.KV_CAPACITY,
                        f"prompt needs {need} KV pages; pool capacity is "
                        f"{self.alloc.capacity} pages of {self.page_size}")
        if req.max_new_tokens < 1:
            return (ErrorKind.BAD_TOKEN_BUDGET,
                    f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if req.deadline_s is not None and req.deadline_s <= 0:
            return (ErrorKind.BAD_DEADLINE,
                    f"deadline_s must be > 0, got {req.deadline_s}")
        return None

    def _admit(self) -> bool:
        progressed = False
        for i in range(self.b):
            # a request that finishes or fails at prefill frees its slot at
            # once, so keep pulling from the queue until one sticks
            while not self.slot_dead[i] and self.slot_req[i] is None and self.queue:
                if self.mode == "paged":
                    head = self.queue[0]
                    # a recovered request will hold its journaled tokens too
                    need = self.alloc.pages_for(
                        len(head.prompt) + len(head.out_tokens) + 1)
                    if need > self.alloc.free_pages:
                        # FIFO backpressure until co-tenants free enough
                        # pages (all idle means all pages free: no deadlock
                        # for a prompt that passed _validate)
                        return progressed
                req = self.queue.pop(0)
                progressed = True
                req.advance(RequestState.PREFILLING, self.clock())
                self.counters["admitted"] += 1
                self.slot_req[i] = req
                # audit only: placement never affects outputs
                self._journal("admit", rid=req.rid, slot=i)
                self._prefill_off[i] = 0
                self.lengths[i] = 0
                if self.mode == "paged":
                    self._prefill_advance(i)
                else:
                    self._slot_prefill(i, req)
        return progressed

    def _prefill_tick(self) -> bool:
        """Advance every mid-prefill slot by one chunk (paged mode), or
        retry a whole-prompt prefill whose last attempt failed."""
        progressed = False
        for i in range(self.b):
            req = self.slot_req[i]
            if req is not None and req.state is RequestState.PREFILLING:
                if self.mode == "paged":
                    progressed |= self._prefill_advance(i)
                else:
                    progressed |= self._slot_prefill(i, req)
        return progressed

    # -- prefill ------------------------------------------------------------

    def _prefill_advance(self, i: int) -> bool:
        """One guarded prefill-chunk attempt for slot ``i``.  On failure
        the chunk offset and length stay, and a poisoned attempt's pages
        are written back, so the retry replays the same chunk from clean
        state.  A recovered request (journaled tokens in ``out_tokens``)
        prefills its prompt alone and samples nothing: the decode step
        then feeds its tokens (see the module docstring)."""
        req = self.slot_req[i]
        prompt = np.asarray(req.prompt, np.int32)
        n_prompt = int(prompt.size)
        got = self.alloc.ensure(req.rid, n_prompt)
        if got is None:
            self._attempt_failed(i, req, PagesExhausted(
                f"free list cannot cover {self.alloc.pages_for(n_prompt)} "
                f"prompt page(s) for rid {req.rid} ({self.alloc.free_pages} "
                f"free of {self.alloc.capacity})"))
            return True
        if got:
            self._write_block_row(i, req.rid)
        off = self._prefill_off[i]
        chunk = self.prefill_chunk or n_prompt
        n = min(chunk, n_prompt - off)
        final = off + n >= n_prompt
        replay = bool(req.out_tokens)
        fault = (self.injector.poll(req.rid, "prefill")
                 if self.injector is not None else None)
        saved = None
        tok = None
        try:
            if self._inject_before(fault, req, "prefill", f" (chunk offset {off})"):
                pages = self.alloc.pages_of(req.rid)
                # the chunk's padding rows write the null page
                saved = self._save_pages(pages + [NULL_PAGE])
                self.injector.corrupt_pages(self.pool, pages)
            tokens = np.zeros((1, chunk), np.int32)
            tokens[0, :n] = prompt[off:off + n]
            positions = off + np.arange(chunk, dtype=np.int32)[None, :]
            valid = (np.arange(chunk) < n)[None, :]
            srow = np.asarray([n - 1], np.int32)
            self.counters["prefill_calls"] += 1
            logits, self.pool = self._paged(
                self.params, self._dev(tokens), self._dev(positions),
                self._dev(valid), self.pool,
                self._dev(self.block_tables[i:i + 1]), self._dev(srow),
                is_prefill=True)
            logits = self._inject_after(fault, logits)
            if final and not replay:
                self._sampling_fault(req)
                tok = int(self._sample(req, logits[:, -1])[0])
            else:
                # chunks that sample nothing still never pass NaN on into
                # later chunks
                self._check_finite(logits)
        except Exception as e:  # isolated: fails only this request
            if saved is not None:
                self._restore_pages(saved)
            self._attempt_failed(i, req, e)
            return True
        self._prefill_off[i] = off + n
        self.lengths[i] = off + n
        self._attempt_streak.pop(req.rid, None)
        self.slot_fail_streak[i] = 0
        if final:
            self._finish_prefill(i, req, tok)
        return True

    def _slot_prefill(self, i: int, req: Request) -> bool:
        """One guarded whole-prompt B=1 prefill attempt (per-slot mode)
        into a fresh cache, committed to the slot only when the attempt
        succeeds.  A recovered request (journaled tokens in ``out_tokens``)
        prefills its prompt alone and samples nothing: the decode calls
        then feed its tokens (see the module docstring)."""
        prompt = np.asarray(req.prompt, np.int32)
        replay = bool(req.out_tokens)
        fault = (self.injector.poll(req.rid, "prefill")
                 if self.injector is not None else None)
        tok = None
        try:
            cache_in = self._fresh_cache()
            if self._inject_before(fault, req, "prefill"):
                cache_in = self.injector.corrupt_cache(cache_in)
            self.counters["prefill_calls"] += 1
            logits, new_cache = self._prefill(
                self.params, {"tokens": self._dev(prompt[None, :])}, cache_in)
            logits = self._inject_after(fault, logits)
            if replay:
                self._check_finite(logits, "a recovered request's prompt")
            else:
                self._sampling_fault(req)
                tok = int(self._sample(req, logits[:, -1])[0])
        except Exception as e:  # isolated: fails only this request
            self._attempt_failed(i, req, e)
            return True
        self.slot_caches[i] = new_cache
        self.lengths[i] = prompt.size
        self._attempt_streak.pop(req.rid, None)
        self.slot_fail_streak[i] = 0
        self._finish_prefill(i, req, tok)
        return True

    def _finish_prefill(self, i: int, req: Request, tok: Optional[int]):
        req.first_token_at = self.clock()
        if tok is None:
            # a recovered request: its journaled tokens are fed next
            req.advance(RequestState.DECODING, self.clock())
            return
        self._commit_token(req, tok)
        # the prefill-sampled token obeys the same termination predicate as
        # decode tokens
        if self._should_finish(req, tok):
            self._release_slot(i)
            self._finalize(req, RequestState.FINISHED)
        else:
            req.advance(RequestState.DECODING, self.clock())

    # -- stepping -----------------------------------------------------------

    def _step(self) -> bool:
        """ONE batched ``paged_step`` over every decoding slot (paged mode;
        per-slot mode: :meth:`_step_slots`)."""
        if self.mode == "slots":
            return self._step_slots()
        active = [i for i in range(self.b)
                  if self.slot_req[i] is not None
                  and self.slot_req[i].state is RequestState.DECODING]
        if not active:
            return False
        progressed = False
        faults: Dict[int, object] = {}
        if self.injector is not None:
            for i in active:
                f = self.injector.poll(self.slot_req[i].rid, "decode")
                if f is not None:
                    faults[i] = f
                    if f.kind == "slow_step":
                        self.injector.sleep(f.seconds)
                    elif f.kind == "process_crash":
                        raise SimulatedCrash(
                            f"simulated crash at decode of rid "
                            f"{self.slot_req[i].rid}")
        # decode-boundary crossings allocate before the forward; a dry free
        # list fails only that slot's attempt (a co-tenant may free pages
        # by the next step)
        for i in list(active):
            req = self.slot_req[i]
            got = self.alloc.ensure(req.rid, int(self.lengths[i]) + 1)
            if got is None:
                active.remove(i)
                self._attempt_failed(i, req, PagesExhausted(
                    f"no free page for rid {req.rid} at position "
                    f"{int(self.lengths[i])} ({self.alloc.free_pages} free of "
                    f"{self.alloc.capacity})"))
                progressed = True
            elif got:
                self._write_block_row(i, req.rid)
        if not active:
            return progressed

        # an injected exception fires "before the forward": the slot drops
        # out of the valid mask (its write goes to the null page), so the
        # ONE batched call still runs for everyone else
        excluded = {i for i in active
                    if i in faults and faults[i].kind == "exception"}
        included = [i for i in active if i not in excluded]
        corrupt = [i for i in included
                   if i in faults and faults[i].kind == "cache_corruption"]
        tokens = np.zeros((self.b, 1), np.int32)
        valid = np.zeros((self.b, 1), bool)
        for i in active:
            req = self.slot_req[i]
            # the stream token at this slot's position: its last one, or
            # for a recovered request still feeding, the next journaled one
            tokens[i, 0] = req.out_tokens[int(self.lengths[i]) - len(req.prompt)]
        for i in included:
            valid[i, 0] = True
        positions = self.lengths.astype(np.int32)[:, None]
        srow = np.zeros((self.b,), np.int32)
        # the pool is written in place: keep each victim's pages before
        # they are poisoned, to write back if its attempt fails
        saved = {}
        for i in corrupt:
            pages = self.alloc.pages_of(self.slot_req[i].rid)
            saved[i] = self._save_pages(pages)
            self.injector.corrupt_pages(self.pool, pages)
        self.counters["decode_calls"] += 1
        try:
            logits, self.pool = self._paged(
                self.params, self._dev(tokens), self._dev(positions),
                self._dev(valid), self.pool, self._dev(self.block_tables),
                self._dev(srow))
        except Exception as e:
            # the one batched call died: every active request gets a
            # (retryable) failed attempt
            for copy in saved.values():
                self._restore_pages(copy)
            for i in active:
                self._attempt_failed(i, self.slot_req[i], e)
            return True

        # per-row outcomes first, then the rollback, then the bookkeeping
        # (_slot_failure frees pages, which must not precede the rollback)
        outcomes: Dict[int, Tuple[str, object]] = {}
        for i in active:
            req = self.slot_req[i]
            f = faults.get(i)
            if i in excluded:
                outcomes[i] = ("fail", InjectedFault(
                    f"injected decode exception for rid {req.rid}"))
                continue
            row = logits[i:i + 1, -1]
            try:
                row = self._inject_after(f, row)
                if self._feeding(i):
                    # a journaled token fed: nothing to sample
                    self._check_finite(row, "journaled-token feed")
                    outcomes[i] = ("fed", None)
                    continue
                self._sampling_fault(req)
                outcomes[i] = ("ok", int(self._sample(req, row)[0]))
            except Exception as e:  # isolated: fails only this request
                outcomes[i] = ("fail", e)

        # a failed victim's pages go back to their pre-step values; excluded
        # slots were never written (null page), and other failures keep
        # their length, so the retry overwrites the same position
        for i, copy in saved.items():
            if outcomes[i][0] == "fail":
                self._restore_pages(copy)

        for i in active:
            req = self.slot_req[i]
            kind, val = outcomes[i]
            progressed = True  # a token, a fed token or a retry is progress
            if kind == "fail":
                self._attempt_failed(i, req, val)
                continue
            self._attempt_streak.pop(req.rid, None)
            self.slot_fail_streak[i] = 0
            self.lengths[i] += 1
            if kind == "fed":
                continue
            self._commit_token(req, val)
            if self._should_finish(req, val):
                self._release_slot(i)
                self._finalize(req, RequestState.FINISHED)
        return progressed

    def _step_slots(self) -> bool:
        """One B=1 decode call per decoding slot (per-slot mode), each
        guarded on its own: a failed attempt commits nothing (the slot keeps
        its cache and length) and retries on the next step."""
        progressed = False
        for i, req in enumerate(self.slot_req):
            if req is None or req.state is not RequestState.DECODING:
                continue
            # the stream token at this slot's position: its last one, or for
            # a recovered request still feeding, the next journaled one
            last = np.asarray(
                [[req.out_tokens[int(self.lengths[i]) - len(req.prompt)]]], np.int32)
            fault = (self.injector.poll(req.rid, "decode")
                     if self.injector is not None else None)
            self.counters["decode_calls"] += 1
            feeding = self._feeding(i)
            tok = None
            try:
                cache_in = self.slot_caches[i]
                if self._inject_before(fault, req, "decode"):
                    cache_in = self.injector.corrupt_cache(cache_in)
                logits, new_cache = self._decode(self.params, self._dev(last),
                                                 cache_in)
                logits = self._inject_after(fault, logits)
                if feeding:
                    # a journaled token fed: nothing to sample
                    self._check_finite(logits, "journaled-token feed")
                else:
                    self._sampling_fault(req)
                    tok = int(self._sample(req, logits[:, -1])[0])
            except Exception as e:  # isolated: fails only this request
                self._attempt_failed(i, req, e)
                progressed = True
                continue
            self.slot_caches[i] = new_cache
            self.lengths[i] += 1
            self._attempt_streak.pop(req.rid, None)
            self.slot_fail_streak[i] = 0
            progressed = True
            if feeding:
                continue
            self._commit_token(req, tok)
            if self._should_finish(req, tok):
                self._release_slot(i)
                self._finalize(req, RequestState.FINISHED)
        return progressed

    def _feeding(self, i: int) -> bool:
        """Slot ``i`` holds a recovered request whose step input is not yet
        its last journaled token."""
        req = self.slot_req[i]
        return int(self.lengths[i]) - len(req.prompt) < len(req.out_tokens) - 1

    # -- attempts, sampling and the pool ------------------------------------

    def _attempt_failed(self, i: int, req: Request, e: BaseException):
        """Account one failed attempt.  Within the retry budget the request
        stays in its slot and the same phase replays on the next engine
        step from clean committed state; past the budget it becomes a
        FAILED record via ``_slot_failure``."""
        streak = self._attempt_streak.get(req.rid, 0)
        if streak >= self.max_retries:
            self._attempt_streak.pop(req.rid, None)
            self._slot_failure(i, req, e)
            return
        self._attempt_streak[req.rid] = streak + 1
        req.retries += 1
        self.counters["retries"] += 1
        if self.retry_backoff_s > 0:
            self.sleep_fn(self.retry_backoff_s * (2 ** streak))

    def _inject_before(self, fault, req: Request, phase: str, where: str = "") -> bool:
        """Apply an attempt's polled ``fault`` before its model call: sleep
        for ``slow_step``, raise for ``process_crash`` (a BaseException, so
        it escapes the per-request guard) and ``exception``; True for
        ``cache_corruption``, whose poisoning of the attempt's cache or
        pages is the caller's."""
        if fault is None:
            return False
        if fault.kind == "slow_step":
            self.injector.sleep(fault.seconds)
        elif fault.kind == "process_crash":
            raise SimulatedCrash(f"simulated crash at {phase} of rid {req.rid}{where}")
        elif fault.kind == "exception":
            raise InjectedFault(f"injected {phase} exception for rid {req.rid}")
        return fault.kind == "cache_corruption"

    def _inject_after(self, fault, logits):
        """The logits of an attempt with a ``nan_logits``/``inf_logits``
        fault poisoned; otherwise as they are."""
        if fault is not None and fault.kind in ("nan_logits", "inf_logits"):
            return self.injector.corrupt_logits(logits, fault.kind)
        return logits

    def _sampling_fault(self, req: Request):
        """Poll and apply the sampling boundary's fault, if any."""
        f = (self.injector.poll(req.rid, "sampling")
             if self.injector is not None else None)
        if f is None:
            return
        if f.kind == "slow_step":
            self.injector.sleep(f.seconds)
        elif f.kind == "process_crash":
            # a BaseException: escapes the per-request guard and the step,
            # so nothing below commits
            raise SimulatedCrash(f"simulated crash at sampling of rid {req.rid}")
        elif f.kind == "exception":
            raise InjectedFault(f"injected sampling exception for rid {req.rid}")

    def _save_pages(self, pages) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A device copy of the given pages of every pool leaf."""
        ids = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        return ids, {name: leaf[:, ids] for name, leaf in self.pool.items()}

    def _restore_pages(self, saved):
        """Write a :meth:`_save_pages` copy back into the pool."""
        ids, copy = saved
        for name, leaf in self.pool.items():
            leaf[:, ids] = copy[name]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _check_finite(self, logits, where: str = "prefill-chunk boundary"):
        """The sampling guard for logits that sample nothing (a non-final
        chunk, a recovered request's prompt or fed token)."""
        if not bool(torch.isfinite(logits).all()):
            n_nan = int(torch.isnan(logits).sum())
            n_inf = int(torch.isinf(logits).sum())
            raise NonFiniteLogitsError(
                f"non-finite logits at {where}: {n_nan} NaN, {n_inf} Inf of "
                f"{logits.numel()} entries")

    def _sample(self, req: Request, logits):
        # the generator depends only on (engine seed, rid, token index): a
        # request's tokens are invariant to slot placement, co-tenants and
        # retries
        gen = None
        if req.temperature > 0.0:
            gen = sampling_generator(self.seed, req.rid, len(req.out_tokens),
                                     logits.device)
        return sample_token(logits, gen, temperature=req.temperature,
                            check_finite=True)

    def _should_finish(self, req: Request, tok: int) -> bool:
        total = len(req.prompt) + len(req.out_tokens)
        return (len(req.out_tokens) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id)
                or total >= self.max_seq - 1)

    # -- crash safety: journal hooks, snapshot, restore ----------------------

    def _journal(self, kind: str, **fields):
        if self.journal is not None:
            self.journal.append(kind, **fields)

    def _commit_token(self, req: Request, tok: int):
        """Durably journal the token at its stream index, THEN append it:
        a crash between the two replays the journaled token, a crash before
        the journal write never shows it anywhere."""
        tok = int(tok)
        if self.journal is not None and req.rid in self._journaled_submits:
            self.journal.append("token", rid=req.rid,
                                idx=len(req.out_tokens), token=tok)
        req.out_tokens.append(tok)

    def _state_tree(self) -> dict:
        """The array state a snapshot persists (and the ``like`` tree a
        restore loads against): the pool and block tables, or the slot
        caches; and the slots' lengths."""
        if self.mode == "paged":
            return {"pool": self.pool,
                    "block_tables": np.array(self.block_tables),
                    "lengths": np.array(self.lengths)}
        return {"slot_caches": self.slot_caches, "lengths": np.array(self.lengths)}

    def snapshot(self) -> Optional[str]:
        """Persist the decode state through the atomic checkpoint path
        (``.tmp``-rename, keep-``snapshot_keep`` rotation): the KV pool,
        the allocator and block tables, lengths, slot states, prefill
        offsets, queue order and counters.  Must run at an engine-step
        boundary — ``run()`` calls it every ``snapshot_every`` steps.
        Returns the checkpoint path, or None without a ``snapshot_dir``."""
        if self._ckpt is None:
            return None
        meta = {
            "mode": self.mode,
            "seed": self.seed,
            "batch_slots": self.b,
            "max_seq": self.max_seq,
            "page_size": self.page_size,
            "prefill_chunk": self.prefill_chunk,
            **self.kv_spec.to_meta(),
            "counters": dict(self.counters),
            "slot_dead": [bool(x) for x in self.slot_dead],
            "slot_fail_streak": [int(x) for x in self.slot_fail_streak],
            "queue": [q.rid for q in self.queue],
            "journal_seq": None if self.journal is None else self.journal.seq,
            "slots": [
                None if req is None else {
                    "rid": req.rid,
                    "state": req.state.value,
                    "n_out": len(req.out_tokens),
                    "prefill_off": self._prefill_off[i],
                }
                for i, req in enumerate(self.slot_req)
            ],
        }
        if self.mode == "paged":
            meta["alloc"] = self.alloc.to_state()
        tree = {
            "state": self._state_tree(),
            # the variable-length JSON rides as a uint8 leaf, read back by
            # load_leaf (the like-tree protocol needs fixed shapes)
            "meta": np.frombuffer(json.dumps(meta).encode(), np.uint8),
        }
        step = self.counters["steps"]
        path = self._ckpt.save(step, tree)
        self._journal("snapshot", step=step, path=str(path))
        return path

    def _clear_slot_state(self, i: int, rid: int):
        """Drop a restored slot whose snapshot KV cannot be reused (its
        owner terminated after the snapshot, or the journal is ahead of the
        snapshot for this rid)."""
        if self.mode == "paged":
            if self.alloc.holds(rid):
                self.alloc.free(rid)
            self.block_tables[i, :] = 0
        else:
            self.slot_caches[i] = self._fresh_cache()
        self.lengths[i] = 0
        self._prefill_off[i] = 0

    @classmethod
    def restore(cls, cfg, params, journal_path, *,
                snapshot_dir: Optional[str] = None,
                snapshot_every: int = 0, snapshot_keep: int = 3,
                fsync: bool = True, **engine_kwargs) -> "ServeEngine":
        """Recover a crashed engine: replay the write-ahead journal (what
        exists, what was delivered, what terminated), then graft on the
        newest restorable snapshot, loaded onto the engine's device
        (``device=`` in ``engine_kwargs``; "cuda" by default, raising
        without a card).

        - A slot whose journaled token count equals the snapshot's resumes
          in place from the restored pool; mid-prefill slots resume at
          their chunk offset.
        - Anything the journal knows that the snapshot does not (tokens
          committed after it, requests still queued, no usable snapshot)
          re-enqueues: its prompt is prefilled again and its journaled
          tokens fed through the decode step, so the continuation is
          bitwise the uninterrupted run's and no journaled token is
          delivered twice.
        - A missing, stale or damaged snapshot degrades to journal-only
          recovery with a warning; a corrupt journal interior raises
          :class:`~repro_torch.serve.journal.JournalCorruption`.

        ``engine_kwargs`` passes operational knobs through (injector,
        clock, retry budgets, kernel_impl, device, ...); the shape config
        (batch_slots, max_seq, seed, paging, KV spec) always comes from the
        journal's ``open`` record."""
        if "journal" in engine_kwargs:
            raise JournalError("restore() owns the journal; do not pass one")
        if "kv_spec" in engine_kwargs:
            raise JournalError(
                "restore() reads the KV spec from the journal's open "
                "record; do not pass kv_spec")
        replay = read_journal(journal_path)
        col = collate(replay.records)
        if not col.opens:
            raise JournalError(
                f"journal {journal_path} has no open record — not a serve "
                f"journal (or its head was lost)")
        opened = col.opens[0]
        eng = cls(cfg, params,
                  batch_slots=int(opened["batch_slots"]),
                  max_seq=int(opened["max_seq"]),
                  eos_id=opened["eos_id"],
                  seed=int(opened["seed"]),
                  page_size=int(opened["page_size"]),
                  kv_pages=opened["kv_pages"],
                  prefill_chunk=opened["prefill_chunk"],
                  kv_spec=KVSpec.from_meta(opened),
                  snapshot_dir=snapshot_dir,
                  snapshot_every=snapshot_every,
                  snapshot_keep=snapshot_keep,
                  **engine_kwargs)
        if opened["mode"] != eng.mode:
            raise JournalError(
                f"journal was written by a {opened['mode']!r}-mode engine "
                f"but cfg {cfg.name!r} resolves to {eng.mode!r}")
        now = eng.clock()

        def make_req(rid: int) -> Request:
            sub = col.submits[rid]
            req = Request(rid=rid, prompt=np.asarray(sub["prompt"], np.int32),
                          max_new_tokens=int(sub["max_new_tokens"]),
                          temperature=float(sub["temperature"]),
                          deadline_s=sub.get("deadline_s"))
            req.out_tokens = list(col.tokens.get(rid, []))
            # deadlines re-anchor at restore: the crash was the engine's
            # fault, so a recovered request gets its full budget back
            req.submitted_at = now
            return req

        # terminal records journaled before the crash come back as records
        # (their timings died with the process)
        for rid, term in col.terminals.items():
            toks = col.tokens.get(rid, [])
            eng.records[rid] = RequestRecord(
                rid=rid, status=RequestState(term["status"]),
                out_tokens=list(toks),
                prompt_tokens=len(col.submits[rid]["prompt"]),
                new_tokens=len(toks), retries=int(term.get("retries", 0)),
                error_kind=term.get("error_kind"), error=term.get("error"),
                timings={})
        eng._journaled_submits = set(col.submits)
        eng._journaled_terminals = set(col.terminals)
        # re-attach the journal (truncating a torn tail) BEFORE any
        # restore-time finalization, so that journals its terminal too
        eng.journal = JournalWriter.reopen(journal_path, replay, fsync=fsync)

        def settle(req: Request) -> bool:
            """A journaled stream that already meets the termination
            predicate (the crash fell between its last token and its
            terminal record) finalizes now, never decoding again."""
            if req.out_tokens and eng._should_finish(req, req.out_tokens[-1]):
                req.advance(RequestState.PREFILLING, now)
                req.first_token_at = now
                eng._finalize(req, RequestState.FINISHED)
                return True
            return False

        # -- the snapshot graft: best effort; any damage degrades to
        # journal-only recovery (slower, never incorrect)
        snap_step, state, meta = None, None, None
        if snapshot_dir is not None:
            try:
                step, tree = eng._ckpt.restore_latest(
                    {"state": eng._state_tree()}, device=eng.device)
                if step is not None:
                    raw = load_leaf(eng._ckpt.dir / f"step_{step:08d}", "meta")
                    meta = json.loads(raw.numpy().tobytes().decode())
                    state = tree["state"]
                    snap_step = step
            except (CheckpointError, ValueError) as e:
                warnings.warn(f"snapshot restore failed ({e}); recovering "
                              f"from the journal alone")
                snap_step, state, meta = None, None, None
        if meta is not None and (meta.get("mode") != eng.mode
                                 or meta.get("seed") != eng.seed
                                 or meta.get("batch_slots") != eng.b
                                 or KVSpec.from_meta(meta) != eng.kv_spec):
            warnings.warn("snapshot belongs to a different engine config; "
                          "recovering from the journal alone")
            snap_step, state, meta = None, None, None
        if meta is not None and eng.mode == "paged":
            try:
                restored_alloc = PageAllocator.from_state(meta["alloc"])
            except (KeyError, ValueError, TypeError) as e:
                warnings.warn(f"snapshot allocator state is corrupt ({e}); "
                              f"recovering from the journal alone")
                snap_step, state, meta = None, None, None

        placed = set()
        if meta is not None:
            eng.counters = dict(meta["counters"])
            eng.slot_dead = [bool(x) for x in meta["slot_dead"]]
            eng.slot_fail_streak = [int(x) for x in meta["slot_fail_streak"]]
            if eng.mode == "paged":
                eng.alloc = restored_alloc
                eng.pool = state["pool"]
                eng.block_tables = np.asarray(state["block_tables"],
                                              np.int32).copy()
            else:
                eng.slot_caches = list(state["slot_caches"])
            eng.lengths = np.asarray(state["lengths"], np.int32).copy()
            for i, s in enumerate(meta["slots"]):
                if s is None:
                    continue
                rid = int(s["rid"])
                k = len(col.tokens.get(rid, []))
                if rid in col.terminals:
                    # terminated after the snapshot: only its pages matter
                    eng._clear_slot_state(i, rid)
                elif (s["state"] == RequestState.DECODING.value
                        and s["n_out"] == k and k > 0):
                    req = make_req(rid)
                    if settle(req):
                        eng._clear_slot_state(i, rid)
                        placed.add(rid)
                        continue
                    # journal and snapshot agree: continue decoding in place
                    req.advance(RequestState.PREFILLING, now)
                    req.first_token_at = now
                    req.advance(RequestState.DECODING, now)
                    eng.slot_req[i] = req
                    eng._prefill_off[i] = int(s.get("prefill_off", 0))
                    placed.add(rid)
                elif (s["state"] == RequestState.PREFILLING.value
                        and s["n_out"] == 0 and k == 0):
                    # mid-prefill at the snapshot: the pool holds chunks
                    # [0, prefill_off); resume at the next chunk
                    req = make_req(rid)
                    req.advance(RequestState.PREFILLING, now)
                    eng.slot_req[i] = req
                    eng._prefill_off[i] = int(s.get("prefill_off", 0))
                    placed.add(rid)
                else:
                    # the journal is AHEAD of the snapshot for this rid: its
                    # KV is stale, so drop it and replay from the journal
                    eng._clear_slot_state(i, rid)

        # everything pending and not resumed in place re-enqueues in
        # submission order; already-satisfied streams finalize instead
        requeued = []
        for rid in col.pending():
            if rid in placed:
                continue
            req = make_req(rid)
            if settle(req):
                placed.add(rid)
            else:
                eng.queue.append(req)
                requeued.append(rid)

        eng._journal("recover", snapshot_step=snap_step,
                     torn_tail=replay.torn_tail, resumed=sorted(placed),
                     requeued=requeued)
        return eng

    # -- failure handling / lifecycle ---------------------------------------

    def _slot_failure(self, i: int, req: Request, e: BaseException):
        """Release the slot and its pages, grow its failure streak
        (``slot_failure_limit`` consecutive request failures kill it), and
        fail ONLY this request with the captured error."""
        kind, msg = _classify_error(e)
        self._release_slot(i)
        self.slot_fail_streak[i] += 1
        self.counters["slot_failures"] += 1
        if self.slot_fail_streak[i] >= self.slot_failure_limit:
            self.slot_dead[i] = True
        self._finalize(req, RequestState.FAILED, kind, msg)

    def _write_block_row(self, i: int, rid: int):
        row = np.zeros((self.pages_per_slot,), np.int32)
        pages = self.alloc.pages_of(rid)
        row[:len(pages)] = pages
        self.block_tables[i] = row

    def _release_slot(self, i: int):
        req = self.slot_req[i]
        self.slot_req[i] = None
        if req is not None:
            self._attempt_streak.pop(req.rid, None)
        if self.mode == "paged":
            # freed pages may hold stale values: a new owner rewrites every
            # position below its length and the mask hides the rest
            if req is not None:
                self.alloc.free(req.rid)
            self.block_tables[i, :] = 0
        else:
            self.slot_caches[i] = self._fresh_cache()
        self.lengths[i] = 0
        self._prefill_off[i] = 0

    def _fresh_cache(self):
        """A B=1 contiguous cache at ``max_seq``, f32 (the reference's
        engine dtype) or the float ``kv_spec``'s dtype."""
        return model_lib.init_cache(self.cfg, 1, self.max_seq, dtype=torch.float32,
                                    device=self.device, kv_spec=self.kv_spec)

    def _finalize(self, req: Request, status: RequestState,
                  error_kind: Optional[str] = None, error: Optional[str] = None):
        self._attempt_streak.pop(req.rid, None)
        req.error_kind = error_kind
        req.error = error
        # WAL: the terminal record is durable before it becomes visible, and
        # a rid terminates in the journal exactly once
        if (self.journal is not None and req.rid in self._journaled_submits
                and req.rid not in self._journaled_terminals):
            self._journaled_terminals.add(req.rid)
            self.journal.append(
                "terminal", rid=req.rid, status=status.value,
                error_kind=(None if error_kind is None else str(error_kind)),
                error=error, retries=req.retries, n_tokens=len(req.out_tokens))
        req.advance(status, self.clock())
        self.records[req.rid] = RequestRecord.from_request(req)
        self.counters[status.value] = self.counters.get(status.value, 0) + 1

    def _expire_deadlines(self) -> bool:
        """Time out every request, queued or in flight, whose deadline has
        passed on the engine clock; an in-flight one keeps its tokens and
        frees its slot and pages."""
        now = self.clock()
        progressed = False
        for req in list(self.queue):
            at = req.deadline_at()
            if at is not None and now >= at:
                self.queue.remove(req)
                self._finalize(req, RequestState.TIMED_OUT, ErrorKind.DEADLINE,
                               f"deadline ({req.deadline_s:.3f}s) expired "
                               f"while queued")
                progressed = True
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            at = req.deadline_at()
            if at is not None and now >= at:
                self._release_slot(i)
                self._finalize(req, RequestState.TIMED_OUT, ErrorKind.DEADLINE,
                               f"deadline ({req.deadline_s:.3f}s) expired "
                               f"after {len(req.out_tokens)} tokens")
                progressed = True
        return progressed

    def _stall_reason(self) -> Optional[str]:
        pending = bool(self.queue) or any(r is not None for r in self.slot_req)
        if pending and all(self.slot_dead):
            return (f"all {self.b} slots dead "
                    f"(slot_failure_limit={self.slot_failure_limit}) with "
                    f"{len(self.queue)} request(s) still queued")
        if self._steps_since_progress > self.stall_patience:
            return (f"no progress for {self._steps_since_progress} steps "
                    f"(stall_patience={self.stall_patience})")
        return None

    def _drain_unfinished(self, kind: str, msg: str):
        """Every request still queued or in a slot becomes a TIMED_OUT
        record — nothing silently vanishes from ``run()``'s return."""
        for i, req in enumerate(self.slot_req):
            if req is not None:
                self._release_slot(i)
                self._finalize(req, RequestState.TIMED_OUT, kind,
                               f"{msg}; in flight with {len(req.out_tokens)} "
                               f"token(s)")
        while self.queue:
            req = self.queue.pop(0)
            self._finalize(req, RequestState.TIMED_OUT, kind,
                           f"{msg}; still queued")
