"""Continuous-batching serving engine, paged dense mode (counterpart of
``repro/serve/engine.py``).

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
  pool capacity in pages, token ids, budget, deadline, unique rid);
  ``_admit`` holds the queue FIFO until the free list covers the head's
  prompt.
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

Sampling generators derive only from (engine seed, rid, token index) and
masked attention positions weigh exactly zero, so a request's tokens do not
depend on its slot, its pages or its co-tenants.

- **KV storage** (``kv_spec=``, a :class:`~repro_torch.serve.kvquant.KVSpec`;
  default f32): f32 and bf16 pools, or int8 / packed-int4 pools with f32
  scale planes that the allocator accounts in lockstep with the pages
  (``sidecar``).  The spec's geometry is checked when the engine is built.
  ``health()["kv"]`` reports the scheme and its bytes per token.

Not ported yet (ROADMAP Queue 1): fault injection and the chaos contract,
retries with backoff (an attempt that raises fails its request at once),
cancel, the queue bound, the stall watchdog, the journal and
snapshot/restore, meshes, and the stacked and per-slot modes of other
families.

The page pool is written in place by ``paged_step``, so a failed attempt
may leave writes in the failing request's own pages (or the null page);
they are never read, because the request is released with its pages.

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
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib
from repro_torch.quant.qlinear import (KERNEL_IMPLS, QLinear,
                                       retag_qlinear_impl)
from repro_torch.serve.kvquant import KVSpec
from repro_torch.serve.lifecycle import (ErrorKind, Request, RequestRecord,
                                         RequestState)
from repro_torch.serve.paging import PageAllocator
from repro_torch.serve.sampling import (NonFiniteLogitsError, sample_token,
                                        sampling_generator)

__all__ = ["PagesExhausted", "Request", "RequestRecord", "RequestState",
           "ServeEngine", "attention_report"]


class PagesExhausted(RuntimeError):
    """The free list could not cover a page allocation."""


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
    if isinstance(e, NonFiniteLogitsError):
        kind = ErrorKind.NON_FINITE_LOGITS
    elif isinstance(e, PagesExhausted):
        kind = ErrorKind.KV_PAGES_EXHAUSTED
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
                 default_deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic, device="cuda"):
        self.device = resolve_device(device)
        if cfg.family not in model_lib.PAGED_FAMILIES:
            raise NotImplementedError(
                f"only the paged families {model_lib.PAGED_FAMILIES} are "
                f"ported, not {cfg.family!r}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.kv_spec = kv_spec if kv_spec is not None else KVSpec()
        if self.kv_spec.is_quantized:
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
        self.default_deadline_s = default_deadline_s
        self.clock = clock
        self.mode = "paged"
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        # the default pool covers every slot at full length, so the free
        # list only runs dry when the caller shrinks kv_pages
        self.pages_per_slot = -(-max_seq // page_size)
        num_pages = (kv_pages if kv_pages is not None
                     else batch_slots * self.pages_per_slot + 1)
        self.alloc = PageAllocator(num_pages, page_size,
                                   sidecar=self.kv_spec.is_quantized)
        self.pool = model_lib.init_paged_cache(
            cfg, num_pages, page_size, dtype=torch.float32, device=self.device,
            kv_spec=self.kv_spec)
        self.block_tables = np.zeros((batch_slots, self.pages_per_slot), np.int32)
        self.lengths = np.zeros((batch_slots,), np.int32)
        self._prefill_off = [0] * batch_slots

        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.records: Dict[int, RequestRecord] = {}
        self.counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "steps": 0, "finished": 0,
            "failed": 0, "rejected": 0, "timed_out": 0, "decode_calls": 0,
            "prefill_calls": 0,
        }
        self._paged = functools.partial(model_lib.paged_step, cfg,
                                        kv_spec=self.kv_spec, ctx=ctx)
        self.decode_plan = self._resolve_decode_plan()
        route_ctx = ctx if ctx is not None else ops.DEFAULT_CONTEXT
        self.decode_attention = attention_report(
            route_ctx, self.device, cfg.head_dim, self.kv_spec, decode=True)
        self.prefill_attention = attention_report(
            route_ctx, self.device, cfg.head_dim, self.kv_spec, decode=False)

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
        self.counters["submitted"] += 1
        self.queue.append(req)
        return True

    def run(self, max_steps: int = 1024) -> Dict[int, RequestRecord]:
        """Drive until queue and slots drain; never raises for per-request
        failures.  Exhausting ``max_steps`` returns the survivors as
        ``TIMED_OUT`` records."""
        for _ in range(max_steps):
            self.counters["steps"] += 1
            self._expire_deadlines()
            self._admit()
            if not any(r is not None for r in self.slot_req) and not self.queue:
                break
            self._prefill_tick()
            self._step()
        else:
            self._drain_unfinished(ErrorKind.STEP_LIMIT,
                                   f"engine step budget ({max_steps}) exhausted")
        return self.records

    def health(self) -> dict:
        """Slot states, queue depth, counters and page-pool accounting."""
        slots = []
        for i in range(self.b):
            req = self.slot_req[i]
            slots.append({
                "slot": i,
                "state": req.state.value if req is not None else "idle",
                "rid": None if req is None else req.rid,
                "tokens": 0 if req is None else len(req.out_tokens),
            })
        return {
            "slots": slots,
            "queue_depth": len(self.queue),
            "counters": dict(self.counters),
            "mode": self.mode,
            "device": str(self.device),
            "kv_pages": self.alloc.stats(),
            "kv": self._kv_health(),
            "decode_plan": self.decode_plan,
            "decode_attention": self.decode_attention,
            "prefill_attention": self.prefill_attention,
        }

    def _kv_health(self) -> dict:
        """``health()["kv"]``: the KV storage scheme and ``bytes_per_token``,
        the all-layer K+V device bytes of one token (data plus scale
        planes, ``KVSpec.kv_bytes_per_token``)."""
        return {"dtype": self.kv_spec.dtype, "group": self.kv_spec.group,
                "layout": self.kv_spec.describe(),
                "bytes_per_token": self.cfg.n_layers * self.kv_spec.kv_bytes_per_token(
                    self.cfg.n_kv_heads, self.cfg.head_dim)}

    # -- kernel-plan introspection ------------------------------------------

    def _resolve_decode_plan(self) -> List[dict]:
        """The path each distinct (K, N, R, act_group) QLinear site runs at
        decode: the batched step flattens (B, 1, K) activations to an (M =
        batch_slots, K) GEMM, and the site's activation group (None:
        per-token) enters the plan as it does in the forward.  A site on a
        plain impl (sim, int8) reports that impl as its path.  Empty for
        float params."""
        sites: Dict[tuple, dict] = {}

        def visit(node):
            if isinstance(node, QLinear):
                r = 0 if node.u is None else int(node.u.shape[1])
                entry = {"m": self.b, "k": node.d_in, "n": node.d_out, "r": r,
                         "act_group": node.act_group, "impl": node.impl,
                         "path": node.impl, "pinned": False, "demoted": False}
                if node.impl in KERNEL_IMPLS:
                    ctx = ops.DEFAULT_CONTEXT if node.ctx is None else node.ctx
                    entry.update(ctx.resolve_plan(
                        self.b, node.d_in, node.d_out, r, layer=node.name,
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
            while self.slot_req[i] is None and self.queue:
                head = self.queue[0]
                if self.alloc.pages_for(len(head.prompt) + 1) > self.alloc.free_pages:
                    # FIFO backpressure until co-tenants free enough pages
                    return progressed
                req = self.queue.pop(0)
                progressed = True
                req.advance(RequestState.PREFILLING, self.clock())
                self.counters["admitted"] += 1
                self.slot_req[i] = req
                self._prefill_off[i] = 0
                self.lengths[i] = 0
                self._prefill_advance(i)
        return progressed

    def _prefill_tick(self) -> bool:
        """Advance every mid-prefill slot by one chunk."""
        progressed = False
        for i in range(self.b):
            req = self.slot_req[i]
            if req is not None and req.state is RequestState.PREFILLING:
                progressed |= self._prefill_advance(i)
        return progressed

    # -- prefill ------------------------------------------------------------

    def _prefill_advance(self, i: int) -> bool:
        """One prefill-chunk attempt for slot ``i``."""
        req = self.slot_req[i]
        prompt = np.asarray(req.prompt, np.int32)
        n_prompt = int(prompt.size)
        got = self.alloc.ensure(req.rid, n_prompt)
        if got is None:
            self._slot_failure(i, req, PagesExhausted(
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
        tokens = np.zeros((1, chunk), np.int32)
        tokens[0, :n] = prompt[off:off + n]
        positions = off + np.arange(chunk, dtype=np.int32)[None, :]
        valid = (np.arange(chunk) < n)[None, :]
        srow = np.asarray([n - 1], np.int32)
        self.counters["prefill_calls"] += 1
        try:
            logits, self.pool = self._paged(
                self.params, self._dev(tokens), self._dev(positions),
                self._dev(valid), self.pool,
                self._dev(self.block_tables[i:i + 1]), self._dev(srow),
                is_prefill=True)
            if final:
                tok = int(self._sample(req, logits[:, -1])[0])
            else:
                # non-final chunks never sample, but NaN must not pass
                # silently into later chunks
                self._check_finite(logits)
        except Exception as e:  # isolated: fails only this request
            self._slot_failure(i, req, e)
            return True
        self._prefill_off[i] = off + n
        self.lengths[i] = off + n
        if final:
            self._finish_prefill(i, req, tok)
        return True

    def _finish_prefill(self, i: int, req: Request, tok: int):
        req.out_tokens.append(int(tok))
        req.first_token_at = self.clock()
        # the prefill-sampled token obeys the same termination predicate as
        # decode tokens
        if self._should_finish(req, tok):
            self._release_slot(i)
            self._finalize(req, RequestState.FINISHED)
        else:
            req.advance(RequestState.DECODING, self.clock())

    # -- stepping -----------------------------------------------------------

    def _step(self) -> bool:
        """ONE batched ``paged_step`` over every decoding slot."""
        active = [i for i in range(self.b)
                  if self.slot_req[i] is not None
                  and self.slot_req[i].state is RequestState.DECODING]
        if not active:
            return False
        progressed = False
        # decode-boundary crossings allocate before the forward
        for i in list(active):
            req = self.slot_req[i]
            got = self.alloc.ensure(req.rid, int(self.lengths[i]) + 1)
            if got is None:
                active.remove(i)
                self._slot_failure(i, req, PagesExhausted(
                    f"no free page for rid {req.rid} at position "
                    f"{int(self.lengths[i])} ({self.alloc.free_pages} free of "
                    f"{self.alloc.capacity})"))
                progressed = True
            elif got:
                self._write_block_row(i, req.rid)
        if not active:
            return progressed

        tokens = np.zeros((self.b, 1), np.int32)
        valid = np.zeros((self.b, 1), bool)
        for i in active:
            tokens[i, 0] = self.slot_req[i].out_tokens[-1]
            valid[i, 0] = True
        positions = self.lengths.astype(np.int32)[:, None]
        srow = np.zeros((self.b,), np.int32)
        self.counters["decode_calls"] += 1
        try:
            logits, self.pool = self._paged(
                self.params, self._dev(tokens), self._dev(positions),
                self._dev(valid), self.pool, self._dev(self.block_tables),
                self._dev(srow))
        except Exception as e:
            # the one batched call died: every active request fails
            for i in active:
                self._slot_failure(i, self.slot_req[i], e)
            return True

        for i in active:
            req = self.slot_req[i]
            progressed = True
            try:
                tok = int(self._sample(req, logits[i:i + 1, -1])[0])
            except Exception as e:  # isolated: fails only this request
                self._slot_failure(i, req, e)
                continue
            req.out_tokens.append(tok)
            self.lengths[i] += 1
            if self._should_finish(req, tok):
                self._release_slot(i)
                self._finalize(req, RequestState.FINISHED)
        return progressed

    # -- helpers ------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _check_finite(self, logits):
        if not bool(torch.isfinite(logits).all()):
            n_nan = int(torch.isnan(logits).sum())
            n_inf = int(torch.isinf(logits).sum())
            raise NonFiniteLogitsError(
                f"non-finite logits at prefill-chunk boundary: {n_nan} NaN, "
                f"{n_inf} Inf of {logits.numel()} entries")

    def _sample(self, req: Request, logits):
        # the generator depends only on (engine seed, rid, token index): a
        # request's tokens are invariant to slot placement and co-tenants
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

    def _slot_failure(self, i: int, req: Request, e: BaseException):
        """Release the slot (and its pages) and fail ONLY this request."""
        kind, msg = _classify_error(e)
        self._release_slot(i)
        self._finalize(req, RequestState.FAILED, kind, msg)

    def _write_block_row(self, i: int, rid: int):
        row = np.zeros((self.pages_per_slot,), np.int32)
        pages = self.alloc.pages_of(rid)
        row[:len(pages)] = pages
        self.block_tables[i] = row

    def _release_slot(self, i: int):
        req = self.slot_req[i]
        self.slot_req[i] = None
        # freed pages may hold stale values: a new owner rewrites every
        # position below its length and the mask hides the rest
        if req is not None:
            self.alloc.free(req.rid)
        self.block_tables[i, :] = 0
        self.lengths[i] = 0
        self._prefill_off[i] = 0

    def _finalize(self, req: Request, status: RequestState,
                  error_kind: Optional[str] = None, error: Optional[str] = None):
        req.error_kind = error_kind
        req.error = error
        req.advance(status, self.clock())
        self.records[req.rid] = RequestRecord.from_request(req)
        self.counters[status.value] = self.counters.get(status.value, 0) + 1

    def _expire_deadlines(self):
        """Time out every request, queued or in flight, whose deadline has
        passed on the engine clock; an in-flight one keeps its tokens and
        frees its slot and pages."""
        now = self.clock()
        for req in list(self.queue):
            at = req.deadline_at()
            if at is not None and now >= at:
                self.queue.remove(req)
                self._finalize(req, RequestState.TIMED_OUT, ErrorKind.DEADLINE,
                               f"deadline ({req.deadline_s:.3f}s) expired "
                               f"while queued")
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            at = req.deadline_at()
            if at is not None and now >= at:
                self._release_slot(i)
                self._finalize(req, RequestState.TIMED_OUT, ErrorKind.DEADLINE,
                               f"deadline ({req.deadline_s:.3f}s) expired "
                               f"after {len(req.out_tokens)} tokens")

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
