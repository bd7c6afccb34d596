"""Deterministic fault injection for the serving engine (counterpart of
``repro/serve/faults.py``).

A :class:`FaultInjector` is handed to ``ServeEngine(injector=...)`` and
polled at the three request-phase boundaries (``prefill`` / ``decode`` /
``sampling``).  Every fault fires on a deterministic schedule — the n-th
time a given (rid, phase) boundary is hit — so a chaos run is exactly
reproducible: same specs (or same seed via :meth:`FaultInjector.sample`,
which draws from numpy as the reference does, so one seed targets the same
rids with the same kinds and calls in both packages), same engine seed,
same records, and the untargeted requests' outputs are bitwise identical to
a fault-free run.

Fault kinds:

- ``exception``         raise :class:`InjectedFault` before the forward
- ``nan_logits``        overwrite every 7th vocab entry of the logits with NaN
- ``inf_logits``        same, with +Inf
- ``slow_step``         burn ``seconds`` of (injectable) wall clock — pairs
                        with per-request deadlines to produce TIMED_OUT
- ``cache_corruption``  poison the victim's KV pages (every float leaf of
                        the pool; on a quantized pool the f32 scale planes),
                        or in the per-slot mode a copy of its cache, with
                        NaN, surfacing as non-finite logits
- ``process_crash``     raise :class:`SimulatedCrash` (a ``BaseException``)
                        at the seeded (rid, phase, hit) point — it escapes
                        the engine's per-request ``except Exception``
                        isolation on purpose, killing ``run()`` mid-step
                        as a process death would.  Pairs with the
                        write-ahead journal and snapshots
                        (``serve/journal.py``, ``ServeEngine.restore``).

W4A4+LRC is the regime where activation outliers stress quantized
numerics, so ``nan_logits`` / ``cache_corruption`` are not hypothetical.

The payloads work on torch tensors.  :meth:`FaultInjector.corrupt_pages`
writes the pool IN PLACE (the port's pool is written in place by
``paged_step``); the engine keeps a device copy of the victim's pages and
writes it back when the attempt fails, so a failed attempt commits nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FAULT_KINDS = ("exception", "nan_logits", "inf_logits", "slow_step",
               "cache_corruption", "process_crash")
FAULT_PHASES = ("prefill", "decode", "sampling")
# sampling sees a token id, not logits or a cache: only control-flow faults
# make sense there
_SAMPLING_KINDS = ("exception", "slow_step", "process_crash")
# hard kinds deterministically fail a request once they outlast the retry
# budget; slow_step only fails via a deadline, and process_crash kills the
# whole engine rather than failing one request, so neither is sampled by
# the K-of-N chaos targeting
HARD_KINDS = ("exception", "nan_logits", "inf_logits", "cache_corruption")


class InjectedFault(RuntimeError):
    """Raised by the injector at an ``exception`` fault site."""


class SimulatedCrash(BaseException):
    """A simulated process death, raised at a ``process_crash`` fault site.

    A ``BaseException`` on purpose: the engine's per-request isolation
    catches ``Exception``, so a simulated crash, like a real SIGKILL, cannot
    be retried, quarantined or turned into a FAILED record.  It unwinds out
    of ``ServeEngine.run()`` mid-step, leaving only what the write-ahead
    journal and the last snapshot persisted."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``repeat`` consecutive times starting at
    the ``at_call``-th hit of the (rid, phase) boundary."""

    kind: str
    phase: str
    rid: int
    at_call: int = 0
    repeat: int = 1
    seconds: float = 0.0  # slow_step only

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.phase not in FAULT_PHASES:
            raise ValueError(f"unknown fault phase {self.phase!r}; one of {FAULT_PHASES}")
        if self.phase == "sampling" and self.kind not in _SAMPLING_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} cannot fire at the sampling "
                f"boundary (no logits/cache there); use one of {_SAMPLING_KINDS}")
        if self.at_call < 0 or self.repeat < 1:
            raise ValueError(f"need at_call >= 0 and repeat >= 1, got "
                             f"at_call={self.at_call} repeat={self.repeat}")
        if self.kind == "slow_step" and self.seconds < 0:
            raise ValueError(f"slow_step needs seconds >= 0, got {self.seconds}")


class FaultInjector:
    """Seed- or schedule-driven fault source, polled by the engine.

    ``poll(rid, phase)`` increments the (rid, phase) hit counter and returns
    the matching :class:`FaultSpec` (or None); the engine applies the fault
    at the right point of the step.  Fired faults are logged in
    ``self.fired`` as ``(spec, hit_index)``.
    """

    def __init__(self, specs: Sequence[FaultSpec],
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.sleep_fn = sleep_fn
        self._hits: Dict[Tuple[int, str], int] = {}
        self.fired: List[Tuple[FaultSpec, int]] = []

    @classmethod
    def sample(cls, rids: Sequence[int], k: int, seed: int,
               kinds: Sequence[str] = HARD_KINDS, phase: str = "decode",
               at_call_max: int = 3, repeat: int = 8, seconds: float = 0.05,
               sleep_fn: Callable[[float], None] = time.sleep) -> "FaultInjector":
        """Deterministically target ``k`` of ``rids``: the seed fixes which
        requests are hit, with which kind, and on which call (the
        reference's draws from ``np.random.default_rng(seed)``, in its
        order).  ``repeat`` defaults high enough to outlast any sane retry
        budget, so a sampled hard fault reliably fails its request."""
        if not 0 <= k <= len(rids):
            raise ValueError(f"need 0 <= k <= {len(rids)}, got {k}")
        rng = np.random.default_rng(seed)
        targets = sorted(int(r) for r in
                         rng.choice(np.asarray(list(rids)), size=k, replace=False))
        specs = [
            FaultSpec(kind=str(rng.choice(list(kinds))), phase=phase, rid=rid,
                      at_call=int(rng.integers(0, max(1, at_call_max))),
                      repeat=repeat, seconds=seconds)
            for rid in targets
        ]
        return cls(specs, sleep_fn=sleep_fn)

    @property
    def targets(self) -> frozenset:
        return frozenset(s.rid for s in self.specs)

    def poll(self, rid: int, phase: str) -> Optional[FaultSpec]:
        n = self._hits.get((rid, phase), 0)
        self._hits[(rid, phase)] = n + 1
        for spec in self.specs:
            if (spec.rid == rid and spec.phase == phase
                    and spec.at_call <= n < spec.at_call + spec.repeat):
                self.fired.append((spec, n))
                return spec
        return None

    def sleep(self, seconds: float):
        self.sleep_fn(seconds)

    # -- fault payloads ------------------------------------------------------

    @staticmethod
    def corrupt_logits(logits: torch.Tensor, kind: str) -> torch.Tensor:
        """A deterministic non-finite burst on a clone: every 7th vocab
        entry."""
        fill = float("nan") if kind == "nan_logits" else float("inf")
        out = logits.clone()
        out[..., ::7] = fill
        return out

    @staticmethod
    def corrupt_cache(cache: Dict[str, object]) -> Dict[str, object]:
        """A copy of a cache tree (nested dicts, such as the moe family's
        ``{"dense", "moe"}`` latent caches) with every float leaf NaN
        everywhere; integer leaves (codes, offsets) keep their values, so
        the corruption surfaces as non-finite activations, not an index
        error.  The per-slot engine mode passes the copy to the victim's
        attempt and keeps the slot's own cache; the paged engine uses
        :meth:`corrupt_pages`."""
        return {name: (FaultInjector.corrupt_cache(leaf) if isinstance(leaf, dict)
                       else torch.full_like(leaf, float("nan"))
                       if leaf.is_floating_point() else leaf)
                for name, leaf in cache.items()}

    @staticmethod
    def corrupt_pages(cache: Dict[str, torch.Tensor], page_ids) -> Dict[str, torch.Tensor]:
        """Poison ONLY the given pages of a paged KV pool (leaves shaped
        (L, NP, P, ...), page id on axis 1), in place: every float leaf of
        the pool, which on a quantized pool is its f32 scale planes.  The
        page-scoped analogue of :meth:`corrupt_cache` for the shared pool,
        where poisoning every leaf would corrupt the co-tenants.  Returns
        the same pool."""
        ids = [int(p) for p in page_ids]
        if ids:
            for leaf in cache.values():
                if leaf.is_floating_point() and leaf.ndim >= 2:
                    leaf[:, ids] = float("nan")
        return cache

    @staticmethod
    def corrupt_rows(cache: Dict[str, torch.Tensor], row: int) -> Dict[str, torch.Tensor]:
        """A copy of a stacked cache with batch row ``row`` (axis 1 of every
        float leaf of rank >= 2) NaN.  For the stacked engine mode, not
        ported yet."""
        out = {}
        for name, leaf in cache.items():
            if leaf.is_floating_point() and leaf.ndim >= 2:
                leaf = leaf.clone()
                leaf[:, row] = float("nan")
            out[name] = leaf
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "specs": len(self.specs),
            "targets": sorted(self.targets),
            "fired": [(s.kind, s.phase, s.rid, n) for s, n in self.fired],
        }
