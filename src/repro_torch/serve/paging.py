"""Paged-KV bookkeeping for the serving engine: a free-list page allocator
plus per-request block tables (the Lightllm/vLLM layout).

Ported from ``repro/serve/paging.py`` (which imports no JAX) so that the
port imports nothing of the reference package.

The engine owns ONE page pool per model (``model.init_paged_cache``); this
module owns which request holds which pages.  Pages are fixed-size
(``page_size`` token slots each); a request's KV for absolute positions
``[j*page_size, (j+1)*page_size)`` lives in the j-th page of its page list.
Pages are allocated lazily — prompt pages at admission, one page per
decode-boundary crossing — and freed as a unit when the request reaches a
terminal state.

Invariants (enforced by ``check()``, tested in
``tests/test_torch_engine.py`` and ``tests/test_torch_kvquant.py``):

- **Conservation.**  Every page id in ``[1, num_pages)`` is at all times
  either on the free list or in exactly one request's page list:
  ``free_pages + sum(per-request pages) == capacity``.
- **No double allocation.**  A page never appears in two page lists, twice
  in one list, or on the free list while allocated.
- **Null page.**  Page 0 is reserved and never allocated; model-side writes
  for padding / inactive slots are redirected there, so ``capacity ==
  num_pages - 1``.
- **No double free.**  Freeing an unknown rid is a no-op returning 0;
  freeing twice cannot return a page to the free list twice.
- **Admission accounting.**  ``pages_for(n)`` is the exact number of pages
  a request holding ``n`` tokens needs; ``used_pages`` equals the sum of
  per-request page counts, which is what admission control charges against
  ``free_pages``.
- **Scale-sidecar lockstep** (``sidecar=True``, quantized KV specs).  A
  quantized pool carries f32 scale planes (``k_scale`` / ``v_scale``)
  indexed by the SAME page ids as the data pages.  The allocator mirrors
  its accounting (free list and per-request lists) for the sidecar, and
  ``check()`` asserts that the two never diverge: a scale plane is never
  freed, aliased or double-allocated apart from its data page.
"""

from __future__ import annotations

from typing import Dict, List, Optional

NULL_PAGE = 0


class PageAllocator:
    """Free-list allocator over ``num_pages - 1`` usable pages.

    The free list is LIFO (a stack), which deliberately recycles pages hot
    and out of order — the chaos suite's bitwise-parity asserts prove that
    outputs never depend on WHICH pages a request lands on."""

    def __init__(self, num_pages: int, page_size: int, sidecar: bool = False):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                             f"reserved null page), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        self._owned: Dict[int, List[int]] = {}
        # quantized pools: mirrored accounting for the scale-plane sidecar
        # (same page ids, tracked apart so check() can prove the two never
        # drift)
        self.sidecar = bool(sidecar)
        self._side_free: Optional[List[int]] = (
            list(self._free) if self.sidecar else None)
        self._side_owned: Optional[Dict[int, List[int]]] = (
            {} if self.sidecar else None)

    # -- accounting ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Total allocatable pages (excludes the null page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Sum of per-request page counts == capacity - free_pages."""
        return sum(len(v) for v in self._owned.values())

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` token slots (ceil division)."""
        return -(-max(n_tokens, 0) // self.page_size)

    def pages_of(self, rid: int) -> List[int]:
        """The request's page list (a copy), prompt-order."""
        return list(self._owned.get(rid, ()))

    def holds(self, rid: int) -> int:
        return len(self._owned.get(rid, ()))

    # -- alloc / free -------------------------------------------------------

    def ensure(self, rid: int, n_tokens: int) -> Optional[List[int]]:
        """Grow ``rid``'s page list to cover ``n_tokens`` token positions.

        Returns the (possibly empty) list of newly allocated page ids, or
        None — with NO partial allocation committed — if the free list
        cannot cover the growth.  Idempotent: ensuring an already-covered
        length allocates nothing."""
        need = self.pages_for(n_tokens) - self.holds(rid)
        if need <= 0:
            return []
        if need > len(self._free):
            return None
        fresh = [self._free.pop() for _ in range(need)]
        self._owned.setdefault(rid, []).extend(fresh)
        if self.sidecar:
            side = [self._side_free.pop() for _ in range(need)]
            self._side_owned.setdefault(rid, []).extend(side)
        return fresh

    def free(self, rid: int) -> int:
        """Return ALL of ``rid``'s pages to the free list (the terminal-state
        transition).  Unknown rid is a no-op; returns the page count freed.

        Raises ``ValueError`` if any page being returned is already on the
        free list or out of range — pushing such a page would silently break
        the conservation invariant (``free + held == capacity``) the fuzz
        suite checks, and the very next double allocation would hand one
        physical page to two requests.  This can only happen through state
        corruption, so it is an error, never a no-op."""
        pages = self._owned.get(rid)
        if not pages:
            self._owned.pop(rid, None)
            if self.sidecar:
                self._side_owned.pop(rid, None)
            return 0
        on_free = set(self._free)
        bad = [p for p in pages
               if p in on_free or not NULL_PAGE < p < self.num_pages]
        if bad:
            raise ValueError(
                f"double free: rid {rid} page list {pages} contains page(s) "
                f"{bad} already on the free list or out of range "
                f"[1, {self.num_pages}) — allocator state is corrupt")
        if self.sidecar:
            # validate the sidecar BEFORE either list changes: a failed free
            # must not leave data and scale accounting half-applied
            spages = self._side_owned.get(rid, [])
            on_side_free = set(self._side_free)
            sbad = [p for p in spages
                    if p in on_side_free or not NULL_PAGE < p < self.num_pages]
            if sbad:
                raise ValueError(
                    f"scale-plane double free: rid {rid} sidecar list "
                    f"{spages} contains page(s) {sbad} already free or out "
                    f"of range — sidecar state is corrupt")
            self._side_owned.pop(rid, None)
            self._side_free.extend(reversed(spages))
        del self._owned[rid]
        self._free.extend(reversed(pages))
        return len(pages)

    # -- snapshot / restore -------------------------------------------------

    def to_state(self) -> dict:
        """JSON-serializable snapshot of the full allocator state (free
        list order included — LIFO recycling survives a restore)."""
        state = {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "free": list(self._free),
            "owned": {str(rid): list(pages)
                      for rid, pages in self._owned.items()},
            "sidecar": self.sidecar,
        }
        if self.sidecar:
            state["side_free"] = list(self._side_free)
            state["side_owned"] = {str(rid): list(pages)
                                   for rid, pages in self._side_owned.items()}
        return state

    @classmethod
    def from_state(cls, state: dict) -> "PageAllocator":
        """Rebuild an allocator from :meth:`to_state`, validating every
        conservation invariant — a corrupt snapshot raises ``ValueError``
        instead of silently double-allocating pages later.  (Pre-sidecar
        snapshots carry no ``sidecar`` key and restore as plain
        allocators.)"""
        alloc = cls(int(state["num_pages"]), int(state["page_size"]),
                    sidecar=bool(state.get("sidecar", False)))
        alloc._free = [int(p) for p in state["free"]]
        alloc._owned = {int(rid): [int(p) for p in pages]
                        for rid, pages in state["owned"].items()}
        if alloc.sidecar:
            alloc._side_free = [int(p) for p in state["side_free"]]
            alloc._side_owned = {int(rid): [int(p) for p in pages]
                                 for rid, pages in state["side_owned"].items()}
        try:
            alloc.check()
        except AssertionError as e:
            raise ValueError(f"corrupt allocator snapshot: {e}") from None
        return alloc

    # -- diagnostics --------------------------------------------------------

    def check(self) -> None:
        """Assert every invariant in the module docstring (test hook)."""
        seen = set(self._free)
        assert len(seen) == len(self._free), "free list holds duplicates"
        assert NULL_PAGE not in seen, "null page on the free list"
        for rid, pages in self._owned.items():
            assert pages, f"rid {rid} owns an empty page list"
            for p in pages:
                assert 0 < p < self.num_pages, f"page {p} out of range"
                assert p not in seen, f"page {p} owned twice (rid {rid})"
                seen.add(p)
        assert len(seen) == self.capacity, \
            f"page leak: {self.capacity - len(seen)} pages unaccounted"
        assert self.free_pages + self.used_pages == self.capacity
        if self.sidecar:
            # the sidecar satisfies the same alias/double-free structure...
            sseen = set(self._side_free)
            assert len(sseen) == len(self._side_free), \
                "scale-plane free list holds duplicates"
            assert NULL_PAGE not in sseen, "null page on scale-plane free list"
            for rid, pages in self._side_owned.items():
                for p in pages:
                    assert 0 < p < self.num_pages, \
                        f"scale plane {p} out of range"
                    assert p not in sseen, \
                        f"scale plane {p} owned twice (rid {rid})"
                    sseen.add(p)
            assert len(sseen) == self.capacity, "scale-plane leak"
            # ...and stays in LOCKSTEP with the page pool: the same free-list
            # order and the same per-request page lists
            assert self._side_free == self._free, \
                "scale-plane free list diverged from the page free list"
            assert self._side_owned == self._owned, \
                "scale-plane ownership diverged from page ownership"

    def stats(self) -> dict:
        return {
            "page_size": self.page_size,
            "capacity": self.capacity,
            "free": self.free_pages,
            "used": self.used_pages,
            "sidecar": self.sidecar,
            "per_request": {rid: len(v) for rid, v in self._owned.items()},
        }
