"""Fixed-size KV page pool: the allocator behind the paged serving cache.

The port of ``distributed_training_tpu/serving/pages.py``, unchanged (host Python): the device half, the pool tensors
and the paged gather, is ``parallel/ring_attention.py``'s ``PagedKV``.

PagedAttention's memory model (vLLM), host-side half: KV memory is a
fixed pool of ``page_size``-token pages and a sequence holds
``ceil(written / page_size)`` of them instead of a contiguous
``max_len`` reservation. Pages are interchangeable (any physical page
serves any logical position via the per-slot page table), so there is
no external fragmentation BY CONSTRUCTION — the free list is the whole
allocation state, and capacity arithmetic is exact.

Physical page ids run ``1..num_pages``; **page 0 is the reserved null
page** the device pool keeps for masked writes (inactive decode lanes,
chunk padding) and unallocated page-table entries. The allocator never
hands it out, so a request's pages can never alias the garbage page.

Admission safety is COMMITMENT-based: seating a request commits its
worst-case page count (``ceil((prompt + max_new_tokens) / page_size)``)
while physical pages still allocate on demand as the write head
advances. A committed page can always be allocated, so an admitted
sequence can never hit pool exhaustion mid-flight — overload queues at
admission (or raises the typed :class:`~distributed_training_tpu_torch.
inference.sampler.CacheBudgetError` at submit when a request could
never fit the pool), it does not corrupt a running batch.

Speculative decoding changes nothing here by design
(``serving/speculative.py``): a verify window's VALID writes stop at
``prompt + len(tokens) - 1 + useful`` where ``useful`` is clamped to
the remaining completion budget minus one — i.e. at most position
``prompt + max_new_tokens - 2``, the same worst-case write the
commitment already covers — and window padding rows write the null
page. A rejected draft suffix never frees pages early either: its
pages stay with the slot (they are inside the commitment) and the next
window overwrites them, so accept-rewind cycles keep
:meth:`PagePool.check_balanced` green (pinned by
``tests/test_speculative.py``).

**Shared pages** (the radix prefix cache, ``serving/prefix_cache.py``):
an allocated page carries a REFERENCE COUNT — the cache's trie holds
one reference on every page it indexes, and every sequence whose block
table aliases a cached prefix page holds another (:meth:`PagePool.
incref` at seat). :meth:`free` releases ONE reference per call; the
page returns to the free list only when the last holder lets go, so a
prefix shared by the trie and three running sequences is freed exactly
once no matter which order they finish in. Reads through aliased
tables are safe by construction (the paged gather is read-only);
writes never land in a shared page because a prefix hit is page-ALIGNED
— the new sequence's first write position sits at or past the aliased
region's end, in a private page of its own. Commitment accounting is
per-holder: a hit request commits only its non-resident tail, so the
``uncommit`` a finishing sequence returns is exactly what IT promised —
shared pages release no commitment twice (pinned by
``tests/test_prefix_cache.py``).
"""

from __future__ import annotations

from distributed_training_tpu_torch.inference.sampler import CacheBudgetError

# Physical page 0: the device pool's garbage page (see module docstring).
NULL_PAGE = 0


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` cache positions (ceil division)."""
    if tokens < 0:
        raise ValueError(f"tokens must be >= 0, got {tokens}")
    return -(-tokens // page_size)


class PagePool:
    """Free-list allocator over ``num_pages`` interchangeable KV pages.

    >>> pool = PagePool(num_pages=8, page_size=16)
    >>> pool.commit(3)           # admission: worst-case reservation
    >>> p = pool.alloc(1)        # on-demand: draws against the commitment
    >>> pool.free(p, uncommit=2) # eviction: pages back + unused commitment

    ``alloc``/``commit`` raise the typed :class:`CacheBudgetError`
    (pages requested vs free) on exhaustion; ``free`` raises on a
    double-free or a foreign page id, so a leak or aliasing bug fails
    loudly at the boundary instead of corrupting a neighbor's KV.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: a just-freed page is reused first, keeping the
        # working set of device pages dense (and reuse deterministic).
        self._free: list[int] = list(range(self.num_pages, 0, -1))
        self._allocated: set[int] = set()
        # page id -> reference count (only for allocated pages; alloc
        # starts at 1, incref adds holders, free releases one — the page
        # returns to the free list at zero). The prefix cache's trie and
        # every sequence aliasing one of its pages each hold one ref.
        self._refs: dict[int, int] = {}
        self.committed = 0  # pages promised to seated requests, unallocated

    # -- views ---------------------------------------------------------------
    @property
    def num_free(self) -> int:
        """Physically free pages (ignores commitments)."""
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    @property
    def available(self) -> int:
        """Pages a NEW request may commit: free minus already-committed."""
        return len(self._free) - self.committed

    def can_commit(self, n: int) -> bool:
        return n <= self.available

    # -- transitions ---------------------------------------------------------
    def commit(self, n: int) -> None:
        """Reserve ``n`` pages worth of future allocations (admission).

        Raises :class:`CacheBudgetError` when the pool cannot promise
        them — the page-aware admission gate.
        """
        if n < 0:
            raise ValueError(f"cannot commit {n} pages")
        if n > self.available:
            raise CacheBudgetError(
                f"KV page pool exhausted: requested {n} page(s) but only "
                f"{max(self.available, 0)} of {self.num_pages} free and "
                f"uncommitted ({self.num_allocated} allocated, "
                f"{self.committed} committed; page_size="
                f"{self.page_size})")
        self.committed += n

    def release(self, n: int) -> None:
        """Return ``n`` unused commitments (early finish / eviction)."""
        if n < 0 or n > self.committed:
            raise ValueError(
                f"cannot release {n} of {self.committed} committed pages")
        self.committed -= n

    def alloc(self, n: int = 1, *, committed: bool = True) -> list[int]:
        """Draw ``n`` physical pages (ids 1..num_pages, never the null
        page). ``committed=True`` (the engine's path) consumes prior
        :meth:`commit` reservations; ``committed=False`` allocates
        against the uncommitted remainder (raw allocator use).

        Raises :class:`CacheBudgetError` on exhaustion — pages requested
        vs free, as the admission error contract specifies.
        """
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        budget = self.committed if committed else self.available
        if n > budget or n > len(self._free):
            raise CacheBudgetError(
                f"KV page pool exhausted: requested {n} page(s) but "
                f"{len(self._free)} of {self.num_pages} free "
                f"({'committed budget ' + str(self.committed) if committed else 'uncommitted'}; "
                f"page_size={self.page_size})")
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        for p in pages:
            self._refs[p] = 1
        if committed:
            self.committed -= n
        return pages

    def incref(self, pages: list[int]) -> None:
        """Add one holder to each of ``pages`` (prefix-cache sharing:
        the trie indexing a page, or a sequence aliasing one into its
        block table). Raises on a page that is not allocated — a ref on
        a free page would resurrect garbage."""
        for p in pages:
            if p not in self._allocated:
                raise ValueError(
                    f"cannot incref page {p}: not allocated (the null "
                    f"page, a freed page, or a foreign id)")
            self._refs[p] += 1

    def refcount(self, page: int) -> int:
        """Current holder count (0 for a free/foreign page)."""
        return self._refs.get(page, 0)

    def free(self, pages: list[int], *, uncommit: int = 0) -> None:
        """Release ONE reference on each of ``pages`` (plus ``uncommit``
        unused commitments — a request that finished early via
        EOS/timeout never allocated its worst case). A page returns to
        the free list only when its last holder releases it; unshared
        pages (refcount 1, the pre-prefix-cache norm) free immediately,
        and releasing a page that holds no reference still raises — a
        double free is a bug whether or not the page was shared."""
        for p in pages:
            if p not in self._allocated:
                raise ValueError(
                    f"page {p} is not allocated (double free, the null "
                    f"page, or a foreign id)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._allocated.discard(p)
                self._free.append(p)
        if uncommit:
            self.release(uncommit)

    def check_balanced(self, cached: "set[int] | None" = None) -> None:
        """Invariant audit: every page is exactly free or allocated and
        nothing is committed — the post-drain steady state. Raises
        ``AssertionError`` with the leak arithmetic otherwise.

        ``cached`` is the prefix cache's held-page set
        (``PrefixCache.pages_held()``): with a trie attached, the drained
        steady state legitimately keeps pages allocated — but then every
        allocated page must be EXACTLY a trie page with EXACTLY one
        reference (the trie's). A page the trie holds that the pool
        thinks is free, a page no one holds that never came back, or a
        stranded sequence reference all fail here. ``cached=None``
        (no prefix cache) additionally demands refcounts degenerate to
        the pre-sharing shape: one holder per allocated page."""
        assert len(self._free) + len(self._allocated) == self.num_pages, (
            f"page leak: {len(self._free)} free + {len(self._allocated)} "
            f"allocated != {self.num_pages} total")
        assert self.committed == 0, (
            f"{self.committed} committed page(s) never released")
        assert not (set(self._free) & self._allocated), "page aliased"
        if cached is not None:
            assert self._allocated == set(cached), (
                f"prefix-cache page drift: pool holds "
                f"{sorted(self._allocated - set(cached))} outside the "
                f"trie; trie claims {sorted(set(cached) - self._allocated)} "
                f"the pool freed")
        stranded = {p: n for p, n in self._refs.items() if n != 1}
        assert not stranded, (
            f"stranded page references at steady state (holder leaked): "
            f"{stranded}")
