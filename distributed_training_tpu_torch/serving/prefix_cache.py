"""Radix-tree prefix cache: cross-request KV reuse over the paged pool.

The port of ``distributed_training_tpu/serving/prefix_cache.py``,
unchanged (host Python).

Production traffic is dominated by shared boilerplate — system prompts,
few-shot preambles, multi-turn histories — yet without this module every
request re-prefills its full prompt even when another request just
computed identical KV pages. This is the SGLang RadixAttention / vLLM
automatic-prefix-caching shape restated for this repo's page pool
(``serving/pages.py``): committed page chains become a content-addressed
trie, and a new request whose prompt starts with a resident chain seats
with that prefix already in the pool — it aliases the physical pages
into its block table and prefills only the tail.

**Keying.** The trie is indexed at page granularity: one edge per
``page_size``-token chunk of the token stream, keyed by those tokens'
bytes. A node's PATH from the root therefore encodes the full token
prefix — the "hash chain" — and because K/V at position ``i`` is a pure
function of tokens ``0..i`` (causal attention, deterministic kernels,
fixed weights), two sequences that share a page-aligned token prefix
share the page CONTENTS bitwise. Exact-token keys (not hashes of them)
mean a collision can never alias the wrong KV.

**Copy-on-write, degenerately.** Aliasing is restricted to FULL pages
of the matched prefix, so the first divergent page — and any trailing
partial page — is simply re-prefilled into a private page of the new
sequence ("copy" by recompute at page granularity). Writes can then
never land in a shared page: the hit is page-aligned, so the tail
prefill's first write position sits at or past the aliased region, in
the sequence's own pages. No device-side COW machinery exists because
none is needed — the block-table indirection IS the aliasing, and the
write-head discipline IS the write barrier.

**Ownership and refcounts.** The trie holds one :meth:`PagePool.incref`
reference on every page it indexes; every sequence aliasing a cached
page holds another. A finishing sequence's full written pages are
*adopted* into the trie (its reference becomes the trie's — prompt AND
generated tokens, so multi-turn follow-ups hit), and everything else
releases one reference; pages return to the free list only when the
last holder lets go. :meth:`PagePool.check_balanced` audits the drained
steady state: allocated pages == trie pages, one reference each.

**Eviction.** Two pressures reclaim trie pages, both deterministic
(recency is a monotone operation counter, never a wall clock — the
graftlint determinism rule applies here too):

- ``max_pages`` (the ``--prefix-cache-pages`` cap): inserting past the
  cap first evicts least-recently-used *unreferenced leaves* (a parent
  is only evictable once its children are gone — evicting mid-chain
  would orphan descendants the matcher could no longer reach);
- pool pressure (:meth:`evict_until`): when admission cannot commit a
  candidate's tail, the engine reclaims unreferenced trie pages —
  oldest first, the candidate's own matched chain pinned — until the
  commitment fits. A page some sequence still aliases (refcount > 1)
  is never evicted.

**Swap flush.** KV computed under one set of weights must never seed a
request served under another: the hot-swap barrier calls :meth:`flush`
(drop every trie reference; in-flight sequences keep theirs) and the
engine's epoch stamp keeps old-epoch sequences from re-inserting their
pages at finish (``serving/engine.py``).

The cache is performance-only by construction: a hit changes WHICH
pages a block table points at and how much prefill work runs, never a
single gathered value or sampled token — a cache-hit request is bitwise
equal to the same request served cold (pinned across greedy/sampled ×
spec 0/2 by ``tests/test_torch_prefix_cache.py``).
"""

from __future__ import annotations

import numpy as np

from distributed_training_tpu_torch.serving.pages import PagePool


class _Node:
    """One trie edge: ``page_size`` tokens -> one physical page."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: bytes, page: int, parent, tick: int):
        self.key = key
        self.page = int(page)
        self.children: dict[bytes, _Node] = {}
        self.parent = parent
        self.last_used = tick


class PrefixCache:
    """Content-addressed radix index over committed KV page chains.

    >>> cache = PrefixCache(page_size=8)
    >>> cache.insert_chain(tokens, pages, pool)  # finishing seq
    >>> pages = cache.claim(prompt, pool, max_tokens=prompt.size - 1)
    >>> cache.evict_until(pool, need_pages)   # admission pressure

    All state is host-side Python; no device value, no clock reads
    (recency is a deterministic operation counter), no numpy on
    computed device values — safe to call from ``Engine.step``'s
    admission pass under the graftlint hot-path rules.
    """

    def __init__(self, page_size: int, max_pages: int | None = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_pages is not None and max_pages < 1:
            raise ValueError(
                f"max_pages must be >= 1 (or None), got {max_pages}")
        self.page_size = int(page_size)
        self.max_pages = max_pages
        self._children: dict[bytes, _Node] = {}  # root's children
        # Incrementally maintained page index: membership answers
        # "does the trie hold this page" in O(1) (the scheduler's
        # futility bound asks per victim page).
        self._pages: set[int] = set()
        # Deterministic recency clock: bumped once per trie operation.
        self._tick = 0

    # -- views ---------------------------------------------------------------
    @property
    def num_pages(self) -> int:
        """Pages the trie currently indexes (== references it holds)."""
        return len(self._pages)

    def holds(self, page: int) -> bool:
        """Whether the trie holds a reference on ``page`` (O(1))."""
        return page in self._pages

    def pages_held(self) -> set[int]:
        """Every physical page the trie holds a reference on — the
        ``cached`` argument of :meth:`PagePool.check_balanced`."""
        return set(self._pages)

    # -- matching ------------------------------------------------------------
    def _chain(self, tokens: np.ndarray, max_tokens: int) -> list[_Node]:
        """Longest resident page-aligned chain for ``tokens``, capped at
        ``max_tokens`` positions (the engine passes ``prompt - 1`` for a
        fresh request so at least one position always prefills — the
        first-token logits must be computed, not remembered)."""
        toks = np.ascontiguousarray(
            # graftlint: disable=hot-path-transfer -- host token ids by contract: prompts and emitted tokens are host numpy/ints (note_token casts at landing); no device value reaches the trie
            np.asarray(tokens).reshape(-1), dtype=np.int32)
        ps = self.page_size
        limit = min(toks.size, max(int(max_tokens), 0)) // ps
        chain: list[_Node] = []
        children = self._children
        for i in range(limit):
            node = children.get(toks[i * ps:(i + 1) * ps].tobytes())
            if node is None:
                break
            chain.append(node)
            children = node.children
        return chain

    def probe(self, tokens, *, max_tokens: int) -> list[int]:
        """The longest resident prefix's page ids (read-only; no
        refcount or recency effect) — the admission gate's sizing probe
        and the pin set pressure eviction must not reclaim."""
        return [node.page for node in self._chain(tokens, max_tokens)]

    def claim(self, tokens, pool: PagePool, *,
                max_tokens: int) -> list[int]:
        """Claim the longest resident prefix for a seating sequence:
        one reference per matched page, recency touched along the whole
        chain (a hot prefix's interior never ages out under its
        leaves). Returns the physical page ids in logical order — the
        caller aliases them into the sequence's block table."""
        chain = self._chain(tokens, max_tokens)
        self._tick += 1
        for node in chain:
            node.last_used = self._tick
        pages = [node.page for node in chain]
        pool.incref(pages)
        return pages

    # -- insertion -----------------------------------------------------------
    def insert_chain(self, tokens, pages: list[int],
               pool: PagePool) -> tuple[set[int], int]:
        """Index a finishing (or preempted) sequence's written chain.

        ``tokens`` is the written token stream (every cache position the
        sequence actually holds K/V for) and ``pages`` its logical page
        list — aliased prefix pages first, private pages after, exactly
        the engine's per-slot table. Full pages only (a trailing partial
        page is never indexed — its future content is not yet a pure
        function of these tokens).

        Returns ``(adopted, evicted)``: the set of pages ADOPTED —
        private pages whose reference the trie took over (the caller
        must NOT free those) — and how many resident pages LRU-evicted
        to make room under ``max_pages`` (the chain being inserted is
        pinned; when nothing is evictable the remaining tail is simply
        not indexed). Pages whose chain position is already resident
        are duplicates — the trie keeps its existing page (other
        sequences may alias it) and the caller's copy frees normally.
        """
        toks = np.ascontiguousarray(
            # graftlint: disable=hot-path-transfer -- host token ids by contract: the written stream is prompt + emitted host ints; no device value reaches the trie
            np.asarray(tokens).reshape(-1), dtype=np.int32)
        ps = self.page_size
        n_full = toks.size // ps
        self._tick += 1
        adopted: set[int] = set()
        evicted = 0
        children = self._children
        parent: _Node | None = None
        path: set[int] = set()
        # Cap eviction is batched like evict_until: collect the
        # evictable-leaf list once and pop from it, re-validating each
        # candidate (a popped node may since have gained a child from
        # THIS insertion or joined its pinned path). The batch refreshes
        # only after it drains AND an eviction happened since the last
        # collection — an eviction can expose a parent as a new leaf,
        # nothing else can — so a K-page insert at cap amortizes to
        # O(trie) per BATCH of evictions, not per page, and the
        # progress gate guarantees termination.
        cap_batch: list[_Node] | None = None
        cap_idx = 0
        since_refresh = 0

        def evict_one() -> bool:
            nonlocal cap_batch, cap_idx, since_refresh, evicted
            while True:
                if cap_batch is not None:
                    while cap_idx < len(cap_batch):
                        node = cap_batch[cap_idx]
                        cap_idx += 1
                        if (not node.children
                                and node.page in self._pages
                                and node.page not in path
                                and pool.refcount(node.page) == 1):
                            self._remove(node, pool)
                            evicted += 1
                            since_refresh += 1
                            return True
                    if since_refresh == 0:
                        return False  # a refresh could find nothing new
                cap_batch = self._evictable_leaves(pool, path)
                cap_idx = 0
                since_refresh = 0
                if not cap_batch:
                    return False

        for i in range(min(n_full, len(pages))):
            key = toks[i * ps:(i + 1) * ps].tobytes()
            node = children.get(key)
            if node is None:
                if (self.max_pages is not None
                        and len(self._pages) >= self.max_pages
                        and not evict_one()):
                    break  # cap hit, nothing evictable: stop indexing
                node = _Node(key, pages[i], parent, self._tick)
                children[key] = node
                self._pages.add(node.page)
                adopted.add(node.page)
            else:
                node.last_used = self._tick
            path.add(node.page)
            parent = node
            children = node.children
        return adopted, evicted

    # -- eviction ------------------------------------------------------------
    def _evictable_leaves(self, pool: PagePool,
                          pinned: set[int]) -> "list[_Node]":
        """Every currently UNREFERENCED leaf (no children, no sequence
        aliasing its page, not pinned), least-recently-used first. One
        O(trie) walk collects the whole batch — eviction then pops from
        it instead of re-walking per page."""
        out: list[_Node] = []
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
                continue
            if node.page in pinned or pool.refcount(node.page) != 1:
                continue
            out.append(node)
        out.sort(key=lambda n: n.last_used)
        return out

    def _remove(self, node: _Node, pool: PagePool) -> None:
        siblings = (self._children if node.parent is None
                    else node.parent.children)
        del siblings[node.key]
        self._pages.discard(node.page)
        pool.free([node.page])

    def evict_until(self, pool: PagePool, need: int,
                    pinned: set[int] | None = None) -> int:
        """Pool-pressure reclamation: free LRU unreferenced trie pages
        until the pool could commit ``need`` more pages (or nothing
        evictable remains). ``pinned`` protects the candidate's own
        matched chain — evicting the pages a hit is about to alias
        would trade the hit for the headroom. Returns pages evicted.

        Batched: each round collects ALL evictable leaves in one trie
        walk and drains them LRU-first (siblings stay valid as their
        neighbors go — only a PARENT becoming a leaf needs the next
        round), so reclaiming E pages costs O(depth × trie), not
        O(E × trie), inside the admission pass."""
        pinned = pinned or set()
        evicted = 0
        while pool.available < need:
            batch = self._evictable_leaves(pool, pinned)
            if not batch:
                break
            for node in batch:
                if pool.available >= need:
                    break
                self._remove(node, pool)
                evicted += 1
        return evicted

    def flush(self, pool: PagePool) -> int:
        """Drop every trie reference (the hot-swap barrier: KV computed
        under the old weights must never seed a new-epoch request).
        Pages still aliased by in-flight sequences stay allocated under
        their remaining references; the rest return to the free list.
        Returns the number of pages released from the index."""
        pages = []
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            pages.append(node.page)
            stack.extend(node.children.values())
        pool.free(pages)
        self._children = {}
        self._pages.clear()
        return len(pages)
