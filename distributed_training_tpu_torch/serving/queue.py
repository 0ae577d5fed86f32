"""Thread-safe tiered request queue with admission control and fairness.

The port of ``distributed_training_tpu/serving/queue.py``, unchanged (host Python and numpy).

Producers (CLI readers, the bench load generator, RPC handlers) submit
from any thread; the engine drains from its scheduling loop. The queue
is ONE logical admission structure holding ``num_tiers`` SLO tiers
(priority 0 = highest), each an arrival-ordered deque — FIFO within a
``(tier, tenant)`` pair, weighted-fair across tenants within a tier,
strict tier order across tiers. Preempted sequences requeue into their
tier in arrival (uid) order, so a resumption re-seats ahead of younger
work of its own tier.

Admission applies typed guards at submit time, so a request that can
never be served (or should not be) fails fast in the producer instead of
wedging or bloating the queue:

- **budget** — the request's whole-lifetime KV footprint must be
  servable: ``prompt_len + max_new_tokens`` within the per-slot token
  budget (:func:`~distributed_training_tpu_torch.inference.sampler.
  cache_budget`), and — paged engine — its worst-case page count
  (``ceil(total / kv_page_size)``) within the page pool. Violations
  raise the typed :class:`~distributed_training_tpu_torch.inference.sampler.
  CacheBudgetError` with page-based accounting (pages needed vs the
  pool/table capacity); it would never become admissible, so queueing
  it would wedge its tier's head forever.
- **depth** — an optional ``max_depth`` bounds the queue (all tiers
  summed). The shed is TIER-AWARE: when a higher-tier request arrives
  on a full queue, the NEWEST queued request of the lowest tier below
  it is dropped instead (it surfaces through :meth:`take_shed` as a
  ``shed`` completion), so best-effort work degrades first. Only when
  nothing lower-tier is queued is the incoming request itself shed
  with :class:`~distributed_training_tpu_torch.resilience.errors.
  QueueFullError` (every queued request's TTFT grows with depth — past
  the SLA horizon, rejecting early beats accepting work that is
  already doomed to time out).
- **drain** — :meth:`close` flips admission off for graceful shutdown;
  subsequent submits raise :class:`~distributed_training_tpu_torch.resilience.
  errors.DrainingError` while the engine finishes what it already
  accepted (requeued preempted sequences included — they were admitted
  once and drain() owes them their completion).
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from distributed_training_tpu_torch.inference.sampler import CacheBudgetError
from distributed_training_tpu_torch.resilience.errors import (
    DrainingError,
    QueueFullError,
)
from distributed_training_tpu_torch.serving.request import ActiveSequence, Request


def _request_of(entry):
    """Queue entries are fresh :class:`Request`\\ s or requeued
    :class:`ActiveSequence` resumptions; admission logic reads the
    underlying request either way."""
    return entry.request if isinstance(entry, ActiveSequence) else entry


class RequestQueue:
    """Tiered FIFO of :class:`Request` with typed admission guards.

    ``budget`` is the per-slot KV-cache capacity in tokens; ``submit``
    enforces ``prompt_len + max_new_tokens <= budget``. ``depth_max``
    tracks the high-water queue depth for SLA telemetry; ``shed`` /
    ``drain_rejected`` count the load-shedding and drain rejections
    (``shed_by_tier`` breaks sheds down per SLO tier).
    ``ttft_deadline_ms`` / ``deadline_ms`` stamp every admitted request
    with absolute deadlines (the engine evicts violators with finish
    reason ``timeout`` — or ``preempted_timeout`` for a requeued
    resumption whose clock ran out).

    Fairness state: ``tenant_weights`` (missing tenants weigh 1.0) and
    an accumulated per-tenant service counter starting at zero — each
    seat charges the request's worst-case token footprint / weight, and
    :meth:`next_candidate` always offers the eligible tenant with the
    LEAST accumulated weighted service (deterministic ties: tenant
    name, then uid). A preemption refunds its seat's charge at requeue,
    so an evicted tenant is not billed twice for the same work.
    ``tenant_quota`` caps concurrently seated requests per tenant; a
    quota-blocked tier falls through to the next tier rather than
    idling slots.

    ``trace`` (a TraceSession or None) marks every admission decision on
    the timeline's 'queue' track: arrivals as instants (at the request's
    ARRIVAL time, so queueing spans line up), sheds/drain rejections as
    instants at the rejection.
    """

    def __init__(self, budget: int, default_max_new_tokens: int = 128,
                 max_depth: int | None = None,
                 ttft_deadline_ms: float | None = None,
                 deadline_ms: float | None = None,
                 trace=None, page_size: int | None = None,
                 pool_pages: int | None = None, num_tiers: int = 1,
                 tenant_quota: int | None = None,
                 tenant_weights: dict[str, float] | None = None):
        if budget < 2:
            raise ValueError(f"budget must be >= 2, got {budget}")
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if num_tiers < 1:
            raise ValueError(f"num_tiers must be >= 1, got {num_tiers}")
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1, got {tenant_quota}")
        self.budget = int(budget)
        # Paged-KV admission accounting: when set, the fail-fast check
        # (and its error message) is in pages — a request whose
        # worst-case page count exceeds the POOL can never seat, even
        # if its token count fits the per-slot table.
        self.page_size = page_size
        self.pool_pages = pool_pages
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_depth = max_depth
        self.ttft_deadline_ms = ttft_deadline_ms
        self.deadline_ms = deadline_ms
        self.num_tiers = int(num_tiers)
        self.tenant_quota = tenant_quota
        self.tenant_weights = dict(tenant_weights or {})
        for t, w in self.tenant_weights.items():
            if not w > 0:
                raise ValueError(
                    f"tenant weight must be > 0, got {t!r}: {w}")
        self.trace = trace
        self._lock = threading.Lock()
        self._tiers: list[collections.deque] = [
            collections.deque() for _ in range(self.num_tiers)]
        # Tier-aware shed victims awaiting pickup by the engine (they
        # complete with finish reason "shed"; see take_shed).
        self._shed_out: list = []
        # Weighted-fair service accumulator: tenant -> tokens/weight
        # already seated (deficit-round-robin shape: least weighted
        # service seats next; a preemption refunds its charge).
        self._tenant_service: dict[str, float] = {}
        self._closed = False
        self._next_uid = 0
        self.depth_max = 0
        self.submitted = 0
        self.rejected = 0
        self.shed = 0
        self.shed_by_tier = [0] * self.num_tiers
        self.drain_rejected = 0

    def submit(self, prompt, max_new_tokens: int | None = None,
               arrival_t: float | None = None, priority: int = 0,
               tenant: str = "default",
               deadline_ms: float | None = None,
               trace_id: str | None = None) -> Request:
        """Enqueue one request; returns its admission record.

        Raises :class:`CacheBudgetError` when the request can never fit a
        slot, :class:`QueueFullError` when the bounded queue is full and
        nothing lower-tier can be shed instead, and
        :class:`DrainingError` after :meth:`close`. ``arrival_t``
        defaults to now (perf_counter) — the bench passes its scheduled
        arrival so queueing delay is measured from the intended arrival,
        not from when the host thread got around to the submit call.
        ``deadline_ms`` overrides the configured total deadline for this
        one request (the network front door's per-request deadline
        field); None keeps the engine-wide default. ``trace_id`` is the
        distributed-tracing correlation id propagated by the front door
        (``X-Graft-Trace``); None self-mints ``uid-<uid>`` — either way
        the id is a pure function of the admission order, never the
        wall clock, so two replays mint identical ids.
        """
        tokens = np.ascontiguousarray(np.asarray(prompt).reshape(-1),
                                      dtype=np.int32)
        if tokens.size < 1:
            raise ValueError("empty prompt (need at least one token)")
        prio = int(priority)
        if not 0 <= prio < self.num_tiers:
            raise ValueError(
                f"priority must be in [0, {self.num_tiers - 1}] "
                f"(num_tiers={self.num_tiers}), got {prio}")
        mnt = (self.default_max_new_tokens
               if max_new_tokens is None else int(max_new_tokens))
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        total = tokens.size + mnt
        if self.page_size is not None:
            # Page-based accounting: the request's worst-case footprint
            # in pages vs what a slot's page table (and the pool) can
            # ever hand one sequence.
            from distributed_training_tpu_torch.serving.pages import pages_for

            need = pages_for(total, self.page_size)
            cap = pages_for(self.budget, self.page_size)
            if self.pool_pages is not None:
                cap = min(cap, self.pool_pages)
            # The token budget stays authoritative (write positions must
            # fit the positional table) even when page-count rounding
            # would cover the overflow.
            if need > cap or total > self.budget:
                with self._lock:
                    self.rejected += 1
                raise CacheBudgetError(
                    f"prompt ({tokens.size}) + max_new_tokens ({mnt}) = "
                    f"{total} tokens needs {need} KV page(s) of "
                    f"{self.page_size}, but at most {cap} page(s) and "
                    f"{self.budget} token positions can ever serve one "
                    f"sequence"
                    + (f" ({self.pool_pages}-page pool)"
                       if self.pool_pages is not None else ""))
        elif total > self.budget:
            with self._lock:
                self.rejected += 1
            raise CacheBudgetError(
                f"prompt ({tokens.size}) + max_new_tokens ({mnt}) = "
                f"{total} exceeds the KV cache (max_len={self.budget})")
        arrival = (time.perf_counter()
                   if arrival_t is None else float(arrival_t))
        with self._lock:
            if self._closed:
                self.drain_rejected += 1
                if self.trace is not None:
                    self.trace.instant("request.drain_rejected",
                                       track="queue")
                raise DrainingError(
                    "engine is draining: admission is closed while "
                    "in-flight requests complete; submit to another "
                    "replica or retry after restart")
            if (self.max_depth is not None
                    and self._depth() >= self.max_depth
                    and not self._shed_lower_tier(prio)):
                self.shed += 1
                self.shed_by_tier[prio] += 1
                if self.trace is not None:
                    self.trace.instant("request.shed", track="queue",
                                       depth=self._depth(), tier=prio)
                raise QueueFullError(
                    f"request queue is at max_depth={self.max_depth} "
                    f"with nothing below tier {prio} to shed; "
                    f"shedding load instead of growing the queue (and "
                    f"every queued request's TTFT) without bound")
            req = Request(
                uid=self._next_uid, prompt=tokens, max_new_tokens=mnt,
                arrival_t=arrival,
                trace_id=(str(trace_id) if trace_id is not None
                          else f"uid-{self._next_uid}"),
                ttft_deadline_t=(arrival + self.ttft_deadline_ms / 1e3
                                 if self.ttft_deadline_ms else None),
                deadline_t=(arrival + float(deadline_ms) / 1e3
                            if deadline_ms else
                            arrival + self.deadline_ms / 1e3
                            if self.deadline_ms else None),
                priority=prio, tenant=str(tenant))
            self._next_uid += 1
            self._tiers[prio].append(req)
            self.submitted += 1
            self.depth_max = max(self.depth_max, self._depth())
            if self.trace is not None:
                self.trace.instant("request.arrival", track="queue",
                                   t=arrival, uid=req.uid, tier=prio,
                                   prompt_len=int(tokens.size))
        return req

    # -- internal (callers hold self._lock) ----------------------------------
    def _depth(self) -> int:
        return sum(len(q) for q in self._tiers)

    def _shed_lower_tier(self, prio: int) -> bool:
        """Drop the NEWEST queued entry of the lowest tier strictly
        below ``prio`` (tier-aware shed); True if one was dropped. The
        victim surfaces through :meth:`take_shed` so the engine can
        complete it with finish reason ``shed`` (a requeued resumption
        keeps the tokens it already emitted)."""
        for tier in range(self.num_tiers - 1, prio, -1):
            if self._tiers[tier]:
                victim = self._tiers[tier][-1]
                del self._tiers[tier][-1]
                self._shed_out.append(victim)
                self.shed += 1
                self.shed_by_tier[tier] += 1
                if self.trace is not None:
                    self.trace.instant(
                        "request.shed", track="queue", tier=tier,
                        uid=_request_of(victim).uid, for_tier=prio)
                return True
        return False

    def _weight(self, tenant: str) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    # -- scheduler interface -------------------------------------------------
    def next_candidate(self, tenant_active: dict[str, int] | None = None,
                       prefix_probe=None):
        """The entry the scheduler should try to seat next, or None.

        Tier order is strict: the highest-priority nonempty tier whose
        tenants are not all quota-blocked wins (a quota-saturated tier
        falls through so slots never idle on a fairness cap, but a
        RESOURCE-blocked head never falls through — the scheduler stops
        there, preserving the no-size-skipping anti-starvation rule in
        tier form). Within the tier: the eligible tenant with the least
        accumulated weighted service, then that tenant's oldest entry.
        Single tenant, single tier = the old strict FIFO.

        ``prefix_probe`` (cache-aware seat ordering): an optional
        ``entry -> resident-prefix tokens`` callable (the engine wraps
        a read-only trie probe). Among tenant heads of EQUAL weighted-
        service rank, the head with the larger resident prefix seats
        first — it admits with fewer committed pages and prefills only
        its tail, so under pressure it is the cheapest seat. The probe
        never reorders across fairness ranks or within a tenant's FIFO
        lane, and with no probe (prefix cache off) the key degenerates
        to the old ``(service, tenant, uid)`` ordering bitwise — pinned
        by tests/test_frontend.py.
        """
        active = tenant_active or {}
        with self._lock:
            for tier in self._tiers:
                if not tier:
                    continue
                heads: dict[str, object] = {}  # tenant -> oldest entry
                for entry in tier:
                    ten = _request_of(entry).tenant
                    if ten not in heads:
                        heads[ten] = entry
                if self.tenant_quota is not None:
                    heads = {t: e for t, e in heads.items()
                             if active.get(t, 0) < self.tenant_quota}
                    if not heads:
                        continue  # tier fully quota-blocked: fall through
                best = min(
                    heads.items(),
                    key=lambda te: (self._tenant_service.get(te[0], 0.0)
                                    / self._weight(te[0]),
                                    -prefix_probe(te[1])
                                    if prefix_probe is not None else 0,
                                    te[0], _request_of(te[1]).uid))
                return best[1]
        return None

    def take(self, entry) -> bool:
        """Remove ``entry`` (a :meth:`next_candidate` result) and charge
        its tenant's weighted-fair service with the request's worst-case
        token footprint. Returns False — nothing removed, nothing
        charged — when the entry is already gone: a producer-side
        tier-aware shed can race the scheduler between
        :meth:`next_candidate` and here (both are separate lock
        sections), and the scheduler simply re-polls."""
        req = _request_of(entry)
        with self._lock:
            try:
                self._tiers[req.priority].remove(entry)
            except ValueError:
                return False  # concurrently shed by a producer thread
            cost = (req.prompt.size + req.max_new_tokens) \
                / self._weight(req.tenant)
            self._tenant_service[req.tenant] = \
                self._tenant_service.get(req.tenant, 0.0) + cost
            return True

    def requeue(self, seq: ActiveSequence) -> None:
        """Return a preempted sequence to its tier, in arrival (uid)
        order — it re-seats ahead of younger same-tier work. The seat
        that is being undone refunds its weighted-fair service charge
        (the re-seat will charge it again), and the requeue bypasses
        ``max_depth``: the request was already admitted once, and
        dropping it here would break the lossless-preemption contract.
        """
        req = seq.request
        with self._lock:
            tier = self._tiers[req.priority]
            idx = len(tier)
            for i, entry in enumerate(tier):
                if _request_of(entry).uid > req.uid:
                    idx = i
                    break
            tier.insert(idx, seq)
            cost = (req.prompt.size + req.max_new_tokens) \
                / self._weight(req.tenant)
            if req.tenant in self._tenant_service:
                self._tenant_service[req.tenant] -= cost
            self.depth_max = max(self.depth_max, self._depth())

    def restore(self, entry) -> None:
        """Re-admit a journal-recovered entry (crash-restart path,
        serving/journal.py) with its ORIGINAL uid — the RNG stream is
        ``fold_in(seed, uid)``, so uid continuity is what makes the
        recovered output bitwise. Bypasses every admission guard (the
        request was accepted once; dropping it now would break the
        recovery contract) exactly like :meth:`requeue` does for
        preemptions. Callers restore in uid order, so FIFO-within-tier
        is preserved by construction."""
        req = _request_of(entry)
        if not 0 <= req.priority < self.num_tiers:
            raise ValueError(
                f"recovered request uid={req.uid} carries tier "
                f"{req.priority}, but this engine serves only "
                f"{self.num_tiers} tier(s) — restart with the journal "
                f"writer's num_tiers")
        with self._lock:
            self._tiers[req.priority].append(entry)
            self._next_uid = max(self._next_uid, req.uid + 1)
            self.depth_max = max(self.depth_max, self._depth())

    def withdraw(self, req: Request) -> bool:
        """Remove a just-submitted request whose DURABLE admission
        failed (the journal's sync write raised): the engine's
        acceptance contract is journal-backed, so a request the journal
        never recorded must not stay queued while its submitter sees an
        exception — it would decode anyway and duplicate the retry.
        No fairness charge (it was never seated); True if removed."""
        with self._lock:
            tier = self._tiers[req.priority]
            for entry in tier:
                if _request_of(entry).uid == req.uid:
                    tier.remove(entry)
                    return True
        return False

    def find_uid(self, uid: int):
        """Read-only lookup of a queued entry by uid across all tiers
        (the stream re-attach path); None when not queued."""
        with self._lock:
            for tier in self._tiers:
                for entry in tier:
                    if _request_of(entry).uid == uid:
                        return entry
        return None

    def remove_uid(self, uid: int):
        """Remove a queued entry by uid across ALL tiers (the
        client-disconnect cancellation path: the frontend only knows
        the uid, not the tier) and return it — a fresh ``Request`` or a
        preempted ``ActiveSequence`` — or None when the uid is not
        queued (already seated, finished, or never admitted). No
        fairness charge: a cancelled request consumed no seat."""
        with self._lock:
            for tier in self._tiers:
                for entry in tier:
                    if _request_of(entry).uid == uid:
                        tier.remove(entry)
                        return entry
        return None

    def reserve_uids(self, next_uid: int) -> None:
        """Advance the uid sequence past everything the journal ever
        assigned (dropped/compacted entries included): a fresh submit
        must never reuse a journaled uid, or two different requests
        would share one RNG stream and one delivery cursor."""
        with self._lock:
            self._next_uid = max(self._next_uid, int(next_uid))

    def take_shed(self) -> list:
        """Drain the tier-aware shed victims (entries dropped from the
        queue to admit higher-tier work); the engine completes each with
        finish reason ``shed``."""
        with self._lock:
            out, self._shed_out = self._shed_out, []
        return out

    @property
    def has_shed_pending(self) -> bool:
        with self._lock:
            return bool(self._shed_out)

    def close(self) -> None:
        """Close admission (idempotent): the graceful-drain gate. Queued
        and slotted requests continue to completion; new submits raise
        the typed :class:`DrainingError`."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def reopen(self) -> None:
        """Reopen admission after a completed drain (idempotent) — the
        rolling-deploy path (serving/router.py): a replica drains,
        applies its staged weight swap at the empty-engine boundary,
        and reopens for traffic with the new epoch. Counters, the uid
        sequence, and tenant fairness state all carry across — the
        reopened queue is the same queue, not a restart."""
        with self._lock:
            self._closed = False

    def reset_counters(self) -> None:
        """Zero the telemetry counters (depth high-water, submitted,
        rejected, shed, drain_rejected) without touching queued requests
        or the uid sequence — the engine calls this from ``reset_stats``
        so a compile warm-up pass doesn't contaminate the measured SLA
        window."""
        with self._lock:
            self.depth_max = self._depth()
            self.submitted = 0
            self.rejected = 0
            self.shed = 0
            self.shed_by_tier = [0] * self.num_tiers
            self.drain_rejected = 0

    def pop(self):
        """Oldest entry of the highest-priority nonempty tier, or None
        when empty (never blocks — the engine polls at iteration
        boundaries, it does not park a thread)."""
        with self._lock:
            for tier in self._tiers:
                if tier:
                    return tier.popleft()
        return None

    def peek(self):
        """The effective queue head without popping it — the page-aware
        admission gate inspects the head's footprint before committing
        pool pages."""
        with self._lock:
            for tier in self._tiers:
                if tier:
                    return tier[0]
        return None

    def pop_expired(self, now: float) -> list:
        """Remove and return every queued entry already past its TTFT
        or total deadline — they will never make their SLA, so they must
        not consume a prefill. The engine completes fresh requests with
        finish reason ``timeout`` and requeued resumptions with
        ``preempted_timeout`` (their clock ran while they waited for a
        re-seat)."""
        expired: list = []
        with self._lock:
            for t, tier in enumerate(self._tiers):
                dead = []
                for entry in tier:
                    req = _request_of(entry)
                    # A resumption that already emitted its first token
                    # is only bound by the TOTAL deadline (TTFT was met
                    # before the preemption).
                    has_first = (isinstance(entry, ActiveSequence)
                                 and entry.first_token_t is not None)
                    if ((req.ttft_deadline_t is not None and not has_first
                         and now >= req.ttft_deadline_t)
                            or (req.deadline_t is not None
                                and now >= req.deadline_t)):
                        dead.append(entry)
                if dead:
                    ids = set(id(e) for e in dead)
                    self._tiers[t] = collections.deque(
                        e for e in tier if id(e) not in ids)
                    expired.extend(dead)
        return expired

    def __len__(self) -> int:
        with self._lock:
            return self._depth()
