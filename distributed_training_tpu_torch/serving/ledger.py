"""Per-request latency ledger: conserved millisecond attribution.

The port of ``distributed_training_tpu/serving/ledger.py``, unchanged (host Python): the engine, the requests and the
telemetry of both packages bill the same causes.

Engine-global sums (``admission_blocked_s``, ``swap_blocked_s``,
``spec_rollback_s`` in ``serving/metrics.py``) answer "how much wall
time did cause X cost *this engine*" — they cannot answer "where did
*this request's* p99 go". The ledger closes that gap: every request
carries an append-only list of ``(cause, start, end)`` intervals,
stamped host-side (``perf_counter`` arithmetic only — no device read,
no extra sync; the stamps ride measurement points the engine already
pays for), whose causes **partition** the request's wall lifetime.

The partition is built by a telescoping cursor: the ledger opens at the
request's arrival and every stamp closes the span ``[cursor, t]`` under
one cause, advancing the cursor to ``t``. Contiguous same-cause stamps
coalesce, so a 32-token decode is ONE ``decode`` interval, not 32.
Induction: the cursor starts at ``arrival_t``; every engine touch point
(seat, chunk boundary, decode iteration, spec rollback, preemption,
swap barrier, recovery replay, finish) stamps exactly once — so at any
boundary ``sum(intervals) == cursor − arrival_t`` and, once the finish
stamp lands, the intervals tile ``[arrival_t, finish_t]`` exactly.

**Conservation invariant** (checked per finished request by
:meth:`LatencyLedger.violations`, counted by ``ServeTelemetry`` as
``ledger_conservation_violations``, zero-tolerance CI-gated):

- the ledger is closed and ``|Σ(end − start) − (finish_t − arrival_t)|
  ≤ EPSILON_S`` — a missed terminal stamp, a cursor reset, or a
  recovery wall-anchor mismatch all surface here;
- the first-token instant is a stamp boundary and nothing before it is
  attributed to ``decode`` — which is the sub-invariant
  ``queue_wait + prefill == TTFT`` (plus ``journal_admit`` when a
  journal is attached, plus ``swap_barrier`` when a barrier landed
  mid-prefill) restated so it holds under every composition. The check
  is skipped for recovered requests (the dead process's detail is
  gone) — total conservation still applies to them.

``EPSILON_S`` covers float summation only: ``perf_counter`` values are
~1e5 s, so each ``end − start`` carries ~1e-11 s of cancellation error;
a few hundred intervals stay orders of magnitude under 1 µs.

**Cause taxonomy** (docs/OBSERVABILITY.md "Latency ledger"):

===============  =========================================================
cause            wall span billed to it
===============  =========================================================
journal_admit    arrival → durable admission write returns (journal only)
queue_wait       waiting for the FIRST seat
prefill          seat → first token (chunk-lane waits included)
decode           decode iterations (the spec verify window IS decode)
spec_rollback    host accept/rewind bookkeeping after a verify window
preempt_requeue  preemption (or recovery restore) → the re-seat
recompute        re-prefilling a carried prefix after preempt/recovery
swap_barrier     a hot-swap barrier pausing this in-flight request
pre_crash        arrival → last durable token of the process that died
recovery         crash downtime + journal replay (wall-anchored)
cancelled        last stamp → the cancel eviction (client hung up)
===============  =========================================================

The ledger also counts **tokens per cause** (``TOKEN_CAUSES``): cache
positions written by fresh prefill (``prefill``), emitted tokens
(``decode``), re-prefilled positions (``recompute`` — the per-request
twin of ``preempted_token_recompute``/``tokens_recomputed_on_recovery``)
and the per-request draft economics (``spec_draft``/``spec_accept``).
These are pure functions of each request's own token stream and the
deterministic schedule, so the bench gate holds their engine totals
(``ledger_tokens_*``) bitwise zero-drift.
"""

from __future__ import annotations

import json
from typing import Any

CAUSE_JOURNAL_ADMIT = "journal_admit"
CAUSE_QUEUE_WAIT = "queue_wait"
CAUSE_PREFILL = "prefill"
CAUSE_DECODE = "decode"
CAUSE_SPEC_ROLLBACK = "spec_rollback"
CAUSE_PREEMPT_REQUEUE = "preempt_requeue"
CAUSE_RECOMPUTE = "recompute"
CAUSE_SWAP_BARRIER = "swap_barrier"
CAUSE_PRE_CRASH = "pre_crash"
CAUSE_RECOVERY = "recovery"
# Client-disconnect cancellation: the tail span between the request's
# last ordinary stamp and the engine's cancel eviction. A terminal
# cause like ``timeout`` — conservation still tiles the full lifetime.
CAUSE_CANCELLED = "cancelled"

# Every wall cause, in lifecycle order — the fixed key set telemetry
# exports (``ledger_<cause>_ms_total`` always present, 0.0 when unused).
LEDGER_CAUSES = (
    CAUSE_JOURNAL_ADMIT, CAUSE_QUEUE_WAIT, CAUSE_PREFILL, CAUSE_DECODE,
    CAUSE_SPEC_ROLLBACK, CAUSE_PREEMPT_REQUEUE, CAUSE_RECOMPUTE,
    CAUSE_SWAP_BARRIER, CAUSE_PRE_CRASH, CAUSE_RECOVERY, CAUSE_CANCELLED,
)

CAUSE_SPEC_DRAFT = "spec_draft"
CAUSE_SPEC_ACCEPT = "spec_accept"
# Prefix-cache reuse (serving/prefix_cache.py): cache positions a seat
# found already RESIDENT in the paged pool and aliased instead of
# prefilling. A token cause only — reused positions cost no wall time
# by construction (they are skipped, not computed), which is exactly
# how "reused-prefix time bills nothing to prefill" holds: the prefill
# token counter covers only the tail the sequence actually wrote.
CAUSE_PREFIX_HIT = "prefix_hit"

# Deterministic token-count keys (``ledger_tokens_<cause>``).
TOKEN_CAUSES = (CAUSE_PREFILL, CAUSE_DECODE, CAUSE_RECOMPUTE,
                CAUSE_SPEC_DRAFT, CAUSE_SPEC_ACCEPT, CAUSE_PREFIX_HIT)

# -- fleet ledger (router front door) ----------------------------------------
# The router stamps its OWN conserved interval list per proxied request
# on the same telescoping-cursor machinery: ``route`` (probe fan-out +
# candidate ordering), ``relay`` (bytes on the wire, which CONTAINS the
# replica's whole lifetime), ``retry_backoff`` (the empty-rotation
# poll), and ``failover_resume`` (upstream death → resumed relay
# start). The cross-hop audit then joins the replica's ledger causes
# returned in the SSE ``done`` frame: router intervals must tile the
# client wall time exactly (EPSILON_S, as ever), and the replica's
# reported lifetime must fit inside the relay span(s) up to
# FLEET_SKEW_SLACK_MS — both clocks are per-process perf_counter
# DURATIONS (rate-skew-free on one host), so the slack covers only
# scheduling between the door's connect and the replica's admission
# stamp, not calendar-clock drift.
CAUSE_ROUTE = "route"
CAUSE_RELAY = "relay"
CAUSE_RETRY_BACKOFF = "retry_backoff"
CAUSE_FAILOVER_RESUME = "failover_resume"
FLEET_CAUSES = (CAUSE_ROUTE, CAUSE_RELAY, CAUSE_RETRY_BACKOFF,
                CAUSE_FAILOVER_RESUME)
FLEET_SKEW_SLACK_MS = 50.0

# Conservation tolerance in seconds (see module docstring: float
# summation error only — the stamps themselves telescope exactly).
EPSILON_S = 1e-6

# Causes that may legitimately precede the first token; a ``decode``
# interval before it is a mis-binned stamp and fails the TTFT check.
_PRE_TTFT_CAUSES = frozenset(LEDGER_CAUSES) - {CAUSE_DECODE,
                                               CAUSE_SPEC_ROLLBACK}


class LatencyLedger:
    """One request's append-only ``(cause, start, end)`` interval list.

    Pure host-side Python (floats, lists, dicts — deliberately no numpy:
    the stamps run inside the engine's hot iteration tail). The
    interval list has exactly ONE mutating thread — the engine loop:
    a request becomes seatable the moment the queue enqueues it (before
    a journal-backed ``submit`` even returns), so the producer thread
    never touches ``intervals``; its only write is the
    :meth:`note_admit_done` attribute store, which the engine
    materializes at its next :meth:`stamp`.
    """

    __slots__ = ("origin", "cursor", "intervals", "tokens", "finish_t",
                 "_admit_done_t")

    def __init__(self, origin: float):
        self.origin = float(origin)
        self.cursor = self.origin
        # [cause, start, end] lists (mutable for coalescing).
        self.intervals: list[list] = []
        self.tokens: dict[str, int] = {}
        self.finish_t: float | None = None
        self._admit_done_t: float | None = None

    # -- stamping ------------------------------------------------------------
    def note_admit_done(self, t: float) -> None:
        """Producer-thread handoff for the ``journal_admit`` span: the
        durable admission write finished at ``t``. A single attribute
        store (atomic under the GIL) — NO interval mutation happens
        here, because the request became visible to the engine thread
        at enqueue, BEFORE the journal write returned, and two threads
        must never touch ``intervals``. The engine thread materializes
        the interval at its next :meth:`stamp`; if the engine raced
        ahead (seated the request mid-fsync), the span clamps away and
        only the attribution detail is lost, never conservation."""
        self._admit_done_t = float(t)

    def stamp(self, cause: str, t: float) -> None:
        """Close the open span ``[cursor, t]`` under ``cause`` and
        advance the cursor. ``t`` earlier than the cursor clamps to it
        (a zero-width interval; clock glitches and same-instant double
        stamps must not make time run backwards), and a zero-width
        stamp of a NEW cause is dropped entirely — it would carry no
        time and only bloat the list."""
        t = float(t)
        at = self._admit_done_t
        if at is not None:
            # Materialize the producer-recorded admission span first
            # (engine thread — the ledger's only interval mutator).
            # Only as the FIRST interval: the taxonomy defines the span
            # as arrival → admit-done, so if the engine raced ahead
            # (some other span already stamped before the fsync
            # returned), the admission span clamps away entirely —
            # attribution detail lost, never a mislabeled in-slot span.
            self._admit_done_t = None
            at = min(at, t)
            if not self.intervals and at > self.cursor:
                self.intervals.append(
                    [CAUSE_JOURNAL_ADMIT, self.cursor, at])
                self.cursor = at
        if t < self.cursor:
            t = self.cursor
        last = self.intervals[-1] if self.intervals else None
        if last is not None and last[0] == cause and last[2] == self.cursor:
            last[2] = t
        elif t > self.cursor:
            self.intervals.append([cause, self.cursor, t])
        else:
            return  # zero-width new cause: nothing to record
        self.cursor = t

    def add_tokens(self, cause: str, n: int) -> None:
        """Attribute ``n`` token units (cache positions written, tokens
        emitted, drafts proposed/accepted) to ``cause``."""
        if n:
            self.tokens[cause] = self.tokens.get(cause, 0) + int(n)

    def close(self, cause: str, t: float | None = None) -> None:
        """Terminal stamp: bill the tail span to ``cause`` (``t=None``
        closes at the cursor — the finish coincides with the last
        stamp) and freeze the lifetime end. Idempotent."""
        if self.finish_t is not None:
            return
        if t is not None:
            self.stamp(cause, t)
        self.finish_t = self.cursor

    def seal(self, cause: str, t: float | None = None) -> None:
        """``close()`` under a collision-free name for HANDLER call
        graphs: the router front door seals its per-request fleet
        ledger from the ``do_POST`` proxy thread, and graftlint
        resolves a bare-name ``.close()`` from a handler root against
        every ``close`` in the repo — the metrics exporter's shutdown
        included, which really does flush incident bundles. The
        handler-reachable spelling resolves only here."""
        self.close(cause, t)

    @property
    def closed(self) -> bool:
        return self.finish_t is not None

    # -- derived -------------------------------------------------------------
    def total_s(self, cause: str) -> float:
        return sum(iv[2] - iv[1] for iv in self.intervals
                   if iv[0] == cause)

    def totals_ms(self) -> dict[str, float]:
        """cause → milliseconds, for causes that actually appeared."""
        out: dict[str, float] = {}
        for cause, t0, t1 in self.intervals:
            out[cause] = out.get(cause, 0.0) + (t1 - t0) * 1e3
        return out

    @property
    def lifetime_ms(self) -> float:
        end = self.cursor if self.finish_t is None else self.finish_t
        return (end - self.origin) * 1e3

    # -- the invariant -------------------------------------------------------
    def violations(self, ttft_ms: float | None = None) -> list[str]:
        """Conservation audit; empty list = conserved. ``ttft_ms`` (the
        independently measured ``first_token_t − arrival_t``) enables
        the TTFT sub-invariant; recovered requests skip it (pre-crash
        detail died with the old process) but never the total."""
        out: list[str] = []
        if self.finish_t is None:
            return ["ledger never closed (no terminal stamp)"]
        span = self.finish_t - self.origin
        total = sum(iv[2] - iv[1] for iv in self.intervals)
        err = abs(total - span)
        if err > EPSILON_S:
            out.append(
                f"sum(intervals) {total:.9f}s != lifetime {span:.9f}s "
                f"(|err| {err:.3e}s > {EPSILON_S:.0e}s)")
        if ttft_ms is not None and not any(
                iv[0] in (CAUSE_PRE_CRASH, CAUSE_RECOVERY)
                for iv in self.intervals):
            first_t = self.origin + ttft_ms / 1e3
            if not any(abs(iv[2] - first_t) <= EPSILON_S
                       for iv in self.intervals):
                out.append(
                    f"first token at +{ttft_ms:.3f}ms is not a stamp "
                    f"boundary (queue_wait + prefill == TTFT broken)")
            for cause, t0, t1 in self.intervals:
                if t1 <= first_t - EPSILON_S and \
                        cause not in _PRE_TTFT_CAUSES:
                    out.append(
                        f"{cause!r} interval ends at "
                        f"+{(t1 - self.origin) * 1e3:.3f}ms, before the "
                        f"first token at +{ttft_ms:.3f}ms")
                    break
        return out

    # -- export --------------------------------------------------------------
    def to_dict(self, ttft_ms: float | None = None) -> dict[str, Any]:
        """Strict-JSON shape (one row of :func:`dump_ledgers`): interval
        endpoints in ms relative to arrival, per-cause totals, token
        counts, and the conservation verdict. Pass the request's
        measured ``ttft_ms`` so the verdict includes the TTFT
        sub-invariant — the same audit ``ServeTelemetry`` counts."""
        violations = self.violations(ttft_ms=ttft_ms)
        return {
            "lifetime_ms": self.lifetime_ms,
            "conserved": not violations,
            "violations": violations,
            "intervals": [
                {"cause": cause,
                 "start_ms": (t0 - self.origin) * 1e3,
                 "end_ms": (t1 - self.origin) * 1e3}
                for cause, t0, t1 in self.intervals],
            "totals_ms": self.totals_ms(),
            "tokens": dict(self.tokens),
        }


def dump_ledgers(path: str, completions) -> tuple[int, int]:
    """Write every delivered completion's latency ledger to ``path`` as
    one strict-JSON list (the ``--ledger-out`` file both serving CLIs
    share): ``[{uid, reason, ledger: to_dict() | null}, ...]`` sorted
    by uid. Results redelivered verbatim from the journal carry
    ``ledger: null`` — their wall detail belongs to the process that
    served them. Returns ``(rows_written, conservation_violations)``.
    """
    rows = []
    bad = 0
    for fin in sorted(completions, key=lambda f: f.uid):
        led = fin.ledger
        row = None
        if led is not None:
            row = led.to_dict(ttft_ms=fin.ttft_ms)
            bad += 0 if row["conserved"] else 1
        rows.append({"uid": int(fin.uid), "reason": fin.finish_reason,
                     "ledger": row})
    with open(path, "w") as fh:
        json.dump(rows, fh, allow_nan=False)
    return len(rows), bad
