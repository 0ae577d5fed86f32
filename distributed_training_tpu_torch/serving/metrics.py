"""SLA telemetry for the serving engine, on the flight recorder.

The port of ``distributed_training_tpu/serving/metrics.py``, unchanged (host Python), over the port's
``observability/flight_recorder.py`` and ``histogram.py``: its dumps
are read by both packages' ``flight_report`` tools.

Serving SLAs are tail-latency numbers, so the telemetry mirrors what an
inference on-call actually pages on:

- **TTFT** (time to first token): arrival → first emitted token, per
  request. Includes queueing delay — that is the point: a saturated
  engine shows up here first.
- **TPOT** (time per output token): mean inter-token interval over a
  request's decode phase (first → last token, / n-1).
- **throughput_tok_s**: emitted tokens over the engine's busy time — the
  SUM of work segments (work start → last token before each drain), so
  idle waits between arrivals measure as queue emptiness, not as lost
  serving capacity.
- **queue_depth_max**: admission high-water mark.

Utilization accounting (the evidence layer for the paged-KV ROADMAP
item): today every slot reserves the full ``max_len`` cache budget and
admission runs one batch-1 prefill per request — this module *measures*
what that costs instead of asserting it:

- **kv_reserved_vs_written**: per decode iteration, KV positions
  *reserved* (active slots × per-slot budget) vs *actually written*
  (each slot's live cache write head) — summed over the run, their
  ratio is the ``max_len`` over-reservation factor a paged allocator
  would reclaim.
- **slot_occupancy_mean**: active slots / total slots per iteration —
  how much of the decode batch the arrival process actually fills.
- **queue wait vs prefill compute**: per request, arrival→seated
  (queueing) and seated→first-token (prefill compute) separately, as
  sample percentiles AND fixed-bucket histograms — the breakdown that
  shows whether admission latency is load or serialization.
- **admission_blocked_s**: wall-time with requests queued while every
  slot was busy — the head-of-line blocking chunked prefill removes.

Tiered-scheduling accounting (docs/SERVING.md "Tiered scheduling &
preemption"): per-SLO-tier TTFT/TPOT fixed-bucket histograms (the
selective-degradation evidence — tier 0 must hold while best-effort
tiers absorb overload), ``requests_preempted`` /
``preempted_token_recompute`` (lossless preempt-and-requeue count and
its recompute debt in cache positions), per-tier finished/preempted
counts, and ``requests_preempt_timed_out`` (deadline misses attributed
to preemption pressure rather than service time).

Latency-ledger accounting (serving/ledger.py; docs/OBSERVABILITY.md
"Latency ledger"): per-request ``(cause, start, end)`` intervals whose
causes partition each request's wall lifetime fold into per-cause
fixed-bucket lifetime histograms (``ledger_<cause>_ms``), deterministic
per-cause token counters (``ledger_tokens_<cause>``, bench-gated
zero-drift), a bounded slowest-requests decomposition (``ledger_top``),
and the zero-tolerance ``ledger_conservation_violations`` audit —
every finished request's intervals must sum to its lifetime within
``ledger.EPSILON_S``, with ``queue_wait + prefill == TTFT`` as the
sub-invariant for unpreempted, unrecovered requests.

The engine drives the same two touch points the trainers use
(``observability/hooks.py`` shape): :meth:`on_iteration` per decode
iteration (one host timestamp into the :class:`FlightRecorder` ring — so
``step_time_*`` stats ARE per-iteration decode latency), and
:meth:`flush` every ``flush_every`` iterations (queue depth, active
slots, running totals into the flush ring). :meth:`dump` writes the
standard flight-record JSON with a ``serving`` section, readable by
``tools/flight_report.py`` and ``FlightRecorder.load``.
"""

from __future__ import annotations

import time
from typing import Any

from distributed_training_tpu_torch.observability.flight_recorder import (
    FlightRecorder,
    percentile,
)
from distributed_training_tpu_torch.observability.histogram import FixedHistogram
from distributed_training_tpu_torch.serving.ledger import (
    LEDGER_CAUSES,
    TOKEN_CAUSES,
)
from distributed_training_tpu_torch.serving.request import FinishedRequest

# How many of the slowest finished requests the flight/scrape surfaces
# keep, each decomposed by cause — the "where did this p99 go" view
# tools/flight_report.py renders as the latency-ledger table.
LEDGER_TOP_N = 8


class ServeTelemetry:
    """Per-request SLA accounting + flight-recorder ring for one engine.

    Latency samples feed BOTH views: exact lists for the sample
    percentiles (bounded by request count per stats window), and
    fixed-bucket :class:`FixedHistogram`\\ s — the SLO view, mergeable
    across windows/replicas and exported in Prometheus shape by
    ``tools/flight_report.py --prometheus``. The histogram-derived
    p50/p95/p99 ride the stats dict as ``*_hist_*`` keys so a scraper
    and the bench SLA line agree on the same bucket-resolution numbers.
    """

    def __init__(self, ring_size: int = 4096, num_tiers: int = 1):
        self.recorder = FlightRecorder(ring_size)
        self.num_tiers = max(int(num_tiers), 1)
        self.ttft_ms: list[float] = []
        self.tpot_ms: list[float] = []
        self.ttft_hist = FixedHistogram()
        self.tpot_hist = FixedHistogram()
        # Per-SLO-tier latency views (tier 0 = highest): the selective-
        # degradation evidence — under overload the high tier's TTFT/
        # TPOT histograms must hold while best-effort tiers absorb the
        # shed/preemption pressure. Same fixed buckets as the global
        # histograms, so per-tier and global quantiles are comparable.
        self.tier_ttft_hist = [FixedHistogram()
                               for _ in range(self.num_tiers)]
        self.tier_tpot_hist = [FixedHistogram()
                               for _ in range(self.num_tiers)]
        self.tier_finished = [0] * self.num_tiers
        self.tier_preempted = [0] * self.num_tiers
        # Lossless preempt-and-requeue accounting (scheduler/engine):
        # how many evictions happened and the cache positions they
        # freed — which the re-seat must prefill AGAIN. The recompute
        # counter is the preemption cost in token units (the tokens
        # themselves are never lost); both are workload-deterministic
        # under the bench's virtual-time drive, so the CI overload
        # drill holds them zero-drift.
        self.requests_preempted = 0
        self.preempted_token_recompute = 0
        # Crash-recovery accounting (serving/journal.py): requests
        # reconstructed from the write-ahead journal at restart
        # (redelivered finished + re-seated unfinished + expired at
        # replay) and the recompute debt the re-seats carry — the cache
        # positions recovery must re-prefill, same token units as
        # preempted_token_recompute. Both are pure functions of the
        # journal's durable state, so the CI crash drill holds them
        # bitwise-equal across runs (and zero-drift on no-crash rows).
        self.requests_recovered = 0
        self.tokens_recomputed_on_recovery = 0
        # Per-request latency ledger aggregates (serving/ledger.py):
        # one fixed-bucket histogram per cause over per-request
        # milliseconds (process-LIFETIME aggregates — reset_stats
        # carries them across a warm-up window reset exactly like
        # requests_recovered, because the recovery/pre_crash causes are
        # stamped once per process and a reset must not erase them),
        # deterministic per-cause token counters (bench-gated
        # zero-drift), the conservation audit counter (zero-tolerance:
        # every finished request's intervals must tile its lifetime),
        # and a bounded slowest-requests list for the flight report.
        self.ledger_cause_ms = {c: FixedHistogram()
                                for c in LEDGER_CAUSES}
        # Windowed per-cause wall totals (reset with the stats window,
        # like ledger_requests/ledger_tokens): the `ledger_<cause>_
        # ms_total` stats describe exactly the requests this window
        # audited — the lifetime histograms above additionally carry
        # pre-reset (warm-up/recovery) spans.
        self.ledger_window_ms = {c: 0.0 for c in LEDGER_CAUSES}
        self.ledger_tokens = {c: 0 for c in TOKEN_CAUSES}
        self.ledger_requests = 0
        self.ledger_conservation_violations = 0
        self.ledger_violation_last: str | None = None
        self.ledger_top: list[dict[str, Any]] = []
        # Prefix-cache accounting (serving/prefix_cache.py): cache
        # positions seats found resident and aliased instead of
        # prefilling (hit_tokens — THE prefill-compute-saved counter,
        # deterministic under the bench's virtual-time drive because
        # trie state is a pure function of the seeded completion
        # order), SEATS with a nonzero hit (a preempted request's
        # restore re-seat counts again — this can exceed
        # requests_finished under preemption churn, it is not a
        # per-request hit rate), and the trie's page churn
        # (adopted at finish / evicted under cap-or-pool pressure; a
        # swap-barrier flush counts in neither — it is deployment
        # hygiene, not memory pressure). All bench-gated zero-drift.
        self.prefix_cache_hit_tokens = 0
        self.prefix_cache_hit_requests = 0
        self.prefix_cache_inserted_pages = 0
        self.prefix_cache_evicted_pages = 0
        # Admission-latency breakdown: queueing vs prefill compute.
        self.queue_wait_ms: list[float] = []
        self.prefill_ms: list[float] = []
        self.queue_wait_hist = FixedHistogram()
        self.prefill_hist = FixedHistogram()
        # KV/slot utilization accumulators (token-iterations: one unit =
        # one cache position over one decode iteration).
        self.kv_reserved_tokens = 0
        self.kv_written_tokens = 0
        self.slot_iters_active = 0
        self.slot_iters_total = 0
        # Page-pool occupancy (paged engine only; page-iterations):
        # allocated vs total pool pages per iteration — the capacity
        # headroom view the allocator adds on top of reserved/written.
        self.page_iters_allocated = 0
        self.page_iters_total = 0
        self.admission_blocked_s = 0.0
        # Live weight hot-swap accounting (serving/hotswap.py): applied
        # and rejected swap attempts, and the wall-time swap barriers
        # blocked the decode loop. The pause is billed HERE, not to the
        # TPOT samples or the decode step-time percentiles (the engine
        # marks a recorder gap at the barrier), the same attribution
        # discipline admission_blocked_s applies to head-of-line time.
        self.swaps_completed = 0
        self.swaps_rejected = 0
        self.swap_blocked_s = 0.0
        # Speculative decoding accounting (serving/speculative.py):
        # drafts proposed vs drafts that became emitted tokens, and the
        # host-side accept/rewind bookkeeping wall time. Both token
        # counters are workload-deterministic (a slot's drafts and
        # accepts are pure functions of its own token stream, never of
        # batch neighbors), so the bench gate holds them zero-drift
        # like the KV counters.
        self.tokens_drafted = 0
        self.tokens_accepted = 0
        self.spec_rollback_s = 0.0
        # Quantized execution accounting (serving/quantize.py):
        # kv_bytes_per_token is the device-cache footprint gauge the
        # engine measures off its real cache pytree (int8 pools + their
        # scale planes, deterministic for a given config — bench-gated
        # zero-drift); quantized_params_bytes the stored weight
        # footprint (0 when quantize_weights is off);  weight_quant_s
        # the staging-time wall cost of quantizing — construction plus
        # every armed hot-swap candidate — attributed explicitly like
        # swap staging, never inside Engine.step.
        self.kv_bytes_per_token = 0.0
        self.quantized_params_bytes = 0
        self.weight_quant_s = 0.0
        # Decode dispatch economics: slot-lane dispatches vs tokens they
        # landed. Their ratio is the speculation speedup factor at
        # fixed dispatch cost (1.0 with speculation off) — DETERMINISTIC
        # (a pure function of each request's token stream), which is
        # what lets CI gate the speedup on shared hardware where
        # wall-clock throughput jitters ±2x.
        self.decode_lanes = 0
        self.decode_tokens = 0
        self.tokens_emitted = 0
        self.requests_finished = 0
        self.finish_reasons: dict[str, int] = {}
        self.queue_depth_max = 0
        # Busy time is a SUM of work segments, not first-work→last-token
        # wall clock: at low arrival rates the engine sits idle between
        # requests, and billing those gaps to the throughput denominator
        # would report arrival rate, not serving capacity.
        self._busy_s = 0.0
        self._seg_t0: float | None = None  # open segment start
        self._busy_t1: float | None = None  # last token landed

    # -- engine touch points -------------------------------------------------
    def begin_work(self, t: float | None = None) -> None:
        """Open a busy segment (idempotent while one is open). The engine
        calls this BEFORE an iteration's prefill/decode work, so the
        first iteration's wall time sits in the denominator alongside its
        tokens — opening at iteration END would inflate throughput, and a
        run whose requests all finish at prefill would never open it."""
        if self._seg_t0 is None:
            self._seg_t0 = time.perf_counter() if t is None else t

    def end_work(self) -> None:
        """Close the open busy segment at the last token's landing time
        (the engine calls this when it drains to idle)."""
        if self._seg_t0 is not None:
            if self._busy_t1 is not None:
                self._busy_s += max(self._busy_t1 - self._seg_t0, 0.0)
            self._seg_t0 = None

    def on_iteration(self, iteration: int, *, queue_depth: int,
                     active: int, t: float | None = None) -> None:
        """One decode iteration happened (or a prefill-only boundary)."""
        t = time.perf_counter() if t is None else t
        self.queue_depth_max = max(self.queue_depth_max, queue_depth)
        self.recorder.record_step(iteration, t)

    def on_idle(self) -> None:
        """No work this boundary: the next iteration's wall delta is
        arrival wait, not decode latency — exclude it from the stats."""
        self.recorder.mark_gap()

    def on_tokens(self, n: int, t: float | None = None) -> None:
        self.tokens_emitted += n
        self._busy_t1 = time.perf_counter() if t is None else t

    def on_kv(self, *, reserved: int, written: int, active: int,
              slots: int, pages_allocated: int | None = None,
              pages_total: int | None = None) -> None:
        """One decode iteration's KV-cache occupancy: ``reserved`` =
        KV positions actually HELD for occupied slots (allocated pages ×
        page size under the paged allocator; active slots × full budget
        on the legacy path), ``written`` = Σ live cache write heads
        (prompt + generated positions actually holding K/V). The paged
        engine also reports pool occupancy (``pages_allocated`` of
        ``pages_total``). All host-side integers the engine already
        tracks — no device read."""
        self.kv_reserved_tokens += int(reserved)
        self.kv_written_tokens += int(written)
        self.slot_iters_active += int(active)
        self.slot_iters_total += int(slots)
        if pages_allocated is not None and pages_total is not None:
            self.page_iters_allocated += int(pages_allocated)
            self.page_iters_total += int(pages_total)

    def on_admitted(self, queue_wait_ms: float,
                    prefill_ms: float) -> None:
        """One request seated and prefilled: its queueing span
        (arrival → seat) and prefill-compute span (seat → first token),
        in ms — the same arithmetic the trace spans carry."""
        self.queue_wait_ms.append(queue_wait_ms)
        self.queue_wait_hist.observe(queue_wait_ms)
        self.prefill_ms.append(prefill_ms)
        self.prefill_hist.observe(prefill_ms)

    def on_admission_blocked(self, seconds: float) -> None:
        """Wall-time this iteration spent with requests queued while
        every decode slot was busy (head-of-line blocking)."""
        self.admission_blocked_s += max(float(seconds), 0.0)

    def on_swap_applied(self, blocked_s: float) -> None:
        """One live weight swap landed at an iteration boundary;
        ``blocked_s`` is the barrier's wall time (validate + pointer
        assign — staging already happened off the hot path)."""
        self.swaps_completed += 1
        self.swap_blocked_s += max(float(blocked_s), 0.0)

    def on_decode(self, *, lanes: int, tokens: int) -> None:
        """One decode iteration's dispatch economics: ``lanes``
        slot-lane verifications landed ``tokens`` emitted tokens
        (equal without speculation; tokens/lanes is the per-dispatch
        speedup with it)."""
        self.decode_lanes += int(lanes)
        self.decode_tokens += int(tokens)

    def on_spec(self, *, drafted: int, accepted: int,
                rollback_s: float) -> None:
        """One speculative iteration's draft economics: ``drafted``
        proposal tokens entered the verify window, ``accepted`` of them
        became emitted tokens (the bonus/correction token is target
        compute, not a draft, so it counts in neither), and the host
        spent ``rollback_s`` on accept/rewind bookkeeping — attributed
        explicitly like ``admission_blocked_s``."""
        self.tokens_drafted += int(drafted)
        self.tokens_accepted += int(accepted)
        self.spec_rollback_s += max(float(rollback_s), 0.0)

    def on_swap_rejected(self) -> None:
        """A swap candidate died somewhere in the pipeline (verify /
        stage / validate / arm); the engine kept its old weights."""
        self.swaps_rejected += 1

    def on_weight_quant(self, quant_s: float, params_bytes: int) -> None:
        """One weight-quantization pass finished off the hot path
        (engine construction, or a hot-swap candidate at arm time on
        the watcher thread): ``quant_s`` wall seconds accumulate —
        the same staging-cost attribution as swap verify/restore —
        and ``params_bytes`` (re)states the stored quantized footprint
        (a gauge: every pass serves the same tree shape)."""
        self.weight_quant_s += max(float(quant_s), 0.0)
        self.quantized_params_bytes = int(params_bytes)

    def set_kv_bytes_per_token(self, v: float) -> None:
        """Device-cache bytes per storable KV token position — a gauge
        the engine measures once from its real cache pytree."""
        self.kv_bytes_per_token = float(v)

    def on_preempted(self, recompute_tokens: int, tier: int) -> None:
        """One lossless preemption: a ``tier`` sequence was evicted to
        seat a higher tier and requeued; ``recompute_tokens`` cache
        positions were freed and will be re-prefilled at the re-seat
        (the preemption's entire cost — no token is ever lost)."""
        self.requests_preempted += 1
        self.preempted_token_recompute += int(recompute_tokens)
        t = min(max(int(tier), 0), self.num_tiers - 1)
        self.tier_preempted[t] += 1

    def on_prefix_hit(self, tokens: int, *, restored_preempt: int = 0,
                      restored_recovery: int = 0) -> None:
        """One seat aliased ``tokens`` resident prefix positions instead
        of prefilling them. The ``restored_*`` counts covered recompute
        debt a preemption / crash recovery had already billed — the
        preempt-and-RESTORE satellite: each recompute counter drops by
        exactly what IT was charged, down to the divergent tail the
        re-seat will actually re-prefill (clamped at zero; the debt was
        charged in full at eviction/replay time, so mid-flight scrapes
        may transiently overstate it until the re-seat lands its
        hit). Counts one SEAT per call — a preempted request's restore
        re-seat that hits again increments hit_requests again, so the
        counter is seats-that-hit, not distinct requests."""
        self.prefix_cache_hit_tokens += int(tokens)
        self.prefix_cache_hit_requests += 1
        if restored_recovery:
            self.tokens_recomputed_on_recovery = max(
                self.tokens_recomputed_on_recovery
                - int(restored_recovery), 0)
        if restored_preempt:
            self.preempted_token_recompute = max(
                self.preempted_token_recompute - int(restored_preempt), 0)

    def on_prefix_pages(self, *, inserted: int = 0,
                        evicted: int = 0) -> None:
        """Trie page churn: ``inserted`` pages adopted from finishing
        sequences, ``evicted`` reclaimed by LRU pressure (cap or pool
        exhaustion; swap flushes count in neither)."""
        self.prefix_cache_inserted_pages += int(inserted)
        self.prefix_cache_evicted_pages += int(evicted)

    def on_recovered(self, requests: int, recompute_tokens: int) -> None:
        """Journal replay landed: ``requests`` were reconstructed from
        the write-ahead log and their re-seats owe ``recompute_tokens``
        cache positions of re-prefill. The engine re-applies these
        across ``reset_stats`` — recovery happened once per process,
        and a warm-up window reset must not erase the evidence."""
        self.requests_recovered += int(requests)
        self.tokens_recomputed_on_recovery += int(recompute_tokens)

    def on_finished(self, fin: FinishedRequest) -> None:
        self.requests_finished += 1
        self.finish_reasons[fin.finish_reason] = \
            self.finish_reasons.get(fin.finish_reason, 0) + 1
        tier = min(max(int(fin.priority), 0), self.num_tiers - 1)
        self.tier_finished[tier] += 1
        if fin.ttft_ms is not None:  # queue-side timeouts carry no sample
            self.ttft_ms.append(fin.ttft_ms)
            self.ttft_hist.observe(fin.ttft_ms)
            self.tier_ttft_hist[tier].observe(fin.ttft_ms)
        if fin.tpot_ms is not None:
            self.tpot_ms.append(fin.tpot_ms)
            self.tpot_hist.observe(fin.tpot_ms)
            self.tier_tpot_hist[tier].observe(fin.tpot_ms)
        self._audit_ledger(fin)

    def _audit_ledger(self, fin: FinishedRequest) -> None:
        """Fold one finished request's latency ledger into the per-cause
        aggregates and enforce the conservation invariant (module
        docstring of serving/ledger.py). Journal redeliveries carry no
        ledger (their wall detail died with the old process) and are
        skipped — they never count as violations."""
        led = fin.ledger
        if led is None:
            return
        self.ledger_requests += 1
        totals = led.totals_ms()
        for cause, ms in totals.items():
            hist = self.ledger_cause_ms.get(cause)
            if hist is not None:
                hist.observe(ms)
            if cause in self.ledger_window_ms:
                self.ledger_window_ms[cause] += ms
        for cause, n in led.tokens.items():
            if cause in self.ledger_tokens:
                self.ledger_tokens[cause] += n
        violations = led.violations(ttft_ms=fin.ttft_ms)
        if violations:
            self.ledger_conservation_violations += 1
            self.ledger_violation_last = (
                f"uid {fin.uid} ({fin.finish_reason}): {violations[0]}")
        # Bounded slowest-requests view (LEDGER_TOP_N): lifetime-sorted,
        # uid tiebreak for determinism under equal stamps.
        entry = {
            "uid": int(fin.uid),
            # Fleet-tracing correlation: an SLA outlier surfaced here is
            # looked up by this id on the merged tools/fleet_trace.py
            # timeline (and in the door's fleet_ledger_top).
            "trace_id": fin.trace_id,
            "finish_reason": fin.finish_reason,
            "lifetime_ms": led.lifetime_ms,
            "ttft_ms": fin.ttft_ms,
            "tokens": int(fin.tokens.size),
            "causes_ms": totals,
        }
        self.ledger_top.append(entry)
        self.ledger_top.sort(
            key=lambda e: (-e["lifetime_ms"], e["uid"]))
        del self.ledger_top[LEDGER_TOP_N:]

    def adopt_ledger_lifetime(self, old: "ServeTelemetry") -> None:
        """Carry the process-lifetime ledger evidence across a stats
        window reset (``Engine.reset_stats``): the per-cause lifetime
        histograms and the conservation audit — the round-17
        ``requests_recovered`` precedent, extended. The WINDOWED ledger
        surfaces (per-cause ms totals, token counters, slowest-request
        list, audited count) deliberately start fresh, so a compile
        warm-up pass cannot contaminate the measured window's
        deterministic counters — or the SLA line's per-cause
        decomposition of the requests it claims to audit."""
        self.ledger_cause_ms = old.ledger_cause_ms
        self.ledger_conservation_violations = \
            old.ledger_conservation_violations
        self.ledger_violation_last = old.ledger_violation_last

    def flush(self, iteration: int, queue_depth: int, active: int) -> None:
        self.recorder.record_flush(iteration, {
            "queue_depth": queue_depth,
            "active_slots": active,
            "tokens_emitted": self.tokens_emitted,
            "requests_finished": self.requests_finished,
        })

    # -- derived -------------------------------------------------------------
    def queue_wait_p95_ms(self) -> float:
        """The routing fallback signal (serving/router.py): ledger
        queue-wait p95 over the current window, 0.0 with no samples.
        One percentile over one list — cheap enough for a per-request
        probe, and read-only (scrape-safe from the probe endpoint)."""
        return (percentile(self.queue_wait_ms, 95)
                if self.queue_wait_ms else 0.0)

    def stats(self) -> dict[str, Any]:
        """The serving SLA summary; every field always present (0.0 when
        no sample exists) so downstream JSON consumers need no key
        guards."""

        def pct(xs: list[float], q: float) -> float:
            return percentile(xs, q) if xs else 0.0

        busy_s = self._busy_s
        if self._seg_t0 is not None and self._busy_t1 is not None:
            busy_s += max(self._busy_t1 - self._seg_t0, 0.0)
        tput = self.tokens_emitted / busy_s if busy_s > 0 else 0.0
        from distributed_training_tpu_torch.serving.request import (
            FINISH_CANCELLED,
            FINISH_PREEMPT_TIMEOUT,
            FINISH_TIMEOUT,
        )

        # Per-SLO-tier SLA view: fixed-bucket TTFT/TPOT quantiles plus
        # finished/preempted counts for every configured tier (one tier
        # = the global view restated, so downstream consumers read one
        # key shape regardless of config).
        tiers: dict[str, Any] = {}
        for t in range(self.num_tiers):
            tiers[f"tier{t}_ttft_hist_p50_ms"] = \
                self.tier_ttft_hist[t].quantile(0.50)
            tiers[f"tier{t}_ttft_hist_p95_ms"] = \
                self.tier_ttft_hist[t].quantile(0.95)
            tiers[f"tier{t}_ttft_hist_p99_ms"] = \
                self.tier_ttft_hist[t].quantile(0.99)
            tiers[f"tier{t}_tpot_hist_p50_ms"] = \
                self.tier_tpot_hist[t].quantile(0.50)
            tiers[f"tier{t}_tpot_hist_p95_ms"] = \
                self.tier_tpot_hist[t].quantile(0.95)
            tiers[f"tier{t}_requests_finished"] = self.tier_finished[t]
            tiers[f"tier{t}_requests_preempted"] = self.tier_preempted[t]

        # Latency-ledger aggregates (serving/ledger.py): WINDOWED
        # per-cause wall totals (deliberately not the lifetime
        # histograms' sums — the scalars must describe exactly the
        # requests this window audited, warm-up excluded), the
        # deterministic per-cause token counters, and the
        # zero-tolerance conservation audit. Every key always present
        # (0 / 0.0 when unused).
        ledger: dict[str, Any] = {
            f"ledger_{c}_ms_total": self.ledger_window_ms[c]
            for c in LEDGER_CAUSES}
        for c in TOKEN_CAUSES:
            ledger[f"ledger_tokens_{c}"] = int(self.ledger_tokens[c])
        ledger["ledger_requests"] = int(self.ledger_requests)
        ledger["ledger_conservation_violations"] = \
            int(self.ledger_conservation_violations)

        return {
            **tiers,
            **ledger,
            "throughput_tok_s": tput,
            "ttft_p50_ms": pct(self.ttft_ms, 50),
            "ttft_p95_ms": pct(self.ttft_ms, 95),
            "tpot_p50_ms": pct(self.tpot_ms, 50),
            "tpot_p95_ms": pct(self.tpot_ms, 95),
            # Fixed-bucket (SLO) percentiles — bucket-resolution, but
            # mergeable and what a Prometheus scrape would report.
            "ttft_hist_p50_ms": self.ttft_hist.quantile(0.50),
            "ttft_hist_p95_ms": self.ttft_hist.quantile(0.95),
            "ttft_hist_p99_ms": self.ttft_hist.quantile(0.99),
            "tpot_hist_p50_ms": self.tpot_hist.quantile(0.50),
            "tpot_hist_p95_ms": self.tpot_hist.quantile(0.95),
            "tpot_hist_p99_ms": self.tpot_hist.quantile(0.99),
            "queue_depth_max": int(self.queue_depth_max),
            "requests_finished": self.requests_finished,
            "requests_timed_out": self.finish_reasons.get(FINISH_TIMEOUT, 0),
            # Preempted-then-timed-out is attributed separately: the
            # clock ran down while the sequence waited requeued, so the
            # miss belongs to preemption pressure, not service time.
            "requests_preempt_timed_out":
                self.finish_reasons.get(FINISH_PREEMPT_TIMEOUT, 0),
            # Client-disconnect cancellations (broken pipe on an SSE
            # write → engine eviction). Zero-drift on no-fault rows:
            # bench-gated at zero tolerance.
            "requests_cancelled":
                self.finish_reasons.get(FINISH_CANCELLED, 0),
            # Lossless preempt-and-requeue economics (deterministic
            # under the bench's virtual-time drive; CI-gated zero-drift).
            "requests_preempted": int(self.requests_preempted),
            "preempted_token_recompute":
                int(self.preempted_token_recompute),
            # Crash-recovery economics (serving/journal.py): always
            # present (0 without a journal) so the bench gate can hold
            # the no-crash rows at zero drift.
            "requests_recovered": int(self.requests_recovered),
            "tokens_recomputed_on_recovery":
                int(self.tokens_recomputed_on_recovery),
            "tokens_emitted": self.tokens_emitted,
            "busy_seconds": busy_s,
            # Utilization accounting (see module docstring): the
            # over-reservation evidence for the paged-KV roadmap item.
            "kv_reserved_tokens": int(self.kv_reserved_tokens),
            "kv_written_tokens": int(self.kv_written_tokens),
            "kv_reserved_vs_written": (
                self.kv_reserved_tokens / self.kv_written_tokens
                if self.kv_written_tokens else 0.0),
            "slot_occupancy_mean": (
                self.slot_iters_active / self.slot_iters_total
                if self.slot_iters_total else 0.0),
            # Paged-allocator pool view (0.0 on the legacy path): mean
            # fraction of pool pages allocated per iteration, and the
            # same numerator in page-iterations for the bench gate's
            # workload-deterministic drift check.
            "page_pool_occupancy_mean": (
                self.page_iters_allocated / self.page_iters_total
                if self.page_iters_total else 0.0),
            "kv_pages_allocated_iters": int(self.page_iters_allocated),
            # Prefix cache (serving/prefix_cache.py): reuse economics —
            # hit_tokens is prefill compute SAVED in cache positions
            # (deterministic under --virtual-dt, bench-gated), the page
            # counters are the trie's churn. pages_held is merged by
            # Engine.stats() (a gauge owned by the trie itself).
            "prefix_cache_hit_tokens": int(self.prefix_cache_hit_tokens),
            "prefix_cache_hit_requests":
                int(self.prefix_cache_hit_requests),
            "prefix_cache_inserted_pages":
                int(self.prefix_cache_inserted_pages),
            "prefix_cache_evicted_pages":
                int(self.prefix_cache_evicted_pages),
            "queue_wait_p50_ms": pct(self.queue_wait_ms, 50),
            "queue_wait_p95_ms": pct(self.queue_wait_ms, 95),
            "prefill_p50_ms": pct(self.prefill_ms, 50),
            "prefill_p95_ms": pct(self.prefill_ms, 95),
            "admission_blocked_s": self.admission_blocked_s,
            # Live weight hot-swap (serving/hotswap.py): deployment
            # counters + the explicitly-attributed barrier pause.
            "swaps_completed": self.swaps_completed,
            "swaps_rejected": self.swaps_rejected,
            "swap_blocked_s": self.swap_blocked_s,
            # Speculative decoding (serving/speculative.py): the draft
            # economics the bench gate reads. drafted/accepted are
            # zero-drift workload-deterministic; acceptance_rate is
            # their ratio (0.0 with speculation off).
            "drafted_tokens": int(self.tokens_drafted),
            "accepted_tokens": int(self.tokens_accepted),
            "spec_acceptance_rate": (
                self.tokens_accepted / self.tokens_drafted
                if self.tokens_drafted else 0.0),
            # Tokens landed per decode slot-lane dispatch: the
            # deterministic speedup factor the CI speculation gate
            # asserts (1.0 speculation-off; wall-clock throughput on
            # shared runners is too noisy to carry the >= 1.3x claim).
            "spec_tokens_per_dispatch": (
                self.decode_tokens / self.decode_lanes
                if self.decode_lanes else 0.0),
            "spec_rollback_s": self.spec_rollback_s,
            # Quantized execution (serving/quantize.py): cache bytes
            # per token position and stored quantized-weight bytes are
            # config-deterministic gauges (bench-gated zero-drift);
            # weight_quant_s is staging wall time, attributed like
            # swap staging cost.
            "kv_bytes_per_token": float(self.kv_bytes_per_token),
            "quantized_params_bytes": int(self.quantized_params_bytes),
            "weight_quant_s": float(self.weight_quant_s),
        }

    def _serving_section(self, stats: dict[str, Any] | None
                         ) -> dict[str, Any]:
        """The ``serving`` extra section dumps AND live scrapes carry:
        the SLA summary plus the full fixed-bucket latency histograms
        (the recorder's own decode-iteration histogram is already in the
        snapshot's top-level ``histograms``)."""
        serving = dict(stats if stats is not None else self.stats())
        serving["histograms"] = {
            "ttft_ms": self.ttft_hist.to_dict(),
            "tpot_ms": self.tpot_hist.to_dict(),
            "queue_wait_ms": self.queue_wait_hist.to_dict(),
            "prefill_ms": self.prefill_hist.to_dict(),
        }
        if self.num_tiers > 1:
            # Full per-tier latency histograms (mergeable, Prometheus-
            # exportable) — only under a multi-tier config, where they
            # differ from the global pair above.
            for t in range(self.num_tiers):
                serving["histograms"][f"ttft_ms_tier{t}"] = \
                    self.tier_ttft_hist[t].to_dict()
                serving["histograms"][f"tpot_ms_tier{t}"] = \
                    self.tier_tpot_hist[t].to_dict()
        # Latency-ledger per-cause histograms (causes that appeared) and
        # the slowest-requests decomposition for the flight report.
        for c in LEDGER_CAUSES:
            if self.ledger_cause_ms[c].total:
                serving["histograms"][f"ledger_{c}_ms"] = \
                    self.ledger_cause_ms[c].to_dict()
        if self.ledger_top:
            serving["ledger_top"] = [dict(e) for e in self.ledger_top]
        if self.ledger_violation_last is not None:
            serving["ledger_violation_last"] = self.ledger_violation_last
        return serving

    def snapshot(self, *, reason: str = "scrape",
                 stats: dict[str, Any] | None = None,
                 extra_sections: dict[str, Any] | None = None,
                 ) -> dict[str, Any]:
        """The live flight snapshot (dump shape, no disk): what the
        ``/metrics``/``/vars`` exporter serves mid-run. Reads only
        host-side state this object already holds — scrape-safe from
        another thread by construction. ``extra_sections`` lets the
        engine ride additional top-level sections (``alerts``,
        ``timeseries``) on the same snapshot."""
        extra = {"serving": self._serving_section(stats)}
        if extra_sections:
            extra |= extra_sections
        return self.recorder.snapshot(reason=reason, extra=extra)

    def dump(self, path: str, *, reason: str = "serving",
             stats: dict[str, Any] | None = None,
             extra_sections: dict[str, Any] | None = None,
             ) -> dict[str, Any]:
        """Flight-recorder-compatible JSON dump with a ``serving`` extra
        section (``tools/flight_report.py`` renders it). ``stats`` lets
        the engine pass its merged summary (queue counters included);
        ``extra_sections`` rides additional top-level sections exactly
        as :meth:`snapshot` does."""
        extra = {"serving": self._serving_section(stats)}
        if extra_sections:
            extra |= extra_sections
        return self.recorder.dump(path, reason=reason, extra=extra)
