"""Request lifecycle datatypes for the serving engine.

The port of ``distributed_training_tpu/serving/request.py``, unchanged (host Python and numpy).

A request moves queue → slot → finished — and, under overload, may take
the preemption detour slot → queue → slot again:

- :class:`Request` is the immutable admission record (tokens + budget +
  arrival timestamp + SLO tier + tenant).
- :class:`ActiveSequence` is a slot's host-side bookkeeping while the
  sequence decodes (emitted tokens, first/last token timestamps). When a
  higher-tier request needs its slot or pages, :meth:`prepare_resume`
  turns it into a queued *resumption*: the emitted tokens ride along and
  are re-prefilled on the next seat, so the preemption is LOSSLESS —
  the continued token stream is bitwise identical to an uninterrupted
  run (see docs/SERVING.md "Tiered scheduling & preemption").
- :class:`FinishedRequest` is the completed result with its SLA numbers
  (TTFT from arrival to first emitted token; TPOT as the mean inter-token
  interval over the decode phase).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from distributed_training_tpu_torch.serving.ledger import LatencyLedger

# Why a sequence left its slot (or the queue).
FINISH_EOS = "eos"        # emitted the configured eos_id
FINISH_LENGTH = "length"  # hit its max_new_tokens budget
FINISH_TIMEOUT = "timeout"  # missed its TTFT/total deadline (evicted)
# Tier-aware load shedding: a queued lower-tier request dropped to make
# room for a higher-tier arrival on a full queue (serving/queue.py).
FINISH_SHED = "shed"
# A preempted-and-requeued sequence whose deadline expired before it
# could re-seat (or finish after re-seating). Kept distinct from plain
# ``timeout`` so telemetry attributes the miss to preemption pressure,
# not to the request's own service time.
FINISH_PREEMPT_TIMEOUT = "preempted_timeout"
# The client hung up (broken pipe on an SSE write): the frontend asks
# the engine to cancel, the engine evicts at its next step boundary and
# frees the pages — decoding to completion for a dead socket would burn
# slots and skew every latency percentile with tokens nobody received.
FINISH_CANCELLED = "cancelled"


@dataclasses.dataclass(frozen=True)
class Request:
    """One admitted generation request (arrival-ordered by ``uid``).

    ``priority`` is the SLO tier: 0 is the highest (interactive) tier,
    larger numbers degrade first under load (``ServeConfig.num_tiers``
    bounds it). ``tenant`` names the submitting principal for the
    per-tenant quota/weighted-fair admission in
    :class:`~distributed_training_tpu_torch.serving.queue.RequestQueue`.

    ``ttft_deadline_t`` / ``deadline_t`` are absolute ``perf_counter``
    deadlines (None = none): a request past its TTFT deadline with no
    first token yet (still queued, or seated mid-chunked-prefill), or
    still decoding past its total deadline, is evicted with finish
    reason ``timeout`` instead of holding a slot or queue position
    forever under overload. The clock keeps running while a preempted
    sequence waits requeued — that eviction reports
    ``preempted_timeout`` instead, so the miss is attributed to
    preemption pressure.
    """

    uid: int
    prompt: np.ndarray        # int32 [T], T >= 1
    max_new_tokens: int
    arrival_t: float          # perf_counter at submit
    ttft_deadline_t: float | None = None
    deadline_t: float | None = None
    priority: int = 0         # SLO tier, 0 = highest
    tenant: str = "default"
    # Distributed-tracing correlation id (docs/OBSERVABILITY.md "Fleet
    # tracing"): minted by the front door (or the queue, from the uid)
    # and carried on every trace span/instant this request emits, so
    # tools/fleet_trace.py can stitch one request's timeline across the
    # door and replica processes. Deterministic by construction — never
    # derived from the wall clock — and excluded from equality (it is
    # correlation metadata, not part of the admission record).
    trace_id: str | None = dataclasses.field(default=None, compare=False)
    # Per-request latency ledger (serving/ledger.py): the append-only
    # (cause, start, end) interval list whose causes partition the
    # request's wall lifetime. It travels WITH the request through
    # every state change — queue → slot → (preempt) → queue → slot →
    # finished — so attribution survives requeues and the finished
    # record carries the full decomposition. Mutable by design (the
    # frozen dataclass pins the admission record; the ledger is
    # telemetry riding along) and excluded from equality.
    ledger: LatencyLedger | None = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.ledger is None:
            object.__setattr__(self, "ledger",
                               LatencyLedger(self.arrival_t))


@dataclasses.dataclass
class ActiveSequence:
    """Host-side state of one occupied decode slot (or, after a
    preemption, of one requeued resumption awaiting a slot)."""

    request: Request
    slot: int
    tokens: list = dataclasses.field(default_factory=list)  # emitted ids
    # When the scheduler seated the request into its slot (perf_counter):
    # arrival→seated is the queueing span, seated→first token the prefill
    # span on the trace timeline (serving/engine.py). A re-seat after
    # preemption re-stamps it, so the TTFT decomposition
    # (queue_wait + prefill == TTFT) stays telescoping.
    seated_t: float | None = None
    first_token_t: float | None = None
    last_token_t: float | None = None
    # Chunked-prefill progress (paged engine): prefill tokens already
    # written to the KV pool. A seated sequence decodes only once
    # prefill_pos reaches the prefill length AND its first token landed;
    # until then it occupies its slot as "prefilling".
    prefill_pos: int = 0
    # Wall-time a live weight hot-swap barrier blocked this sequence's
    # decode between two of its tokens (serving/hotswap.py). Billed to
    # the engine-level swap_blocked_s stat and SUBTRACTED from the
    # request's TPOT: TPOT reports decode compute per token, and the
    # swap pause is deployment cost the engine attributes explicitly
    # rather than smearing over whichever requests were in flight.
    swap_pause_s: float = 0.0
    # Lossless preemption state: how many times this sequence was
    # evicted mid-flight to make room for a higher tier, and — when it
    # had already emitted tokens — the token prefix (prompt + emitted
    # minus the uncached last token) the next seat must re-prefill.
    # The re-prefill recomputes exactly the cache positions the
    # eviction freed, and the continuation samples the same
    # fold_in(rng, position) stream, so the final output is bitwise
    # identical to an uninterrupted run.
    preempts: int = 0
    resume_prefix: np.ndarray | None = None
    # Ledger token-attribution debt (serving/ledger.py): cache
    # positions freed by preemptions/crashes that the next prefill
    # chunks will write AGAIN. Each re-prefill chunk consumes this
    # before billing to 'prefill' — a request preempted mid-prefill
    # bills only the positions it had actually written as recompute;
    # the never-written tail of its prompt stays first-time 'prefill'
    # work. When every evicted request re-seats, the summed ledger
    # counter equals preempted_token_recompute +
    # tokens_recomputed_on_recovery; a resumption shed or expired
    # from the queue dies with its debt unconsumed (nothing was
    # recomputed, so nothing is billed).
    recompute_owed: int = 0
    # Prefix-cache state (serving/prefix_cache.py). kv_epoch stamps
    # WHICH weights wrote this seat's KV pages (the engine bumps its
    # epoch at every hot-swap barrier): a sequence whose pages predate
    # the serving weights must not index them into the trie at finish —
    # old-weight KV must never seed a new-epoch request.
    # prefix_hit_tokens is the resident prefix this seat aliased
    # instead of prefilling (0 = cold); re-stamped at every re-seat.
    kv_epoch: int = 0
    prefix_hit_tokens: int = 0
    # The portion of recompute_owed that was charged to the RECOVERY
    # counter (tokens_recomputed_on_recovery, billed up front by
    # Engine.recover()) rather than to preempted_token_recompute: a
    # prefix-cache hit that covers debt credits each counter back by
    # what it was actually charged. Maintained as recovery-first on
    # hits and clamped under recompute_owed when chunks genuinely
    # recompute (a recomputed position's charge legitimately stands).
    recovery_owed: int = 0

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What prefill must write: the original prompt, or — resuming
        after a preemption — prompt + emitted tokens except the last
        (the last emitted token is never cached; it re-enters as the
        next decode step's incoming token, exactly as it would have
        uninterrupted)."""
        return (self.request.prompt if self.resume_prefix is None
                else self.resume_prefix)

    @property
    def prefilling(self) -> bool:
        """Seated but not yet decoding (paged engine's chunked prefill);
        always False on the legacy path, whose batch-1 prefill emits the
        first token before the sequence ever reaches the slot state."""
        return (self.prefill_pos < self.prefill_tokens.size
                or not self.tokens)

    @staticmethod
    def from_journal(req: Request, tokens, *, preempts: int = 0,
                     first_token_t: float | None = None,
                     last_token_t: float | None = None
                     ) -> "ActiveSequence":
        """Reconstruct a crash-interrupted sequence from its journaled
        state (serving/journal.py) as a queued resumption — the SAME
        shape :meth:`prepare_resume` leaves behind, so the re-seat path
        (re-prefill prompt + emitted-minus-last, continue the
        ``fold_in(rng, position)`` stream) needs no recovery-specific
        branch and the continued output is bitwise identical to the
        uninterrupted run. Tokens emitted after the journal's last
        durable flush are simply recomputed by the same induction.
        ``first_token_t``/``last_token_t`` are the journal's wall
        anchors mapped into the new process's clock: TTFT stays "met"
        across the restart and deadline attribution keeps working."""
        seq = ActiveSequence(
            request=req, slot=-1, tokens=[int(t) for t in tokens],
            first_token_t=first_token_t,
            last_token_t=last_token_t, preempts=int(preempts))
        if seq.tokens:
            seq.resume_prefix = np.concatenate([
                req.prompt, np.asarray(seq.tokens[:-1], np.int32)])
            # The recovery re-prefill rewrites exactly the positions
            # the crash lost — the same count Engine.recover() reports
            # as tokens_recomputed_on_recovery (recovery_owed tracks
            # that attribution so a prefix-cache hit covering the debt
            # credits the recovery counter, not the preemption one —
            # even when the journal also restored pre-crash preempts).
            seq.recompute_owed = req.prompt.size + len(seq.tokens) - 1
            seq.recovery_owed = seq.recompute_owed
        return seq

    def prepare_resume(self) -> None:
        """Preemption bookkeeping: snapshot the re-prefill prefix from
        the tokens emitted so far and rewind the prefill cursor. The
        snapshot is taken NOW (not derived lazily) because ``tokens``
        keeps growing after the re-seat — the prefill target must stay
        what was cached at eviction time."""
        if self.tokens:
            self.resume_prefix = np.concatenate([
                self.request.prompt,
                # graftlint: disable=hot-path-transfer -- emitted tokens are host ints by contract (note_token casts at landing); no device value involved
                np.asarray(self.tokens[:-1], np.int32)])
        # else: preempted mid-prefill — restart from the original prompt
        # (resume_prefix stays None; nothing was emitted, so nothing to
        # carry).
        self.prefill_pos = 0
        self.preempts += 1
        self.slot = -1

    def note_token(self, token: int, t: float) -> None:
        self.tokens.append(int(token))
        if self.first_token_t is None:
            self.first_token_t = t
        self.last_token_t = t

    def finish_reason(self, eos_id: int | None,
                      now: float | None = None) -> str | None:
        """None while the sequence should keep decoding.

        EOS and budget win over a deadline landing on the same token (a
        naturally-finished request is not a timeout); ``now`` enables the
        total-deadline check — callers without deadlines pass nothing.
        A deadline miss on a sequence that was ever preempted reports
        ``preempted_timeout``: its clock kept running while it sat
        requeued, so the miss belongs to preemption pressure, not to the
        request's own service time.
        """
        if eos_id is not None and self.tokens and self.tokens[-1] == eos_id:
            return FINISH_EOS
        if len(self.tokens) >= self.request.max_new_tokens:
            return FINISH_LENGTH
        timeout = (FINISH_PREEMPT_TIMEOUT if self.preempts
                   else FINISH_TIMEOUT)
        dl = self.request.deadline_t
        if now is not None and dl is not None and now >= dl:
            return timeout
        # TTFT deadline, mid-prefill: chunked prefill holds a slot for
        # ceil(prompt/chunk) iterations before the first token, so a
        # request can now miss its TTFT SLA while SEATED (impossible on
        # the legacy path, whose seat and first token share an
        # iteration). Past the deadline with no first token it will
        # never make its SLA — evict so the chunk lane and its pool
        # pages go to a request that still can. A first token landing on
        # the deadline tick wins (first_token_t set → not a timeout),
        # matching the EOS/length-beat-deadline rule above.
        tdl = self.request.ttft_deadline_t
        if (now is not None and tdl is not None and now >= tdl
                and self.first_token_t is None):
            return timeout
        return None


@dataclasses.dataclass(frozen=True)
class FinishedRequest:
    """A completed request with its per-request SLA measurements.

    A queue-side deadline eviction completes with zero tokens and no
    latency samples (``ttft_ms``/``first_token_t`` None): the request
    never produced a first token, so it contributes to the timeout
    counter, not to the TTFT percentiles. A shed or expired resumption
    (preempted, then dropped from the queue) DOES carry the tokens it
    had emitted before eviction.
    """

    uid: int
    prompt: np.ndarray
    tokens: np.ndarray        # int32 [n]; n >= 1 except queue evictions
    finish_reason: str        # FINISH_* above
    ttft_ms: float | None     # arrival → first emitted token
    tpot_ms: float | None     # mean inter-token ms; None for <2 tokens
    arrival_t: float          # perf_counter timestamps (fairness audits)
    first_token_t: float | None
    # Trace-timeline fields (None for queue-side evictions): the slot
    # the request decoded in and its last token's landing time — the
    # engine closes the slot track's decode span from these at eviction.
    last_token_t: float | None = None
    slot: int | None = None
    priority: int = 0         # SLO tier (per-tier SLA histograms)
    tenant: str = "default"
    # The request's latency ledger (closed by the engine at completion;
    # None for results redelivered verbatim from the journal — their
    # wall detail belongs to the process that served them).
    ledger: "object | None" = dataclasses.field(
        default=None, compare=False, repr=False)
    # The request's trace correlation id (see Request.trace_id): rides
    # into the done frame and the slowest-request views so an SLA
    # outlier can be looked up on the merged fleet timeline.
    trace_id: str | None = dataclasses.field(default=None, compare=False)

    @staticmethod
    def from_active(seq: ActiveSequence, reason: str,
                    slot: int | None = -1) -> "FinishedRequest":
        """``slot`` defaults to the sequence's own; queue-side evictions
        of a requeued resumption pass ``slot=None`` (it holds no slot,
        so its trace marks belong on the queue track)."""
        n = len(seq.tokens)
        tpot = None
        if n > 1:
            span_s = max(
                seq.last_token_t - seq.first_token_t - seq.swap_pause_s,
                0.0)
            tpot = span_s * 1e3 / (n - 1)
        # A deadline eviction can now land mid-prefill (chunked prefill
        # holds a slot across iterations): no first token, no TTFT
        # sample — same contract as a queue-side timeout.
        ttft = (None if seq.first_token_t is None
                else (seq.first_token_t - seq.request.arrival_t) * 1e3)
        return FinishedRequest(
            uid=seq.request.uid,
            prompt=seq.request.prompt,
            tokens=np.asarray(seq.tokens, np.int32),
            finish_reason=reason,
            ttft_ms=ttft,
            tpot_ms=tpot,
            arrival_t=seq.request.arrival_t,
            first_token_t=seq.first_token_t,
            last_token_t=seq.last_token_t,
            slot=seq.slot if slot == -1 else slot,
            priority=seq.request.priority,
            tenant=seq.request.tenant,
            ledger=seq.request.ledger,
            trace_id=seq.request.trace_id,
        )

    @staticmethod
    def rejected_in_queue(req: Request, reason: str) -> "FinishedRequest":
        """A request evicted from the queue (deadline expiry or a
        tier-aware shed) — it never reached a slot, so it carries no
        tokens and no latency samples."""
        return FinishedRequest(
            uid=req.uid,
            prompt=req.prompt,
            tokens=np.zeros((0,), np.int32),
            finish_reason=reason,
            ttft_ms=None,
            tpot_ms=None,
            arrival_t=req.arrival_t,
            first_token_t=None,
            priority=req.priority,
            tenant=req.tenant,
            ledger=req.ledger,
            trace_id=req.trace_id,
        )

    @staticmethod
    def timed_out_in_queue(req: Request) -> "FinishedRequest":
        """A request evicted from the queue past its deadline — it never
        reached a slot, so it carries no tokens and no latency samples."""
        return FinishedRequest.rejected_in_queue(req, FINISH_TIMEOUT)
