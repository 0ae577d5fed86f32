"""Continuous-batching inference engine: admit → prefill → decode → evict.

The port of ``distributed_training_tpu/serving/engine.py``'s core. It
serves a :class:`~distributed_training_tpu_torch.models.gpt.TransformerLM`
with one of two cache managements, chosen by ``ServeConfig.kv_page_size``:

**Paged KV + chunked prefill (default).** KV memory is one pool of
``kv_page_size``-position pages per layer
(``parallel/ring_attention.py``'s :class:`PagedCache`, page 0 the null
page); each decode slot holds a page table that grows as its write head
advances, and admission commits a request's worst-case page count. A
prompt prefills in ``prefill_chunk`` pieces, one per iteration, in the
same step as the decode lanes: the *fused* iteration runs the chunk lane
``[1, prefill_chunk]`` and then the decode lane ``[max_batch, 1]``, the
*decode-only* iteration the second alone. Padded rows write the null
page.

**Legacy contiguous slots (``kv_page_size=None``).** One
``[max_batch, budget, H, hd]`` cache per layer with a ``[max_batch]``
device tensor of write heads (JAX ``vmap``s the one-sequence decode over
the slots; ``KVCache``'s per-row form does the same rows). Admission
runs one bucketed batch-1 prefill and copies it into the slot; decode
steps every slot and keeps the inactive ones' heads.

Shared discipline, JAX's — masks, never shapes:

- **Iteration-level scheduling.** At each boundary the
  :class:`SlotScheduler` evicts finished sequences (EOS, budget,
  deadline) and seats queued ones (tier-ordered, tenant-fair,
  page-aware), preempting lower tiers when a higher one cannot seat. A
  preempted sequence requeues with its tokens; its re-seat prefills
  prompt + emitted-minus-last and continues the same sampling stream,
  so its output equals an uninterrupted run's.
- **Lane independence.** A slot's row arithmetic does not depend on the
  other rows, and each row samples under its own key (``inference/
  sampler.py``'s :func:`row_keys` of (seed, uid, position)), so a
  request's tokens do not depend on the batch, the page size or the
  chunk size, and greedy tokens equal the sequential ``Generator``'s.
- **Host routing.** Page tables, write heads, last tokens and keys are
  host numpy, shipped each iteration as one small tensor with one copy
  to the card; the engine reads the card once an iteration, for the
  sampled tokens (and, on the legacy path, once per admission for its
  first token: the TTFT point). ``device_reads`` counts those reads.
  The step's shapes never change, so a CUDA graph can capture it later
  (ROADMAP.md queue B).

The attention of both paths is the plain product JAX's serving runs
(``_paged_decode_attend`` and ``_decode_attend``, no Pallas kernel): no
kernel of the port is on this path.

Telemetry (TTFT / TPOT / throughput / queue depth / KV utilization) goes
through :class:`ServeTelemetry` onto the flight recorder, and every
request carries its latency ledger (``serving/ledger.py``), audited for
conservation at each completion. :meth:`dump_flight` writes a record the
``flight_report`` tools render. ``trace=`` draws the engine on a
:class:`~distributed_training_tpu_torch.observability.trace.TraceSession`:
decode spans on an ``engine`` track, one track a slot with each
request's queued → prefill (chunks) → decode spans, queue marks.

Not ported yet (ROADMAP.md A9 (b) and (c)), refused away from their
defaults with ``NotImplementedError``: the prefix cache, speculative
decoding, int8 weights, int8 KV pages, the journal and
:meth:`recover`, the hot swap (:meth:`validate_swap`, :meth:`arm_swap`,
:meth:`rollback`), SLO rules and incident bundles. With no rules the
``alerts_*`` counts are 0, as in JAX.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.inference.sampler import (
    SampleConfig,
    cache_budget,
    check_unsharded,
    row_keys,
    sample_rows,
    stream_key,
)
from distributed_training_tpu_torch.parallel.ring_attention import PagedKV
from distributed_training_tpu_torch.serving.ledger import (
    CAUSE_CANCELLED,
    CAUSE_DECODE,
    CAUSE_JOURNAL_ADMIT,
    CAUSE_PREEMPT_REQUEUE,
    CAUSE_PREFILL,
    CAUSE_QUEUE_WAIT,
    CAUSE_RECOMPUTE,
    LEDGER_CAUSES,
)
from distributed_training_tpu_torch.serving.metrics import ServeTelemetry
from distributed_training_tpu_torch.serving.pages import PagePool, pages_for
from distributed_training_tpu_torch.serving.queue import RequestQueue
from distributed_training_tpu_torch.serving.request import (
    FINISH_CANCELLED,
    FINISH_PREEMPT_TIMEOUT,
    FINISH_SHED,
    FINISH_TIMEOUT,
    ActiveSequence,
    FinishedRequest,
    Request,
)
from distributed_training_tpu_torch.serving.scheduler import SlotScheduler
from distributed_training_tpu_torch.serving.timeseries import (
    TIMESERIES_DUMP_SAMPLES,
    TelemetryRing,
)

# The empty alert engine's JSON view (JAX's ``AlertEngine([]).to_dict()``):
# the flight dump's ``alerts`` section with no rules configured.
_NO_ALERTS = {"format_version": 1, "rules": [], "fired": 0, "cleared": 0,
              "active": [], "log_dropped": 0, "log": []}


def unported_serve_fields(cfg: ServeConfig) -> dict[str, bool]:
    """The ``ServeConfig`` options the port lacks, each with whether
    ``cfg`` sets it away from its default."""
    return {
        "prefix_cache (the radix-tree prefix cache, A9 (b))": cfg.prefix_cache,
        "spec_k > 0 (speculative decoding, A9 (b))": cfg.spec_k > 0,
        "quantize_weights (int8 weights, A9 (b))": cfg.quantize_weights,
        "kv_dtype (int8 KV pages, A9 (b))": cfg.kv_dtype is not None,
        "journal_dir (the request journal and recovery, A9 (b))":
            cfg.journal_dir is not None,
        "slo_rules (SLO alerting, A9 (c))": cfg.slo_rules is not None,
        "incident_dir (incident bundles, A9 (c))": cfg.incident_dir is not None,
    }


def refuse_unported_serve(cfg: ServeConfig) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md for every option of
    ``cfg`` set to a behaviour the port lacks."""
    bad = [k for k, v in unported_serve_fields(cfg).items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported yet (see ROADMAP.md): {', '.join(bad)}")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md, A9 (b))")


class Engine:
    """Continuous-batching serving engine for a ``TransformerLM``.

    >>> eng = Engine(model, ServeConfig(max_batch=8))
    >>> eng.submit(prompt_tokens)
    >>> done = eng.run()          # list[FinishedRequest]
    >>> eng.stats()               # SLA summary dict

    The model serves on the device its weights are on, in eval mode.
    Thread model: ``submit`` and ``cancel`` are safe from any thread (the
    queue locks); ``step``/``run`` belong to one serving thread.
    """

    def __init__(self, model: Any, cfg: ServeConfig, *, trace=None,
                 weights_epoch: int = -1):
        check_unsharded(model)
        refuse_unported_serve(cfg)
        self.cfg = cfg
        self.trace = trace
        self.model = model.eval()
        self.device = model.pos_embed.device
        self.budget = cache_budget(model, cfg.max_len)
        if self.budget < 2:
            raise ValueError(
                f"cache budget {self.budget} cannot hold a prompt token "
                f"plus a generated token")
        self.paged = cfg.kv_page_size is not None
        self.weights_epoch = int(weights_epoch)
        self.sample_cfg = SampleConfig(
            max_new_tokens=cfg.max_new_tokens,
            temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p,
            eos_id=cfg.eos_id, pad_id=cfg.pad_id)
        # Reads of the card (the per-iteration token landing, and the
        # legacy path's first-token read per admission).
        self.device_reads = 0

        s = cfg.max_batch
        if self.paged:
            ps = int(cfg.kv_page_size)
            self.page_size = ps
            self.pages_per_slot = pages_for(self.budget, ps)
            self.pool_pages = (int(cfg.kv_pages) if cfg.kv_pages is not None
                               else s * self.pages_per_slot)
            self.pool = PagePool(self.pool_pages, ps)
            # A chunk wider than the longest admissible prompt is padding.
            self.prefill_chunk = min(int(cfg.prefill_chunk),
                                     max(self.budget - 1, 1))
        else:
            self.page_size = None
            self.pool = None
        self.queue = RequestQueue(
            self.budget, default_max_new_tokens=cfg.max_new_tokens,
            max_depth=cfg.max_queue_depth,
            ttft_deadline_ms=cfg.ttft_deadline_ms,
            deadline_ms=cfg.deadline_ms, trace=trace,
            page_size=self.page_size,
            pool_pages=self.pool_pages if self.paged else None,
            num_tiers=cfg.num_tiers, tenant_quota=cfg.tenant_quota,
            tenant_weights=cfg.tenant_weights)
        self.scheduler = SlotScheduler(
            s, reserved_slots=cfg.tier_reserved_slots, preempt=cfg.preempt)
        self._drained = False
        # Overload latch for /healthz: the last admission pass left work
        # queued that could not seat.
        self._overloaded = False
        self.telemetry = ServeTelemetry(cfg.ring_size, num_tiers=cfg.num_tiers)
        # The control room's sample ring (iteration cadence), built always;
        # flight snapshots and dumps carry it.
        self.timeseries = TelemetryRing(cfg.timeseries_capacity,
                                        cfg.sample_every)
        self._iteration = 0
        # The front door's per-iteration token listener and its cursors.
        self._token_listener = None
        self._stream_cursor: dict[int, int] = {}
        # Cancellation marks from handler threads, consumed at step start.
        self._cancel_lock = threading.Lock()
        self._cancel_uids: set[int] = set()

        with torch.no_grad():
            if self.paged:
                # Device state: only the pool (batch-free). Slot routing is
                # host numpy, shipped each iteration.
                self._cache = model.init_paged_cache(self.pool_pages + 1, ps,
                                                     device=self.device)
                self._tables = np.zeros((s, self.pages_per_slot), np.int64)
                self._slot_key = np.zeros((s,), np.int64)
                self._slot_pages: list[list[int]] = [[] for _ in range(s)]
                self._slot_commit_left = [0] * s
            else:
                # Slot-axis device state: the cache with a write head a
                # row, each slot's last token and sampling stream.
                self._cache = model.init_cache(s, self.budget, device=self.device)
                self._cache.index = torch.zeros(s, dtype=torch.long, device=self.device)
                self._tok = torch.zeros(s, dtype=torch.long, device=self.device)
                self._keys = torch.zeros(s, dtype=torch.long, device=self.device)
        self.telemetry.on_weight_quant(0.0, 0)
        self.telemetry.set_kv_bytes_per_token(self._kv_bytes_per_token())

    def _kv_bytes_per_token(self) -> float:
        """Device-cache bytes per storable token position: the pool over
        its physical rows (null page included), or the slot cache over
        slots × budget."""
        if self.paged:
            rows = (self.pool_pages + 1) * self.page_size
        else:
            rows = self.cfg.max_batch * self.budget
        return self._cache.nbytes / max(rows, 1)

    # -- device pieces: paged KV + chunked prefill ---------------------------
    def _decode_step(self, d_tok, d_pos, d_valid, d_keys, tables):
        """One token for every slot through the paged pool: ``d_tok``,
        ``d_pos``, ``d_valid`` ``[B, 1]``, ``d_keys`` ``[B]`` (each slot's
        stream), ``tables`` ``[B, pages_per_slot]``. Invalid rows compute
        (static shapes) but write the null page and sample ``pad_id``.
        Returns the tokens ``[B, 1]``."""
        logits = self.model(d_tok, d_pos, cache=self._cache,
                            pages=PagedKV(tables, d_pos, d_valid))
        b, w, v = logits.shape
        keys = row_keys(d_keys[:, None].expand(b, w), d_pos)
        t = sample_rows(logits.reshape(b * w, v), keys.reshape(-1),
                        self.sample_cfg).reshape(b, w)
        return torch.where(d_valid, t, torch.full_like(t, self.sample_cfg.pad_id))

    def _chunk_step(self, c_tok, c_pos, c_valid, c_table, c_key):
        """One prefill chunk ``[1, C]`` of the oldest prefilling slot: its
        K/V through the slot's page table (padding rows write the null
        page) and a candidate token a row under ``(uid, position)``; the
        host keeps the last valid row's as the first token when the chunk
        is final, the row and key a whole-prompt prefill would use."""
        pos = c_pos[None]
        logits = self.model(c_tok[None], pos, cache=self._cache,
                            pages=PagedKV(c_table, pos, c_valid[None]))
        keys = row_keys(c_key.expand(c_pos.shape[0]), c_pos)
        return sample_rows(logits[0], keys, self.sample_cfg)

    # -- host-side lifecycle -------------------------------------------------
    def submit(self, prompt, max_new_tokens: int | None = None,
               arrival_t: float | None = None, priority: int = 0,
               tenant: str = "default",
               deadline_ms: float | None = None,
               trace_id: str | None = None) -> Request:
        """Enqueue a request (thread-safe). ``priority`` is its SLO tier
        (0 = highest, < ``cfg.num_tiers``), ``tenant`` its fairness
        principal, ``deadline_ms`` a per-request total deadline overriding
        the configured one. Raises ``CacheBudgetError`` when it can never
        fit a slot's page table (or the legacy budget), and the queue's
        typed ``QueueFullError`` / ``DrainingError``."""
        return self.queue.submit(prompt, max_new_tokens=max_new_tokens,
                                 arrival_t=arrival_t, priority=priority,
                                 tenant=tenant, deadline_ms=deadline_ms,
                                 trace_id=trace_id)

    @property
    def idle(self) -> bool:
        return (len(self.queue) == 0 and self.scheduler.num_active == 0
                and not self.queue.has_shed_pending)

    def _bucket(self, n: int) -> int:
        b = self.cfg.prefill_bucket
        return min(self.budget, -(-n // b) * b)

    def _req_pages(self, req: Request) -> int:
        """Worst-case page commitment: prompt + completion budget,
        page-rounded (the last emitted token is never written back)."""
        return pages_for(req.prompt.size + req.max_new_tokens, self.page_size)

    def _ensure_pages(self, slot: int, tokens: int) -> None:
        """Grow ``slot``'s page table to cover ``tokens`` positions, from
        the slot's commitment."""
        need = pages_for(tokens, self.page_size)
        have = len(self._slot_pages[slot])
        if need > have:
            new = self.pool.alloc(need - have)
            for i, p in enumerate(new):
                self._tables[slot, have + i] = p
            self._slot_pages[slot].extend(new)
            self._slot_commit_left[slot] -= len(new)

    def _free_slot_pages(self, slot: int) -> None:
        """Release a slot's pages and its unused commitment (finish,
        deadline eviction, cancellation or preemption). The pages keep
        their stale K/V until reused; the causal mask hides them."""
        self.pool.free(self._slot_pages[slot],
                       uncommit=max(self._slot_commit_left[slot], 0))
        self._slot_pages[slot] = []
        self._slot_commit_left[slot] = 0
        self._tables[slot, :] = 0

    def check_balanced(self) -> None:
        """Leak audit at the drained steady state: every pool page free,
        nothing committed (a no-op on the legacy path)."""
        if self.pool is not None:
            self.pool.check_balanced()

    # -- latency ledger (serving/ledger.py) ----------------------------------
    @staticmethod
    def _phase_cause(seq: ActiveSequence) -> str:
        """The cause an in-slot sequence's current span bills to."""
        if seq.prefilling:
            return (CAUSE_RECOMPUTE
                    if seq.preempts or seq.resume_prefix is not None
                    else CAUSE_PREFILL)
        return CAUSE_DECODE

    @staticmethod
    def _finish_cause(fin: FinishedRequest) -> str:
        """The cause of a completed request's terminal span: queue-side
        evictions were waiting (a first wait or a requeue), slot
        evictions were serving."""
        led = fin.ledger
        if fin.slot is None:
            if led is not None and led.intervals and \
                    led.intervals[-1][0] not in (CAUSE_QUEUE_WAIT,
                                                 CAUSE_JOURNAL_ADMIT):
                return CAUSE_PREEMPT_REQUEUE
            return CAUSE_QUEUE_WAIT
        if led is not None and led.intervals and \
                led.intervals[-1][0] == CAUSE_RECOMPUTE:
            return CAUSE_RECOMPUTE
        if fin.first_token_t is None:
            return CAUSE_PREFILL
        return CAUSE_DECODE

    @staticmethod
    def _bill_prefill(seq: ActiveSequence, n: int) -> int:
        """Ledger token attribution of ``n`` positions a prefill wrote:
        the part that re-writes freed positions (the sequence's recompute
        debt) bills to ``recompute``, the rest to ``prefill``; returns the
        recomputed count."""
        led = seq.request.ledger
        rec = min(n, seq.recompute_owed)
        seq.recompute_owed -= rec
        seq.recovery_owed = min(seq.recovery_owed, seq.recompute_owed)
        if led is not None:
            if rec:
                led.add_tokens(CAUSE_RECOMPUTE, rec)
            if n - rec:
                led.add_tokens(CAUSE_PREFILL, n - rec)
        return rec

    # -- tier-aware admission (shared by both step paths) --------------------
    @staticmethod
    def _queue_evict_finish(entry, reason: str) -> FinishedRequest:
        """Complete an entry evicted from the queue: a fresh request
        carries nothing; a requeued resumption keeps its tokens."""
        if isinstance(entry, ActiveSequence):
            return FinishedRequest.from_active(entry, reason, slot=None)
        return FinishedRequest.rejected_in_queue(entry, reason)

    def _expire_queue(self, finished: list, now: float) -> None:
        """Deadline sweep before admission: a queued entry past its TTFT
        or total deadline completes with ``timeout`` (fresh) or
        ``preempted_timeout`` (a resumption) without a prefill."""
        for entry in self.queue.pop_expired(now):
            finished.append(self._queue_evict_finish(
                entry, FINISH_PREEMPT_TIMEOUT
                if isinstance(entry, ActiveSequence) else FINISH_TIMEOUT))

    def cancel(self, uid: int) -> None:
        """Mark ``uid`` for cancellation (thread-safe, non-blocking); the
        next step evicts it wherever it is, with reason ``cancelled``.
        Unknown or finished uids are dropped."""
        with self._cancel_lock:
            self._cancel_uids.add(int(uid))

    def _cancel_pass(self, finished: list) -> None:
        """Consume the cancellation marks (engine thread, step start), in
        uid order."""
        with self._cancel_lock:
            if not self._cancel_uids:
                return
            uids, self._cancel_uids = sorted(self._cancel_uids), set()
        for uid in uids:
            entry = self.queue.remove_uid(uid)
            if entry is not None:
                finished.append(self._queue_evict_finish(entry, FINISH_CANCELLED))
                continue
            seq = self.scheduler.evict_uid(uid)
            if seq is not None:
                # Free now: admission follows in this step and may re-seat
                # the slot; slot=None keeps the finish sweep from freeing
                # twice.
                if self.paged:
                    self._free_slot_pages(seq.slot)
                finished.append(FinishedRequest.from_active(
                    seq, FINISH_CANCELLED, slot=None))

    def _admit_pass(self, finished: list) -> list[ActiveSequence]:
        """One tier-aware admission pass: complete pending shed victims,
        then seat candidates, preempting lower tiers when a higher one
        cannot otherwise seat. Returns the newly seated sequences.

        Paged gate: a candidate seats only when the pool can commit its
        worst case, and a non-top tier only when that leaves
        ``tier_reserved_pages`` of headroom (waived on an idle pool)."""
        for entry in self.queue.take_shed():
            finished.append(self._queue_evict_finish(entry, FINISH_SHED))

        def request_of(entry) -> Request:
            return entry.request if isinstance(entry, ActiveSequence) else entry

        def can_seat(entry) -> bool:
            if not self.paged:
                return True
            req = request_of(entry)
            n_pages = self._req_pages(req)
            headroom = self.cfg.tier_reserved_pages if req.priority > 0 else 0
            if headroom and self.pool.committed == 0 \
                    and self.scheduler.num_active == 0:
                headroom = 0
            if not self.pool.can_commit(n_pages):
                return False
            if headroom and self.pool.available - n_pages < headroom:
                return False
            return True

        def on_seat(seq: ActiveSequence) -> None:
            req = seq.request
            if self.paged:
                slot = seq.slot
                worst = self._req_pages(req)
                self.pool.commit(worst)
                self._slot_pages[slot] = []
                self._slot_commit_left[slot] = worst
                self._tables[slot, :] = 0
                seq.prefill_pos = 0
                self._slot_key[slot] = stream_key(self.cfg.seed, req.uid)

        def on_preempt(seq: ActiveSequence) -> None:
            # Recompute debt: the positions the eviction frees and the
            # re-seat prefills again. A resumption preempted mid-re-prefill
            # has written only prefill_pos positions this seat.
            recompute = (seq.prefill_pos if seq.prefilling
                         else seq.request.prompt.size + len(seq.tokens) - 1)
            if seq.request.ledger is not None:
                seq.request.ledger.stamp(self._phase_cause(seq),
                                         time.perf_counter())
            seq.recompute_owed += recompute
            if self.paged:
                self._free_slot_pages(seq.slot)
            self.telemetry.on_preempted(recompute, seq.request.priority)
            if self.trace is not None:
                self.trace.instant(
                    "request.preempted", track=f"slot {seq.slot}",
                    uid=seq.request.uid, trace=seq.request.trace_id,
                    tier=seq.request.priority,
                    tokens_emitted=len(seq.tokens),
                    # graftlint: disable=hot-path-transfer -- host int for a JSON trace arg (prompt.size/prefill_pos arithmetic, no device value)
                    recompute_tokens=int(recompute))

        def preempt_helps(entry, victims) -> bool:
            # The futility bound: would evicting every strictly-lower-tier
            # active sequence ever let this candidate seat? Legacy: a
            # freed slot is all it needs. Paged: the victims' pages and
            # unused commitments must cover its worst case plus the
            # reserved headroom, or preemption would evict best-effort
            # work for nothing.
            if not self.paged:
                return True
            req = request_of(entry)
            freeable = sum(len(self._slot_pages[v.slot])
                           + max(self._slot_commit_left[v.slot], 0)
                           for v in victims)
            headroom = self.cfg.tier_reserved_pages if req.priority > 0 else 0
            return self.pool.available + freeable >= self._req_pages(req) + headroom

        seated = self.scheduler.admit(
            self.queue, can_seat, on_seat=on_seat, on_preempt=on_preempt,
            preempt_helps=preempt_helps)
        self._overloaded = len(self.queue) > 0
        return seated

    @torch.no_grad()
    def _prefill_request(self, seq: ActiveSequence) -> None:
        """Legacy path: one bucketed batch-1 prefill copied into the slot.

        The pad positions' K/V are zeroed and the head set to the true
        length, so the slot holds what an unpadded prefill would leave. A
        resumption prefills prompt + emitted-minus-last; its sample at the
        last position recomputes the last emitted token (same row, same
        key), which is not emitted again."""
        req = seq.request
        toks = seq.prefill_tokens
        n = toks.size
        lb = self._bucket(n)
        padded = np.full((2, lb), self.sample_cfg.pad_id, np.int64)
        padded[0, :n] = toks
        padded[1] = np.arange(lb)
        routed = torch.from_numpy(padded).to(self.device)
        single = self.model.init_cache(1, self.budget, device=self.device)
        logits = self.model(routed[:1], routed[1:], cache=single)
        key = stream_key(self.cfg.seed, req.uid)
        keys = torch.full((1,), key, dtype=torch.long, device=self.device)
        tok = sample_rows(logits[0, n - 1:n], row_keys(keys, routed[1, n - 1:n]),
                          self.sample_cfg)
        slot = seq.slot
        for big, small in zip((*self._cache.keys, *self._cache.values),
                              (*single.keys, *single.values)):
            small[:, n:] = 0
            big[slot] = small[0]
        self._cache.index[slot] = n
        self._tok[slot] = tok[0]
        self._keys[slot] = key
        seq.prefill_pos = n
        self._bill_prefill(seq, n)
        led = req.ledger
        if seq.tokens:
            # Resumed mid-decode: no new token; bill the re-prefill to
            # 'recompute' and decode on.
            if led is not None:
                led.stamp(CAUSE_RECOMPUTE, time.perf_counter())
            return
        self.device_reads += 1
        # graftlint: disable=hot-path-transfer -- the one deliberate sync: TTFT is measured here
        first = int(tok.cpu()[0])
        self._note_first_token(seq, first, time.perf_counter())

    def _note_first_token(self, seq: ActiveSequence, first: int, t: float) -> None:
        """First-token bookkeeping, the TTFT point: queueing (arrival →
        seat) and prefill (seat → first token), the same endpoints the
        trace spans carry."""
        req = seq.request
        seq.note_token(first, t)
        self.telemetry.on_tokens(1, t)
        if req.ledger is not None:
            req.ledger.stamp(
                CAUSE_RECOMPUTE
                if seq.preempts or seq.resume_prefix is not None
                else CAUSE_PREFILL, t)
            req.ledger.add_tokens(CAUSE_DECODE, 1)
        self.telemetry.on_admitted((seq.seated_t - req.arrival_t) * 1e3,
                                   (t - seq.seated_t) * 1e3)
        if self.trace is not None:
            track = f"slot {seq.slot}"
            self.trace.complete("queued", req.arrival_t, seq.seated_t,
                                track=track, uid=req.uid, trace=req.trace_id)
            self.trace.complete("prefill", seq.seated_t, t, track=track,
                                uid=req.uid, trace=req.trace_id,
                                prompt_len=int(req.prompt.size))
            self.trace.instant("first_token", track=track, t=t,
                               uid=req.uid, trace=req.trace_id,
                               t_arrival=req.arrival_t, t_first_token=t)

    def _land_decode(self, decoding: list[ActiveSequence], toks: np.ndarray,
                     t: float) -> int:
        """Each decoding slot emits its token; returns the count."""
        for seq in decoding:
            seq.note_token(toks[seq.slot], t)
            led = seq.request.ledger
            if led is not None:
                led.stamp(CAUSE_DECODE, t)
                led.add_tokens(CAUSE_DECODE, 1)
        return len(decoding)

    # -- the hot swap and recovery: not ported -------------------------------
    def validate_swap(self, *args, **kwargs) -> None:
        raise _not_ported("the live weight hot swap (validate_swap)")

    def arm_swap(self, *args, **kwargs) -> None:
        raise _not_ported("the live weight hot swap (arm_swap)")

    def rollback(self) -> int:
        raise _not_ported("the live weight hot swap (rollback)")

    def recover(self) -> dict[str, Any]:
        raise _not_ported("journal recovery (Engine.recover)")

    # -- the iteration -------------------------------------------------------
    def step(self) -> list[FinishedRequest]:
        """One engine iteration: admit (+ chunk prefill), decode, evict.
        Returns the requests that finished in it; safe to call idle."""
        with torch.no_grad():
            return self._step_paged() if self.paged else self._step_legacy()

    def _route_paged(self, decoding: list[ActiveSequence],
                     chunk_seq: ActiveSequence | None, c: int) -> np.ndarray:
        """The iteration's routing, packed into one long array (one copy to
        the card): the decode lane's tokens, positions, validity and keys
        ``[B]`` and tables ``[B, P]``; with a chunk, its tokens, positions
        and validity ``[C]``, table ``[P]`` and key. A valid row never maps
        to the null page."""
        s, p = self.cfg.max_batch, self.pages_per_slot
        cw = self.prefill_chunk if chunk_seq is not None else 0
        buf = np.zeros(4 * s + s * p + (3 * cw + p + 1 if cw else 0), np.int64)
        d_tok, d_pos, d_valid, d_key = (buf[i * s:(i + 1) * s] for i in range(4))
        d_tok[:] = self.sample_cfg.pad_id
        buf[4 * s:4 * s + s * p] = self._tables.reshape(-1)
        ps = self.page_size
        for seq in decoding:
            pos = seq.request.prompt.size + len(seq.tokens) - 1
            d_tok[seq.slot] = seq.tokens[-1]
            d_pos[seq.slot] = pos
            d_valid[seq.slot] = 1
            assert self._tables[seq.slot, pos // ps] != 0, "a valid row maps to the null page"
        d_key[:] = self._slot_key
        if cw:
            at = 4 * s + s * p
            c_tok, c_pos, c_valid = (buf[at + i * cw:at + (i + 1) * cw] for i in range(3))
            start = chunk_seq.prefill_pos
            c_tok[:] = self.sample_cfg.pad_id
            c_tok[:c] = chunk_seq.prefill_tokens[start:start + c]
            c_pos[:c] = np.arange(start, start + c)
            c_valid[:c] = 1
            buf[at + 3 * cw:at + 3 * cw + p] = self._tables[chunk_seq.slot]
            buf[-1] = self._slot_key[chunk_seq.slot]
            assert self._tables[chunk_seq.slot, (start + c - 1) // ps] != 0, \
                "a valid chunk row maps to the null page"
        return buf

    def _run_paged(self, buf: np.ndarray, chunked: bool) -> np.ndarray:
        """Ship the routing, run the fused (chunk, then decode) or the
        decode-only step, and land the sampled tokens: the decode lane's
        ``[B]``, then the chunk's ``[C]`` (one read of the card)."""
        s, p = self.cfg.max_batch, self.pages_per_slot
        dev = torch.from_numpy(buf).to(self.device)
        d_tok, d_pos, d_valid, d_key = (dev[i * s:(i + 1) * s] for i in range(4))
        tables = dev[4 * s:4 * s + s * p].view(s, p)
        outs = []
        if chunked:
            cw, at = self.prefill_chunk, 4 * s + s * p
            c_tok, c_pos, c_valid = (dev[at + i * cw:at + (i + 1) * cw] for i in range(3))
            c_table = dev[at + 3 * cw:at + 3 * cw + p].view(1, p)
            # The chunk's slot is not decoding: the two lanes touch
            # disjoint pages, and the order is JAX's.
            outs.append(self._chunk_step(c_tok, c_pos, c_valid.bool(), c_table, dev[-1:]))
        nxt = self._decode_step(d_tok[:, None], d_pos[:, None], d_valid.bool()[:, None],
                                d_key, tables)
        self.device_reads += 1
        # graftlint: disable=hot-path-transfer -- THE per-iteration sync: tokens must land
        return torch.cat([nxt.reshape(-1), *outs]).cpu().numpy()

    def _step_paged(self) -> list[FinishedRequest]:
        it = self._iteration
        self._iteration += 1
        eos = self.sample_cfg.eos_id
        deadlines = (self.cfg.ttft_deadline_ms is not None
                     or self.cfg.deadline_ms is not None)
        finished: list[FinishedRequest] = []
        if deadlines:
            self._expire_queue(finished, time.perf_counter())
        self._cancel_pass(finished)

        had_work = not self.idle
        if had_work:
            self.telemetry.begin_work()
        # Seating costs no device work: the prompt (or a resumption's
        # carried prefix) prefills chunk by chunk below.
        self._admit_pass(finished)
        blocked_t0 = time.perf_counter() if len(self.queue) > 0 else None

        active_seqs = self.scheduler.active()
        decoding = [q for q in active_seqs if not q.prefilling]
        prefilling = [q for q in active_seqs if q.prefilling]
        # Oldest prefilling request first: one chunk per iteration.
        chunk_seq = min(prefilling, key=lambda q: q.request.uid, default=None)

        if chunk_seq is not None or decoding:
            t_step0 = time.perf_counter()
            for seq in decoding:
                # This iteration writes position prompt + emitted - 1.
                self._ensure_pages(
                    seq.slot, seq.request.prompt.size + len(seq.tokens))
            c = 0
            if chunk_seq is not None:
                # prefill_tokens is the prompt, or for a resumption prompt
                # + emitted-minus-last: the positions the preemption freed.
                start = chunk_seq.prefill_pos
                c = min(self.prefill_chunk, chunk_seq.prefill_tokens.size - start)
                self._ensure_pages(chunk_seq.slot, start + c)
            landed = self._run_paged(self._route_paged(decoding, chunk_seq, c),
                                     chunk_seq is not None)
            t = time.perf_counter()
            emitted = self._land_decode(decoding, landed, t)
            self.telemetry.on_decode(lanes=len(decoding), tokens=emitted)
            self.telemetry.on_tokens(emitted, t)
            if chunk_seq is not None:
                start = chunk_seq.prefill_pos
                chunk_seq.prefill_pos = start + c
                rec = self._bill_prefill(chunk_seq, c)
                led = chunk_seq.request.ledger
                if led is not None:
                    led.stamp(CAUSE_RECOMPUTE if rec * 2 >= c else CAUSE_PREFILL, t)
                if self.trace is not None:
                    self.trace.complete(
                        "prefill_chunk", t_step0, t,
                        track=f"slot {chunk_seq.slot}",
                        trace=chunk_seq.request.trace_id,
                        uid=chunk_seq.request.uid, start=start, tokens=c)
                if (chunk_seq.prefill_pos == chunk_seq.prefill_tokens.size
                        and not chunk_seq.tokens):
                    # Final chunk of a fresh prefill: its last valid row is
                    # the first token. (A resumption's final chunk
                    # recomputes its last emitted token: nothing lands.)
                    first = landed[self.cfg.max_batch + c - 1]
                    self._note_first_token(chunk_seq, first, t)
            # KV utilization, host-side only.
            counted = decoding + ([chunk_seq] if chunk_seq is not None else [])
            reserved = sum(len(self._slot_pages[q.slot]) for q in counted) * self.page_size
            written = sum(q.request.prompt.size + len(q.tokens) - 1 for q in decoding)
            if chunk_seq is not None:
                written += chunk_seq.prefill_pos
            self.telemetry.on_kv(
                reserved=reserved, written=written, active=len(counted),
                slots=self.cfg.max_batch,
                pages_allocated=self.pool.num_allocated,
                pages_total=self.pool.num_pages)
            if blocked_t0 is not None:
                self.telemetry.on_admission_blocked(t - blocked_t0)
            if self.trace is not None:
                self.trace.complete("decode", t_step0, t, track="engine",
                                    iteration=it, active=len(decoding),
                                    prefill_chunk=c)
                self.trace.counter("active_slots", len(counted))
                self.trace.counter("kv_written_tokens", written)
                self.trace.counter("kv_pages_allocated", self.pool.num_allocated)
            finished.extend(self.scheduler.evict_finished(
                eos, now=t if deadlines else None))

        return self._finish_iteration(it, had_work, finished)

    def _step_legacy(self) -> list[FinishedRequest]:
        it = self._iteration
        self._iteration += 1
        eos = self.sample_cfg.eos_id
        deadlines = (self.cfg.ttft_deadline_ms is not None
                     or self.cfg.deadline_ms is not None)
        finished: list[FinishedRequest] = []
        if deadlines:
            self._expire_queue(finished, time.perf_counter())
        self._cancel_pass(finished)

        had_work = not self.idle
        if had_work:
            self.telemetry.begin_work()
        for seq in self._admit_pass(finished):
            self._prefill_request(seq)
        # A one-token budget or an instant EOS never joins a decode step.
        finished.extend(self.scheduler.evict_finished(eos))
        blocked_t0 = time.perf_counter() if len(self.queue) > 0 else None

        active_seqs = self.scheduler.active()
        if active_seqs:
            t_decode = time.perf_counter()
            active = torch.from_numpy(self.scheduler.active_mask()).to(self.device)
            heads = self._cache.index
            logits = self.model(self._tok[:, None], heads[:, None], cache=self._cache)
            nxt = sample_rows(logits[:, -1], row_keys(self._keys, heads), self.sample_cfg)
            nxt = torch.where(active, nxt, torch.full_like(nxt, self.sample_cfg.pad_id))
            # Inactive lanes computed (static shapes) but keep their heads.
            self._cache.index = torch.where(active, heads + 1, heads)
            self._tok = nxt
            self.device_reads += 1
            # graftlint: disable=hot-path-transfer -- THE per-iteration sync: tokens must land
            toks = nxt.cpu().numpy()
            t = time.perf_counter()
            emitted = self._land_decode(active_seqs, toks, t)
            self.telemetry.on_decode(lanes=len(active_seqs), tokens=emitted)
            self.telemetry.on_tokens(emitted, t)
            # KV utilization, host-side only: every active slot reserves
            # the whole budget.
            written = sum(q.request.prompt.size + len(q.tokens) - 1 for q in active_seqs)
            self.telemetry.on_kv(
                reserved=len(active_seqs) * self.budget, written=written,
                active=len(active_seqs), slots=self.cfg.max_batch)
            if blocked_t0 is not None:
                self.telemetry.on_admission_blocked(t - blocked_t0)
            if self.trace is not None:
                self.trace.complete("decode", t_decode, t, track="engine",
                                    iteration=it, active=len(active_seqs))
                self.trace.counter("active_slots", len(active_seqs))
                self.trace.counter("kv_written_tokens", written)
            finished.extend(self.scheduler.evict_finished(
                eos, now=t if deadlines else None))

        return self._finish_iteration(it, had_work, finished)

    def _finish_iteration(self, it: int, had_work: bool,
                          finished: list[FinishedRequest]) -> list[FinishedRequest]:
        """Shared iteration tail: page reclamation, the token listener,
        telemetry, the ledger's terminal stamps, traces, samples."""
        if self.paged:
            for fin in finished:
                if fin.slot is not None:
                    self._free_slot_pages(fin.slot)
        if self._token_listener is not None:
            cb = self._token_listener
            for seq in self.scheduler.active():
                uid = seq.request.uid
                have = self._stream_cursor.get(uid, 0)
                if len(seq.tokens) > have:
                    cb(uid, list(seq.tokens[have:]), None)
                    self._stream_cursor[uid] = len(seq.tokens)
            for fin in finished:
                have = self._stream_cursor.pop(fin.uid, 0)
                # graftlint: disable=hot-path-transfer -- fin.tokens is the host int32 completion array by contract; no device value involved
                tail = [int(t) for t in fin.tokens[have:]]
                cb(fin.uid, tail, fin)
        if had_work:
            self.telemetry.on_iteration(it, queue_depth=len(self.queue),
                                        active=self.scheduler.num_active)
            if self.trace is not None:
                self.trace.counter("queue_depth", len(self.queue))
            if self.idle:
                self.telemetry.end_work()
        else:
            self.telemetry.on_idle()
        if finished:
            t_fin = time.perf_counter()
            for fin in finished:
                if fin.ledger is not None and not fin.ledger.closed:
                    cause = (CAUSE_CANCELLED
                             if fin.finish_reason == FINISH_CANCELLED
                             else self._finish_cause(fin))
                    fin.ledger.close(cause, t_fin)
        for fin in finished:
            self.telemetry.on_finished(fin)
            if self.trace is not None:
                self._trace_finish(fin)
        if self._iteration % self.cfg.flush_every == 0:
            self.telemetry.flush(it, len(self.queue), self.scheduler.num_active)
        if self._iteration % self.cfg.sample_every == 0:
            self._sample_telemetry(it)
        return finished

    def _sample_telemetry(self, it: int) -> None:
        """One control-room sample (iteration cadence): a flat sample of
        host-side counters and gauges into the time-series ring, with
        JAX's columns (those of unported features read 0). No device
        read, no file."""
        tm = self.telemetry
        sample: dict[str, float] = {
            "iteration": it,
            "tokens_emitted": tm.tokens_emitted,
            "requests_finished": tm.requests_finished,
            "requests_submitted": self.queue.submitted,
            "requests_shed": self.queue.shed,
            "requests_timed_out": tm.finish_reasons.get(FINISH_TIMEOUT, 0),
            "requests_preempted": tm.requests_preempted,
            "requests_preempt_timed_out":
                tm.finish_reasons.get(FINISH_PREEMPT_TIMEOUT, 0),
            "requests_recovered": tm.requests_recovered,
            "prefix_cache_hit_tokens": tm.prefix_cache_hit_tokens,
            "prefix_cache_evicted_pages": tm.prefix_cache_evicted_pages,
            "drafted_tokens": tm.tokens_drafted,
            "accepted_tokens": tm.tokens_accepted,
            "swaps_completed": tm.swaps_completed,
            "swaps_rejected": tm.swaps_rejected,
            "ledger_conservation_violations": tm.ledger_conservation_violations,
            "journal_records_written": 0,
            "journal_write_errors": 0,
            "queue_depth": len(self.queue),
            "active_slots": self.scheduler.num_active,
            "pool_occupancy": (self.pool.num_allocated / self.pool.num_pages
                               if self.paged else 0.0),
            "prefix_cache_pages_held": 0,
            "weights_epoch": self.weights_epoch,
        }
        for t in range(self.cfg.num_tiers):
            sample[f"tier{t}_requests_shed"] = self.queue.shed_by_tier[t]
            sample[f"tier{t}_requests_preempted"] = tm.tier_preempted[t]
        for c in LEDGER_CAUSES:
            sample[f"ledger_{c}_ms_total"] = tm.ledger_window_ms[c]
        for prefix, hist in (("ttft_ms", tm.ttft_hist), ("tpot_ms", tm.tpot_hist)):
            for i, n in enumerate(hist.cumulative()):
                suffix = f"{i:02d}" if i < len(hist.bounds) else "inf"
                sample[f"{prefix}_le_{suffix}"] = n
        self.timeseries.record_sample(sample)

    def _trace_finish(self, fin: FinishedRequest) -> None:
        """A request's terminal trace events: its decode span and a finish
        mark on its slot track (queue-side evictions mark the queue)."""
        if fin.slot is None:
            self.trace.instant(f"request.{fin.finish_reason}", track="queue",
                               uid=fin.uid, trace=fin.trace_id)
            return
        track = f"slot {fin.slot}"
        if (fin.first_token_t is not None and fin.last_token_t is not None
                and fin.tokens.size > 1):
            self.trace.complete("decode", fin.first_token_t, fin.last_token_t,
                                track=track, uid=fin.uid, trace=fin.trace_id,
                                tokens=int(fin.tokens.size))
        self.trace.instant(f"finish:{fin.finish_reason}", track=track,
                           t=fin.last_token_t, uid=fin.uid, trace=fin.trace_id,
                           tokens=int(fin.tokens.size))

    def run(self, max_iterations: int | None = None) -> list[FinishedRequest]:
        """Drive :meth:`step` until every queued and active request
        finishes (or ``max_iterations``); completions in finish order."""
        out: list[FinishedRequest] = []
        n = 0
        while not self.idle:
            out.extend(self.step())
            n += 1
            if max_iterations is not None and n >= max_iterations:
                break
        return out

    def drain(self, max_iterations: int | None = None) -> list[FinishedRequest]:
        """Graceful shutdown: close admission (new submits raise
        ``DrainingError``), then complete every accepted request.
        Idempotent."""
        self.queue.close()
        out = self.run(max_iterations)
        self._drained = self.idle
        return out

    def close_admission(self) -> None:
        """Close admission without driving the loop (idempotent); pair
        with :meth:`poll_drained` from the loop thread."""
        self.queue.close()

    def poll_drained(self) -> bool:
        """Latch and report drain completion: admission closed and every
        accepted request finished."""
        if self.draining and self.idle:
            self._drained = True
        return self._drained

    def reopen(self) -> None:
        """Reopen admission after a completed drain (idempotent)."""
        self.queue.reopen()
        self._drained = False

    @property
    def draining(self) -> bool:
        """True once admission has been closed."""
        return self.queue.closed

    @property
    def phase(self) -> str:
        """The /healthz lifecycle phase: serving ⇄ overloaded → draining →
        drained (idle = alive, nothing queued)."""
        if self._drained:
            return "drained"
        if self.queue.closed:
            return "draining"
        if self._overloaded and len(self.queue) > 0:
            return "overloaded"
        return "idle" if self.idle else "serving"

    def health(self) -> dict[str, Any]:
        """The /healthz extras: weights epoch, swap and degradation
        counters (JAX's keys; the journal's read 0)."""
        return {
            "weights_epoch": int(self.weights_epoch),
            "swaps_completed": self.telemetry.swaps_completed,
            "swaps_rejected": self.telemetry.swaps_rejected,
            "requests_preempted": self.telemetry.requests_preempted,
            "requests_shed": self.queue.shed,
            "queue_depth": len(self.queue),
            "requests_recovered": self.telemetry.requests_recovered,
            "journal_records_written": 0,
            "journal_fsyncs": 0,
        }

    def set_token_listener(self, listener) -> None:
        """Register (or clear) the per-iteration token listener:
        ``listener(uid, new_tokens, fin)`` on the engine thread, once per
        sequence that landed tokens (``fin=None``) and once per
        completion. It must only buffer."""
        self._token_listener = listener
        self._stream_cursor.clear()

    def stream_attach(self, uid: int):
        """Re-attach a stream to a live ``uid`` (engine thread): the tokens
        already landed (``[]`` for a queued fresh request), aligning the
        listener's cursor; None when the uid is neither seated nor queued."""
        for seq in self.scheduler.active():
            if seq.request.uid == uid:
                self._stream_cursor[uid] = len(seq.tokens)
                return [int(t) for t in seq.tokens]
        entry = self.queue.find_uid(uid)
        if entry is None:
            return None
        toks = list(entry.tokens) if isinstance(entry, ActiveSequence) else []
        self._stream_cursor[uid] = len(toks)
        return [int(t) for t in toks]

    # -- telemetry surface ---------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """The SLA summary with JAX's keys: the telemetry's, the queue's
        admission and degradation counters, and the counters of the
        unported features (0)."""
        stats = self.telemetry.stats()
        stats["queue_depth_max"] = max(stats["queue_depth_max"], self.queue.depth_max)
        stats["requests_submitted"] = self.queue.submitted
        stats["requests_rejected"] = self.queue.rejected
        stats["requests_shed"] = self.queue.shed
        for t, n in enumerate(self.queue.shed_by_tier):
            stats[f"tier{t}_requests_shed"] = n
        stats["requests_drain_rejected"] = self.queue.drain_rejected
        stats["drained"] = bool(self._drained)
        stats["journal_records_written"] = 0
        stats["journal_fsyncs"] = 0
        stats["weights_epoch"] = int(self.weights_epoch)
        stats["prefix_cache_pages_held"] = 0
        stats["alerts_fired"] = 0
        stats["alerts_cleared"] = 0
        stats["alerts_active"] = 0
        stats["incidents_captured"] = 0
        return stats

    def reset_stats(self) -> None:
        """A fresh telemetry window (after a warm-up pass, say); slot state
        and page allocations are untouched. The ledger's lifetime
        histograms and conservation audit carry over."""
        old = self.telemetry
        self.telemetry = ServeTelemetry(self.cfg.ring_size, num_tiers=self.cfg.num_tiers)
        self.telemetry.on_recovered(old.requests_recovered,
                                    old.tokens_recomputed_on_recovery)
        self.telemetry.adopt_ledger_lifetime(old)
        self.telemetry.on_weight_quant(0.0, 0)
        self.telemetry.set_kv_bytes_per_token(old.kv_bytes_per_token)
        self.queue.reset_counters()
        self.timeseries = TelemetryRing(self.cfg.timeseries_capacity,
                                        self.cfg.sample_every)
        self._iteration = 0

    def _control_room_sections(self) -> dict[str, Any]:
        """The ``alerts`` (none configured) and ``timeseries`` sections of
        flight snapshots and dumps."""
        return {"alerts": {**_NO_ALERTS, "active": [], "log": []},
                "timeseries": self.timeseries.to_dict(last_n=TIMESERIES_DUMP_SAMPLES)}

    def flight_snapshot(self, *, reason: str = "scrape") -> dict[str, Any]:
        """What a /metrics scrape serves: :meth:`dump_flight`'s record, no
        write and no flush (host state only)."""
        return self.telemetry.snapshot(reason=reason, stats=self.stats(),
                                       extra_sections=self._control_room_sections())

    def dump_flight(self, path: str, *, reason: str = "serving") -> dict[str, Any]:
        """A flight-recorder JSON dump (``tools/flight_report.py`` and the
        port's ``flight_report`` render it)."""
        self.telemetry.flush(self._iteration, len(self.queue), self.scheduler.num_active)
        return self.telemetry.dump(path, reason=reason, stats=self.stats(),
                                   extra_sections=self._control_room_sections())
