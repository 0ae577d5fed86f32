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

The serving features, each JAX's:

- **Prefix cache** (``prefix_cache``, paged only;
  ``serving/prefix_cache.py``): finished sequences' full written pages
  enter a radix trie keyed by their tokens; a seat whose prompt starts
  with a resident page-aligned chain aliases those pages into its table
  (refcounted), commits only the tail and chunk-prefills only the tail.
  A hit changes the prefill work, never a gathered value or a token.
  Every hot-swap barrier flushes the trie and bumps the KV epoch.
- **Speculative decoding** (``spec_k`` > 0; ``serving/speculative.py``):
  a drafter a slot proposes up to ``spec_k`` tokens and the decode lane
  widens to ``[max_batch, spec_k + 1]``; each row samples under its own
  (uid, position) key, so every emitted token is the non-speculative
  engine's, and the accept length is the first mismatch
  (:meth:`_accept_len`). The legacy slots run the same window with the
  write heads forced to the host's (:meth:`_verify_legacy`).
- **int8 weights** (``quantize_weights``; ``serving/quantize.py``): the
  matmul weights are quantized once, at construction and at each
  :meth:`arm_swap`, and installed in the model, whose modules dequantize
  them at use. The engine serves the model it was given: a quantizing
  engine, and every swap, replaces that model's leaves.
- **int8 KV pages** (``kv_dtype="int8"``): the pool's rows are int8
  with float32 per-row, per-head scales (``PagedCache``).
- **The journal** (``journal_dir``; ``serving/journal.py``): admissions
  are durable before :meth:`submit` returns, progress is journaled at
  the iteration tail by a writer thread, and :meth:`recover` replays it.
- **The hot swap** (:meth:`validate_swap`, :meth:`arm_swap`,
  :meth:`rollback`; ``serving/hotswap.py`` drives them): a validated
  parameter set is installed at the next iteration boundary; in-flight
  requests keep their slots, pages and streams.

The control room, JAX's: at every ``sample_every`` iterations the engine
appends a sample of host counters and gauges to its time-series ring,
evaluates the SLO rules (``slo_rules``; ``serving/alerts.py``) over it,
and hands each firing rule's incident bundle to the
:class:`IncidentWriter`'s thread (``incident_dir``), so ``step`` opens no
file. With no rules the ``alerts_*`` counts are 0. A front door
(``serving/frontend.py``) drives one engine over HTTP through
:meth:`set_token_listener`, :meth:`probe_snapshot` and the admission
methods.
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
from distributed_training_tpu_torch.resilience.errors import SwapError
from distributed_training_tpu_torch.serving.alerts import (
    AlertEngine,
    IncidentWriter,
    parse_slo_rules,
)
from distributed_training_tpu_torch.serving.journal import RequestJournal, perf_of
from distributed_training_tpu_torch.serving.ledger import (
    CAUSE_CANCELLED,
    CAUSE_DECODE,
    CAUSE_JOURNAL_ADMIT,
    CAUSE_PRE_CRASH,
    CAUSE_PREEMPT_REQUEUE,
    CAUSE_PREFILL,
    CAUSE_PREFIX_HIT,
    CAUSE_QUEUE_WAIT,
    CAUSE_RECOMPUTE,
    CAUSE_RECOVERY,
    CAUSE_SPEC_ACCEPT,
    CAUSE_SPEC_DRAFT,
    CAUSE_SPEC_ROLLBACK,
    CAUSE_SWAP_BARRIER,
    LEDGER_CAUSES,
)
from distributed_training_tpu_torch.serving.metrics import ServeTelemetry
from distributed_training_tpu_torch.serving.pages import PagePool, pages_for
from distributed_training_tpu_torch.serving.prefix_cache import PrefixCache
from distributed_training_tpu_torch.serving.quantize import (
    install_params,
    is_quantized,
    params_signature,
    quantize_params,
    quantized_param_bytes,
    serving_params,
)
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
from distributed_training_tpu_torch.serving.speculative import (
    make_drafter,
    truncate_at_eos,
)
from distributed_training_tpu_torch.serving.timeseries import (
    TIMESERIES_DUMP_SAMPLES,
    TelemetryRing,
)

class Engine:
    """Continuous-batching serving engine for a ``TransformerLM``.

    >>> eng = Engine(model, ServeConfig(max_batch=8))
    >>> eng.submit(prompt_tokens)
    >>> done = eng.run()          # list[FinishedRequest]
    >>> eng.stats()               # SLA summary dict

    The model serves on the device its weights are on, in eval mode.
    ``drafter`` replaces the speculative drafter ``cfg.spec_drafter``
    would build (needs ``spec_k`` >= 1). Thread model: ``submit`` and
    ``cancel`` are safe from any thread (the queue locks), and so are
    :meth:`arm_swap` and :meth:`rollback` (the swap lock);
    ``step``/``run`` belong to one serving thread.
    """

    def __init__(self, model: Any, cfg: ServeConfig, *, trace=None,
                 weights_epoch: int = -1, drafter=None):
        check_unsharded(model)
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
        # int8 weights (serving/quantize.py): quantized once here, and
        # again for every swap candidate at arm time on the caller's
        # thread; step only ever serves the installed set. The float32
        # signature is pinned first: swap candidates restored from
        # checkpoints arrive unquantized.
        self._quantize_weights = bool(cfg.quantize_weights)
        self._weight_quant_s = 0.0
        self._quantized_params_bytes = 0
        params = serving_params(model)
        self._fp32_signature = (params_signature(params)
                                if self._quantize_weights else None)
        if self._quantize_weights:
            t0_q = time.perf_counter()
            params = quantize_params(params)
            install_params(model, params)
            self._weight_quant_s = time.perf_counter() - t0_q
            self._quantized_params_bytes = quantized_param_bytes(params)
        self.params = params
        # Speculative decoding: a [max_batch, spec_k + 1] verify window;
        # spec_k 0 is the plain one-token step (width 1).
        self.spec_k = int(cfg.spec_k)
        self.spec_width = self.spec_k + 1
        if drafter is not None and not self.spec_k:
            raise ValueError(
                "a drafter requires spec_k >= 1 (speculation is off)")
        self.drafter = ((drafter if drafter is not None else make_drafter(cfg, model))
                        if self.spec_k else None)
        # The hot swap (serving/hotswap.py): one parameter set served at a
        # time; a staged candidate waits under the lock for the next
        # iteration boundary. The signature pinned here is what every
        # candidate must match.
        self.weights_epoch = int(weights_epoch)
        self._params_signature = params_signature(params)
        self._swap_lock = threading.Lock()
        self._pending_swap: tuple[Any, int] | None = None
        # Rollback insurance: the previously served set survives one swap.
        self._prev_params: Any = None
        self._prev_epoch: int = -1
        self.last_swap_error: SwapError | None = None
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
            # Gather width of a slot's table: verify-window padding rows
            # clamp their positions under it, so the per-row overflow
            # poison never fires on a masked row.
            self._l_all = self.pages_per_slot * ps
        else:
            if cfg.prefix_cache:
                raise ValueError(
                    "prefix_cache requires the paged KV cache "
                    "(kv_page_size): the legacy contiguous slot "
                    "reservation has no pages to alias across requests")
            self.page_size = None
            self.pool = None
            # Speculation needs spec_k slack positions past the budget:
            # the contiguous write lands all spec_k + 1 rows, padding
            # included, so a full window at the last admissible head must
            # fit, or the cache's overflow poison fires on a legal request.
            self._cache_len = self.budget + self.spec_k
            if self._cache_len > int(model.max_len):
                raise ValueError(
                    f"spec_k={self.spec_k} on the legacy contiguous "
                    f"path needs budget + spec_k <= the positional "
                    f"table (got {self.budget} + {self.spec_k} > "
                    f"{model.max_len}); lower max_len or use the paged "
                    f"cache (kv_page_size), whose window padding is "
                    f"validity-masked instead of written")
        # The radix-tree prefix cache; _kv_epoch stamps which weights
        # wrote a seat's pages (every swap barrier bumps it and flushes
        # the trie).
        self.prefix_cache = (PrefixCache(self.page_size, max_pages=cfg.prefix_cache_pages)
                             if self.paged and cfg.prefix_cache else None)
        self._kv_epoch = 0
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
        # The write-ahead request journal: admissions persist on the
        # producer thread, progress is enqueued at the iteration tail and
        # persisted by the journal's writer thread. Callers with a journal
        # run recover() before serving. The fingerprint holds what the
        # journaled streams depend on (JAX's keys).
        self.journal: RequestJournal | None = None
        if cfg.journal_dir:
            self.journal = RequestJournal(
                cfg.journal_dir, fsync=cfg.journal_fsync,
                segment_bytes=cfg.journal_segment_bytes,
                fingerprint={
                    "seed": cfg.seed, "temperature": cfg.temperature,
                    "top_k": cfg.top_k, "top_p": cfg.top_p,
                    "eos_id": cfg.eos_id, "pad_id": cfg.pad_id,
                    "quantize_weights": bool(cfg.quantize_weights),
                    "kv_dtype": cfg.kv_dtype,
                    "weights_epoch": int(weights_epoch)},
                trace=trace)
        self._recovering = False
        self.recovery_report: dict[str, Any] | None = None
        self.telemetry = ServeTelemetry(cfg.ring_size, num_tiers=cfg.num_tiers)
        # The control room (iteration cadence, never wall time): the sample
        # ring, the SLO rules evaluated at each sample, and the incident
        # writer's thread that owns the disk. A bad rule spec fails here,
        # before the engine serves.
        self.timeseries = TelemetryRing(cfg.timeseries_capacity,
                                        cfg.sample_every)
        self.alerts = AlertEngine(
            parse_slo_rules(cfg.slo_rules) if cfg.slo_rules else [])
        self.incidents: IncidentWriter | None = (
            IncidentWriter(cfg.incident_dir) if cfg.incident_dir else None)
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
                                                     device=self.device,
                                                     kv_dtype=cfg.kv_dtype)
                self._tables = np.zeros((s, self.pages_per_slot), np.int64)
                self._slot_key = np.zeros((s,), np.int64)
                self._slot_pages: list[list[int]] = [[] for _ in range(s)]
                self._slot_commit_left = [0] * s
                # Prefix-cache routing: how many leading entries of each
                # slot's page list are aliased trie pages, and the seated
                # sequence (its written tokens and KV epoch decide what
                # enters the trie at release).
                self._slot_shared = [0] * s
                self._slot_seq: list[ActiveSequence | None] = [None] * s
            else:
                # Slot-axis device state: the cache with a write head a
                # row, each slot's last token and sampling stream.
                self._cache = model.init_cache(s, self._cache_len, device=self.device)
                self._cache.index = torch.zeros(s, dtype=torch.long, device=self.device)
                self._tok = torch.zeros(s, dtype=torch.long, device=self.device)
                self._keys = torch.zeros(s, dtype=torch.long, device=self.device)
        self.telemetry.on_weight_quant(self._weight_quant_s,
                                       self._quantized_params_bytes)
        self.telemetry.set_kv_bytes_per_token(self._kv_bytes_per_token())

    def _kv_bytes_per_token(self) -> float:
        """Device-cache bytes per storable token position: the pool over
        its physical rows (null page and int8 scales included), or the
        slot cache over slots × its length."""
        if self.paged:
            rows = (self.pool_pages + 1) * self.page_size
        else:
            rows = self.cfg.max_batch * self._cache_len
        return self._cache.nbytes / max(rows, 1)

    # -- device pieces: paged KV + chunked prefill ---------------------------
    def _decode_step(self, d_tok, d_pos, d_valid, d_keys, tables):
        """One verify window for every slot through the paged pool:
        ``d_tok``, ``d_pos``, ``d_valid`` ``[B, W]`` (W = spec_k + 1; 1 is
        the plain decode step), ``d_keys`` ``[B]`` (each slot's stream),
        ``tables`` ``[B, pages_per_slot]``. Row 0 of a lane is the slot's
        incoming token, rows 1.. its drafts. Invalid rows compute (static
        shapes) but write the null page and sample ``pad_id``. Each row
        samples under (uid, position), so every row's token is the
        sequential stream's. Returns the tokens ``[B, W]`` and the accept
        lengths ``[B]``."""
        logits = self.model(d_tok, d_pos, cache=self._cache,
                            pages=PagedKV(tables, d_pos, d_valid))
        return self._sample_window(logits, d_keys, d_pos, d_tok, d_valid)

    def _sample_window(self, logits, streams, positions, tok, valid):
        """Each row's token under its (stream, position) key (``pad_id``
        on invalid rows) ``[B, W]``, and the window's accept lengths."""
        b, w, v = logits.shape
        keys = row_keys(streams[:, None].expand(b, w), positions)
        t = sample_rows(logits.reshape(b * w, v), keys.reshape(-1),
                        self.sample_cfg).reshape(b, w)
        t = torch.where(valid, t, torch.full_like(t, self.sample_cfg.pad_id))
        return t, self._accept_len(tok, t, valid)

    @staticmethod
    def _accept_len(tok: torch.Tensor, t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """``[B]`` accepted-draft counts of a verify window: the first
        draft that differs from the target's token before it (an argmax
        over the mismatch mask with a sentinel column; invalid rows
        count as mismatches, so the count never crosses the valid
        width)."""
        mismatch = (tok[:, 1:] != t[:, :-1]) | ~valid[:, 1:]
        sentinel = torch.ones((tok.shape[0], 1), dtype=torch.bool, device=tok.device)
        return torch.cat([mismatch, sentinel], dim=1).to(torch.int32).argmax(dim=1)

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
        typed ``QueueFullError`` / ``DrainingError``. With a journal the
        admission record is durable before this returns."""
        req = self.queue.submit(prompt, max_new_tokens=max_new_tokens,
                                arrival_t=arrival_t, priority=priority,
                                tenant=tenant, deadline_ms=deadline_ms,
                                trace_id=trace_id)
        if self.journal is not None:
            try:
                self.journal.log_admit(req)
            except BaseException:
                # Acceptance is journal-backed: withdraw the request if its
                # durable record failed, or a retry would duplicate it.
                self.queue.withdraw(req)
                raise
            # The synchronous admission write is the request's first
            # ledger span; the engine materializes it at its next stamp.
            if req.ledger is not None:
                req.ledger.note_admit_done(time.perf_counter())
        return req

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

    @staticmethod
    def _written_tokens(seq: ActiveSequence) -> np.ndarray:
        """The tokens of every cache position ``seq`` holds K/V for:
        ``prefill_pos`` positions while prefilling, prompt +
        emitted-minus-last once decoding. The trie's insertion key: K/V
        at position ``i`` is a function of tokens ``0..i``."""
        if seq.prefilling:
            # graftlint: disable=hot-path-transfer -- prefill_tokens is host numpy by contract (the prompt / resume prefix); no device value involved
            return np.asarray(seq.prefill_tokens[:seq.prefill_pos], np.int32)
        # graftlint: disable=hot-path-transfer -- emitted tokens are host ints by contract (note_token casts at landing); no device value involved
        full = np.concatenate([seq.request.prompt, np.asarray(seq.tokens, np.int32)])
        return full[:seq.request.prompt.size + len(seq.tokens) - 1]

    @staticmethod
    def _hit_cap(entry) -> int:
        """The most cache positions a prefix hit may cover for ``entry``:
        a fresh request keeps one prompt position to prefill (its first
        token samples from that position's logits); a resumption that
        already emitted tokens may be covered whole (its incoming token
        is known, so it re-seats straight into decode)."""
        if isinstance(entry, ActiveSequence):
            n = entry.prefill_tokens.size
            return n if entry.tokens else n - 1
        return entry.prompt.size - 1

    def _free_slot_pages(self, slot: int) -> None:
        """Release a slot's pages and its unused commitment (finish,
        deadline eviction, cancellation or preemption). With the prefix
        cache on, the sequence's full written pages enter the trie first:
        private pages are adopted (the slot's reference becomes the
        trie's), aliased ones drop the slot's reference. Pages written
        before the last swap barrier are never indexed. The freed pages
        keep their stale K/V until reused; the causal mask hides them."""
        pages = self._slot_pages[slot]
        seq = self._slot_seq[slot]
        adopted: set[int] = set()
        if (self.prefix_cache is not None and seq is not None and pages
                and seq.kv_epoch == self._kv_epoch):
            adopted, evicted = self.prefix_cache.insert_chain(
                self._written_tokens(seq), pages, self.pool)
            if adopted or evicted:
                self.telemetry.on_prefix_pages(inserted=len(adopted), evicted=evicted)
        self.pool.free([p for p in pages if p not in adopted],
                       uncommit=max(self._slot_commit_left[slot], 0))
        self._slot_pages[slot] = []
        self._slot_shared[slot] = 0
        self._slot_commit_left[slot] = 0
        self._slot_seq[slot] = None
        self._tables[slot, :] = 0

    def check_balanced(self) -> None:
        """Leak audit at the drained steady state: every pool page free
        or, with the prefix cache, held by the trie alone with one
        reference; nothing committed (a no-op on the legacy path)."""
        if self.pool is not None:
            self.pool.check_balanced(
                cached=(self.prefix_cache.pages_held()
                        if self.prefix_cache is not None else None))

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
        worst case less its resident prefix, and a non-top tier only when
        that leaves ``tier_reserved_pages`` of headroom (waived on an idle
        pool). With the prefix cache, unreferenced trie pages are
        reclaimed oldest first under pool pressure, the candidate's own
        chain pinned."""
        for entry in self.queue.take_shed():
            finished.append(self._queue_evict_finish(entry, FINISH_SHED))
        pc = self.prefix_cache

        def request_of(entry) -> Request:
            return entry.request if isinstance(entry, ActiveSequence) else entry

        def tokens_of(entry) -> np.ndarray:
            return entry.prefill_tokens if isinstance(entry, ActiveSequence) else entry.prompt

        def probe(entry) -> list[int]:
            # Read-only trie walk: no refcount or recency effect.
            return pc.probe(tokens_of(entry), max_tokens=self._hit_cap(entry))

        def can_seat(entry) -> bool:
            if not self.paged:
                return True
            req = request_of(entry)
            hit_pages = probe(entry) if pc is not None else []
            n_pages = self._req_pages(req) - len(hit_pages)
            headroom = self.cfg.tier_reserved_pages if req.priority > 0 else 0
            if headroom and self.pool.committed == 0 \
                    and self.scheduler.num_active == 0:
                headroom = 0
            if (pc is not None and self.pool.available < n_pages + headroom
                    # Futility guard: even every trie page would not cover
                    # the commitment, so leave the trie whole.
                    and n_pages + headroom <= self.pool.available + pc.num_pages):
                evicted = pc.evict_until(self.pool, n_pages + headroom,
                                         pinned=set(hit_pages))
                if evicted:
                    self.telemetry.on_prefix_pages(evicted=evicted)
            if not self.pool.can_commit(n_pages):
                return False
            if headroom and self.pool.available - n_pages < headroom:
                return False
            return True

        def on_seat(seq: ActiveSequence) -> None:
            if not self.paged:
                return
            req = seq.request
            slot = seq.slot
            # Claim the resident prefix (a reference a page) and alias it
            # into the slot's table; commit only the tail.
            hit_pages = (pc.claim(seq.prefill_tokens, self.pool,
                                  max_tokens=self._hit_cap(seq))
                         if pc is not None else [])
            worst = self._req_pages(req)
            self.pool.commit(worst - len(hit_pages))
            self._slot_pages[slot] = list(hit_pages)
            self._slot_shared[slot] = len(hit_pages)
            self._slot_commit_left[slot] = worst - len(hit_pages)
            self._slot_seq[slot] = seq
            self._tables[slot, :] = 0
            self._tables[slot, :len(hit_pages)] = hit_pages
            hit = len(hit_pages) * self.page_size
            seq.kv_epoch = self._kv_epoch
            seq.prefix_hit_tokens = hit
            # The chunk lane starts past the resident prefix.
            seq.prefill_pos = hit
            if hit:
                # Recompute debt covered by residency (a preempted victim
                # re-seating onto its own pages, or a recovered request
                # hitting an earlier chain): each recompute counter drops
                # by what it charged, recovery's first.
                covered = min(hit, seq.recompute_owed)
                seq.recompute_owed -= covered
                rec_credit = min(covered, seq.recovery_owed)
                seq.recovery_owed -= rec_credit
                self.telemetry.on_prefix_hit(hit, restored_preempt=covered - rec_credit,
                                             restored_recovery=rec_credit)
                if req.ledger is not None:
                    req.ledger.add_tokens(CAUSE_PREFIX_HIT, hit)
                if self.trace is not None:
                    self.trace.instant("prefix_cache.hit", track=f"slot {slot}",
                                       uid=req.uid, trace=req.trace_id,
                                       tokens=hit, pages=len(hit_pages))
            self._slot_key[slot] = stream_key(self.cfg.seed, req.uid)

        def on_preempt(seq: ActiveSequence) -> None:
            if self.journal is not None:
                # Tokens first, then the preempt mark (enqueue only).
                self.journal.note_preempt(seq)
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
            # freed slot is all it needs. Paged: the victims' private
            # pages and unused commitments, plus each shared page whose
            # holders past the victims are none or the trie alone, must
            # cover its worst case less its resident prefix plus the
            # reserved headroom.
            if not self.paged:
                return True
            req = request_of(entry)
            need = self._req_pages(req)
            pinned: set[int] = set()
            if pc is not None:
                pinned = set(probe(entry))
                need -= len(pinned)
            freeable = 0
            shared_holders: dict[int, int] = {}
            for v in victims:
                shared_n = self._slot_shared[v.slot]
                freeable += (len(self._slot_pages[v.slot]) - shared_n
                             + max(self._slot_commit_left[v.slot], 0))
                for pg in self._slot_pages[v.slot][:shared_n]:
                    shared_holders[pg] = shared_holders.get(pg, 0) + 1
            for pg, held in shared_holders.items():
                if pg in pinned:
                    continue
                residual = self.pool.refcount(pg) - held
                if residual == 0 or (residual == 1 and pc is not None and pc.holds(pg)):
                    freeable += 1
            headroom = self.cfg.tier_reserved_pages if req.priority > 0 else 0
            return self.pool.available + freeable >= need + headroom

        def prefix_probe(entry) -> int:
            # Cache-aware seat order among equal-fairness tenant heads:
            # the larger resident prefix seats first.
            return len(probe(entry)) * self.page_size

        seated = self.scheduler.admit(
            self.queue, can_seat, on_seat=on_seat, on_preempt=on_preempt,
            preempt_helps=preempt_helps,
            prefix_probe=prefix_probe if pc is not None else None)
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
        single = self.model.init_cache(1, self._cache_len, device=self.device)
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

    # -- speculative decoding (serving/speculative.py) -----------------------
    def _draft_window(self, decoding: list[ActiveSequence]):
        """The iteration's ``[max_batch, spec_width]`` verify-window inputs
        (host numpy). Row 0 of a decoding slot's lane is its incoming token
        at write head ``p``; rows 1..useful its drafter's proposals at
        ``p+1..``, where ``useful = min(spec_k, remaining budget - 1,
        proposal length)``: every valid write stays inside the request's
        page commitment (paged) or budget (legacy). Padding rows are
        masked by validity; on the paged path their positions clamp under
        the table width so the per-row overflow poison cannot fire on
        them. Returns ``(tok, pos, valid, useful_by_slot, drafted)``."""
        s, w = self.cfg.max_batch, self.spec_width
        d_tok = np.full((s, w), self.sample_cfg.pad_id, np.int64)
        d_pos = np.zeros((s, w), np.int64)
        d_valid = np.zeros((s, w), bool)
        useful_by_slot: dict[int, int] = {}
        drafted = 0
        for seq in decoding:
            p = seq.request.prompt.size + len(seq.tokens) - 1
            useful = 0
            if self.spec_k:
                cap = seq.request.max_new_tokens - len(seq.tokens) - 1
                useful = min(self.spec_k, max(cap, 0))
            if useful > 0:
                # graftlint: disable=hot-path-transfer -- emitted tokens are host ints by contract; no device value involved
                ctx = np.concatenate([seq.request.prompt, np.asarray(seq.tokens, np.int32)])
                # graftlint: disable=hot-path-transfer -- drafter proposals are host numpy by protocol; this normalizes drafter output
                props = np.asarray(self.drafter.propose(ctx, self.spec_k), np.int64).reshape(-1)
                useful = min(useful, props.size)
                d_tok[seq.slot, 1:1 + useful] = props[:useful]
            d_tok[seq.slot, 0] = seq.tokens[-1]
            win_pos = p + np.arange(w)
            if self.paged:
                win_pos = np.minimum(win_pos, self._l_all - 1)
            d_pos[seq.slot] = win_pos
            d_valid[seq.slot, :useful + 1] = True
            useful_by_slot[seq.slot] = useful
            drafted += useful
        return d_tok, d_pos, d_valid, useful_by_slot, drafted

    def _apply_accepts(self, decoding: list[ActiveSequence], toks: np.ndarray,
                       accepts: np.ndarray, useful_by_slot: dict, t: float
                       ) -> tuple[int, int]:
        """Land one verify window: each slot emits its verified prefix and
        the correction or bonus token (``accept + 1`` tokens, cut at EOS:
        the sequential loop would have stopped there). The rejected
        suffix needs no device work: the host write head does not advance
        past the accepted prefix, and the next window's valid rows
        overwrite the stale K/V before any valid query attends it.
        Returns ``(tokens emitted, drafts accepted)``."""
        emitted = accepted = 0
        eos = self.sample_cfg.eos_id
        for seq in decoding:
            # graftlint: disable=hot-path-transfer -- accepts already landed host-side with the iteration sync; this indexes a numpy array
            a = int(accepts[seq.slot])
            emit = truncate_at_eos(toks[seq.slot, :a + 1], eos)
            for tk in emit:
                seq.note_token(tk, t)
            emitted += emit.size
            accepted += emit.size - 1
            led = seq.request.ledger
            if led is not None:
                led.stamp(CAUSE_DECODE, t)
                led.add_tokens(CAUSE_DECODE, emit.size)
                if self.spec_k:
                    led.add_tokens(CAUSE_SPEC_DRAFT, useful_by_slot.get(seq.slot, 0))
                    led.add_tokens(CAUSE_SPEC_ACCEPT, emit.size - 1)
            if self.trace is not None and self.spec_k:
                self.trace.instant("spec.accept", track=f"slot {seq.slot}", t=t,
                                   uid=seq.request.uid,
                                   drafted=useful_by_slot.get(seq.slot, 0),
                                   accepted=emit.size - 1)
        return emitted, accepted

    def _spec_rollback(self, decoding: list[ActiveSequence], drafted: int,
                       accepted: int, t: float) -> None:
        """The host's accept bookkeeping after tokens land: billed to each
        decoding request's ledger as ``spec_rollback`` and to the
        telemetry's rollback time."""
        t_roll = time.perf_counter()
        for seq in decoding:
            if seq.request.ledger is not None:
                seq.request.ledger.stamp(CAUSE_SPEC_ROLLBACK, t_roll)
        self.telemetry.on_spec(drafted=drafted, accepted=accepted, rollback_s=t_roll - t)

    def _verify_legacy(self, tok: np.ndarray, pos0: np.ndarray,
                       valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The verify window on the contiguous slots: ``tok``/``valid``
        ``[B, W]``, ``pos0`` ``[B]`` each lane's write head (the host's).
        Forcing the cache's heads to the host's is the speculative rewind:
        a rejected suffix never advances the head, and the next window's
        leading rows overwrite its K/V (the contiguous write lands all W
        rows, padding past every valid query: masked now, overwritten
        later). An inactive lane writes its freed slot, which the next
        admission overwrites whole. Returns the tokens ``[B, W]`` and the
        accept lengths ``[B]``, landed in one read."""
        b, w = tok.shape
        routed = torch.from_numpy(np.concatenate(
            [tok.reshape(-1), pos0, valid.reshape(-1).astype(np.int64)])).to(self.device)
        d_tok = routed[:b * w].view(b, w)
        d_pos0 = routed[b * w:b * w + b]
        d_valid = routed[b * w + b:].view(b, w).bool()
        self._cache.index = d_pos0
        positions = d_pos0[:, None] + torch.arange(w, device=self.device)
        logits = self.model(d_tok, positions, cache=self._cache)
        t, acc = self._sample_window(logits, self._keys, positions, d_tok, d_valid)
        self.device_reads += 1
        # graftlint: disable=hot-path-transfer -- THE per-iteration sync: tokens must land
        landed = torch.cat([t.reshape(-1), acc.to(t.dtype)]).cpu().numpy()
        return landed[:b * w].reshape(b, w), landed[b * w:]

    # -- the live weight hot swap (serving/hotswap.py drives this) -----------
    def validate_swap(self, params: Any, *, stage: str = "validate",
                      epoch: int | None = None) -> None:
        """Raise :class:`SwapError` unless ``params`` (a dict of parameter
        names to tensors or ``QuantizedTensor``) can serve in place of the
        current set: the same names, shapes and dtypes. A quantizing
        engine also takes the float32 set it was built from (what the
        watcher stages from checkpoints; :meth:`arm_swap` quantizes it)."""
        if not isinstance(params, dict):
            raise SwapError(
                f"swap candidate is a {type(params).__name__}, not a parameter "
                f"dict; the engine keeps its current weights "
                f"(epoch {self.weights_epoch})", stage=stage, epoch=epoch)
        sig = params_signature(params)
        if sig == self._params_signature or (
                self._fp32_signature is not None and sig == self._fp32_signature):
            return
        want = self._params_signature
        detail = (f"names {sorted(set(sig) ^ set(want))[:4]} differ from the serving model's"
                  if set(sig) != set(want) else
                  "leaf shapes/dtypes differ from the serving model")
        if self._fp32_signature is not None:
            detail += (" (matches neither the quantized serving set nor "
                       "the float32 restore set)")
        raise SwapError(
            f"swap candidate does not match the serving model's "
            f"parameters ({detail}); the engine keeps its "
            f"current weights (epoch {self.weights_epoch})",
            stage=stage, epoch=epoch)

    def arm_swap(self, params: Any, *, epoch: int) -> None:
        """Stage validated weights for the next iteration boundary
        (thread-safe; the hot-swap watcher calls this from its thread).
        The live engine is untouched until :meth:`step` installs them;
        arming again first replaces the earlier candidate. Raises
        :class:`SwapError` (``stage="arm"``) on a mismatch. The tensors
        move to the engine's device here. A quantizing engine quantizes a
        float32 candidate here, on the caller's thread, and bills the time
        to ``weight_quant_s``; a quantized one (rollback's) arms as is."""
        if isinstance(params, dict):
            params = {n: v.to(self.device) if isinstance(v, torch.Tensor) else v
                      for n, v in params.items()}
        if self._quantize_weights and isinstance(params, dict) \
                and not is_quantized(params):
            # Validate before paying for quantization.
            self.validate_swap(params, stage="arm", epoch=epoch)
            t0_q = time.perf_counter()
            params = quantize_params(params)
            dt_q = time.perf_counter() - t0_q
            self._weight_quant_s += dt_q
            self._quantized_params_bytes = quantized_param_bytes(params)
            self.telemetry.on_weight_quant(dt_q, self._quantized_params_bytes)
        self.validate_swap(params, stage="arm", epoch=epoch)
        with self._swap_lock:
            self._pending_swap = (params, int(epoch))
        if self.trace is not None:
            self.trace.instant("swap.armed", track="engine", epoch=int(epoch))

    def rollback(self) -> int:
        """Re-arm the previously served weights (the last completed swap's
        predecessor); returns their epoch. Raises :class:`SwapError`
        (``stage="rollback"``) when no swap has completed. The pair is
        read under the swap lock, then armed (``arm_swap`` takes the same
        lock)."""
        with self._swap_lock:
            prev_params, prev_epoch = self._prev_params, self._prev_epoch
        if prev_params is None:
            raise SwapError(
                "nothing to roll back to: no weight swap has completed "
                "on this engine", stage="rollback")
        self.arm_swap(prev_params, epoch=prev_epoch)
        return prev_epoch

    def note_swap_rejected(self, err: SwapError) -> None:
        """Record a swap attempt that died in the pipeline; the engine
        still serves its current weights."""
        self.last_swap_error = err
        self.telemetry.on_swap_rejected()
        if self.trace is not None:
            self.trace.instant("swap.rejected", track="engine", stage=err.stage,
                               epoch=-1 if err.epoch is None else int(err.epoch))

    def _install_params(self, params: Any) -> None:
        """The barrier's only hot-path work: point the model's leaves at
        the staged set (validated at arm; nothing is copied)."""
        install_params(self.model, params)
        self.params = params

    def _apply_pending_swap(self) -> None:
        """The iteration-boundary swap barrier: install a staged set, if
        any. In-flight requests keep their slots, KV pages and streams and
        continue on the new weights; the pause is billed to
        ``swap_blocked_s`` (and taken out of the in-flight requests' TPOT)
        and to each one's ledger as ``swap_barrier``."""
        t0 = time.perf_counter()
        # One lock section for the handoff and the install: the
        # (_prev_params, _prev_epoch) pair and weights_epoch change
        # together with respect to rollback()'s read.
        with self._swap_lock:
            pending, self._pending_swap = self._pending_swap, None
            if pending is None:
                return
            params, epoch = pending
            self._prev_params = self.params
            self._prev_epoch = self.weights_epoch
            self._install_params(params)
            # graftlint: disable=hot-path-transfer -- epoch is a staged host int, not a device value
            self.weights_epoch = int(epoch)
        # KV identity: the trie's pages hold K/V of the old weights. Flush
        # it and bump the epoch, so in-flight old-epoch sequences (which
        # keep their pages) never index them at finish.
        self._kv_epoch += 1
        if self.prefix_cache is not None:
            self.prefix_cache.flush(self.pool)
        if self.journal is not None:
            self.journal.update_fingerprint(weights_epoch=self.weights_epoch)
        if self.drafter is not None:
            self.drafter.on_weights_swap(params, epoch)
        t1 = time.perf_counter()
        dt = t1 - t0
        self.telemetry.recorder.mark_gap()
        self.telemetry.on_swap_applied(dt)
        for seq in self.scheduler.active():
            if seq.first_token_t is not None:
                seq.swap_pause_s += dt
            if seq.request.ledger is not None:
                seq.request.ledger.stamp(self._phase_cause(seq), t0)
                seq.request.ledger.stamp(CAUSE_SWAP_BARRIER, t1)
        if self.trace is not None:
            self.trace.instant("swap.applied", track="engine",
                               # graftlint: disable=hot-path-transfer -- host int for a JSON trace arg
                               epoch=int(epoch), blocked_ms=dt * 1e3,
                               inflight=self.scheduler.num_active)

    # -- the iteration -------------------------------------------------------
    def step(self) -> list[FinishedRequest]:
        """One engine iteration: the swap barrier, admit (+ chunk
        prefill), decode, evict. Returns the requests that finished in it;
        safe to call idle."""
        with torch.no_grad():
            self._apply_pending_swap()
            return self._step_paged() if self.paged else self._step_legacy()

    def _route_paged(self, window, chunk_seq: ActiveSequence | None,
                     c: int) -> np.ndarray:
        """The iteration's routing, packed into one long array (one copy to
        the card): the verify window's tokens, positions and validity
        ``[B, W]``, the keys ``[B]`` and tables ``[B, P]``; with a chunk,
        its tokens, positions and validity ``[C]``, table ``[P]`` and key.
        A valid row never maps to the null page."""
        d_tok, d_pos, d_valid = window
        s, p, w = self.cfg.max_batch, self.pages_per_slot, self.spec_width
        cw = self.prefill_chunk if chunk_seq is not None else 0
        ps = self.page_size
        for slot in np.flatnonzero(d_valid.any(axis=1)):
            last = d_pos[slot][d_valid[slot]].max()
            assert self._tables[slot, last // ps] != 0, "a valid row maps to the null page"
        parts = [d_tok.reshape(-1), d_pos.reshape(-1), d_valid.reshape(-1).astype(np.int64),
                 self._slot_key, self._tables.reshape(-1)]
        if cw:
            start = chunk_seq.prefill_pos
            c_tok = np.full((cw,), self.sample_cfg.pad_id, np.int64)
            c_pos = np.zeros((cw,), np.int64)
            c_valid = np.zeros((cw,), np.int64)
            c_tok[:c] = chunk_seq.prefill_tokens[start:start + c]
            c_pos[:c] = np.arange(start, start + c)
            c_valid[:c] = 1
            assert self._tables[chunk_seq.slot, (start + c - 1) // ps] != 0, \
                "a valid chunk row maps to the null page"
            parts += [c_tok, c_pos, c_valid, self._tables[chunk_seq.slot],
                      self._slot_key[chunk_seq.slot:chunk_seq.slot + 1]]
        buf = np.concatenate(parts)
        assert buf.size == 3 * s * w + s + s * p + (3 * cw + p + 1 if cw else 0)
        return buf

    def _run_paged(self, buf: np.ndarray, chunked: bool):
        """Ship the routing, run the fused (chunk, then verify window) or
        the window-only step, and land the sampled tokens ``[B, W]``, the
        accept lengths ``[B]`` and the chunk's candidates ``[C]`` (one
        read of the card)."""
        s, p, w = self.cfg.max_batch, self.pages_per_slot, self.spec_width
        dev = torch.from_numpy(buf).to(self.device)
        d_tok, d_pos, d_valid = (dev[i * s * w:(i + 1) * s * w].view(s, w) for i in range(3))
        at = 3 * s * w
        d_key = dev[at:at + s]
        tables = dev[at + s:at + s + s * p].view(s, p)
        outs = []
        if chunked:
            cw, at = self.prefill_chunk, at + s + s * p
            c_tok, c_pos, c_valid = (dev[at + i * cw:at + (i + 1) * cw] for i in range(3))
            c_table = dev[at + 3 * cw:at + 3 * cw + p].view(1, p)
            # The chunk's slot is not decoding: the two lanes touch
            # disjoint pages, and the order is JAX's.
            outs.append(self._chunk_step(c_tok, c_pos, c_valid.bool(), c_table, dev[-1:]))
        nxt, acc = self._decode_step(d_tok, d_pos, d_valid.bool(), d_key, tables)
        self.device_reads += 1
        # graftlint: disable=hot-path-transfer -- THE per-iteration sync: tokens must land
        landed = torch.cat([nxt.reshape(-1), acc.to(nxt.dtype), *outs]).cpu().numpy()
        return (landed[:s * w].reshape(s, w), landed[s * w:s * w + s],
                landed[s * w + s:] if chunked else None)

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
        # carried prefix) prefills chunk by chunk below, past any resident
        # prefix.
        self._admit_pass(finished)
        blocked_t0 = time.perf_counter() if len(self.queue) > 0 else None

        active_seqs = self.scheduler.active()
        decoding = [q for q in active_seqs if not q.prefilling]
        prefilling = [q for q in active_seqs if q.prefilling]
        # Oldest prefilling request first: one chunk per iteration.
        chunk_seq = min(prefilling, key=lambda q: q.request.uid, default=None)

        if chunk_seq is not None or decoding:
            t_step0 = time.perf_counter()
            # The verify window (the plain one-token lane at spec_k 0);
            # pages are ensured for the valid width only, so speculation
            # draws nothing past the admission commitment.
            d_tok, d_pos, d_valid, useful_by_slot, drafted = self._draft_window(decoding)
            for seq in decoding:
                p = seq.request.prompt.size + len(seq.tokens) - 1
                self._ensure_pages(seq.slot, p + useful_by_slot[seq.slot] + 1)
            t_draft1 = time.perf_counter()
            c = 0
            if chunk_seq is not None:
                # prefill_tokens is the prompt, or for a resumption prompt
                # + emitted-minus-last: the positions the preemption freed.
                start = chunk_seq.prefill_pos
                c = min(self.prefill_chunk, chunk_seq.prefill_tokens.size - start)
                self._ensure_pages(chunk_seq.slot, start + c)
            toks, accepts, c_sampled = self._run_paged(
                self._route_paged((d_tok, d_pos, d_valid), chunk_seq, c),
                chunk_seq is not None)
            t = time.perf_counter()
            emitted, accepted = self._apply_accepts(decoding, toks, accepts,
                                                    useful_by_slot, t)
            if self.spec_k:
                self._spec_rollback(decoding, drafted, accepted, t)
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
                    self._note_first_token(chunk_seq, c_sampled[c - 1], t)
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
                if self.spec_k and decoding:
                    self.trace.complete("draft", t_step0, t_draft1, track="engine",
                                        iteration=it, tokens=drafted, slots=len(decoding))
                    self.trace.complete("verify", t_draft1, t, track="engine",
                                        iteration=it, drafted=drafted, accepted=accepted)
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
            if self.spec_k:
                # The verify window with host-authoritative write heads.
                d_tok, d_pos, d_valid, useful_by_slot, drafted = \
                    self._draft_window(active_seqs)
                t_draft1 = time.perf_counter()
                toks, accepts = self._verify_legacy(d_tok, d_pos[:, 0], d_valid)
                t = time.perf_counter()
                emitted, accepted = self._apply_accepts(active_seqs, toks, accepts,
                                                        useful_by_slot, t)
                self._spec_rollback(active_seqs, drafted, accepted, t)
                if self.trace is not None:
                    self.trace.complete("draft", t_decode, t_draft1, track="engine",
                                        iteration=it, tokens=drafted,
                                        slots=len(active_seqs))
                    self.trace.complete("verify", t_draft1, t, track="engine",
                                        iteration=it, drafted=drafted, accepted=accepted)
            else:
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
                emitted, _ = self._apply_accepts(active_seqs, toks[:, None],
                                                 np.zeros(len(toks), np.int64), {}, t)
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
        """Shared iteration tail: page reclamation, the journal, the token
        listener, telemetry, the ledger's terminal stamps, traces,
        samples."""
        if self.paged:
            for fin in finished:
                if fin.slot is not None:
                    self._free_slot_pages(fin.slot)
        if self.journal is not None:
            # Durability sweep, enqueue only (the writer thread owns the
            # disk): each active slot's new tokens and every completion.
            # Tokens not yet durable at a crash are recomputed on recovery.
            for seq in self.scheduler.active():
                self.journal.note_tokens(seq)
            for fin in finished:
                self.journal.note_finish(fin)
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
        JAX's columns; the SLO rules evaluated over it, and one incident
        bundle enqueued a rule that fired. No device read, no file (the
        incident writer's thread owns the disk)."""
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
            "journal_records_written": (self.journal.records_written
                                        if self.journal is not None else 0),
            "journal_write_errors": (self.journal.write_errors
                                     if self.journal is not None else 0),
            "queue_depth": len(self.queue),
            "active_slots": self.scheduler.num_active,
            "pool_occupancy": (self.pool.num_allocated / self.pool.num_pages
                               if self.paged else 0.0),
            "prefix_cache_pages_held": (self.prefix_cache.num_pages
                                        if self.prefix_cache is not None else 0),
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
        for event in self.alerts.evaluate(self.timeseries, it):
            if self.incidents is not None:
                # One bundle a fire: the alert, the alert log, the newest
                # samples and a flight snapshot without the control-room
                # sections (the bundle carries them at its top level).
                self.incidents.capture(event["rule"], {
                    "format_version": 1,
                    "alert": event,
                    "alerts": self.alerts.to_dict(),
                    "timeseries": self.timeseries.to_dict(
                        last_n=TIMESERIES_DUMP_SAMPLES),
                    "flight": self.telemetry.snapshot(
                        reason=f"incident:{event['rule']}",
                        stats=self.stats()),
                })

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

    def recover(self) -> dict[str, Any]:
        """Replay the write-ahead journal before serving: call once, right
        after construction and before the first submit or step.

        Three recovery classes, each exactly once, and for anything that
        decodes further, identical to the uninterrupted run:

        - **finished but unacked** results are redelivered from the journal
          (``report["redelivered"]``; the consumer acks them with
          ``journal.ack``);
        - **unfinished** requests re-seat through the preempt-and-requeue
          resume path in uid order: the re-prefill rebuilds prompt +
          emitted-minus-last and the continuation samples the same
          (uid, position) stream, so tokens past the last durable flush
          are recomputed, not lost (``tokens_recomputed_on_recovery``);
          the downtime is billed to the request's ``swap_pause_s``;
        - requests whose **deadline ran out while the engine was down**
          (or whose journaled stream already met EOS or its budget)
          complete at replay (``report["completed_at_replay"]``).

        Returns the report, also kept as ``recovery_report``; an empty one
        without a journal. The prefix cache starts cold: its pages died
        with the old process, and a hit never changes a token.
        """
        report: dict[str, Any] = {
            "redelivered": [], "completed_at_replay": [],
            "resumed": 0, "notes": {}, "torn_bytes": 0}
        self.recovery_report = report
        if self.journal is None:
            return report
        self._recovering = True
        try:
            state = self.journal.recover()
            report["notes"] = dict(state.notes)
            report["torn_bytes"] = int(state.torn_bytes)
            self.queue.reserve_uids(state.max_uid + 1)
            now = time.perf_counter()
            recovered = 0
            recompute = 0
            for uid in sorted(state.requests):
                rr = state.requests[uid]
                recovered += 1
                prompt = np.asarray(rr.prompt, np.int32)
                if rr.finished:
                    report["redelivered"].append(FinishedRequest(
                        uid=uid, prompt=prompt,
                        tokens=np.asarray(rr.finish_tokens or [], np.int32),
                        finish_reason=rr.finish_reason,
                        ttft_ms=rr.ttft_ms, tpot_ms=rr.tpot_ms,
                        arrival_t=perf_of(rr.arrival_wall),
                        first_token_t=None, priority=rr.priority,
                        tenant=rr.tenant))
                    continue
                arrival_t = perf_of(rr.arrival_wall)
                req = Request(
                    uid=uid, prompt=prompt, max_new_tokens=rr.max_new_tokens,
                    arrival_t=arrival_t,
                    ttft_deadline_t=(arrival_t + rr.ttft_rel_s
                                     if rr.ttft_rel_s is not None else None),
                    deadline_t=(arrival_t + rr.deadline_rel_s
                                if rr.deadline_rel_s is not None else None),
                    priority=rr.priority, tenant=rr.tenant)
                seq = ActiveSequence.from_journal(
                    req, rr.tokens, preempts=rr.preempts,
                    first_token_t=(perf_of(rr.first_wall)
                                   if rr.first_wall is not None else None),
                    last_token_t=(perf_of(rr.last_wall)
                                  if rr.last_wall is not None else None))
                # Ledger (wall-anchored): the dead process's span is
                # 'pre_crash' up to its last durable token, and everything
                # from there to this replay bills to 'recovery'.
                if req.ledger is not None:
                    if seq.last_token_t is not None:
                        req.ledger.stamp(CAUSE_PRE_CRASH, seq.last_token_t)
                    req.ledger.stamp(CAUSE_RECOVERY, now)
                reason = seq.finish_reason(self.sample_cfg.eos_id, now)
                if reason is not None:
                    fin = FinishedRequest.from_active(seq, reason, slot=None)
                    if fin.ledger is not None:
                        fin.ledger.close(CAUSE_RECOVERY, now)
                    self.journal.note_finish(fin)
                    self.telemetry.on_finished(fin)
                    report["completed_at_replay"].append(fin)
                    continue
                if seq.last_token_t is not None:
                    seq.swap_pause_s += max(now - seq.last_token_t, 0.0)
                if seq.tokens:
                    recompute += prompt.size + len(seq.tokens) - 1
                # A resumption (tokens, or a journaled preemption whose
                # attribution must survive) restores as the sequence; an
                # untouched admission as the bare request.
                self.queue.restore(seq if (seq.tokens or seq.preempts) else req)
                report["resumed"] += 1
            self.telemetry.on_recovered(recovered, recompute)
        finally:
            self._recovering = False
        return report

    @property
    def draining(self) -> bool:
        """True once admission has been closed."""
        return self.queue.closed

    @property
    def phase(self) -> str:
        """The /healthz lifecycle phase: recovering, then serving ⇄
        swapping ⇄ overloaded → draining → drained (idle = alive, nothing
        queued). ``swapping``: a staged weight set waits for the next
        iteration boundary."""
        if self._recovering:
            return "recovering"
        if self._drained:
            return "drained"
        if self.queue.closed:
            return "draining"
        with self._swap_lock:
            if self._pending_swap is not None:
                return "swapping"
        if self._overloaded and len(self.queue) > 0:
            return "overloaded"
        return "idle" if self.idle else "serving"

    def health(self) -> dict[str, Any]:
        """The /healthz extras: weights epoch, swap, degradation and
        journal counters (JAX's keys)."""
        return {
            "weights_epoch": int(self.weights_epoch),
            "swaps_completed": self.telemetry.swaps_completed,
            "swaps_rejected": self.telemetry.swaps_rejected,
            "requests_preempted": self.telemetry.requests_preempted,
            "requests_shed": self.queue.shed,
            "queue_depth": len(self.queue),
            "requests_recovered": self.telemetry.requests_recovered,
            "journal_records_written": (self.journal.records_written
                                        if self.journal is not None else 0),
            "journal_fsyncs": self.journal.fsyncs if self.journal is not None else 0,
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

    def probe_snapshot(self, tokens=None) -> dict[str, Any]:
        """Read-only routing probe (a router's replica choice): the
        resident prefix the trie holds for ``tokens`` and the
        replica-selection signals. :meth:`PrefixCache.probe` touches no
        refcount or recency; the rest is host state."""
        hit = 0
        if self.prefix_cache is not None and tokens is not None and len(tokens) > 1:
            arr = np.asarray(tokens, np.int32)
            hit = len(self.prefix_cache.probe(arr, max_tokens=arr.size - 1)) * self.page_size
        return {
            "hit_tokens": hit,
            "queue_wait_p95_ms": self.telemetry.queue_wait_p95_ms(),
            "queue_depth": len(self.queue),
            "active_slots": self.scheduler.num_active,
            "draining": bool(self.draining or self._drained),
            "phase": self.phase,
            "weights_epoch": int(self.weights_epoch),
        }

    # -- telemetry surface ---------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """The SLA summary with JAX's keys: the telemetry's, the queue's
        admission and degradation counters, the journal's, the trie's
        gauge, and the alerts' and incidents' lifetime counts (0 without
        rules)."""
        stats = self.telemetry.stats()
        stats["queue_depth_max"] = max(stats["queue_depth_max"], self.queue.depth_max)
        stats["requests_submitted"] = self.queue.submitted
        stats["requests_rejected"] = self.queue.rejected
        stats["requests_shed"] = self.queue.shed
        for t, n in enumerate(self.queue.shed_by_tier):
            stats[f"tier{t}_requests_shed"] = n
        stats["requests_drain_rejected"] = self.queue.drain_rejected
        stats["drained"] = bool(self._drained)
        stats["journal_records_written"] = (self.journal.records_written
                                            if self.journal is not None else 0)
        stats["journal_fsyncs"] = self.journal.fsyncs if self.journal is not None else 0
        stats["weights_epoch"] = int(self.weights_epoch)
        stats["prefix_cache_pages_held"] = (self.prefix_cache.num_pages
                                            if self.prefix_cache is not None else 0)
        stats["alerts_fired"] = self.alerts.fired
        stats["alerts_cleared"] = self.alerts.cleared
        stats["alerts_active"] = len(self.alerts.active)
        stats["incidents_captured"] = (self.incidents.captured
                                       if self.incidents is not None else 0)
        return stats

    def reset_stats(self) -> None:
        """A fresh telemetry window (after a warm-up pass, say); slot state
        and page allocations are untouched. The ledger's lifetime
        histograms and conservation audit carry over, and so do the
        recovery counters, the quantization gauges and the alert engine
        and incident writer (facts of the engine, not of a window: an alert
        that fired before a warm-up reset did fire). The sample ring starts
        afresh."""
        old = self.telemetry
        self.telemetry = ServeTelemetry(self.cfg.ring_size, num_tiers=self.cfg.num_tiers)
        self.telemetry.on_recovered(old.requests_recovered,
                                    old.tokens_recomputed_on_recovery)
        self.telemetry.adopt_ledger_lifetime(old)
        self.telemetry.on_weight_quant(self._weight_quant_s, self._quantized_params_bytes)
        self.telemetry.set_kv_bytes_per_token(old.kv_bytes_per_token)
        self.queue.reset_counters()
        self.timeseries = TelemetryRing(self.cfg.timeseries_capacity,
                                        self.cfg.sample_every)
        self._iteration = 0

    def _control_room_sections(self) -> dict[str, Any]:
        """The ``alerts`` and ``timeseries`` sections of flight snapshots
        and dumps (both packages' ``flight_report`` and ``incident_report``
        read these shapes)."""
        return {"alerts": self.alerts.to_dict(),
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

    def timeseries_snapshot(self) -> dict[str, Any]:
        """The ring's JSON view for the exporter's ``/timeseries``: a
        scrape copies rows and changes nothing."""
        return self.timeseries.to_dict(last_n=TIMESERIES_DUMP_SAMPLES)

    def alerts_snapshot(self) -> dict[str, Any]:
        """The alert engine's JSON view (rules, counts, active set, event
        log) for the exporter's ``/alerts``; rules are evaluated on the
        engine's thread alone."""
        return self.alerts.to_dict()

    def close_incidents(self) -> None:
        """Write out the queued incident bundles and stop the writer's
        thread (idempotent; nothing without ``incident_dir``). Callers run
        it at exit, after the last iteration, as ``journal.shutdown()``."""
        if self.incidents is not None:
            self.incidents.shutdown()
