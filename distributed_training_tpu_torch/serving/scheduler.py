"""Slot scheduler: iteration-level (continuous) batching over fixed slots.

The port of ``distributed_training_tpu/serving/scheduler.py``, unchanged (host Python and numpy).

Orca's scheduling insight, restated for compiled steps: the decode
step's shapes must never change (a retrace or a new graph capture costs
seconds), so the batch is
``max_batch`` fixed SLOTS rather than a dynamic list of sequences. At
every iteration boundary the scheduler

- **admits**: seats queue candidates (highest SLO tier first, weighted
  tenant-fair within a tier — :meth:`RequestQueue.next_candidate` owns
  that order) into however many slots are free, gated by the engine's
  page-commitment predicate,
- **preempts**: when a candidate outranks active work and cannot seat
  (no slot, reserved headroom, or no pages), the WORST active sequence
  of a strictly lower tier is evicted and requeued — losslessly: its
  emitted tokens ride back to the queue and are re-prefilled on the
  next seat, continuing the same ``fold_in(rng, position)`` stream, so
  the final output is bitwise identical to an uninterrupted run
  (vLLM-style preempt-and-recompute; docs/SERVING.md), and
- **evicts**: returns finished sequences (EOS emitted, completion
  budget spent, or deadline missed) to the caller and marks their
  slots free.

Mid-iteration the slot set is immutable — the decode step sees a boolean
active mask and per-slot cache write heads, nothing else. All state here
is host-side Python; no device work.

Speculative decoding is invisible to the scheduler: a slot may emit
several tokens per iteration (the engine's verify window,
``serving/speculative.py``), but membership still only changes at
boundaries, and :meth:`SlotScheduler.evict_finished` reads the same
``tokens``/EOS/budget state — a mid-window EOS is truncated by the
engine before it lands here, so ``tokens[-1]`` remains the finishing
token exactly as in one-token decode. It composes with preemption the
same way: a preempted slot's drafts simply never happen, and the
resumption drafts again from its (identical) token stream.
"""

from __future__ import annotations

import time

import numpy as np

from distributed_training_tpu_torch.serving.ledger import (
    CAUSE_PREEMPT_REQUEUE,
    CAUSE_QUEUE_WAIT,
)
from distributed_training_tpu_torch.serving.request import (
    ActiveSequence,
    FinishedRequest,
    Request,
)


class SlotScheduler:
    """Fixed decode slots; tier-aware refill + preemption, boundary
    eviction.

    ``reserved_slots`` holds that many slots back from non-top tiers
    (``priority > 0``): a best-effort request only seats while MORE than
    ``reserved_slots`` slots are free, so a high-tier arrival always
    finds headroom without even needing a preemption. Tier 0 ignores
    the reserve. ``preempt=False`` disables mid-flight eviction (tiers
    then only order the queue).
    """

    def __init__(self, num_slots: int, *, reserved_slots: int = 0,
                 preempt: bool = True):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if not 0 <= reserved_slots < num_slots:
            raise ValueError(
                f"reserved_slots must be in [0, num_slots-1], got "
                f"{reserved_slots} of {num_slots}")
        self.num_slots = int(num_slots)
        self.reserved_slots = int(reserved_slots)
        self.preempt = bool(preempt)
        self._slots: list[ActiveSequence | None] = [None] * self.num_slots

    # -- views ---------------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def active(self) -> list[ActiveSequence]:
        """Occupied slots, slot-index order."""
        return [s for s in self._slots if s is not None]

    def active_mask(self) -> np.ndarray:
        """bool [num_slots] — the decode step's per-slot active mask."""
        return np.asarray([s is not None for s in self._slots], bool)

    def sequence(self, slot: int) -> ActiveSequence:
        seq = self._slots[slot]
        if seq is None:
            raise KeyError(f"slot {slot} is free")
        return seq

    def evict_uid(self, uid: int) -> ActiveSequence | None:
        """Clear and return the seated sequence with ``uid`` (the
        cancellation path — the caller finishes it with reason
        ``cancelled`` and the normal finish sweep frees its pages), or
        None when the uid holds no slot."""
        for slot, seq in enumerate(self._slots):
            if seq is not None and seq.request.uid == uid:
                self._slots[slot] = None
                return seq
        return None

    def tenant_active(self) -> dict[str, int]:
        """tenant -> seated-sequence count (the queue's quota input)."""
        counts: dict[str, int] = {}
        for s in self._slots:
            if s is not None:
                t = s.request.tenant
                counts[t] = counts.get(t, 0) + 1
        return counts

    # -- iteration boundaries ------------------------------------------------
    def _victim_slot(self, priority: int) -> int | None:
        """The slot to preempt for a ``priority`` candidate: the active
        sequence of the numerically LARGEST (worst) tier strictly below
        the candidate, newest (largest uid) first — the least sunk cost
        within the worst tier, and a deterministic rule either way.
        None when nothing outrankable is active."""
        best: int | None = None
        for slot, seq in enumerate(self._slots):
            if seq is None or seq.request.priority <= priority:
                continue
            if best is None or (
                    (seq.request.priority, seq.request.uid)
                    > (self._slots[best].request.priority,
                       self._slots[best].request.uid)):
                best = slot
        return best

    def admit(self, queue, can_seat=None, *, on_seat=None,
              on_preempt=None, preempt_helps=None, prefix_probe=None
              ) -> list[ActiveSequence]:
        """One admission pass; returns the newly seated sequences (the
        engine prefills each — resumptions re-prefill their carried
        prefix).

        ``can_seat`` is the engine's resource gate (page commitment +
        reserved-page headroom), consulted per candidate; ``on_seat``
        runs engine-side seat bookkeeping (commit pages, slot RNG);
        ``on_preempt`` runs eviction bookkeeping (free pages, counters)
        BEFORE the sequence is requeued. Candidate order is the queue's
        (tier-strict, tenant-fair). A resource-blocked candidate first
        tries to PREEMPT the worst strictly-lower-tier active sequence —
        but only when ``preempt_helps(cand, victims)`` (the engine's
        futility bound: could evicting EVERY strictly-lower-tier active
        ever free enough?) says yes, so a candidate too large for its
        preemptible pool cannot throw away best-effort progress for
        nothing. When nothing is (usefully) preemptible, admission
        STOPS — lower tiers never skip past a blocked higher tier (the
        anti-starvation / anti-priority-inversion rule), and within a
        (tier, tenant) lane order stays strictly FIFO.

        Every loop step either seats a candidate (queue shrinks) or
        preempts a strictly-lower-tier active (num_active shrinks, and
        the victim can only re-seat after this candidate), so the pass
        terminates; preemption cannot cycle because it is strictly
        rank-ordered. (A candidate vanishing between the queue's
        ``next_candidate`` and ``take`` — a producer-side tier-aware
        shed racing this pass — just re-polls.)

        ``prefix_probe`` threads through to ``queue.next_candidate``
        (cache-aware seat ordering): among equal-fairness tenant heads,
        the one with the larger resident prefix seats first.
        """
        seated: list[ActiveSequence] = []
        while True:
            cand = queue.next_candidate(self.tenant_active(),
                                        prefix_probe=prefix_probe)
            if cand is None:
                break
            req: Request = (cand.request
                            if isinstance(cand, ActiveSequence) else cand)
            free = [i for i, s in enumerate(self._slots) if s is None]
            slot_ok = bool(free) and (
                req.priority == 0 or len(free) > self.reserved_slots)
            if not slot_ok or (can_seat is not None
                              and not can_seat(cand)):
                victim = (self._victim_slot(req.priority)
                          if self.preempt else None)
                if victim is None:
                    break
                if preempt_helps is not None:
                    victims = [s for s in self._slots
                               if s is not None
                               and s.request.priority > req.priority]
                    if not preempt_helps(cand, victims):
                        break
                seq = self._slots[victim]
                self._slots[victim] = None
                if on_preempt is not None:
                    on_preempt(seq)
                seq.prepare_resume()
                queue.requeue(seq)
                continue
            if not queue.take(cand):
                continue  # candidate shed concurrently: re-poll
            slot = free[0]
            # seated_t closes (or re-opens, after a preemption) the
            # request's queueing interval; the engine's trace emits it
            # as the 'queued' span.
            now = time.perf_counter()
            if isinstance(cand, ActiveSequence):
                seq = cand
                seq.slot = slot
                seq.seated_t = now
            else:
                seq = ActiveSequence(request=cand, slot=slot,
                                     seated_t=now)
            # Ledger seat stamp (serving/ledger.py): the wait that just
            # ended is 'queue_wait' for a first seat and
            # 'preempt_requeue' for a resumption's re-seat (preemption
            # OR crash-recovery restore — both ride the resume path).
            if seq.request.ledger is not None:
                seq.request.ledger.stamp(
                    CAUSE_PREEMPT_REQUEUE if isinstance(
                        cand, ActiveSequence) else CAUSE_QUEUE_WAIT,
                    now)
            self._slots[slot] = seq
            if on_seat is not None:
                on_seat(seq)
            seated.append(seq)
        return seated

    def evict_finished(self, eos_id: int | None,
                       now: float | None = None) -> list[FinishedRequest]:
        """Free every slot whose sequence has finished; returns results.

        Called after tokens land (post-prefill and post-decode-step): a
        one-token request or an instant EOS finishes without ever joining
        a decode iteration. ``now`` additionally evicts slots past their
        total deadline (partial tokens returned) — and, chunked prefill,
        slots past their TTFT deadline with no first token yet — with
        finish reason ``timeout`` (``preempted_timeout`` when the
        sequence's clock ran down while it sat preempted): a slot is
        serving capacity, and a request that already missed its SLA must
        hand it to one that can still make its own.
        """
        done: list[FinishedRequest] = []
        for slot in range(self.num_slots):
            seq = self._slots[slot]
            if seq is None:
                continue
            reason = seq.finish_reason(eos_id, now)
            if reason is not None:
                done.append(FinishedRequest.from_active(seq, reason))
                self._slots[slot] = None
        return done
