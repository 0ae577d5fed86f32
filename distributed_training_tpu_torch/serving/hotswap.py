"""Zero-drain live weight hot swap: watcher → verify → stage → barrier.

The port of ``distributed_training_tpu/serving/hotswap.py``, unchanged
apart from its imports (host Python). :class:`HotSwapper` watches a
checkpoint directory and streams each newly *committed* epoch into the
running engine at a decode-iteration boundary: the queue never closes,
nothing is shed, in-flight requests keep their KV pages and continue on
the new weights.

The pipeline is a one-way state machine; every stage can refuse, and a
refusal leaves the engine serving exactly the weights it had (a typed
:class:`~distributed_training_tpu_torch.resilience.errors.SwapError` and
``swaps_rejected``):

1. **watch**: ``epoch_N`` directories newer than the engine's
   ``weights_epoch`` that carry the atomic ``COMMITTED`` marker;
2. **verify**: ``resilience/verify.py``'s ``verify_checkpoint`` (the
   manifest's checksums); a failing candidate is quarantined to
   ``epoch_N.corrupt`` and never touches the engine;
3. **stage**: the restore read (``inference/restore.py``'s restorer)
   on the watcher's thread, behind the chaos injection point
   (``ChaosConfig.swap_error_rate``): an I/O fault costs this attempt,
   the next poll retries;
4. **validate**: ``Engine.validate_swap``, the candidate's names,
   shapes and dtypes against the serving set's;
5. **arm → barrier**: ``Engine.arm_swap`` stages it, ``Engine.step``
   installs it at the next iteration boundary, bills the pause to
   ``swap_blocked_s`` and to each in-flight request's ledger as
   ``swap_barrier``, flushes the prefix cache and bumps the KV epoch.

``Engine.rollback()`` re-arms the previously served weights.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from distributed_training_tpu_torch.resilience import verify as verify_lib
from distributed_training_tpu_torch.resilience.chaos import chaos_io_check
from distributed_training_tpu_torch.resilience.errors import (
    CheckpointCorruptError,
    SwapError,
)


def committed_epochs(directory: str) -> list[int]:
    """Epoch numbers under ``directory`` whose save carries the atomic
    ``COMMITTED`` marker, newest first. Uncommitted dirs are invisible
    to the swap plane by design (in-flight or dead saves)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("epoch_") and d.split("_", 1)[1].isdigit():
            epoch = int(d.split("_", 1)[1])
            if verify_lib.is_committed(os.path.join(directory, d)):
                out.append(epoch)
    return sorted(out, reverse=True)


class HotSwapper:
    """Checkpoint watcher + staged swap driver for one serving engine.

    >>> swapper = HotSwapper(engine, ckpt_dir, restore_fn)
    >>> swapper.start(interval_s=2.0)   # background polling
    >>> ...                             # engine serves; swaps stream in
    >>> swapper.close()

    ``restore_fn(epoch) -> params`` is the staging read — typically the
    closure ``inference/restore.py::build_lm_and_restorer`` returns,
    which re-runs the restore tail against the prebuilt template state.
    It runs on the watcher thread (or the ``poll_once`` caller), never
    on the decode loop.

    Failed candidates are quarantined (``quarantine=True``), recorded
    on the engine (``swaps_rejected`` counter, ``last_swap_error``,
    trace mark) and remembered in a blacklist so an un-quarantinable
    dir is not re-counted every poll. The watcher keeps scanning older
    epochs: a newest-candidate tear must not block an older-but-still-
    newer-than-deployed good save.
    """

    def __init__(self, engine, watch_dir: str,
                 restore_fn: Callable[[int], Any], *,
                 quarantine: bool = True,
                 printer: Callable[[str], None] = print):
        self.engine = engine
        self.watch_dir = os.path.abspath(watch_dir)
        self.restore_fn = restore_fn
        self.quarantine = quarantine
        self.printer = printer
        self.counters = {"polls": 0, "armed": 0, "rejected": 0}
        self.last_error: SwapError | None = None
        # A rejection is a verdict on BYTES, not on an epoch number:
        # the blacklist keys each rejected epoch to its COMMITTED
        # marker's mtime_ns at rejection time, so an in-place re-save
        # (fresh marker) or a re-drop after quarantine is a NEW
        # candidate that gets the full pipeline — while the same bad
        # dir is not re-read and re-counted every poll.
        self._blacklist: dict[int, int] = {}
        # Newest epoch handed to arm_swap: an armed-but-not-yet-applied
        # candidate must not be re-staged on the next poll (the barrier
        # fires at the engine's pace, not the watcher's).
        self._armed_epoch: int = int(engine.weights_epoch)
        # Consecutive staging-read failures per epoch: a transient I/O
        # hiccup deserves a retry, but a DETERMINISTIC restore failure
        # (e.g. an architecture-incompatible checkpoint dropped in the
        # watch dir) would otherwise be re-read and re-rejected every
        # poll forever — after this many strikes it is blacklisted.
        self._stage_failures: dict[int, int] = {}
        self.stage_failure_limit = 3
        self._rollback_requested = threading.Event()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._wake = threading.Event()

    # -- the pipeline --------------------------------------------------------
    def poll_once(self, *, raise_on_error: bool = False) -> int | None:
        """One watch→verify→stage→validate→arm pass. Returns the epoch
        armed for the next iteration boundary, or None when no
        committed epoch newer than the engine's ``weights_epoch``
        survived the pipeline. Rejections are recorded on the engine
        (and re-raised when ``raise_on_error``); the scan continues to
        older candidates either way."""
        self.counters["polls"] += 1
        current = max(int(self.engine.weights_epoch), self._armed_epoch)
        for epoch in committed_epochs(self.watch_dir):
            if epoch <= current:
                break  # newest-first scan: nothing newer remains
            ident = self._candidate_id(epoch)
            if ident is not None and self._blacklist.get(epoch) == ident:
                continue  # same rejected bytes, not a fresh candidate
            try:
                return self._stage(epoch)
            except SwapError as err:
                self._note_rejected(epoch, err)
                if raise_on_error:
                    raise
        return None

    def _stage(self, epoch: int) -> int:
        """verify → stage → validate → arm one committed candidate.
        Raises :class:`SwapError` naming the stage that refused."""
        path = os.path.join(self.watch_dir, f"epoch_{epoch}")
        t0 = time.perf_counter()
        # The explicit verify pass is what guarantees the quarantine
        # contract for ANY restore_fn (the closure is caller-injected;
        # nothing forces it to verify). The real restore path
        # (restore_checkpoint) verifies again internally — a deliberate
        # double read of the candidate, off the hot path, traded for
        # refusal semantics that cannot be bypassed by a custom stager.
        try:
            verify_lib.verify_checkpoint(path)
        except CheckpointCorruptError as e:
            qpath = None
            if self.quarantine:
                try:
                    qpath = verify_lib.quarantine_checkpoint(path)
                except OSError:
                    pass
            raise SwapError(
                f"swap candidate epoch {epoch} failed checkpoint "
                f"verification ({e})"
                + (f"; quarantined to {qpath}" if qpath else ""),
                stage="verify", epoch=epoch) from e
        try:
            # Chaos injection point: a transient staging-read fault
            # costs this attempt (the next poll retries), never the
            # engine (ChaosConfig.swap_error_rate).
            chaos_io_check("swap", f"epoch_{epoch}")
            params = self.restore_fn(epoch)
        except SwapError:
            raise
        except Exception as e:  # OSError, torch.load, a racing quarantine...
            raise SwapError(
                f"staging read of verified epoch {epoch} failed "
                f"({type(e).__name__}: {e}); the engine keeps epoch "
                f"{self.engine.weights_epoch}",
                stage="stage", epoch=epoch) from e
        try:
            # arm_swap validates internally (structure/shapes/dtypes vs
            # the serving model's abstract tree) — one validation pass,
            # relabeled to this pipeline's stage vocabulary.
            self.engine.arm_swap(params, epoch=epoch)
        except SwapError as e:
            raise SwapError(str(e), stage="validate", epoch=epoch) from e
        self._armed_epoch = epoch
        self._stage_failures.pop(epoch, None)
        self.counters["armed"] += 1
        trace = getattr(self.engine, "trace", None)
        if trace is not None:
            trace.complete("swap.stage", t0, time.perf_counter(),
                           track="hotswap", epoch=int(epoch))
        self.printer(f"[hotswap] epoch {epoch} verified + staged; armed "
                     f"for the next iteration boundary "
                     f"({time.perf_counter() - t0:.2f}s off hot path)")
        return epoch

    def _candidate_id(self, epoch: int) -> int | None:
        """Identity of the committed candidate currently at
        ``epoch_N``: its COMMITTED marker's mtime_ns (the marker is
        rewritten atomically on every save, so a re-save gets a fresh
        identity). None when the dir/marker is gone — quarantined,
        vanished mid-scan, or never committed."""
        try:
            return os.stat(os.path.join(
                self.watch_dir, f"epoch_{epoch}",
                verify_lib.COMMIT_NAME)).st_mtime_ns
        except OSError:
            return None

    def _note_rejected(self, epoch: int, err: SwapError) -> None:
        self.counters["rejected"] += 1
        self.last_error = err
        # Verify/validate failures are permanent verdicts on those
        # bytes: quarantine renames the dir out of future scans, and
        # the blacklist covers the un-renameable remainder so one bad
        # candidate is not re-counted every poll. A STAGING failure is
        # transient by the failure model (an I/O hiccup reading a
        # verified save) — the next poll retries it — but a restore
        # that fails stage_failure_limit polls in a row is not weather,
        # it is a deterministically-unloadable checkpoint (wrong
        # architecture, lost shards): blacklist it too, or the watcher
        # re-reads and re-rejects it forever.
        if err.stage != "stage":
            # Pin the rejected BYTES (marker identity), not the epoch
            # number: a successful quarantine leaves no marker (ident
            # None — nothing to pin, the dir is out of scans anyway),
            # and a later fresh drop or in-place re-save of the same
            # epoch number carries a new identity and gets the full
            # pipeline — pinning the number would silently keep the
            # engine on old weights forever.
            ident = self._candidate_id(epoch)
            if ident is not None:
                self._blacklist[epoch] = ident
        else:
            strikes = self._stage_failures.get(epoch, 0) + 1
            self._stage_failures[epoch] = strikes
            if strikes >= self.stage_failure_limit:
                ident = self._candidate_id(epoch)
                if ident is not None:
                    self._blacklist[epoch] = ident
                self.printer(
                    f"[hotswap] epoch {epoch} failed staging "
                    f"{strikes}x in a row — blacklisted (not a "
                    f"transient fault)")
        self.engine.note_swap_rejected(err)
        self.printer(f"[hotswap] REJECTED ({err.stage}): {err}")

    def rollback(self) -> int:
        """Re-arm the previously served weights (``Engine.rollback``);
        returns the re-armed epoch. The watcher will NOT re-deploy the
        rolled-back-from epoch (``_armed_epoch`` already covers it) —
        only a strictly newer committed save supersedes a rollback.

        NOT signal-safe: ``Engine.arm_swap`` takes the engine's
        non-reentrant swap lock, which the serving loop (the main
        thread) also holds around the barrier — a signal handler
        calling this inline can deadlock its own thread. Signal
        handlers must use :meth:`request_rollback` instead."""
        epoch = self.engine.rollback()
        self.printer(f"[hotswap] rollback armed: epoch {epoch}")
        return epoch

    def request_rollback(self) -> None:
        """Ask the watcher thread to roll back on its next wake
        (signal-safe: just Event sets, no locks touched on the signal
        frame) — the serve CLI's SIGUSR1 path. Requires :meth:`start`;
        a refusal (nothing to roll back to) is printed, not raised."""
        self._rollback_requested.set()
        self._wake.set()

    # -- background watcher --------------------------------------------------
    def start(self, interval_s: float = 2.0) -> "HotSwapper":
        """Poll on a daemon thread every ``interval_s`` (idempotent).
        :meth:`trigger` wakes it early — the serve CLI's SIGHUP path."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name="hotswap-watcher", daemon=True)
            self._thread.start()
        return self

    def trigger(self) -> None:
        """Wake the watcher for one immediate poll (signal-safe: just an
        Event set)."""
        self._wake.set()

    def _loop(self, interval_s: float) -> None:
        while not self._stop.is_set():
            if self._rollback_requested.is_set():
                self._rollback_requested.clear()
                try:
                    self.rollback()
                except SwapError as e:
                    self.printer(f"[hotswap] rollback refused: {e}")
            try:
                self.poll_once()
            except Exception as e:  # never kill the watcher thread
                self.printer(f"[hotswap] poll failed: "
                             f"{type(e).__name__}: {e}")
            self._wake.wait(interval_s)
            self._wake.clear()

    def close(self) -> None:
        """Stop the watcher thread (idempotent; armed-but-unapplied
        swaps stay armed — the engine owns them)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
