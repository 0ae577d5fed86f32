"""Deterministic chaos harness: seeded, step-addressed fault injection.

The port of ``distributed_training_tpu/resilience/chaos.py``. Recovery
paths (the preemption save, auto-resume, the torn-write fallback, the
transient-I/O retry) rot unless they run; this harness makes every fault a
deterministic input:

- **kill at step k**: SIGTERM (the eviction signal; the
  ``runtime/preemption.py`` ``PreemptionGuard`` path) or SIGKILL (death
  with no save; the resume falls back to the last interval save),
  delivered from inside the step loop at an exact global step;
- **torn checkpoint write**: after the save of a chosen epoch lands,
  truncate its largest payload file and remove the ``COMMITTED`` marker,
  what a crash mid-write leaves, which ``latest_valid_epoch`` must skip;
- **tear after commit**: corrupt a committed save's largest payload file
  and keep its marker and manifest, caught only by the checksum pass;
- **transient data-I/O errors**: a seeded, per-key one-shot
  :class:`ChaosIOError` from inside the loaders' reads (the imagefolder
  decode, the LM corpus read), which their ``RetryPolicy`` absorbs (the
  ``swap`` kind, the serving hot swap's staging read, has no reader in
  the port yet);
- **slow steps**: host stalls every N steps, on every rank or on one,
  visible in the flight recorder and its cross-rank straggler view.

Every choice is a pure function of ``(ChaosConfig.seed, fault address)``
through ``zlib.crc32``, so for one config the port faults the same keys as
the JAX package, and a chaos run replays exactly.
"""

from __future__ import annotations

import os
import signal
import time
import zlib

from distributed_training_tpu_torch.resilience.verify import (
    COMMIT_NAME,
    is_manifest_name as _is_manifest,
)


class ChaosIOError(OSError):
    """An injected transient I/O fault (retryable by construction)."""


def _largest_payload_file(path: str) -> str:
    """The deterministically-chosen victim of a checkpoint fault: the
    largest non-manifest file (lexicographic tiebreak)."""
    victims = []
    for dirpath, _, files in os.walk(path):
        for name in files:
            if name == COMMIT_NAME or _is_manifest(name):
                continue
            p = os.path.join(dirpath, name)
            victims.append((-os.path.getsize(p), os.path.relpath(p, path), p))
    if not victims:
        raise FileNotFoundError(f"no checkpoint files to tear at {path}")
    victims.sort()  # largest first, lexicographic tiebreak: deterministic
    return victims[0][2]


def tear_checkpoint(path: str, truncate_bytes: int = 64) -> str:
    """Turn a completed save at ``path`` into a torn write: truncate its
    largest payload file to ``truncate_bytes`` and drop the COMMITTED
    marker (a real crash dies before the marker, which is written last).
    Returns the truncated file's path.
    """
    victim = _largest_payload_file(path)
    size = os.path.getsize(victim)
    with open(victim, "r+b") as fh:
        fh.truncate(min(truncate_bytes, max(size - 1, 0)))
    marker = os.path.join(path, COMMIT_NAME)
    if os.path.exists(marker):
        os.remove(marker)
    return victim


def corrupt_committed_checkpoint(path: str, flip_bytes: int = 64) -> str:
    """Tear-AFTER-commit: flip the leading bytes of the save's largest
    payload file while leaving the manifest and the ``COMMITTED`` marker
    intact — bit rot or a buggy copy that lands *after* a successful
    commit. Invisible to the marker scan, caught by the manifest
    checksum pass (``verify_checkpoint`` reason ``"checksum"``). Returns
    the corrupted file's path."""
    victim = _largest_payload_file(path)
    n = min(flip_bytes, os.path.getsize(victim))
    if n < 1:
        raise FileNotFoundError(
            f"largest payload file of {path} is empty; nothing to corrupt")
    with open(victim, "r+b") as fh:
        buf = fh.read(n)
        fh.seek(0)
        fh.write(bytes(b ^ 0xFF for b in buf))
    return victim


def hard_kill(flush=None) -> None:
    """Die as the hardware would: SIGKILL, no grace window, no cleanup.
    ``flush`` (a journal's ``persist``, say) runs first, so the durable
    state at death is exactly what was enqueued so far."""
    if flush is not None:
        flush()
    os.kill(os.getpid(), signal.SIGKILL)


class ChaosMonkey:
    """One run's fault injector, driven by the trainers' step loop.

    Built from a ``config.ChaosConfig``; hooks are no-ops for faults the
    config leaves unset. ``counters`` records every injected fault for the
    flight dump's resilience section. ``process_index`` (the rank) scopes
    ``slow_step_host``; ``trace`` (a ``TraceSession`` or None) marks every
    injection as an instant event on its ``chaos`` track.
    """

    def __init__(self, cfg, *, process_index: int = 0, trace=None):
        self.cfg = cfg
        self.process_index = int(process_index)
        self.trace = trace
        self._killed = False
        self._torn = False
        self._corrupted = False
        self._io_failed: set[str] = set()
        self.counters = {"kills": 0, "torn_ckpts": 0, "corrupt_ckpts": 0,
                         "io_faults": 0, "slow_steps": 0}

    def _mark(self, name: str, **attrs) -> None:
        if self.trace is not None:
            self.trace.instant(name, track="chaos", **attrs)

    # -- step loop -----------------------------------------------------------
    def on_step(self, step: int) -> None:
        """Called after every optimizer step with the global step index."""
        c = self.cfg
        if (c.slow_step_every and c.slow_step_ms > 0
                and step % c.slow_step_every == 0
                and (c.slow_step_host is None
                     or c.slow_step_host == self.process_index)):
            self.counters["slow_steps"] += 1
            self._mark("chaos.slow_step", step=int(step),
                       ms=float(c.slow_step_ms))
            time.sleep(c.slow_step_ms / 1e3)
        if c.kill_at_step is not None and step >= c.kill_at_step \
                and not self._killed:
            self._killed = True
            self.counters["kills"] += 1
            self._mark("chaos.kill", step=int(step), sig=c.kill_signal)
            if c.kill_signal == "kill":
                # Death with no grace window and no save: the resume
                # falls back to the last committed interval save.
                os.kill(os.getpid(), signal.SIGKILL)
            else:
                # Graceful eviction: the PreemptionGuard latches it, and
                # the trainer finishes the step and saves.
                signal.raise_signal(signal.SIGTERM)

    # -- checkpoint path -----------------------------------------------------
    def after_checkpoint_save(self, path: str, epoch: int) -> None:
        """Post-save hook (the synchronous path and the async writer's
        thread both call it): tears or corrupts the configured epoch's
        save once. ``torn_ckpt_epoch`` leaves a torn uncommitted save
        (auto-resume falls back); ``corrupt_ckpt_epoch`` a committed save
        that fails its checksums."""
        c = self.cfg
        if c.torn_ckpt_epoch is not None and epoch == c.torn_ckpt_epoch \
                and not self._torn:
            self._torn = True
            self.counters["torn_ckpts"] += 1
            self._mark("chaos.torn_ckpt", epoch=int(epoch))
            tear_checkpoint(path, c.torn_truncate_bytes)
        if getattr(c, "corrupt_ckpt_epoch", None) is not None \
                and epoch == c.corrupt_ckpt_epoch and not self._corrupted:
            self._corrupted = True
            self.counters["corrupt_ckpts"] += 1
            self._mark("chaos.corrupt_ckpt", epoch=int(epoch))
            corrupt_committed_checkpoint(path)

    # -- data I/O ------------------------------------------------------------
    def io_check(self, kind: str, key: str) -> None:
        """Raise a one-shot :class:`ChaosIOError` for ``key`` when the
        seeded coin says so — once per key, so a retry always succeeds
        (the injected faults are transient by construction). Kinds:
        ``"data"`` (loader reads, absorbed by the RetryPolicy) and
        ``"swap"`` (the serving hot swap's staging reads)."""
        c = self.cfg
        rate = {"data": c.data_error_rate,
                "swap": getattr(c, "swap_error_rate", 0.0)}.get(kind, 0.0)
        if rate <= 0:
            return
        full = f"{c.seed}:{kind}:{key}"
        if full in self._io_failed:
            return
        if zlib.crc32(full.encode()) % 1_000_000 \
                < int(rate * 1_000_000):
            self._io_failed.add(full)
            self.counters["io_faults"] += 1
            self._mark("chaos.io_fault", key=key)  # loader threads: safe
            raise ChaosIOError(
                f"chaos-injected transient I/O error ({kind}: {key})")


# -- process-global install point (the loaders poll it) ----------------------
# Handing a monkey through every loader's constructor would thread chaos
# through the whole data API; one registration keeps it to a
# `chaos_io_check` call in each read path, free when nothing is installed.
# The trainers install for the duration of `fit()` only.
_active: ChaosMonkey | None = None


def install(monkey: ChaosMonkey | None) -> None:
    global _active
    _active = monkey


def uninstall() -> None:
    install(None)


def active_monkey() -> ChaosMonkey | None:
    return _active


def chaos_io_check(kind: str, key: str) -> None:
    """Fault-injection point for I/O paths; no-op without a monkey."""
    if _active is not None:
        _active.io_check(kind, key)
