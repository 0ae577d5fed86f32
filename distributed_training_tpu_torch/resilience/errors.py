"""Typed failure-path errors for the resilience subsystem.

The port of ``distributed_training_tpu/resilience/errors.py``, whole.
Every recoverable failure gets its own exception type, so callers
(trainers, the serving engine, tests, ``chip_smoke.py``'s drills) branch on
types instead of matching messages. The hierarchy is shallow:

- :class:`CheckpointCorruptError` — a checkpoint directory that must not
  be restored (torn write, checksum mismatch, never committed, empty).
  Raised by ``checkpoint.restore_checkpoint`` / ``verify_checkpoint``
  before ``torch.load`` reads a byte of it.
- :class:`DrainingError` — admission is closed: the serving engine is
  completing in-flight work before shutdown and rejects new requests.
- :class:`QueueFullError` — bounded-queue load shedding: the request
  queue is at ``max_queue_depth`` and sheds the submit instead of
  growing without bound.
- :class:`SwapError` — a live weight hot-swap failed at some stage
  (verification, staging read, tree validation, apply/rollback). The
  serving engine keeps the old weights; the error records where the
  candidate died.
- :class:`JournalCorruptError` — the serving request journal cannot be
  used as-is (written under a different RNG/sampling fingerprint, or
  appended to before recovery read its prior state). Torn tails are
  NOT errors — ``serving/journal.py`` truncates and quarantines them.
"""

from __future__ import annotations


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed validity verification.

    Carries the offending ``path`` and a machine-readable ``reason``
    slug (``"uncommitted"`` / ``"torn"`` / ``"empty"`` / ``"checksum"``)
    alongside the human message; ``auto_resume`` catches this type to
    fall back to the newest *good* save (``checkpoint.
    latest_valid_epoch``) while an explicit ``--resume N`` surfaces it.
    """

    def __init__(self, message: str, *, path: str = "",
                 reason: str = "corrupt"):
        super().__init__(message)
        self.path = path
        self.reason = reason


class DrainingError(RuntimeError):
    """The serving engine is draining: admission is closed, in-flight
    requests are being completed, and new submits are rejected."""


class QueueFullError(RuntimeError):
    """The bounded request queue is full; the submit was shed instead of
    growing the queue (and its tail latency) without bound."""


class JournalCorruptError(RuntimeError):
    """The serving request journal refused an operation that would
    break its durability contract. Torn record tails never raise this
    (they are truncated and quarantined, like torn checkpoints); it is
    reserved for structural misuse: replaying a journal written under a
    different RNG/sampling ``fingerprint`` (the journaled token streams
    would not reproduce) or appending before :meth:`RequestJournal.
    recover` read the prior state (the next compaction would silently
    drop it). Carries ``path`` and a machine-readable ``reason`` slug
    (``"fingerprint"`` / ``"unrecovered"`` / ``"crashed"``)."""

    def __init__(self, message: str, *, path: str = "",
                 reason: str = "corrupt"):
        super().__init__(message)
        self.path = path
        self.reason = reason


class SwapError(RuntimeError):
    """A live weight hot-swap candidate was rejected (or a rollback had
    nothing to arm). The engine is guaranteed to still be serving the
    weights it served before the attempt — a swap either completes
    atomically at an iteration boundary or leaves no trace on the hot
    path.

    Carries the pipeline ``stage`` where the candidate died
    (``"verify"`` — checksum/commit verification failed, candidate
    quarantined; ``"stage"`` — I/O or restore failure reading the
    verified save; ``"validate"`` — restored tree mismatches the
    serving model's structure/shapes/dtypes; ``"arm"`` / ``"rollback"``
    — barrier-side refusals) and the candidate ``epoch`` (None when no
    candidate was identified).
    """

    def __init__(self, message: str, *, stage: str = "swap",
                 epoch: int | None = None):
        super().__init__(message)
        self.stage = stage
        self.epoch = epoch
