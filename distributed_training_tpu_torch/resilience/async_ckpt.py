"""Asynchronous checkpointing: snapshot now, persist in the background.

The port of ``distributed_training_tpu/resilience/async_ckpt.py``
(CheckFreq's split): the step loop pays only for a host copy of the state
(:class:`Snapshot`); a writer thread serialises it through the
commit protocol of ``checkpoint.py`` (payload, manifest, ``COMMITTED``),
so the save's file I/O overlaps the following steps.

The copy is the part the JAX package gets for free: its arrays are
immutable, so a snapshot is a reference. The port's optimizers update
parameters and moments in place (K1, ``torch._foreach_*``, the ZeRO
shards of ``train/train_state.py``), so a reference would be overwritten
by the next step. :class:`Snapshot` therefore copies every tensor
into new host memory: from the card into pinned buffers, queued on the
current stream (``non_blocking``), so every later in-place write on that
stream runs after the copy has read its source; an event recorded after
the copies lets the writer thread wait for them before it serialises.
The host does not wait for the card. Under ZeRO the state is gathered to
the whole tensors of the synchronous save (``TrainState.state_dict``, the
world-1 format) by every rank together; rank 0 alone copies it to the
host and writes it.

Failures in the writer thread are recorded and surface on :meth:`wait`
(or on a ``sync=True`` save), as the JAX writer's do. As in JAX, a
``post_save`` hook runs in the writer thread after each committed save
(the chaos harness tears saves there, where a crash would), and a span
trace gets the writer's own ``ckpt-writer`` track (``ckpt.persist`` and
``ckpt.prune`` spans), where its overlap with the steps shows.
"""

from __future__ import annotations

import contextlib
import queue as queue_lib
import threading
from typing import Any, Callable

import torch

from distributed_training_tpu_torch import checkpoint as ckpt_lib


def _to_host(obj, copies: list) -> Any:
    """``obj`` with every tensor replaced by a new host copy (see the
    module docstring); numbers and strings as they are."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cuda":
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            copies.append(t.device)
            return out
        return t.clone()
    if isinstance(obj, dict):
        return {k: _to_host(v, copies) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, copies) for v in obj)
    return obj


class Snapshot:
    """A host copy of a state dict and the event after its copies."""

    def __init__(self, sd: dict):
        devices: list = []
        self.sd = _to_host(sd, devices)
        self.event = None
        if devices:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(devices[0]))

    def ready(self) -> dict:
        """The state dict, once every copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.sd


class AsyncCheckpointWriter:
    """Serial background writer of checkpoint saves (rank 0 writes; every
    rank snapshots)."""

    _STOP = object()

    def __init__(self, *, post_save: Callable[[str, int], None] | None = None,
                 printer: Callable[[str], None] = print, trace=None):
        """``post_save(path, epoch)`` runs in the writer thread after each
        committed save; ``trace`` is a ``TraceSession`` or None."""
        self._q: queue_lib.Queue = queue_lib.Queue(maxsize=1)
        self._thread: threading.Thread | None = None
        self._post_save = post_save
        self._trace = trace
        self._printer = printer
        self._lock = threading.Lock()
        self.last_error: BaseException | None = None
        self.counters = {"saves_committed": 0, "saves_failed": 0}

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name="ckpt-writer", daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is self._STOP:
                    return
                if task[0] == "save":
                    _, directory, epoch, snapshot, kwargs = task
                    with self._span("ckpt.persist", epoch=int(epoch)):
                        path = ckpt_lib.write_checkpoint(directory, epoch,
                                                         snapshot.ready(), **kwargs)
                    with self._lock:
                        self.counters["saves_committed"] += 1
                    if self._post_save is not None:
                        self._post_save(path, epoch)
                else:  # prune
                    _, directory, keep = task
                    with self._span("ckpt.prune"):
                        ckpt_lib.prune_checkpoints(directory, keep)
            except BaseException as e:  # noqa: BLE001 - recorded, surfaced on wait
                with self._lock:
                    if task is not self._STOP and task[0] == "save":
                        self.counters["saves_failed"] += 1
                    self.last_error = e
                self._printer(f"[ckpt-writer] background save failed: {e}")
            finally:
                self._q.task_done()

    def _span(self, name: str, **attrs):
        """A span on the writer's track, or nothing without a trace."""
        if self._trace is None:
            return contextlib.nullcontext()
        return self._trace.span(name, track="ckpt-writer", **attrs)

    def save(self, directory: str, epoch: int, state, *, sync: bool = False,
             **kwargs: Any) -> None:
        """Snapshot ``state`` now and persist it in the background (the
        keywords of ``checkpoint.write_checkpoint``). Every rank calls it
        (the state dict gathers under ZeRO). ``sync=True`` also drains the
        queue, raises if this save failed, and holds every rank at a
        barrier until it is committed: the preemption save's contract."""
        sd = state.state_dict()
        if state.writes_checkpoints():
            snapshot = Snapshot(sd)
            self._ensure_thread()
            failed_before = self.counters["saves_failed"]
            self._q.put(("save", directory, int(epoch), snapshot, kwargs))
            if sync:
                err = self._drain_error()
                if self.counters["saves_failed"] > failed_before:
                    raise RuntimeError(f"checkpoint save of epoch {epoch} to "
                                       f"{directory} failed: {err}") from err
                if err is not None:  # an earlier failure, already counted
                    self._printer(f"[ckpt-writer] note: an earlier background "
                                  f"save had failed: {err}")
        if sync:
            state.zero.barrier()

    def prune(self, directory: str, keep: int) -> None:
        """Enqueue retention pruning, after the pending saves."""
        self._ensure_thread()
        self._q.put(("prune", directory, int(keep)))

    def _drain_error(self) -> BaseException | None:
        if self._thread is not None:
            self._q.join()
        with self._lock:
            err, self.last_error = self.last_error, None
        return err

    def wait(self, raise_on_error: bool = True) -> None:
        """Block until every queued task is done; surface (once) a
        recorded failure, raising with ``raise_on_error``."""
        err = self._drain_error()
        if err is not None:
            if raise_on_error:
                raise RuntimeError(f"async checkpoint save failed: {err}") from err
            self._printer(f"[ckpt-writer] background failure "
                          f"({self.counters['saves_failed']} in all): {err}")

    def close(self, raise_on_error: bool = False) -> None:
        """Drain and stop the writer thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            self.wait(raise_on_error=raise_on_error)
            self._q.put(self._STOP)
            self._thread.join(timeout=30)
        self._thread = None
