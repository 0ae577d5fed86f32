"""Device prefetch: host batches copied to the card ahead of the step.

The port of ``distributed_training_tpu/data/prefetch.py``. A daemon
worker thread iterates the loader (decode, augment) and places each batch
on the device, ``depth`` batches ahead of the consumer, through a bounded
queue; an exception in the worker is raised at the consumer's next
``__next__``; when the consumer leaves the loop early, the worker is told
to stop and the queue is drained so that it cannot stay blocked holding
batches.

On the card (:class:`CudaStager`) the worker copies each host array into
a pinned staging buffer and issues the host-to-device copy on a stream of
its own with ``non_blocking=True``, then records an event there. The
consumer makes its current stream wait on that event before the step
reads the batch, and marks each tensor as used on that stream
(``record_stream``), so the caching allocator does not hand its memory to
the copy stream while the step still reads it. A staging buffer is used
again only after the event of the copy that read it has completed. On
the CPU the placement is the plain ``to_device``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from distributed_training_tpu_torch.data.pipeline import to_device

_END = object()


class _Error:
    """An exception raised in the worker, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DevicePrefetcher:
    """Wraps a batch iterable; yields placed batches ``depth`` ahead.

    ``place`` maps a host batch to what the worker hands over (it runs on
    the worker thread); ``ready``, if given, maps that to the batch the
    consumer receives, on the consumer's thread.
    """

    def __init__(self, batches: Iterable, place: Callable[[Any], Any],
                 depth: int = 2, ready: Callable[[Any], Any] | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._batches = batches
        self._place = place
        self._ready = ready
        self._depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put(item) -> bool:
            # A bounded wait: once the consumer has left, the stop flag
            # frees the worker instead of leaving it blocked on a full
            # queue that holds batches on the device.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches:
                    if stop.is_set() or not put(self._place(batch)):
                        return
            except BaseException as e:  # noqa: BLE001 (raised in the consumer)
                put(_Error(e))
                return
            put(_END)

        threading.Thread(target=worker, name="DevicePrefetcher", daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Error):
                    raise item.exc
                yield item if self._ready is None else self._ready(item)
        finally:
            stop.set()
            try:  # drain, so that a worker blocked in put() sees the flag
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


class _Staged:
    """A batch whose copy to the card was queued on the copy stream."""

    def __init__(self, batch: dict, event: torch.cuda.Event):
        self.batch, self.event = batch, event


class CudaStager:
    """The card-side ``place`` and ``ready`` of :class:`DevicePrefetcher`
    (see the module docstring). ``copies`` counts the host-to-device
    copies issued, ``stream`` is the copy stream (made on first use, on
    the worker thread)."""

    def __init__(self, device: torch.device):
        # An index of its own: the worker thread's current device is not
        # the consumer's.
        self.device = (device if device.index is not None
                       else torch.device("cuda", torch.cuda.current_device()))
        self.stream: torch.cuda.Stream | None = None
        self.copies = 0
        # (shape, dtype) → [(pinned buffer, event of the copy that read it)];
        # touched only by the worker thread.
        self._pool: dict[tuple, list] = {}

    def _buffer(self, key: tuple, arr: np.ndarray) -> torch.Tensor:
        """A pinned buffer for ``arr``: a free one whose copy has completed,
        else a new one."""
        free = self._pool.setdefault(key, [])
        for i, (buf, event) in enumerate(free):
            if event.query():
                del free[i]
                return buf
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        return torch.empty(arr.shape, dtype=dtype, pin_memory=True)

    def place(self, batch: dict) -> _Staged:
        """Worker side: stage each array and queue its copy on the copy
        stream; an event marks the end of the batch's copies."""
        torch.cuda.set_device(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        out, used = {}, []
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                v = np.ascontiguousarray(v)
                key = (v.shape, v.dtype.str)
                buf = self._buffer(key, v)
                buf.copy_(torch.from_numpy(v))
                out[k] = buf.to(self.device, non_blocking=True)
                used.append((key, buf))
                self.copies += 1
            event = torch.cuda.Event()
            event.record(self.stream)
        for key, buf in used:
            self._pool[key].append((buf, event))
        return _Staged(out, event)

    def ready(self, staged: _Staged) -> dict:
        """Consumer side: the current stream waits for the batch's copies,
        and each tensor is marked as used on it."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(staged.event)
        for t in staged.batch.values():
            t.record_stream(current)
        return staged.batch


def prefetch_to_device(batches: Iterable, device: torch.device, depth: int = 2,
                       host: Callable[[dict], dict] | None = None) -> DevicePrefetcher:
    """``batches`` (numpy dicts, each first mapped by ``host`` on the
    worker thread) on ``device``, ``depth`` ahead: through a
    :class:`CudaStager` on the card, the plain ``to_device`` on the CPU."""
    host = host or (lambda b: b)
    if device.type == "cuda":
        stager = CudaStager(device)
        prefetcher = DevicePrefetcher(batches, lambda b: stager.place(host(b)), depth,
                                      ready=stager.ready)
        prefetcher.stager = stager
        return prefetcher
    return DevicePrefetcher(batches, lambda b: to_device(host(b), device), depth)
