"""Profiling hooks: a profiler trace of a run and a wall-clock breakdown.

The port of ``distributed_training_tpu/utils/profiling.py``:

- :func:`trace` takes a ``torch.profiler`` trace (host and, on the card,
  device activity) of its block and writes it into ``log_dir`` as a Chrome
  trace (``trace_<pid>.json``, for chrome://tracing or Perfetto), where the
  JAX package writes a ``jax.profiler`` trace;
- :class:`WallClock`, DeepSpeed's ``wall_clock_breakdown``: wall time
  split into named phases (the trainers use ``data``, ``step``, ``log``,
  ``eval`` and ``ckpt``, as the JAX trainers do), reported per epoch.

Not ported: what the JAX ``WallClock`` keeps for the flight recorder (the
span-trace session it can feed, its run-lifetime totals and the open
phase that ``/healthz`` reads).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (no-op when None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class WallClock:
    """Phase timer: ``with clock.phase('data'): ...``; :meth:`report` per
    epoch.

    Attribution is exclusive, as in the JAX package: entering a nested
    phase pauses the outer one, so the totals partition the tracked wall
    time. PyTorch returns before the card finishes, so with ``device`` a
    CUDA device each phase boundary synchronises it, and a phase's time is
    the device work it queued; only when enabled (disabled, a phase costs
    nothing and synchronises nothing).
    """

    def __init__(self, enabled: bool = False,
                 device: str | torch.device | None = None):
        self.enabled = enabled
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self.totals: dict[str, float] = defaultdict(float)
        self._stack: list[list] = []  # [name, segment_start] frames

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        now = self._now()
        if self._stack:  # pause the outer phase
            outer = self._stack[-1]
            self.totals[outer[0]] += now - outer[1]
        self._stack.append([name, now])
        try:
            yield
        finally:
            now = self._now()
            frame = self._stack.pop()
            self.totals[frame[0]] += now - frame[1]
            if self._stack:  # resume the outer phase's segment
                self._stack[-1][1] = now

    def report(self) -> dict[str, float]:
        """This epoch's phase totals in seconds; clears them."""
        out = dict(self.totals)
        self.totals.clear()
        return out
