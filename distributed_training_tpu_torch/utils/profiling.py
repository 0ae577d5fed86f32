"""Profiling hooks: a profiler trace of a run and a wall-clock breakdown.

The port of ``distributed_training_tpu/utils/profiling.py``:

- :func:`trace` takes a ``torch.profiler`` trace (host and, on the card,
  device activity) of its block and writes it into ``log_dir`` as a Chrome
  trace (``trace_<pid>.json``, for chrome://tracing or Perfetto), where the
  JAX package writes a ``jax.profiler`` trace;
- :class:`WallClock`, DeepSpeed's ``wall_clock_breakdown``: wall time
  split into named phases (the trainers use ``data``, ``step``, ``log``,
  ``eval`` and ``ckpt``, as the JAX trainers do), reported per epoch.

The clock also keeps the run-lifetime totals the flight recorder's
goodput reads (:meth:`WallClock.snapshot`), and the phase open now (the
live exporter's ``/healthz``). With a span-trace session
(``observability/trace.py``) each phase is also one span, inclusive of
its nested phases, on the clock's track: how both trainers get their
step, data, log, eval and ckpt spans.
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
    nothing and synchronises nothing). Without ``device`` the clock reads
    host time only, as JAX's does (the trainers run it so for the flight
    recorder's goodput: the phases then bill host time, and the device's
    lands where the host waits for it, at the meter's flush).
    """

    def __init__(self, enabled: bool = False,
                 device: str | torch.device | None = None, *, trace=None,
                 track: str = "train"):
        """``trace`` (a ``TraceSession`` or None) receives each phase as a
        span on ``track``."""
        self.enabled = enabled
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self.trace, self.track = trace, track
        self.totals: dict[str, float] = defaultdict(float)
        # Run-lifetime totals: report() clears ``totals`` each epoch.
        self.lifetime: dict[str, float] = defaultdict(float)
        self._stack: list[list] = []  # [name, segment_start, entry] frames

    def _accrue(self, name: str, dt: float) -> None:
        self.totals[name] += dt
        self.lifetime[name] += dt

    @property
    def current_phase(self) -> str | None:
        """The innermost open phase, or None. Read without a lock from the
        exporter's thread: the stack gains and loses whole frames under
        the interpreter lock, and a stale answer is fine there."""
        try:
            return self._stack[-1][0]
        except IndexError:  # popped between the check and the read
            return None

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def phase(self, name: str):
        """A context manager that bills the time inside it to ``name``
        (nested phases pause the outer one); a shared no-op when disabled."""
        return _Phase(self, name) if self.enabled else _OFF

    def snapshot(self) -> dict[str, float]:
        """Run-lifetime phase totals in seconds, never cleared."""
        return dict(self.lifetime)

    def report(self) -> dict[str, float]:
        """This epoch's phase totals in seconds; clears them."""
        out = dict(self.totals)
        self.totals.clear()
        return out


class _Phase:
    """One open phase of a :class:`WallClock` (a class, not a generator:
    the trainers enter three a step)."""

    __slots__ = ("clock", "name")

    def __init__(self, clock: WallClock, name: str):
        self.clock, self.name = clock, name

    def __enter__(self):
        clock = self.clock
        now = clock._now()
        if clock._stack:  # pause the outer phase
            outer = clock._stack[-1]
            clock._accrue(outer[0], now - outer[1])
        clock._stack.append([self.name, now, now])

    def __exit__(self, *exc) -> None:
        clock = self.clock
        now = clock._now()
        frame = clock._stack.pop()
        clock._accrue(frame[0], now - frame[1])
        if clock._stack:  # resume the outer phase's segment
            clock._stack[-1][1] = now
        if clock.trace is not None:
            clock.trace.complete(frame[0], frame[2], now, track=clock.track)


_OFF = contextlib.nullcontext()
