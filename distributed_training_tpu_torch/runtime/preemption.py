"""Preemption handling: latch SIGTERM, save, exit clean.

The port of ``distributed_training_tpu/runtime/preemption.py``. A cloud
scheduler sends SIGTERM and a grace window before it evicts a job, so the
trainers flip a flag on the signal, finish the step in flight, save a
checkpoint that says how far into its epoch training got, and return;
with ``auto_resume`` the next run picks up from that save.
"""

from __future__ import annotations

import signal
from typing import Iterable

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.runtime.coordinator import _device_for
from distributed_training_tpu_torch.runtime.distributed import process_group


class PreemptionGuard:
    """Latches termination signals into a flag the step loop polls.

    The first signal sets the flag (the graceful path); a second one goes
    to the handler that was there before (repeated SIGTERM means now, and
    the default disposition terminates). Installed on entering the
    ``with`` block, restored on leaving it; signal handlers can only be
    installed from the main thread.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous: dict[int, object] = {}
        self.triggered = False

    def _handle(self, signum, frame):
        if self.triggered:  # second signal: defer to the previous handler
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self.triggered = True

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()

    def should_stop(self, at_sync_point: bool = True) -> bool:
        """Whether the step loop should break now.

        Alone (no process group, or one rank): the local flag, every step.
        Under a group the signal reaches each rank at another time, and a
        rank that broke alone would leave the others blocked in the next
        step's collectives; so the flag is agreed with one all-reduce (max)
        of a flag tensor, and only at ``at_sync_point`` steps (the trainers
        pass their log-interval flushes, which every rank reaches at the
        same step), so the steady step makes no collective for it.
        """
        group = process_group()
        if group is None or dist.get_world_size(group) == 1:
            return self.triggered
        if not at_sync_point:
            return False
        flag = torch.tensor([float(self.triggered)], device=_device_for(group))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item() > 0)
