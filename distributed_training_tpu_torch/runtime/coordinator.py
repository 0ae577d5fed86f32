"""Multi-process coordination over the default process group.

The port of ``distributed_training_tpu/runtime/coordinator.py``
(ColossalAI's ``DistCoordinator``): the process index and count, rank-0
gating of prints, a barrier, rank-0-first execution and a broadcast
scalar. Without a group every method acts as the single process it is.
"""

from __future__ import annotations

import builtins
import contextlib

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.runtime.distributed import process_group


def _device_for(group) -> torch.device:
    """Where a collective's tensor lives: the current card under NCCL, the
    CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Coordinator:
    """Process-level coordination facade over the default group (read
    when each method runs, so one made before the group opens sees it)."""

    @property
    def group(self):
        return process_group()

    @property
    def process_index(self) -> int:
        return dist.get_rank() if self.group is not None else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if self.group is not None else 1

    @property
    def world_size(self) -> int:
        """Data-parallel ranks: one device a process."""
        return self.process_count

    def is_master(self) -> bool:
        return self.process_index == 0

    def barrier(self, tag: str = "barrier") -> None:
        if self.group is not None:
            dist.barrier()

    @contextlib.contextmanager
    def priority_execution(self, tag: str = "priority_execution"):
        """Rank 0 runs the body first; the others wait, then run it."""
        if not self.is_master():
            self.barrier(tag + ":enter")
        try:
            yield
        finally:
            if self.is_master():
                self.barrier(tag + ":enter")
            self.barrier(tag + ":exit")

    def print(self, *args, **kwargs) -> None:
        """Print on rank 0 only."""
        if self.is_master():
            builtins.print(*args, **kwargs)

    def broadcast_scalar(self, value: float) -> float:
        """Agree on a host scalar across processes (rank 0's wins)."""
        if self.group is None:
            return value
        t = torch.tensor([value], dtype=torch.float32, device=_device_for(self.group))
        dist.broadcast(t, src=0)
        return float(t.item())
