"""Process-group bring-up and tear-down.

The port of ``distributed_training_tpu/runtime/distributed.py``. The JAX
package calls ``jax.distributed.initialize`` and lets XLA compile the
collectives; the port opens a ``torch.distributed`` process group, over
NCCL on the card and gloo on the CPU, and the train step calls the
collectives itself (``parallel/zero.py``).

:func:`initialize_distributed` reads the launcher's environment, as
``torchrun`` sets it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), or explicit arguments, which win. A
single process with no such environment opens no group and runs at world
1, as the JAX package does; an explicit ``init_method`` opens one even at
world 1 (``chip_smoke.py`` brings NCCL up so on one card). A group that
should exist and does not come up raises: the port never carries on at
world 1 when ``WORLD_SIZE`` says more. :func:`shutdown_distributed` is
the one place that tears the groups down.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.utils.device import resolve_device


def _env_int(name: str) -> int | None:
    return int(os.environ[name]) if name in os.environ else None


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           local_rank: int | None = None,
                           device: str | torch.device | None = None,
                           timeout_s: float = 600.0):
    """Open the default process group (idempotent); return it, or None
    when this process runs alone with no group.

    - ``init_method`` ← ``tcp://$MASTER_ADDR:$MASTER_PORT``; a ``file://``
      store also works (the tests use one under their temporary directory);
    - ``world_size`` ← ``$WORLD_SIZE``, ``rank`` ← ``$RANK``,
      ``local_rank`` ← ``$LOCAL_RANK`` (else ``rank``);
    - ``device``: None means the card (``cuda:local_rank``, backend NCCL,
      raising without one); ``"cpu"`` means gloo.

    After the group opens, one all-reduce over it must return the world
    size, or this raises.
    """
    if dist.is_initialized():
        return dist.group.WORLD
    explicit = init_method is not None
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank or 0
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if not explicit and (world_size is None or world_size <= 1):
        return None
    if init_method is None or world_size is None or rank is None:
        raise RuntimeError(
            f"initialize_distributed: world size {world_size} needs an init "
            f"method and a rank (got {init_method!r}, rank {rank}); set "
            f"MASTER_ADDR, MASTER_PORT and RANK, or pass them")
    dev = local_device(device, local_rank)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev  # NCCL comes up now, not at the first collective
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if dist.get_world_size() != world_size or int(probe.item()) != world_size:
        got = (dist.get_world_size(), probe.item())
        dist.destroy_process_group()
        raise RuntimeError(f"process group of world {world_size} did not come "
                           f"up: world size and all-reduce read {got}")
    return dist.group.WORLD


def local_device(device: str | torch.device | None = None,
                 local_rank: int | None = None) -> torch.device:
    """This process's device: the CPU when asked for, else
    ``cuda:LOCAL_RANK`` (``cuda:0`` alone); raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK") or 0
        dev = torch.device("cuda", local_rank)
    return dev


def process_group():
    """The default group when one is open, else None."""
    return dist.group.WORLD if dist.is_initialized() else None


def shutdown_distributed() -> None:
    """Tear every group the port opened down, on every rank: first the
    straggler exchange's gloo group beside the default group
    (``observability.aggregate.close_host_group``), then a barrier over the
    default group, so that no rank closes its connections while a peer
    still exchanges over them, then ``destroy_process_group`` (the default
    group and the mesh's groups). A no-op without a group."""
    if not dist.is_initialized():
        return
    from distributed_training_tpu_torch.observability import aggregate

    aggregate.close_host_group()
    dist.barrier()
    dist.destroy_process_group()
