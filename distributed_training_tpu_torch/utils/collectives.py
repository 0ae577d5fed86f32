"""Collective accounting: the ``torch.distributed`` calls one step makes.

The port of the accounting half of ``distributed_training_tpu/utils/hlo.py``
(``collective_accounting``, ``step_collectives``). The JAX package reads
the collectives XLA compiled into the step's HLO; the port issues its
collectives by hand, so it counts the calls as the step makes them:
:func:`count_collectives` swaps the ``torch.distributed`` functions the
port calls for counting wrappers while its block runs, and yields
``{kind: {"count", "bytes"}}`` under JAX's kind names (``hlo.py``'s
``all-reduce``, ``all-gather``, ``reduce-scatter``, ``collective-permute``,
``collective-broadcast``; the port issues no ``all-to-all``).

- **What is counted.** ``dist.all_reduce``, ``all_gather``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``broadcast`` and
  ``batch_isend_irecv``: every port module reaches them as ``dist.<name>``
  (``import torch.distributed as dist``), so swapping the module's
  attribute sees each call, those inside autograd's ``backward`` (the
  ring's and the pipeline's hops, TP's f and g, SyncBN) included, on
  whatever thread runs them. ``isend``/``irecv`` are not swapped:
  ``dist.P2POp`` accepts only c10d's own functions. A batch of them counts
  one ``collective-permute`` for each ``irecv`` it holds. ``barrier``,
  ``new_group`` and the object collectives (the straggler view's, outside
  a step) are not counted.
- **Bytes** are the output payload, as ``hlo.py`` sums output shapes: an
  all-reduce its tensor, an all-gather the gathered result, a
  reduce-scatter the shard it returns, a broadcast its tensor, a permute
  the tensor received.
- **Once a call.** A call issued inside a counted call (a depth guard per
  thread) is not counted again; an ``async_op=True`` call counts when it
  is issued.
- **Dynamic counts.** Each call counts, so the ring's ``2·(n−1)`` hops a
  layer show as that many permutes; JAX's counts are static, one for a
  collective inside a loop body however often it runs.
- **No CUDA graph capture.** A capture runs the Python once, so its
  counts would be one capture's, not a replay's: a counted call on a
  capturing stream raises.

The original functions are back in place when the block exits, an
exception included.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch
import torch.distributed as dist


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _arg(args: tuple, kwargs: dict, name: str):
    """The call's first argument, positional or by ``name``."""
    return args[0] if args else kwargs[name]


def _permutes(ops) -> list[int]:
    """Bytes received by each ``irecv`` of a ``batch_isend_irecv`` list."""
    return [_nbytes(op.tensor) for op in ops if op.op is dist.irecv]


# name → (kind, the payloads one call moves: one entry per counted op).
_COUNTED: dict[str, tuple[str, Callable]] = {
    "all_reduce": ("all-reduce", lambda a, k: [_nbytes(_arg(a, k, "tensor"))]),
    "all_gather": ("all-gather",
                   lambda a, k: [sum(_nbytes(t) for t in _arg(a, k, "tensor_list"))]),
    "all_gather_into_tensor": ("all-gather",
                               lambda a, k: [_nbytes(_arg(a, k, "output_tensor"))]),
    "reduce_scatter_tensor": ("reduce-scatter", lambda a, k: [_nbytes(_arg(a, k, "output"))]),
    "broadcast": ("collective-broadcast", lambda a, k: [_nbytes(_arg(a, k, "tensor"))]),
    "batch_isend_irecv": ("collective-permute",
                          lambda a, k: _permutes(_arg(a, k, "p2p_op_list"))),
}

_active = threading.Lock()


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def count_collectives() -> Iterator[dict]:
    """Count the counted calls (see the module docstring) made while the
    block runs; yields the live ``{kind: {"count", "bytes"}}``, which holds
    a kind once it was called. One block at a time in a process."""
    if not _active.acquire(blocking=False):
        raise RuntimeError("count_collectives is already counting in this process")
    acct: dict[str, dict[str, int]] = {}
    lock, local = threading.Lock(), threading.local()
    originals = {name: getattr(dist, name) for name in _COUNTED}

    def wrap(name: str, fn: Callable) -> Callable:
        kind, payloads = _COUNTED[name]

        def counted(*args, **kwargs):
            depth = getattr(local, "depth", 0)
            if depth == 0:
                if _capturing():
                    raise RuntimeError(
                        f"dist.{name} during CUDA graph capture: the count would be "
                        f"the capture's, not a replay's")
                sizes = payloads(args, kwargs)
                with lock:
                    entry = acct.setdefault(kind, {"count": 0, "bytes": 0})
                    entry["count"] += len(sizes)
                    entry["bytes"] += sum(sizes)
            local.depth = depth + 1
            try:
                return fn(*args, **kwargs)
            finally:
                local.depth = depth

        return counted

    try:
        if _capturing():
            raise RuntimeError("count_collectives inside a CUDA graph capture")
        for name, fn in originals.items():
            setattr(dist, name, wrap(name, fn))
        yield acct
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
        _active.release()


def step_collectives(step, state, batch) -> dict[str, dict[str, int]]:
    """The collectives of one ``step(state, batch)`` (a step built by the
    port's factories), as ``{kind: {"count", "bytes"}}``.

    Unlike JAX's ``step_collectives``, which lowers the step ahead of time,
    this runs it: the state advances by one step. The counts are dynamic,
    one for each call (see the module docstring)."""
    with count_collectives() as acct:
        step(state, batch)
    return {kind: dict(entry) for kind, entry in acct.items()}
