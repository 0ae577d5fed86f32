"""N train steps in one call: the counterpart of the root bench's ``multi``.

The root ``bench.py`` compiles N steps of its jitted step into one
dispatch: a ``lax.scan`` of the step over one device batch, the state
donated, the inner step run once first to prime it. :func:`make_multi_step`
gives the port's steps (``train/step.py``, ``train/lm_step.py``) the same
contract: a callable that runs N steps of one batch and returns the last
step's metrics.

- **On the card** the N steps are one ``torch.cuda.CUDAGraph``. First one
  eager step primes it, as the root bench primes its inner jit: on a side
  stream, it builds the kernels with ``nvcc``, initialises cuBLAS and
  cuDNN and is the warm-up a capture needs (the state takes that step).
  Then N steps are captured, and each call replays them. A capture that
  fails raises; nothing falls back to eager steps.
- **On the CPU** there is no graph and nothing to prime: each call runs
  the same N steps in a loop.

Every step runs with ``state.capturable`` set, so it reads no host number
that changes from step to step: the optimizer takes its learning rate and
bias corrections from the count tensor it advances on the card
(``train/optim.py``), and K1 reads them from device memory
(``ops/fused_adam.py``). What needs the host refuses: the dynamic loss scale
(``precision.commit_gradients``) and dropout or noisy gates
(``step.dropout_generator``) raise ``NotImplementedError``. On the card the
state must also be updated in place on its card: expert parallelism, the
pipeline, the fsdp axis and ``cpu_offload`` (host copies) raise, as
ROADMAP.md lists. A process group and tensor parallelism (with or without
``tp_overlap``) are captured when their groups are NCCL's: each replay
launches the step's collectives in the order every rank captured them.
The priming step runs each of them once before the capture, so that every
communicator of the data, model and mesh groups is up when the capture
begins.

The graph writes where it captured: the parameters, the optimizer's slots,
its count tensor and the BatchNorm statistics are updated in place, the
batch is read from the tensors given here (write new data into them to
feed other rows), and the returned metrics are the graph's own output
tensors, overwritten by the next call. The host counters (``state.step``,
``state.opt_state.count``) advance by N a call, as the count tensor does on
the card. The wrappers' launch counters tick when the graph is captured,
not when it replays: :func:`graph_kernels` lists the kernels that every
replay launches, from the captured graph itself.
"""

from __future__ import annotations

import contextlib
import re
import warnings
from typing import Callable

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.train.train_state import TrainState


@contextlib.contextmanager
def _capturable(state: TrainState):
    state.capturable = True
    try:
        yield
    finally:
        state.capturable = False


def _check_graph_state(state: TrainState) -> None:
    zero = state.zero
    sharded = [name for name, on in (
        ("expert parallelism", zero.ep is not None),
        ("the pipeline", zero.pp is not None),
        ("the fsdp axis", zero.fsdp is not None),
        ("cpu_offload", zero.cpu_offload)) if on]
    if sharded:
        raise NotImplementedError(
            f"a CUDA graph of train steps takes a state updated in place on "
            f"its card; not yet with {', '.join(sharded)} (ROADMAP.md, queue B)")
    groups = {"the replica group": zero.group,
              "the model group": zero.tp.group if zero.tp is not None else None}
    other = {what: dist.get_backend(g) for what, g in groups.items()
             if g is not None and dist.get_backend(g) != "nccl"}
    if other:
        raise NotImplementedError(
            f"a CUDA graph captures the collectives of NCCL groups only; "
            f"{', '.join(f'{w} is {b}' for w, b in other.items())}")


def make_multi_step(step: Callable, state: TrainState, batch: dict,
                    n: int, keep_graph: bool = False) -> Callable[[], dict]:
    """``multi() -> metrics``: ``n`` steps of ``step(state, batch)``, the
    last step's metrics returned (see the module docstring). On the card
    it runs the priming step and captures the graph before it returns.
    ``multi.graph`` is the ``torch.cuda.CUDAGraph`` (None on the CPU); with
    ``keep_graph`` its captured nodes are kept for :func:`graph_kernels`."""
    if n < 1:
        raise ValueError(f"steps per call must be >= 1, got {n}")
    device = next(iter(batch.values())).device
    if device.type != "cuda":
        def multi() -> dict:
            with _capturable(state):
                for _ in range(n):
                    metrics = step(state, batch)
            return metrics
        multi.graph = None
        return multi

    _check_graph_state(state)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), _capturable(state):
        step(state, batch)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    # The capture runs the steps' Python once: it advances the host
    # counters, but no work ran. Each replay advances them by n.
    steps, count = state.step, state.opt_state.count
    try:
        with _capturable(state), torch.cuda.graph(graph):
            reserved = torch.cuda.memory_reserved(device)  # after the capture's empty_cache
            for _ in range(n):
                metrics = step(state, batch)
    finally:
        state.step, state.opt_state.count = steps, count
    if keep_graph:  # the captured graph stays beside its instance
        graph.instantiate()
    pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def multi() -> dict:
        graph.replay()
        state.step += n
        state.opt_state.count += n
        return metrics
    multi.pool_bytes = pool_bytes  # the device memory the capture reserved: the graph's pool
    multi.graph = graph
    return multi


# A kernel node of ``cudaGraphDebugDotPrint``'s verbose dump: its label
# opens with ``{KERNEL``, then ``| {ID | <id> (topoId: <n>) | <name>\<\<\<``
# with the function's mangled name before the escaped launch brackets.
_DOT_KERNEL = re.compile(r"\{KERNEL\s*\|\s*\{ID \|[^|]*\|\s*([^\\{}|\s]+)")


def dot_kernel_names(text: str) -> list[str]:
    """The (mangled) function names of the kernel nodes in ``text``, a
    graph's verbose DOT dump, in the dump's order."""
    return _DOT_KERNEL.findall(text)


def graph_kernels(multi: Callable, path: str) -> list[str]:
    """The kernels that each replay of ``multi`` launches, one name per
    kernel node of its graph: ``multi`` from ``make_multi_step(...,
    keep_graph=True)`` on the card, its graph dumped as DOT to ``path``."""
    if multi.graph is None:
        raise ValueError("no CUDA graph: the N-step call runs on the CPU")
    with warnings.catch_warnings():  # debug_dump warns at each call
        warnings.simplefilter("ignore")
        multi.graph.debug_dump(path)
    with open(path) as f:
        return dot_kernel_names(f.read())
