"""The device mesh as process groups, and the ring shift every ring runs.

The port of ``distributed_training_tpu/runtime/mesh.py``. The JAX package
lays its devices out as a logical ``jax.sharding.Mesh`` over the
canonical axes and lets GSPMD and ``shard_map`` bind them; the port lays
its *ranks* out the same way and opens one ``torch.distributed`` process
group for each set of axes a step reduces over:

- :data:`CANONICAL_AXES` orders the axes outer to inner, ``data`` varying
  slowest and ``sequence`` fastest, so rank ``r`` holds the coordinates
  (and hence the batch rows, time chunk and weight shards) that JAX
  device ``r`` holds on ``create_mesh`` of the same sizes;
- :class:`Mesh` resolves the sizes against the world size (one axis may
  be ``-1``, as in ``create_mesh``), and :meth:`Mesh.group` returns the
  group of the ranks that differ from this one only along the given
  axes: the default group when that is every rank (a world-1 group
  included), else ``None`` when it is this rank alone (every collective
  an identity);
- :func:`ring_shift` is the port of ``lax.ppermute`` with
  ``perm = [(j, (j - 1) % n)]``: index ``j`` of the group sends to
  ``j - 1`` and receives from ``j + 1``, in one
  ``dist.batch_isend_irecv``. It is differentiable; its backward is the
  reverse shift, as the transpose of a ``ppermute`` is the reverse hop;
- :func:`pipe_hop` is the other direction, the pipeline's
  ``perm = [(j, (j + 1) % n)]``: index ``j`` sends to the next stage
  ``j + 1`` (:func:`shift_prev` forward, :func:`shift_next` backward).

Groups are opened when the mesh is built, by every rank in the same order
(``dist.new_group`` is collective over the default group).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_EXPERT = "expert"
AXIS_SEQUENCE = "sequence"
AXIS_PIPE = "pipe"

CANONICAL_AXES = (
    AXIS_DATA, AXIS_PIPE, AXIS_FSDP, AXIS_MODEL, AXIS_EXPERT, AXIS_SEQUENCE)

# The sets of axes the strategies communicate over: the replica group
# without ``fsdp`` (gradients, metrics and ZeRO at fsdp 1; without the
# expert axis it is also the group of ranks that hold other tokens, over
# which the MoE gate counts), the tensor-parallel group, the ring, the
# expert group and the pipeline; then the ``fsdp`` axis's: the whole
# replica group (data × fsdp × sequence), the fsdp group that shards the
# parameters, and data × fsdp (the image batch's split, over which the
# image models' MoE gate counts). The fsdp groups are opened only where
# the axis spans ranks.
_GROUP_AXES = ((AXIS_DATA, AXIS_SEQUENCE), (AXIS_MODEL,), (AXIS_SEQUENCE,),
               (AXIS_EXPERT,), (AXIS_PIPE,))
_FSDP_GROUP_AXES = ((AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE), (AXIS_FSDP,),
                    (AXIS_DATA, AXIS_FSDP))


def mesh_sizes(spec, world: int) -> dict[str, int]:
    """The axis sizes of ``spec`` (a ``config.MeshSpec``) over ``world``
    processes, with ``create_mesh``'s rule and messages: at most one axis
    is ``-1`` and takes what the others leave; the product is the world."""
    sizes = {a: int(getattr(spec, a)) for a in CANONICAL_AXES}
    infer = [a for a, d in sizes.items() if d == -1]
    if len(infer) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got "
                         f"{list(sizes)}={list(sizes.values())}")
    fixed = math.prod(d for d in sizes.values() if d != -1)
    if infer:
        if world % fixed:
            raise ValueError(f"{world} devices not divisible by fixed axes "
                             f"product {fixed}")
        sizes[infer[0]] = world // fixed
    elif fixed != world:
        raise ValueError(f"mesh {sizes} needs {fixed} devices, have {world} "
                         f"(the world size)")
    return sizes


def data_axis_size(sizes: dict[str, int]) -> int:
    """Replica count for data-parallel semantics (``scale_lr_by_world``,
    the batch triple): ``data × fsdp``, as the JAX ``data_axis_size``."""
    return sizes[AXIS_DATA] * sizes[AXIS_FSDP]


class Mesh:
    """This rank's place on the mesh of ``spec`` (a ``config.MeshSpec``)
    over the default group's ranks (one, rank 0, without a group), and the
    process groups along its axes (see the module docstring)."""

    def __init__(self, spec):
        opened = dist.is_initialized()
        self.world = dist.get_world_size() if opened else 1
        self.rank = dist.get_rank() if opened else 0
        self.sizes = mesh_sizes(spec, self.world)
        dims = [self.sizes[a] for a in CANONICAL_AXES]
        self.coords = dict(zip(CANONICAL_AXES,
                               (int(c) for c in np.unravel_index(self.rank, dims))))
        self._groups: dict[tuple, object] = {}
        for axes in _GROUP_AXES:
            self._groups[axes] = self._open(axes, dims, opened)
        for axes in _FSDP_GROUP_AXES:
            # At fsdp 1 a group without the axis's size-1 axes is one the
            # mesh already holds (no second dist.new_group of the same ranks).
            same = tuple(a for a in axes if self.sizes[a] > 1)
            held = [k for k in _GROUP_AXES
                    if tuple(a for a in k if self.sizes[a] > 1) == same]
            self._groups[axes] = (self._groups[held[0]] if held and same
                                  else self._open(axes, dims, opened))

    def _open(self, axes: tuple, dims: list[int], opened: bool):
        """The group along ``axes`` that holds this rank; every rank opens
        every such group (in the same order) when one is needed."""
        size = math.prod(self.sizes[a] for a in axes)
        if size == self.world and opened:
            return dist.group.WORLD
        if size == 1:
            return None
        if not opened:
            raise RuntimeError(f"mesh axes {axes} span {size} ranks but no "
                               f"process group is open")
        grid = np.arange(self.world).reshape(dims)
        moving = [CANONICAL_AXES.index(a) for a in axes]
        fixed = [i for i in range(len(dims)) if i not in moving]
        mine = None
        for at in itertools.product(*(range(dims[i]) for i in fixed)):
            index = [slice(None)] * len(dims)
            for i, c in zip(fixed, at):
                index[i] = c
            ranks = sorted(int(r) for r in grid[tuple(index)].reshape(-1))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def group(self, *axes: str):
        """The process group over ``axes`` (canonical order): the default
        group when it spans every rank (at world 1 too, when one is open),
        else None when it is this rank alone."""
        key = tuple(a for a in CANONICAL_AXES if a in axes)
        if key not in self._groups:
            raise KeyError(f"no process group over {key}; the mesh opens "
                           f"{list(self._groups)}")
        return self._groups[key]

    @property
    def data_size(self) -> int:
        return data_axis_size(self.sizes)

    @property
    def replica_index(self) -> int:
        """This rank's index among the ``data × fsdp`` replicas, data-major
        (``d·F + f``): the row block of a batch split over both axes, as
        JAX's ``batch_sharding`` splits the image batch."""
        return self.index(AXIS_DATA) * self.size(AXIS_FSDP) + self.index(AXIS_FSDP)

    def is_master(self) -> bool:
        return self.rank == 0


def group_ranks(group) -> list[int]:
    """The global ranks of ``group``, in the group's index order."""
    return dist.get_process_group_ranks(group)


def _shift(tensors: list[torch.Tensor], group, step: int) -> list[torch.Tensor]:
    """Each tensor of index ``j`` goes to index ``j + step`` of ``group``
    (mod its size); returns what arrived from ``j - step``. One batch of
    non-blocking sends and receives."""
    ranks = group_ranks(group)
    n, j = len(ranks), dist.get_rank(group)
    to, frm = ranks[(j + step) % n], ranks[(j - step) % n]
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t, to, group))
        ops.append(dist.P2POp(dist.irecv, o, frm, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def shift_next(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """``lax.ppermute`` by ``[(j, (j - 1) % n)]``: afterwards index ``j``
    holds what index ``j + 1`` held (not differentiable)."""
    return _shift(tensors, group, -1)


def shift_prev(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The reverse hop: afterwards index ``j`` holds what ``j - 1`` held."""
    return _shift(tensors, group, +1)


class _RingShift(torch.autograd.Function):
    """:func:`shift_next` forward, :func:`shift_prev` backward."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(shift_next(list(tensors), group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *shift_prev(list(grads), ctx.group))


def ring_shift(group, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Differentiable :func:`shift_next` of ``tensors`` over ``group`` (an
    identity when ``group`` is None or this rank alone)."""
    if group is None or dist.get_world_size(group) == 1:
        return tensors
    return _RingShift.apply(group, *tensors)


class _PipeHop(torch.autograd.Function):
    """:func:`shift_prev` forward, :func:`shift_next` backward."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(shift_prev(list(tensors), group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *shift_next(list(grads), ctx.group))


def pipe_hop(group, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Differentiable :func:`shift_prev` of ``tensors`` over ``group``:
    ``lax.ppermute`` by ``[(j, (j + 1) % n)]``, each stage's output to the
    next stage (an identity when ``group`` is None or this rank alone)."""
    if group is None or dist.get_world_size(group) == 1:
        return tensors
    return _PipeHop.apply(group, *tensors)
