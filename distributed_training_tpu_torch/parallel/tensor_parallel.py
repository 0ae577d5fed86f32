"""Tensor parallelism: megatron-style layer sharding over the ``model`` axis.

The port of ``distributed_training_tpu/parallel/tensor_parallel.py``. The
JAX package places each weight by a rule table and lets GSPMD insert the
collectives; the port keeps the same table (:data:`LM_TP_RULES`, the GPT
rows, over the Flax paths ``bridge.py`` uses: ``block0/attn/qkv/kernel``)
and writes the collectives the placement implies:

- ``attn/qkv`` ``[D, 3, H, hd]`` shards H (column-parallel: this rank's
  H/tp heads, and K2/K3 run on them); ``attn/out`` ``[H, hd, D]`` shards
  H (row-parallel: one all-reduce a block, then the bias once);
- ``mlp/fc1`` ``[D, F]`` shards columns (and its bias), ``mlp/fc2``
  ``[F, D]`` rows (row-parallel);
- ``lm_head`` ``[D, V]`` shards the vocabulary (the CE over the sharded
  logits is ``train/lm_step.py``'s vocab-parallel CE), and
  ``tok_embed`` ``[V, D]`` too (a masked lookup, then an all-reduce);
- LayerNorms and ``pos_embed`` stay replicated;
- the MoE experts (``experts/w1``, ``b1``, ``w2``, ``b2``, ``[E, ...]``)
  shard E over the ``expert`` axis (:class:`ExpertParallel`; the layers'
  collectives are ``models/moe.py``'s).

The conjugate pair of megatron: :func:`copy_to_model` (*f*: identity
forward, all-reduce of the gradient backward) in front of every
column-parallel product, and :func:`reduce_from_model` (*g*: all-reduce
forward, identity backward) after every row-parallel one. Between them
the activations are replicated, and so is their gradient, so every
replicated leaf's gradient is complete on each model rank.

With ``overlap`` (``tp_overlap``) the same weights run the ring schedule
of ``parallel/collective_matmul.py`` instead: activations time-sharded
over ``model`` through the decoder stack, column-parallel products through
``allgather_matmul``, row-parallel ones through ``matmul_reducescatter``;
``lm_head`` and ``tok_embed`` stay replicated (``_OVERLAP_REPLICATED``).

:func:`shard_model_` cuts a whole model (built from the run's seed, so
every layout starts from the world-1 weights) into this rank's shards and
hands the modules the :class:`TensorParallel` context they run with;
:func:`shard_tensor` and :func:`gather_tensor` do the same for any
parameter-shaped tensor (Adam's moments, a checkpoint's tensors).
"""

from __future__ import annotations

import dataclasses
import re

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.parallel.collective_matmul import (
    allgather_matmul,
    matmul_reducescatter,
)
from distributed_training_tpu_torch.runtime.mesh import AXIS_EXPERT, AXIS_MODEL

# (path regex, spec) — first match wins; matched against the "/"-joined
# Flax path. A spec lists each dim's mesh axis (None: not sharded); ()
# is replicated. The JAX table's GPT, ViT and expert rows.
LM_TP_RULES: tuple[tuple[str, tuple], ...] = (
    (r"attn/qkv/kernel$", (None, None, AXIS_MODEL, None)),
    (r"attn/qkv/bias$", (None, AXIS_MODEL, None)),
    (r"attn/out/kernel$", (AXIS_MODEL, None, None)),
    (r"attn/out/bias$", ()),
    # ViT blocks: q/k/v [d, H, hd] shard heads (column-parallel); attn/out
    # is the row-parallel rule above; the classifier head shards classes.
    (r"attn/(?:query|key|value)/kernel$", (None, AXIS_MODEL, None)),
    (r"attn/(?:query|key|value)/bias$", (AXIS_MODEL, None)),
    (r"(?:^|/)head/kernel$", (None, AXIS_MODEL)),
    (r"(?:^|/)head/bias$", (AXIS_MODEL,)),
    (r"fc1/kernel$", (None, AXIS_MODEL)),
    (r"fc1/bias$", (AXIS_MODEL,)),
    (r"fc2/kernel$", (AXIS_MODEL, None)),
    (r"fc2/bias$", ()),
    (r"lm_head/kernel$", (None, AXIS_MODEL)),
    (r"lm_head/bias$", (AXIS_MODEL,)),
    (r"tok_embed/embedding$", (AXIS_MODEL, None)),
    # MoE expert weights: the leading E dim over the expert axis.
    (r"experts/w[12]$", (AXIS_EXPERT, None, None)),
    (r"experts/b[12]$", (AXIS_EXPERT, None, None)),
)

# Vocab- and class-parallel params that the ring-overlapped schedules keep
# replicated over the model axis (the LM head consumes the local time
# shard directly; ViT's activations stay replicated).
_OVERLAP_REPLICATED = (
    r"lm_head/(?:kernel|bias)$",
    r"tok_embed/embedding$",
    r"(?:^|/)head/(?:kernel|bias)$",
)


def tp_spec_for_path(path: str, overlap: bool = False) -> tuple:
    """The spec of one ``a/b/c`` leaf path (``()``, replicated, if no rule
    matches); ``overlap`` keeps the vocab-parallel params replicated."""
    if overlap and any(re.search(p, path) for p in _OVERLAP_REPLICATED):
        return ()
    for pat, spec in LM_TP_RULES:
        if re.search(pat, path):
            return spec
    return ()


def param_path(name: str) -> str:
    """A parameter's state-dict name as its Flax path."""
    return name.replace(".", "/")


def shard_dim(name: str, overlap: bool = False, axis: str = AXIS_MODEL) -> int | None:
    """The dim of parameter ``name`` sharded over ``axis``, or None."""
    spec = tp_spec_for_path(param_path(name), overlap)
    return spec.index(axis) if axis in spec else None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's view of the ``model`` axis: its group, size and index,
    and whether the ring-overlapped schedule runs."""

    group: object
    size: int
    index: int
    overlap: bool = False

    @classmethod
    def from_mesh(cls, mesh, overlap: bool = False) -> "TensorParallel | None":
        """The context of ``mesh``'s model axis; None when it is size 1."""
        if mesh is None or mesh.size(AXIS_MODEL) == 1:
            return None
        return cls(mesh.group(AXIS_MODEL), mesh.size(AXIS_MODEL),
                   mesh.index(AXIS_MODEL), overlap)

    def dim(self, name: str) -> int | None:
        return shard_dim(name, self.overlap)


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """One rank's view of the ``expert`` axis: its group, size and index.
    The expert leaves of the rule table hold this rank's ``E / size``
    experts (the ``index``-th contiguous block); every other parameter is
    replicated over the group. It shards and gathers tensors as
    :class:`TensorParallel` does, by :meth:`dim`."""

    group: object
    size: int
    index: int

    @classmethod
    def from_mesh(cls, mesh) -> "ExpertParallel | None":
        """The context of ``mesh``'s expert axis; None when it is size 1."""
        if mesh is None or mesh.size(AXIS_EXPERT) == 1:
            return None
        return cls(mesh.group(AXIS_EXPERT), mesh.size(AXIS_EXPERT),
                   mesh.index(AXIS_EXPERT))

    def dim(self, name: str) -> int | None:
        return shard_dim(name, axis=AXIS_EXPERT)


def shard_tensor(t: torch.Tensor, dim: int | None, tp) -> torch.Tensor:
    """This rank's contiguous chunk of ``t`` along ``dim`` (``t`` itself
    when ``dim`` is None); the dim must divide by the axis size."""
    if dim is None:
        return t
    if t.shape[dim] % tp.size:
        raise ValueError(f"tensor parallelism size {tp.size} must divide dim "
                         f"{dim} of a tensor of shape {tuple(t.shape)}")
    return t.chunk(tp.size, dim)[tp.index].contiguous()


def gather_tensor(t: torch.Tensor, dim: int | None, tp) -> torch.Tensor:
    """The whole tensor from every model rank's chunk along ``dim``."""
    if dim is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t, group=tp.group)
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward, the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: the partial sums all-reduced, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """A column-parallel output all-gathered over its last dim; the
    backward keeps this rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.n = index, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None


def gather_from_model(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """The whole last dim of a column-parallel output on every model rank."""
    return x if tp is None else _GatherFromModel.apply(x, tp.group, tp.index)


def copy_to_model(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def column_matmul(x: torch.Tensor, w: torch.Tensor, tp: TensorParallel | None):
    """``x @ w`` for a column-parallel ``w`` (this rank's output columns):
    ``x`` replicated (behind *f*), or time-sharded under the overlap
    schedule (``allgather_matmul``). The output is ``[..., T, N_local]``."""
    if tp is None:
        return x @ w
    if tp.overlap:
        return allgather_matmul(x, w, tp.group)
    return copy_to_model(x, tp) @ w


def row_matmul(x: torch.Tensor, w: torch.Tensor, tp: TensorParallel | None):
    """``x @ w`` for a row-parallel ``w`` (this rank's contraction rows),
    summed over the model ranks (*g*), or reduce-scattered to this rank's
    time shard under the overlap schedule. A bias goes on afterwards, once."""
    if tp is None:
        return x @ w
    if tp.overlap:
        if x.shape[-2] % tp.size:
            raise ValueError(
                f"tp_overlap: sequence length (= {x.shape[-2]}) must divide by "
                f"the model-axis size {tp.size} (out-proj scatter); pick "
                f"divisible dims or disable tp_overlap")
        return matmul_reducescatter(x, w, tp.group, -2)
    return reduce_from_model(x @ w, tp)


def vocab_parallel_embed(tokens: torch.Tensor, table: torch.Tensor,
                         tp: TensorParallel) -> torch.Tensor:
    """The lookup in a vocab-sharded table: rows this rank does not hold
    are zero, and the all-reduce adds the one rank's row that holds each."""
    vl = table.shape[0]
    local = tokens.long() - tp.index * vl
    mine = (local >= 0) & (local < vl)
    rows = torch.nn.functional.embedding(local.clamp(0, vl - 1), table)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return reduce_from_model(rows, tp)


@torch.no_grad()
def shard_model_(model: torch.nn.Module, tp: TensorParallel | None) -> torch.nn.Module:
    """Cut ``model``'s whole parameters into this rank's shards by the rule
    table, and give the model and every layer with a ``tp`` attribute the
    context they run with (a layer whose weights the table keeps
    replicated gets None). A no-op without a context."""
    if tp is None:
        return model
    for name, p in model.named_parameters():
        p.data = shard_tensor(p.data, tp.dim(name), tp)
    model.tp = tp
    for prefix, module in model.named_modules():
        if module is model or not hasattr(module, "tp"):
            continue
        names = [f"{prefix}.{n}" for n, _ in module.named_parameters(recurse=False)]
        module.tp = tp if any(tp.dim(n) is not None for n in names) else None
    return model
