"""ZeRO data parallelism: the partition rule, the stages, and the
collectives of one rank.

The port of ``distributed_training_tpu/parallel/sharding.py`` (the stage
semantics of ``zero_stage_axes``, ``check_cpu_offload``) and
``parallel/zero.py`` (the explicit reduce-scatter / all-gather
formulation). Under GSPMD the JAX package annotates placements and XLA
inserts the collectives; here the train step calls them, over the data
parallel process group:

======  ===============  ===========  ==========================
stage   optimizer state  gradients    parameters
======  ===============  ===========  ==========================
0       replicated       replicated   replicated
1       partitioned      replicated   replicated
2       partitioned      partitioned  replicated
3       partitioned      partitioned  partitioned between steps
======  ===============  ===========  ==========================

**Partition rule.** Each tensor is flattened (in its logical, row-major
order), zero-padded to a multiple of the world size ``W``, and rank ``r``
owns the contiguous chunk ``[r c, (r + 1) c)``, ``c = ceil(numel / W)``:
DeepSpeed's flat-buffer rule, applied per tensor, so that the
weight-decay mask, which is by parameter name, still applies per name. The
padding is zeros: a zero gradient and a zero parameter give a zero Adam
update, and add nothing to a norm, so it never reaches the model. (The
JAX package's GSPMD rule, the largest divisible dimension or else
replicate, is numerically the same; the flat rule pads instead and so
splits every tensor, the small ones too.) At world 1 the one shard is the
whole flattened tensor: stages 1–3 then partition nothing and run the same
arithmetic as at any world.

All the collectives of a step go through one flat buffer each: the
gradient all-reduce (stages 0–1), the gradient reduce-scatter (2–3) and
the parameter all-gather (1–3) each make one call per step, whatever the
number of tensors. Without a group they are identities.

**The group** is the replica group of the parameters: the ``data`` axis,
and ``data × sequence`` under sequence parallelism (ring shards hold the
same weights for other positions, so ZeRO partitions over them too, as
the JAX ``zero_stage_axes`` recruits them). Under tensor parallelism
(``tp``, a ``tensor_parallel.TensorParallel``) each model rank's own
shards are partitioned over its replica group, and a whole tensor's norm
(the clip's global norm, lamb's trust ratio; :meth:`Zero.whole_sq_norms`)
also sums the squared norms of a model-sharded tensor over the model
ranks, while a replicated one counts once. Under expert parallelism
(``ep``, a ``tensor_parallel.ExpertParallel``) the group is the data
group, which never spans the expert axis: each expert rank partitions its
own experts (DeepSpeed's ``--moe-param-group`` semantics) and its copy of
the replicated parameters over its data group, and an expert tensor's
whole norm sums its experts' squares over the expert ranks.
Under the pipeline (``pp``, a ``pipeline.PipeStage``) the group is the
replica group at this rank's pipe index (data × sequence there, JAX's
``extra_axes=opt_axes``): each stage partitions its own blocks' state and
its copy of the replicated parameters' over it; the clip's global norm
(:meth:`Zero.global_sq_norm`) sums the blocks' squares over the stages and
counts the replicated parameters once.

**The fsdp axis** (``fsdp``, the group of the ``fsdp`` mesh axis, with
``inner`` the rest of the replica group, data × sequence; JAX
``zero_stage_axes``) always shards the parameters and the optimizer
state; the stage decides what else joins:

======  ==========================  ==========================
stage   parameters                  optimizer state
======  ==========================  ==========================
0       over fsdp                   over fsdp
1, 2    over fsdp                   over data × fsdp (× sequence)
3       over data × fsdp (× seq.)   over data × fsdp (× sequence)
======  ==========================  ==========================

The two partitions nest, fsdp-major: each tensor, zero-padded to a
multiple of the replica count ``F·R``, is viewed as ``[F, R, c]``; fsdp
rank ``f`` holds the parameter chunk ``[f]`` and, where the inner group
joins, rank ``(f, r)`` holds ``[f, r]``. A rank's optimizer chunk thus
lies inside its parameter chunk: the update's all-gather runs over
``inner`` within the fsdp shard, and gather-on-use (before each forward)
over ``inner`` where it joins and then ``fsdp``. Gradients are
reduce-scattered over ``fsdp``, then reduce-scattered (or all-reduced,
where the optimizer state is not split over it) over ``inner``, and
divided by ``F·R``: the mean over the whole replica group. Where the fsdp
ranks computed the same rows (every LM strategy splits the batch over
``data`` alone) that mean equals the data ranks' mean, as JAX's pmean of
equal values does; a sum over ``fsdp`` would scale every gradient by F.
A norm over shards sums each element once: over the group the optimizer
state is split over (:meth:`Zero.sum_shards_`). Saves gather everything
into the world-1 format, so the layout is internal.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist

STAGES = (0, 1, 2, 3)


@contextlib.contextmanager
def _tensor_collective():
    """``reduce_scatter_tensor`` and ``all_gather_into_tensor`` exist in
    every PyTorch the port runs on (2.11 on the card); newer releases warn
    that they are deprecated in favour of ``*_single`` calls, which older
    ones lack. The port keeps the calls both have, without the warning."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*is deprecated.*_single")
        yield


def check_cpu_offload(cpu_offload: bool, zero_stage: int) -> None:
    """The ds_config ``cpu_offload`` contract: host placement of the
    *sharded* optimizer state (DeepSpeed ZeRO-Offload,
    ``resnet/deepspeed/deepspeed_train.py:218``). Stage 0 has no sharded
    optimizer partition to offload — DeepSpeed likewise ties offload to
    ZeRO ≥ 1 — so accepting it would silently mean nothing."""
    if cpu_offload and zero_stage < 1:
        raise ValueError(
            "cpu_offload requires a ZeRO stage >= 1 (it offloads the "
            "per-replica optimizer-state shard to host memory; stage 0 "
            "keeps the full state replicated on device)")


class Zero:
    """One rank's view of the replica group and its ZeRO stage.

    ``group`` None means no group: world 1, every collective an identity.
    ``tp``: the tensor-parallel context of the parameters, or None; ``ep``
    the expert-parallel one, ``pp`` the pipeline stage, or None.
    ``fsdp``: the group of the fsdp axis (None, or a group of one rank, at
    fsdp 1); ``group`` is then the whole replica group and ``inner`` its
    data × sequence part (see the module docstring).
    """

    def __init__(self, stage: int = 0, group=None, cpu_offload: bool = False,
                 tp=None, ep=None, pp=None, fsdp=None, inner=None):
        if stage not in STAGES:
            raise ValueError(f"zero stage must be one of {STAGES}, got {stage}")
        check_cpu_offload(cpu_offload, stage)
        self.stage, self.group, self.cpu_offload = stage, group, cpu_offload
        self.tp, self.ep, self.pp = tp, ep, pp
        self.world = _size(group)
        self.rank = _rank(group)
        self.fsdp = fsdp if _size(fsdp) > 1 else None
        self.inner = group if self.fsdp is None else inner
        self.fsdp_size, self.fsdp_rank = _size(self.fsdp), _rank(self.fsdp)
        # The inner group is the whole group at fsdp 1.
        self.inner_size, self.inner_rank = _size(self.inner), _rank(self.inner)
        if self.fsdp_size * self.inner_size != self.world:
            raise ValueError(f"fsdp ({self.fsdp_size}) × inner ({self.inner_size}) "
                             f"ranks must make the replica group ({self.world})")
        # The norms' masks by (context, names, device), built once: a tensor
        # made from a host list is a copy that a CUDA graph's capture refuses.
        self._masks: dict[tuple, torch.Tensor] = {}

    @property
    def partitions_optimizer(self) -> bool:
        """Whether the optimizer state is held as shards."""
        return self.stage >= 1 or self.fsdp is not None

    @property
    def partitions_params(self) -> bool:
        """Whether the parameters are held as shards between steps."""
        return self.stage >= 3 or self.fsdp is not None

    @property
    def _opt_inner(self) -> bool:
        return self.stage >= 1

    @property
    def _param_inner(self) -> bool:
        return self.stage >= 3

    @property
    def opt_is_param_shard(self) -> bool:
        """Whether a rank's optimizer chunk is its whole parameter chunk."""
        return self._opt_inner == self._param_inner

    # -- the partition rule ---------------------------------------------------

    def chunk(self, numel: int) -> int:
        """Elements of one rank's innermost shard of a tensor of ``numel``."""
        return -(-numel // self.world)

    def _padded_flat(self, t: torch.Tensor) -> torch.Tensor:
        flat = t.detach().reshape(-1)
        pad = self.chunk(flat.numel()) * self.world - flat.numel()
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def _slice(self, t: torch.Tensor, inner: bool) -> torch.Tensor:
        """This rank's ``[f]`` (or, with ``inner``, ``[f, r]``) chunk of
        ``t`` viewed as ``[F, R, c]``, as a new contiguous 1-D tensor."""
        c = self.chunk(t.numel())
        at = self.fsdp_rank * self.inner_size * c
        n = self.inner_size * c
        if inner:
            at, n = at + self.inner_rank * c, c
        return self._padded_flat(t)[at:at + n].clone()

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``t`` as the optimizer state holds it."""
        return self._slice(t, self._opt_inner)

    def param_shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``t`` as the parameters are held between
        steps (stage 3, or an fsdp axis)."""
        return self._slice(t, self._param_inner)

    # -- collectives ----------------------------------------------------------

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over the group; an identity without one."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum_shards_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the ranks the optimizer state is split
        over (each element counted once): the group from stage 1 on, the
        fsdp group at stage 0; an identity where nothing is split."""
        group = self.group if self._opt_inner else self.fsdp
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def mean_over_copies(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor, held alike by the ranks whose optimizer chunks are
        the same (all of the group at stage 0 and fsdp 1, the inner group
        at stage 0 under fsdp, none from stage 1 on), averaged over them."""
        if self._opt_inner:
            return list(tensors)
        if self.fsdp is None:
            return self.all_reduce_mean(tensors)
        return _mean(tensors, self.inner, self.inner_size)

    def all_reduce_mean(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor averaged over the ranks (one call on a flat buffer)."""
        return _mean(tensors, self.group, self.world)

    def exchange_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Whole gradients → this rank's optimizer chunks of their mean over
        the replica group. Stages 0–1 at fsdp 1 all-reduce the whole
        gradients (stage 1 then keeps its chunk). Otherwise a reduce-scatter
        over ``fsdp`` (an identity at fsdp 1), then one over ``inner`` (an
        all-reduce where the optimizer state is not split over it), and one
        division by ``F·R``."""
        if self.fsdp is None and self.stage < 2:
            grads = self.all_reduce_mean(grads)
            return [self.shard(g) for g in grads] if self.partitions_optimizer else grads
        sizes = [self.chunk(g.numel()) * self.inner_size for g in grads]
        pieces = [self._padded_flat(g) for g in grads]
        if self.fsdp is not None:
            flat = _scatter(pieces, self.fsdp, self.fsdp_size)
            pieces = list(flat.split(sizes))
        if self._opt_inner:  # always so at fsdp 1 here (stages 2–3)
            flat = _scatter(pieces, self.inner, self.inner_size)
            sizes = [n // self.inner_size for n in sizes]
        elif self.inner is not None:
            dist.all_reduce(flat, group=self.inner)
        flat /= self.world
        return list(flat.split(sizes))

    def _whole(self, shards: list[torch.Tensor], shapes, inner: bool) -> list[torch.Tensor]:
        shapes = [torch.Size(s) for s in shapes]
        if inner:
            shards = _gather(list(shards), self.inner, self.inner_size)
        shards = _gather(list(shards), self.fsdp, self.fsdp_size)
        return [s[:shape.numel()].view(shape) for s, shape in zip(shards, shapes)]

    def all_gather(self, shards: list[torch.Tensor], shapes) -> list[torch.Tensor]:
        """Whole tensors of ``shapes`` (contiguous) from every rank's
        optimizer-state ``shards``."""
        return self._whole(shards, shapes, self._opt_inner or self.fsdp is None)

    def gather_params(self, shards: list[torch.Tensor], shapes) -> list[torch.Tensor]:
        """Whole tensors of ``shapes`` from every rank's parameter shards
        (gather-on-use)."""
        return self._whole(shards, shapes, self._param_inner or self.fsdp is None)

    def params_from_opt(self, shards: list[torch.Tensor]) -> list[torch.Tensor]:
        """Parameter chunks from the optimizer chunks inside them (an
        all-gather over ``inner`` where the two differ)."""
        if self.opt_is_param_shard:
            return list(shards)
        return _gather(list(shards), self.inner, self.inner_size)

    def opt_from_param(self, shard: torch.Tensor) -> torch.Tensor:
        """This rank's optimizer chunk of its parameter chunk ``shard``."""
        if self.opt_is_param_shard:
            return shard
        return shard.view(self.inner_size, -1)[self.inner_rank].clone()

    def whole_sq_norms(self, sq: torch.Tensor, names) -> torch.Tensor:
        """The squared norms of whole tensors from this rank's pieces'
        (``sq``, one per name): summed over the shards where the state is
        split, over the model ranks for the model-sharded names and over
        the expert ranks for the expert-sharded ones."""
        if self.partitions_optimizer:
            sq = self.sum_shards_(sq)
        for ctx in (self.tp, self.ep):
            if ctx is None:
                continue
            sharded = self._mask(ctx, names, sq.device)
            part = torch.where(sharded, sq, torch.zeros_like(sq))
            dist.all_reduce(part, group=ctx.group)
            sq = torch.where(sharded, part, sq)
        return sq

    def global_sq_norm(self, sq: torch.Tensor, names) -> torch.Tensor:
        """The squared global norm from the whole tensors' squared norms
        (``sq``, one per name): their sum, the pipeline's blocks summed over
        the stages (each stage holds others) and the replicated parameters
        counted once."""
        mine = self._mask(self.pp, names, sq.device)
        blocks = torch.where(mine, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(blocks, group=self.pp.group)
        return blocks + torch.where(mine, torch.zeros_like(sq), sq).sum()

    def _mask(self, ctx, names, device) -> torch.Tensor:
        """Whether ``ctx`` (a tensor-, expert-parallel or pipeline context)
        shards each of ``names``, on ``device``: built at the first call for
        these names, then reused."""
        names = tuple(names)
        key = (id(ctx), names, device)
        if key not in self._masks:
            self._masks[key] = torch.tensor([ctx.dim(n) is not None for n in names],
                                            device=device)
        return self._masks[key]

    def barrier(self) -> None:
        """Over the group, then over the model, expert and pipe ranks: a
        rank passes once every rank of each has arrived, the checkpoint
        writer included."""
        if self.group is not None:
            dist.barrier(group=self.group)
        for ctx in (self.tp, self.ep, self.pp):
            if ctx is not None:
                dist.barrier(group=ctx.group)


def _size(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def _rank(group) -> int:
    return dist.get_rank(group) if group is not None else 0


def _mean(tensors: list[torch.Tensor], group, size: int) -> list[torch.Tensor]:
    """Each tensor averaged over ``group`` (one all-reduce of a flat buffer)."""
    if group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= size
    return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in tensors]),
                                             tensors)]


def _scatter(pieces: list[torch.Tensor], group, size: int) -> torch.Tensor:
    """Each flat piece (a multiple of ``size`` long) summed over ``group``,
    of which this rank keeps its ``1/size`` part: the parts one after the
    other in one flat tensor (one reduce-scatter)."""
    if group is None:
        return torch.cat(pieces)
    rows = torch.cat([p.view(size, -1) for p in pieces], 1)
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    with _tensor_collective():
        dist.reduce_scatter_tensor(out, rows.reshape(-1), group=group)
    return out


def _gather(pieces: list[torch.Tensor], group, size: int) -> list[torch.Tensor]:
    """Each piece concatenated over ``group`` in rank order (one
    all-gather): ``size`` times as long."""
    if group is None:
        return pieces
    mine = torch.cat(pieces)
    rows = torch.empty(size * mine.numel(), dtype=mine.dtype, device=mine.device)
    with _tensor_collective():
        dist.all_gather_into_tensor(rows, mine, group=group)
    rows = rows.view(size, -1)
    out, at = [], 0
    for p in pieces:
        out.append(rows[:, at:at + p.numel()].reshape(-1))
        at += p.numel()
    return out
