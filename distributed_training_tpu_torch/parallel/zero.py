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
    """One rank's view of the data-parallel group and its ZeRO stage.

    ``group`` None means no group: world 1, every collective an identity.
    ``tp``: the tensor-parallel context of the parameters, or None; ``ep``
    the expert-parallel one, ``pp`` the pipeline stage, or None.
    """

    def __init__(self, stage: int = 0, group=None, cpu_offload: bool = False,
                 tp=None, ep=None, pp=None):
        if stage not in STAGES:
            raise ValueError(f"zero stage must be one of {STAGES}, got {stage}")
        check_cpu_offload(cpu_offload, stage)
        self.stage, self.group, self.cpu_offload = stage, group, cpu_offload
        self.tp, self.ep, self.pp = tp, ep, pp
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0

    @property
    def partitions_optimizer(self) -> bool:
        return self.stage >= 1

    @property
    def partitions_grads(self) -> bool:
        return self.stage >= 2

    @property
    def partitions_params(self) -> bool:
        return self.stage >= 3

    # -- the partition rule ---------------------------------------------------

    def chunk(self, numel: int) -> int:
        """Elements of one rank's shard of a tensor of ``numel``."""
        return -(-numel // self.world)

    def _padded_flat(self, t: torch.Tensor) -> torch.Tensor:
        flat = t.detach().reshape(-1)
        pad = self.chunk(flat.numel()) * self.world - flat.numel()
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``t`` as a new contiguous 1-D tensor."""
        c = self.chunk(t.numel())
        return self._padded_flat(t)[self.rank * c:(self.rank + 1) * c].clone()

    # -- collectives ----------------------------------------------------------

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over the group; an identity without one."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_reduce_mean(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor averaged over the ranks (one call on a flat buffer)."""
        if self.group is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce_(flat)
        flat /= self.world
        return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in tensors]),
                                                 tensors)]

    def reduce_scatter_mean(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor averaged over the ranks, of which this rank keeps its
        shard (one reduce-scatter on a [W, Σ chunks] buffer whose row r
        holds rank r's shard of every tensor)."""
        if self.group is None:
            return [self.shard(t) for t in tensors]
        rows = torch.cat([self._padded_flat(t).view(self.world, -1) for t in tensors], 1)
        out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
        with _tensor_collective():
            dist.reduce_scatter_tensor(out, rows.reshape(-1), group=self.group)
        out /= self.world
        return list(out.split([self.chunk(t.numel()) for t in tensors]))

    def all_gather(self, shards: list[torch.Tensor], shapes) -> list[torch.Tensor]:
        """Whole tensors of ``shapes`` (contiguous) from every rank's
        ``shards`` (one all-gather)."""
        shapes = [torch.Size(s) for s in shapes]
        if self.group is None:
            return [s[:shape.numel()].view(shape) for s, shape in zip(shards, shapes)]
        mine = torch.cat(list(shards))
        rows = torch.empty(self.world * mine.numel(), dtype=mine.dtype, device=mine.device)
        with _tensor_collective():
            dist.all_gather_into_tensor(rows, mine, group=self.group)
        rows = rows.view(self.world, -1)
        out, at = [], 0
        for s, shape in zip(shards, shapes):
            out.append(rows[:, at:at + s.numel()].reshape(-1)[:shape.numel()].view(shape))
            at += s.numel()
        return out

    def whole_sq_norms(self, sq: torch.Tensor, names) -> torch.Tensor:
        """The squared norms of whole tensors from this rank's pieces'
        (``sq``, one per name): summed over the group's shards from stage
        1 on, over the model ranks for the model-sharded names and over the
        expert ranks for the expert-sharded ones."""
        if self.partitions_optimizer:
            sq = self.all_reduce_(sq)
        for ctx in (self.tp, self.ep):
            if ctx is None:
                continue
            sharded = torch.tensor([ctx.dim(n) is not None for n in names],
                                   device=sq.device)
            part = torch.where(sharded, sq, torch.zeros_like(sq))
            dist.all_reduce(part, group=ctx.group)
            sq = torch.where(sharded, part, sq)
        return sq

    def global_sq_norm(self, sq: torch.Tensor, names) -> torch.Tensor:
        """The squared global norm from the whole tensors' squared norms
        (``sq``, one per name): their sum, the pipeline's blocks summed over
        the stages (each stage holds others) and the replicated parameters
        counted once."""
        mine = torch.tensor([self.pp.dim(n) is not None for n in names], device=sq.device)
        blocks = torch.where(mine, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(blocks, group=self.pp.group)
        return blocks + torch.where(mine, torch.zeros_like(sq), sq).sum()

    def barrier(self) -> None:
        """Over the group, then over the model, expert and pipe ranks: a
        rank passes once every rank of each has arrived, the checkpoint
        writer included."""
        if self.group is not None:
            dist.barrier(group=self.group)
        for ctx in (self.tp, self.ep, self.pp):
            if ctx is not None:
                dist.barrier(group=ctx.group)
