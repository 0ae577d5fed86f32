"""Pipeline parallelism: the GPipe and circular schedules over the ``pipe``
axis.

The port of ``distributed_training_tpu/parallel/pipeline.py``. JAX runs
the schedule as one SPMD program: the decoder blocks stacked and sharded
over ``pipe``, a ``lax.scan`` over the ticks, one ``lax.ppermute`` to the
next stage a tick, and the backward pipeline from autodiff. The port runs
the same ticks as a Python loop on each rank, over its own stage's blocks:

- :func:`circular_layer_order` gives JAX's storage order of the layers:
  stage ``d`` holds the contiguous slice ``d·L/S .. (d+1)·L/S`` of it,
  which for ``v`` virtual stages is its global chunks ``d, d+S, ...,
  d+(v-1)S`` in execution order (``v == 1``: the identity, GPipe);
- :func:`tick_plan` is ``spmd_pipeline``'s schedule: at tick ``t`` stage
  ``idx`` works local time ``u = t − idx`` (live for ``0 ≤ u < v·M``),
  running local chunk ``(max(u, 0) // S) % v`` on microbatch
  ``clip((u // (v·S))·S + u % S, 0, M − 1)``; the first stage feeds a
  fresh microbatch at its chunk-0 slots and reads the ring elsewhere, and
  the last stage's chunk ``v − 1`` output is final. There are
  ``v·M + S − 1`` ticks;
- :class:`PipelinedLM` holds the stage (the blocks, named by their layer
  in the plain model, ``block{i}``) beside the embeddings, the final norm
  and the head, which JAX runs outside the pipeline (replicated over
  ``pipe``); its forward has ``TransformerLM``'s signature, so the LM step
  and eval run it as they run the plain model.

**The hop** is pluggable. Over ranks it is ``runtime.mesh.pipe_hop`` on
the ``pipe`` group (each stage's output to the next stage; the backward
sends each gradient back). In one process (``pipe_size`` without a mesh)
the *virtual* pipeline runs every stage's tick in turn and its hops are
list rotations, as ``ring_attention_virtual`` does for the ring: one card
holds the schedule at full width.

**What the rank version takes care of:**

- *Every rank runs every reverse hop, in tick order.* A non-live tick
  skips its stage and sends zeros (JAX computes garbage there and masks
  it: the same result), and the first stage ignores what it receives at
  its feed ticks; so each tick's input is tied to the received value with
  a zero gradient (:class:`_Tie`), the first received value is a leaf
  that requires a gradient, and the last received value is tied to the
  output. Each rank's graph is then one chain through all the ticks, and
  autograd runs its hops' backward on every rank in the same order.
- *The output broadcast.* Only the last stage holds the outputs; they
  are broadcast over ``pipe`` so that every rank runs the final norm, the
  head and the loss (JAX's ``psum`` of the last stage's masked outputs).
  Every rank computes the same loss, so the backward gives the last
  stage its own gradient, once, and the others nothing
  (:class:`_FromLastStage`).
- *The parameters outside the pipeline.* The embeddings run on the
  first stage only; :meth:`PipelinedLM.pipe_grads` sums their gradient
  over ``pipe`` (JAX's replicated gradient). The final norm's and the
  head's gradients are already the same on every stage and are not
  summed.
- *MoE* (the homogeneous layout only, JAX's rule): the stage sees one
  microbatch, so the gate is local to it (``MoEContext.for_pipeline``);
  the aux loss is the sum over live ticks, summed over ``pipe`` (the
  backward an identity: every rank's loss holds the sum once) and divided
  by ``M``.
- *Dropout and the noisy gate* draw from a generator per (microbatch,
  global chunk, layer), seeded from the step's generator (which the step
  seeds by run, step and shard), as JAX folds its key.

:class:`PipeStage` is the rank's place on the axis for the train state:
the clip's global norm and the fp16 finite flag span ``pipe``, and a
checkpoint gathers every stage's blocks into the world-1 format, in layer
order, so a save at any ``(S, v)`` resumes at any other layout.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from distributed_training_tpu_torch.models.gpt import (
    embed,
    final,
    moe_layer_experts,
    run_block,
)
from distributed_training_tpu_torch.runtime.mesh import AXIS_PIPE, group_ranks, pipe_hop

_BLOCK = re.compile(r"^block(\d+)\.(.+)$")


def circular_layer_order(num_layers: int, stages: int,
                         virtual_stages: int) -> list[int]:
    """Storage order of the layers (JAX's): row ``d·(L/S) + ℓ·(L/C) + j``
    holds layer ``(ℓ·S + d)·(L/C) + j``, ``C = S·v`` chunks of ``L/C``
    layers; ``v == 1`` is the identity."""
    c = stages * virtual_stages
    per_chunk = num_layers // c
    order = []
    for d in range(stages):
        for ell in range(virtual_stages):
            g = ell * stages + d
            order.extend(range(g * per_chunk, (g + 1) * per_chunk))
    return order


@dataclasses.dataclass(frozen=True)
class Tick:
    """What one stage does at one tick (see :func:`tick_plan`)."""

    chunk: int        # local chunk, in [0, v)
    microbatch: int   # clipped to [0, M)
    live: bool        # a real (chunk, microbatch) slot, not warm-up or drain
    feed: bool        # the first stage reads a fresh microbatch
    done: bool        # the last stage's last chunk: the output is final


def tick_plan(t: int, idx: int, stages: int, virtual_stages: int,
              microbatches: int) -> Tick:
    """Stage ``idx``'s work at tick ``t`` (``spmd_pipeline``'s formulas)."""
    s, v, m = stages, virtual_stages, microbatches
    u = t - idx
    chunk = (max(u, 0) // s) % v
    mu = min(max((u // (v * s)) * s + u % s, 0), m - 1)
    live = 0 <= u < v * m
    return Tick(chunk, mu, live, idx == 0 and chunk == 0,
                idx == s - 1 and chunk == v - 1 and live)


def num_ticks(stages: int, virtual_stages: int, microbatches: int) -> int:
    return virtual_stages * microbatches + stages - 1


def bubble_fraction(stages: int, virtual_stages: int, microbatches: int) -> float:
    """Idle fraction of the schedule: ``(S − 1) / (v·M + S − 1)``."""
    return (stages - 1) / num_ticks(stages, virtual_stages, microbatches)


def check_pipeline(num_layers: int, pipe_size: int, num_microbatches: int,
                   virtual_stages: int) -> None:
    """JAX ``PipelinedLM``'s checks of the schedule, with its messages."""
    if virtual_stages < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {virtual_stages}")
    if num_layers % max(pipe_size * virtual_stages, 1):
        raise ValueError(
            f"{num_layers} layers not divisible into "
            f"{pipe_size} stages x {virtual_stages} virtual chunks")
    if virtual_stages > 1 and num_microbatches % max(pipe_size, 1):
        raise ValueError(
            f"the circular schedule moves microbatches in groups of the "
            f"pipe size; num_microbatches {num_microbatches} must divide "
            f"by {pipe_size}")


def check_homogeneous_moe(num_layers: int, moe_every: int, moe_num_experts) -> None:
    """JAX ``PipelinedLM``'s rule: the stacked stages need congruent
    blocks, so MoE rides the pipeline only with every layer an MoE layer of
    one expert count."""
    layer_map = moe_layer_experts(num_layers, moe_every, moe_num_experts)
    if not layer_map:
        return
    counts = set(layer_map.values())
    if len(layer_map) != num_layers or len(counts) != 1:
        raise NotImplementedError(
            "the pipeline strategy stacks congruent decoder blocks; "
            "MoE composes only in the homogeneous layout "
            "(moe_every=1, one expert count for every layer) — got "
            f"MoE layers {sorted(layer_map)} of {num_layers} "
            f"with counts {sorted(counts)}. DeepSpeed's "
            "PipelineModule cannot carry MoE layers at all; use "
            "the tensor/dp or sequence strategies for alternating "
            "or per-layer-count MoE")


class _Tie(torch.autograd.Function):
    """Identity on ``x`` that takes ``others`` as inputs too, with zero
    gradients: it keeps a value that the schedule does not use (a feed
    tick's received value, the last hop's) in the chain, so that every
    rank's backward runs every hop's reverse (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.shapes))


class _FromLastStage(torch.autograd.Function):
    """The last stage's ``x`` on every rank of ``group`` (a broadcast);
    the backward keeps each rank's own gradient on the last stage (every
    rank computes the same loss from the broadcast value) and gives the
    others none."""

    @staticmethod
    def forward(ctx, x, group, src):
        x = x.contiguous().clone()
        dist.broadcast(x, src=src, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumStages(torch.autograd.Function):
    """A scalar summed over ``group``; identity backward (each rank's loss
    holds the sum once)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _layer_generator(base: int, slot: int, layer: int,
                     device: torch.device) -> torch.Generator:
    """A generator for one layer of one (microbatch, global chunk) slot."""
    key = int(np.random.SeedSequence([base, slot, layer]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key % 2**63)


def block_layer(name: str) -> int | None:
    """The layer of a block's parameter name (``block{i}.…``), else None."""
    m = _BLOCK.match(name)
    return int(m.group(1)) if m else None


@dataclasses.dataclass(frozen=True)
class PipeStage:
    """This rank's place on the ``pipe`` axis: its group, the axis size and
    its index, and the storage order of the layers; the stage holds the
    layers ``layers(index)``. Every other parameter is replicated over
    the group."""

    group: object
    size: int
    index: int
    layer_order: tuple
    virtual_stages: int = 1

    def layers(self, idx: int) -> list[int]:
        n = len(self.layer_order) // self.size
        return list(self.layer_order[idx * n:(idx + 1) * n])

    @staticmethod
    def dim(name: str) -> int | None:
        """0 for a block's parameter (JAX shards the stacked layer dim over
        ``pipe``: each stage holds other layers), None for a replicated one."""
        return 0 if block_layer(name) is not None else None

    def layout(self) -> dict:
        """JAX ``_ckpt_layout``'s metadata of this layout."""
        if self.virtual_stages == 1:
            return {"virtual_stages": 1}
        return {"pipe_size": self.size, "virtual_stages": self.virtual_stages}

    def gather(self, tensors: dict, device: torch.device) -> dict:
        """Every stage's blocks (by name, in layer order) beside the rest of
        ``tensors``: each tensor of local layer ``j`` all-gathered over the
        group (on ``device`` for the collective, back where it was)."""
        mine = self.layers(self.index)
        rest = {n: t for n, t in tensors.items() if self.dim(n) is None}
        suffixes = [m.group(2) for n in tensors if (m := _BLOCK.match(n))
                    and int(m.group(1)) == mine[0]]
        blocks = {}
        for j, layer in enumerate(mine):
            for sfx in suffixes:
                t = tensors[f"block{layer}.{sfx}"]
                src = t.detach().to(device).contiguous()
                parts = [torch.empty_like(src) for _ in range(self.size)]
                dist.all_gather(parts, src, group=self.group)
                for p, part in enumerate(parts):
                    blocks[f"block{self.layers(p)[j]}.{sfx}"] = part.to(t.device)
        names = list(tensors)
        lead = next(i for i, n in enumerate(names) if self.dim(n) is not None)
        by_layer = sorted(blocks, key=lambda n: block_layer(n))  # stable: suffix order
        return {**{n: rest[n] for n in names[:lead]}, **{n: blocks[n] for n in by_layer},
                **{n: rest[n] for n in names[lead:] if n in rest}}

    def select(self, tensors: dict) -> dict:
        """This stage's tensors of a whole model's ``tensors``."""
        mine = set(self.layers(self.index))
        return {n: t for n, t in tensors.items()
                if self.dim(n) is None or block_layer(n) in mine}


class PipelinedLM(nn.Module):
    """A ``TransformerLM`` executed with its decoder blocks pipelined.

    Built from a whole ``model`` (the same weights as at world 1; its
    modules are taken over, not copied): over ``mesh``'s ``pipe`` axis this
    rank's stage, or with ``pipe_size`` and no mesh every stage, run in
    turn in one process (the virtual pipeline). ``forward`` has
    ``TransformerLM.forward``'s signature and results (logits or the final
    hidden states, and the aux loss), on every rank of the axis.
    """

    def __init__(self, model: nn.Module, *, num_microbatches: int,
                 virtual_stages: int = 1, mesh=None, pipe_size: int | None = None):
        super().__init__()
        if (mesh is None) == (pipe_size is None):
            raise ValueError("give the mesh (one stage a rank) or pipe_size (the "
                             "virtual pipeline), not both")
        s = mesh.size(AXIS_PIPE) if mesh is not None else pipe_size
        if model.moe_num_experts:
            check_homogeneous_moe(model.num_layers, model.moe_every, model.moe_num_experts)
        check_pipeline(model.num_layers, s, num_microbatches, virtual_stages)
        self.pipe_size, self.virtual_stages = s, virtual_stages
        self.num_microbatches = num_microbatches
        self.layer_order = circular_layer_order(model.num_layers, s, virtual_stages)
        # What the steps, the FLOP count and the remat read of the plain model.
        for attr in ("num_layers", "max_len", "dtype", "dropout_rate", "remat",
                     "seq_axis", "vocab_size", "hidden_dim", "mlp_ratio",
                     "moe_num_experts", "moe_every", "noisy_gate_policy"):
            setattr(self, attr, getattr(model, attr))
        self.mesh, self.tp = model.mesh, None
        if mesh is not None:
            self.group = mesh.group(AXIS_PIPE)
            self.stage = PipeStage(self.group, s, mesh.index(AXIS_PIPE),
                                   tuple(self.layer_order), virtual_stages)
            self.stages = [self.stage.index]
        else:
            self.group, self.stage, self.stages = None, None, list(range(s))
        self.tok_embed = model.tok_embed
        self.pos_embed = model.pos_embed
        held = sorted(i for idx in self.stages for i in self.layers(idx))
        for i in held:
            self.add_module(f"block{i}", getattr(model, f"block{i}"))
        self.ln_f, self.lm_head = model.ln_f, model.lm_head

    def layers(self, idx: int) -> list[int]:
        """Stage ``idx``'s layers in execution order (its local chunks)."""
        n = self.num_layers // self.pipe_size
        return self.layer_order[idx * n:(idx + 1) * n]

    @property
    def bubble_fraction(self) -> float:
        return bubble_fraction(self.pipe_size, self.virtual_stages, self.num_microbatches)

    def _chunk(self, idx: int, tick: Tick, x: torch.Tensor, base: int | None):
        """Local chunk ``tick.chunk`` of stage ``idx`` on one microbatch;
        returns ``(y, aux)``."""
        per_chunk = self.num_layers // (self.pipe_size * self.virtual_stages)
        layers = self.layers(idx)[tick.chunk * per_chunk:(tick.chunk + 1) * per_chunk]
        slot = tick.microbatch * self.virtual_stages * self.pipe_size \
            + tick.chunk * self.pipe_size + idx
        remat = self.remat and self.training and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in layers:
            gen = None if base is None else _layer_generator(base, slot, i, x.device)
            x, a = run_block(getattr(self, f"block{i}"), x, gen, remat)
            aux = aux + a
        return x, aux

    def _check_length(self, tokens: torch.Tensor, positions) -> None:
        """The global length against the table, on every stage (the first
        alone embeds)."""
        t = tokens.shape[-1]
        if positions is None and self.seq_axis is not None:
            t *= self.mesh.size(self.seq_axis)
        if positions is None and t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len={self.max_len}")

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None, *,
                generator: torch.Generator | None = None,
                return_hidden: bool = False, return_aux: bool = False):
        """As ``TransformerLM.forward``, the blocks through the schedule."""
        self._check_length(tokens, positions)
        s, v, m = self.pipe_size, self.virtual_stages, self.num_microbatches
        b = tokens.shape[0]
        if b % m:
            raise ValueError(f"local batch {b} not divisible by microbatches {m}")
        first = 0 in self.stages
        device = tokens.device
        shape = (b // m, tokens.shape[1], self.hidden_dim)
        mbs = embed(self, tokens, positions).chunk(m) if first else None
        base = generator.initial_seed() if generator is not None else None
        ranked = self.stage is not None
        grad = torch.is_grad_enabled()
        # The received values; over ranks the first is a leaf that needs a
        # gradient, so every rank's chain of hops starts in the graph.
        recv = {i: torch.zeros(shape, dtype=self.dtype, device=device,
                               requires_grad=ranked and grad) for i in self.stages}
        outputs = [None] * m
        aux = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(num_ticks(s, v, m)):
            outs = {}
            for idx in self.stages:
                tick = tick_plan(t, idx, s, v, m)
                x = mbs[tick.microbatch] if tick.feed else recv[idx]
                if ranked and tick.feed:
                    x = _Tie.apply(x, recv[idx])
                if tick.live:
                    y, a = self._chunk(idx, tick, x, base)
                    aux = aux + a
                else:  # warm-up or drain: nothing to run, zeros to send
                    y = torch.zeros(shape, dtype=self.dtype, device=device)
                    if ranked and grad:
                        y = _Tie.apply(y, x)
                if tick.done:
                    outputs[tick.microbatch] = y
                outs[idx] = y
            if ranked:
                recv = {self.stage.index: pipe_hop(self.group, outs[self.stage.index])[0]}
            else:
                recv = {idx: outs[(idx - 1) % s] for idx in self.stages}
        last = s - 1 in self.stages
        x = (torch.cat(outputs) if last
             else torch.zeros((b, *shape[1:]), dtype=self.dtype, device=device))
        if ranked and s > 1:
            x = _FromLastStage.apply(x, self.group, group_ranks(self.group)[s - 1])
            if self.moe_num_experts:
                aux = _SumStages.apply(aux, self.group)
            if grad:
                x = _Tie.apply(x, recv[self.stage.index])
        out = final(self, x, return_hidden)
        return (out, aux / m) if return_aux else out

    def pipe_grads(self, names: list[str], grads: list) -> list[torch.Tensor]:
        """The parameters' gradients as JAX's replicated ones: a missing
        gradient (a parameter the stage did not use) as zeros, and the
        embeddings' (the first stage's alone) summed over ``pipe``."""
        params = dict(self.named_parameters())
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        if self.stage is None or self.pipe_size == 1:
            return grads
        at = [i for i, n in enumerate(names) if n in ("tok_embed.embedding", "pos_embed")]
        flat = torch.cat([grads[i].reshape(-1) for i in at])
        dist.all_reduce(flat, group=self.group)
        for i, piece in zip(at, flat.split([grads[i].numel() for i in at])):
            grads[i] = piece.view_as(grads[i])
        return grads
