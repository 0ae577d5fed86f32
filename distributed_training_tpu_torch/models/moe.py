"""Mixture-of-experts layers, numerically matching
``distributed_training_tpu/models/moe.py``.

The JAX package routes tokens with two one-hot einsums over a dense
``[tokens, E, C]`` dispatch mask (``C`` the capacity) and lets GSPMD place
the experts. This port computes the same function from each token's
(expert, slot) index instead, so nothing of size ``T·E·C`` is built:

- :class:`TopKGate`: the router in float32 (``gate/router``), the softmax,
  and per round ``k`` the first maximum of what is left (``torch.argmax``
  and ``jnp.argmax`` both take the first), the token's slot in its
  expert's queue (the running count of earlier tokens sent there, plus the
  slots earlier rounds filled), the drop (``slot ≥ C``), and the gate
  value; top-2 renormalises over the kept choices only. The load-balancing
  loss is ``E · Σ load · importance / T`` with the top-1 ``load``.
- :class:`ExpertMlp`: ``E`` FFNs as batched products on ``[E, C, d]``
  (``w1 [E, d, h]``, GELU tanh, ``w2 [E, h, d]``, biases ``[E, 1, ·]``),
  initialised with ``lecun_normal``'s fan-in ``d·E`` (``h·E``), as Flax
  counts the leading E dim into it.
- :class:`MoEMlp`: the gate, a gather of each kept token into its
  ``(expert, slot)`` row of ``[E, C, d]``, the experts, and each token's
  gate-weighted rows gathered back; ``mlp_type="residual"`` mixes in a
  dense MLP by a float32 two-way softmax (``coefficient``). Its
  load-balancing loss, weighted by ``aux_loss_weight``, is returned beside
  the output (Flax sows it into ``aux_loss``).
- :class:`MoEImageClassifier` and :func:`make_moe_classifier`: the patch
  MLP of ``model='moe_mlp'``, with the Flax module names (``Dense_0``,
  ``LayerNorm_0``, …) so ``bridge.py`` carries its tree as it is.

**Across ranks** (:class:`MoEContext`, set by :func:`shard_experts_`):

- *The gate's scope is JAX's.* Under the GSPMD steps (data, model and
  expert axes) JAX shards the batch over ``data`` and gates over the
  global token order; here each rank gates its own tokens, and each
  round all-gathers the ``[D, E]`` per-expert counts of the data group: a
  rank's slots start after every token of the lower data ranks, the
  capacity comes from the global token count, and the occupancy after a
  round is the global kept count. The aux loss uses the global ``load``
  and the rank's own ``importance`` over its own tokens, so the data
  group's mean of the ranks' losses and gradients is the global loss and
  gradient. Under a ``sequence`` axis JAX's step is a shard_map manual
  over ``(data, sequence)`` and the layer holds no collective over
  either, so each shard gates its own ``[B/D · T/S]`` tokens in row-major
  order: the context has no data group there (the capacity, the load and
  the aux loss come from the shard's own counts).
- *The model axis replicates the layer.* The rule table shards only the
  expert leaves, and over ``expert``: under ``model`` > 1 every model
  rank routes the same replicated tokens through the same weights, and
  the output joins the residual stream unsummed, so each replicated
  leaf's gradient is whole on each model rank.
- *The expert group replicates the tokens* and shards the experts on E
  (JAX ``tensor_parallel.py`` expert rows). Each expert rank dispatches
  to its own ``E / ep`` experts, combines a partial output and the partial
  outputs are summed over the group (:func:`reduce_from_experts`); the
  tokens and gate values that enter the experts pass through
  :func:`copy_to_experts`, whose backward sums their partial gradients,
  so every replicated leaf's gradient is whole on each expert rank.

The noisy gates draw from the ``generator`` the forward is given (the
train step's), not JAX's bits: ``RSample`` adds a standard normal to the
router logits, ``Jitter`` multiplies the gate input by a uniform in
``[1 − 1e-2, 1 + 1e-2)``, in training only.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from distributed_training_tpu_torch.models.gpt import Dense, LayerNorm
from distributed_training_tpu_torch.parallel.ring_attention import lecun_normal_
from distributed_training_tpu_torch.parallel.tensor_parallel import (
    ExpertParallel,
    copy_to_model,
    reduce_from_model,
)
from distributed_training_tpu_torch.parallel.zero import _tensor_collective
from distributed_training_tpu_torch.runtime.mesh import AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE

AUX_LOSS_WEIGHT = 1e-2
JITTER_EPS = 1e-2


@dataclasses.dataclass(frozen=True)
class MoEContext:
    """One rank's view of the groups the MoE layers run over: the data
    group whose ranks hold the other tokens of the gate's batch (its
    counts; None when the gate is this rank's alone) with this rank's
    index and its size, and the expert-parallel context (None at expert
    1)."""

    data: object
    data_index: int
    data_size: int
    ep: ExpertParallel | None

    @classmethod
    def from_mesh(cls, mesh, batch_over_fsdp: bool = False) -> "MoEContext | None":
        """The context on ``mesh``: the gate global over the data group,
        or local to each (data, sequence) shard when the mesh has a
        sequence axis (see the module docstring); None when nothing
        spans ranks. ``batch_over_fsdp``: the batch is split over data ×
        fsdp (the image Trainer's, JAX's ``batch_sharding``), so the gate
        counts over that group; otherwise the fsdp ranks of a data index
        hold the same rows (the LM strategies) and the data group counts."""
        if mesh is None:
            return None
        ep = ExpertParallel.from_mesh(mesh)
        d = mesh.size(AXIS_DATA)
        if mesh.size(AXIS_SEQUENCE) > 1:  # each shard gates its own tokens
            return cls(None, 0, 1, ep) if ep is not None else None
        if batch_over_fsdp and mesh.size(AXIS_FSDP) > 1:
            return cls(mesh.group(AXIS_DATA, AXIS_FSDP), mesh.replica_index,
                       mesh.data_size, ep)
        if d == 1 and ep is None:
            return None
        return cls(mesh.group(AXIS_DATA, AXIS_SEQUENCE) if d > 1 else None,
                   mesh.index(AXIS_DATA), d, ep)

    @classmethod
    def for_pipeline(cls, mesh) -> "MoEContext | None":
        """The context of a pipeline stage on ``mesh``: JAX's pipeline is a
        shard_map manual over ``(pipe, data[, sequence])`` whose stage sees
        one microbatch, so the gate is local to each (data shard,
        microbatch[, sequence shard]); the expert group as in
        :meth:`from_mesh`. None without an expert axis."""
        ep = ExpertParallel.from_mesh(mesh)
        return cls(None, 0, 1, ep) if ep is not None else None


def copy_to_experts(x: torch.Tensor, ep: ExpertParallel | None) -> torch.Tensor:
    """Identity forward; the gradient summed over the expert group."""
    return copy_to_model(x, ep)


def reduce_from_experts(x: torch.Tensor, ep: ExpertParallel | None) -> torch.Tensor:
    """The expert ranks' partial outputs summed; identity backward."""
    return reduce_from_model(x, ep)


@dataclasses.dataclass
class Routing:
    """A gate's decisions for ``T`` tokens over ``k`` rounds: each round's
    expert ``[k, T]``, slot ``[k, T]``, kept flag ``[k, T]`` and combine
    weight ``[k, T]`` (float32, 0 where dropped, differentiable), the
    capacity, and the load-balancing loss before its weight."""

    experts: torch.Tensor
    slots: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    capacity: int
    aux: torch.Tensor


class TopKGate(nn.Module):
    """Top-k router with static capacity and the load-balancing loss (see
    the module docstring); ``router`` is the Flax ``gate/router`` Dense."""

    def __init__(self, d: int, num_experts: int, *, top_k: int = 1,
                 capacity_factor: float = 1.25, min_capacity: int = 0,
                 noisy_gate_policy: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError("gating top 1 and 2 supported")  # DS parity
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.min_capacity = capacity_factor, min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.router = Dense(d, num_experts, use_bias=False, generator=generator)

    def capacity(self, tokens: int) -> int:
        """JAX's static capacity for ``tokens`` global tokens."""
        e = self.num_experts
        c = max(int(self.min_capacity),
                -(-tokens * self.top_k * int(self.capacity_factor * 100) // (e * 100)))
        return min(max(c, 1), tokens)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: torch.Generator | None = None,
                ctx: MoEContext | None = None) -> Routing:
        n, e = x.shape[0], self.num_experts
        data = ctx.data if ctx is not None else None
        tokens = n * (ctx.data_size if data is not None else 1)
        capacity = self.capacity(tokens)
        gate_in = x.float()
        if train and self.noisy_gate_policy == "Jitter":
            u = torch.rand(gate_in.shape, generator=generator, device=x.device)
            gate_in = gate_in * (1.0 - JITTER_EPS + 2 * JITTER_EPS * u)
        logits = self.router(gate_in)
        if train and self.noisy_gate_policy == "RSample":
            logits = logits + torch.randn(logits.shape, generator=generator,
                                          device=x.device)
        probs = torch.softmax(logits, dim=-1)
        importance = probs.sum(0)
        remaining = probs
        occupancy = torch.zeros(e, dtype=torch.long, device=x.device)
        rounds = []
        load = None
        for _ in range(self.top_k):
            idx = remaining.detach().argmax(-1)
            onehot = F.one_hot(idx, e)
            counts = onehot.sum(0)
            offset, total = torch.zeros_like(counts), counts
            if data is not None:
                every = torch.empty(ctx.data_size * e, dtype=counts.dtype,
                                    device=counts.device)
                with _tensor_collective():
                    dist.all_gather_into_tensor(every, counts, group=data)
                every = every.view(ctx.data_size, e)
                offset, total = every[:ctx.data_index].sum(0), every.sum(0)
            if load is None:  # the top-1 fraction routed, over every token
                load = total.float() / tokens
            pos = (onehot.cumsum(0) - 1).gather(1, idx[:, None])[:, 0]
            slot = pos + offset[idx] + occupancy[idx]
            keep = slot < capacity
            gate_val = remaining.gather(1, idx[:, None])[:, 0]
            rounds.append((idx, slot, keep, gate_val))
            occupancy = occupancy + torch.minimum((capacity - occupancy).clamp_min(0), total)
            remaining = remaining * (1.0 - onehot.float())
        experts, slots, keep, gates = (torch.stack(t) for t in zip(*rounds))
        weights = gates * keep
        if self.top_k > 1:  # GShard: the kept choices' weights sum to 1
            denom = weights.sum(0, keepdim=True)
            weights = torch.where(denom > 0, weights / denom.clamp_min(1e-9),
                                  torch.zeros((), device=x.device))
        aux = e * (load * (importance / n)).sum()
        return Routing(experts, slots, keep, weights, capacity, aux)


class ExpertMlp(nn.Module):
    """``num_experts`` FFNs as batched products on ``[E, C, d]`` inputs
    (this rank's experts once :func:`shard_experts_` has cut them)."""

    def __init__(self, num_experts: int, d: int, hidden_dim: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.ep: ExpertParallel | None = None  # set by shard_experts_
        self.w1 = nn.Parameter(torch.empty(num_experts, d, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(num_experts, 1, hidden_dim))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden_dim, d))
        self.b2 = nn.Parameter(torch.zeros(num_experts, 1, d))
        # Flax's fan-in of an [E, in, out] kernel counts E in.
        lecun_normal_(self.w1, d * num_experts, generator)
        lecun_normal_(self.w2, hidden_dim * num_experts, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.bmm(x.to(dt), self.w1.to(dt)) + self.b1.to(dt)
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.w2.to(dt)) + self.b2.to(dt)


class MoEMlp(nn.Module):
    """GShard-style MoE FFN (``standard`` or ``residual``): ``[..., d]`` →
    ``([..., d], weighted load-balancing loss)``."""

    def __init__(self, d: int, num_experts: int, hidden_dim: int, *,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 min_capacity: int = 0, noisy_gate_policy: str | None = None,
                 mlp_type: str = "standard", aux_loss_weight: float = AUX_LOSS_WEIGHT,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if mlp_type not in ("standard", "residual"):
            raise ValueError("accepts [standard, residual]")  # DS parity
        self.num_experts, self.mlp_type = num_experts, mlp_type
        self.aux_loss_weight, self.dtype = aux_loss_weight, dtype
        self.ctx: MoEContext | None = None
        self.kept_share: torch.Tensor | None = None
        self.gate = TopKGate(d, num_experts, top_k=top_k,
                             capacity_factor=capacity_factor,
                             min_capacity=min_capacity,
                             noisy_gate_policy=noisy_gate_policy, generator=generator)
        self.experts = ExpertMlp(num_experts, d, hidden_dim, dtype=dtype,
                                 generator=generator)
        if mlp_type == "residual":
            self.residual_in = Dense(d, hidden_dim, dtype=dtype, generator=generator)
            self.residual_out = Dense(hidden_dim, d, dtype=dtype, generator=generator)
            self.coefficient = Dense(d, 2, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: torch.Generator | None = None):
        shape, d = x.shape, x.shape[-1]
        tokens = x.reshape(-1, d)
        ctx = self.ctx
        ep = ctx.ep if ctx is not None else None
        r = self.gate(tokens, train, generator, ctx)
        # The share of (token, choice) pairs kept, of the last forward: a
        # 0-d tensor on the device, for a reader that wants it.
        self.kept_share = r.keep.detach().float().mean()
        local = self.experts.w1.shape[0]
        lo = ep.index * local if ep is not None else 0
        # Each (token, round)'s row of the flat [E_local·C] expert buffer;
        # dropped choices and other ranks' experts point past its end.
        mine = r.keep & (r.experts >= lo) & (r.experts < lo + local)
        rows = torch.where(mine, (r.experts - lo) * r.capacity + r.slots,
                           local * r.capacity)
        n = tokens.shape[0]
        src = torch.full((local * r.capacity + 1,), n, dtype=torch.long,
                         device=x.device)
        src.scatter_(0, rows.reshape(-1),
                     torch.arange(n, device=x.device).repeat(rows.shape[0]))
        xin = copy_to_experts(tokens.to(self.dtype), ep)
        xin = torch.cat([xin, xin.new_zeros(1, d)])
        expert_in = xin.index_select(0, src[:-1]).view(local, r.capacity, d)
        expert_out = self.experts(expert_in).reshape(local * r.capacity, d)
        expert_out = torch.cat([expert_out, expert_out.new_zeros(1, d)])
        w = copy_to_experts(r.weights, ep).to(self.dtype)
        out = sum(w[i, :, None] * expert_out.index_select(0, rows[i])
                  for i in range(rows.shape[0]))
        out = reduce_from_experts(out, ep)
        if self.mlp_type == "residual":
            dense = self.residual_out(F.gelu(self.residual_in(tokens),
                                             approximate="tanh"))
            coef = torch.softmax(self.coefficient(tokens.float()), dim=-1)
            out = out * coef[:, :1].to(self.dtype) + dense * coef[:, 1:].to(self.dtype)
        return out.reshape(shape), self.aux_loss_weight * r.aux


@torch.no_grad()
def shard_experts_(model: nn.Module, ctx: MoEContext | None) -> nn.Module:
    """Give every :class:`MoEMlp` of ``model`` the context it runs with, and
    cut each :class:`ExpertMlp`'s whole weights to this expert rank's block
    of E (a no-op without a context)."""
    if ctx is None:
        return model
    for module in model.modules():
        if isinstance(module, MoEMlp):
            module.ctx = ctx
            ep = ctx.ep
            if ep is not None and module.num_experts % ep.size:
                raise ValueError(f"expert-parallel size {ep.size} must divide "
                                 f"num_experts (= {module.num_experts})")
        if isinstance(module, ExpertMlp) and ctx.ep is not None:
            module.ep = ctx.ep
            for p in module.parameters():
                p.data = p.data.chunk(ctx.ep.size, 0)[ctx.ep.index].contiguous()
    return model


class PatchEmbed(nn.Module):
    """Flax ``nn.Conv`` with a ``p × p`` kernel, stride ``p`` and VALID
    padding (``kernel`` HWIO, ``bias``) on NHWC images: each patch's
    ``(h, w, c)``-ordered pixels times the flattened kernel."""

    def __init__(self, patch: int, channels: int, features: int, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.kernel = nn.Parameter(torch.empty(patch, patch, channels, features))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.kernel, patch * patch * channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = x.shape
        h, w = h // p * p, w // p * p  # VALID: a partial patch is dropped
        x = x[:, :h, :w].to(self.dtype).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return x @ self.kernel.to(self.dtype).reshape(p * p * c, -1) + self.bias.to(self.dtype)


class MoEImageClassifier(nn.Module):
    """The patch-MLP vision model with MoE FFN blocks (``model='moe_mlp'``):
    NHWC images → float32 logits; ``forward(..., return_aux=True)`` also
    returns the summed load-balancing loss. A layer whose expert count is
    1 or less is a dense MLP (``Dense_{2j}``, ``Dense_{2j+1}``)."""

    def __init__(self, num_classes: int = 10, *, hidden_size: int = 128,
                 num_layers: int = 2, num_experts: Sequence[int] = (4,),
                 mlp_hidden: int = 256, top_k: int = 1, capacity_factor: float = 1.25,
                 min_capacity: int = 0, noisy_gate_policy: str | None = None,
                 mlp_type: str = "standard", patch_size: int = 4, channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        self.noisy_gate_policy = noisy_gate_policy
        self.patch_embed = PatchEmbed(patch_size, channels, hidden_size, dtype=dtype,
                                      generator=generator)
        counts = list(num_experts)
        if len(counts) == 1:
            counts = counts * num_layers
        self.layer_kind = []
        dense = 0
        for i in range(num_layers):
            self.add_module(f"LayerNorm_{i}", LayerNorm(hidden_size, dtype))
            n_exp = int(counts[min(i, len(counts) - 1)])
            if n_exp > 1:
                self.add_module(f"moe_{i}", MoEMlp(
                    hidden_size, n_exp, mlp_hidden, top_k=top_k,
                    capacity_factor=capacity_factor, min_capacity=min_capacity,
                    noisy_gate_policy=noisy_gate_policy, mlp_type=mlp_type,
                    dtype=dtype, generator=generator))
                self.layer_kind.append(f"moe_{i}")
            else:
                self.add_module(f"Dense_{dense}", Dense(hidden_size, mlp_hidden, dtype=dtype,
                                                        generator=generator))
                self.add_module(f"Dense_{dense + 1}", Dense(mlp_hidden, hidden_size,
                                                            dtype=dtype, generator=generator))
                self.layer_kind.append((f"Dense_{dense}", f"Dense_{dense + 1}"))
                dense += 2
        self.add_module(f"LayerNorm_{num_layers}", LayerNorm(hidden_size, dtype))
        self.head = Dense(hidden_size, num_classes, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, *, generator: torch.Generator | None = None,
                return_aux: bool = False):
        x = self.patch_embed(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(self.layer_kind):
            y = getattr(self, f"LayerNorm_{i}")(x)
            if isinstance(kind, str):
                y, a = getattr(self, kind)(y, self.training, generator)
                aux = aux + a
            else:
                fc1, fc2 = (getattr(self, k) for k in kind)
                y = fc2(F.gelu(fc1(y), approximate="tanh"))
            x = x + y
        x = getattr(self, f"LayerNorm_{self.num_layers}")(x).mean(1)
        logits = self.head(x).float()
        return (logits, aux) if return_aux else logits


def make_moe_classifier(*, num_classes: int = 10, dtype: torch.dtype = torch.float32,
                        axis_name: str | None = None, **kwargs) -> MoEImageClassifier:
    """Registry factory (the JAX ``make_moe_classifier``'s fields);
    ``axis_name`` (the registry's SyncBN slot) is unused: no BatchNorm."""
    del axis_name
    return MoEImageClassifier(num_classes, dtype=dtype, **kwargs)
