"""Optimizer and LR schedule, with optax's semantics.

The port of ``distributed_training_tpu/train/optim.py``: the chains that
``make_optimizer`` builds there, and ``with_ema``. Every chain starts with

1. clip by global norm (``optax.clip_by_global_norm``);

then, by ``OptimizerConfig.name``:

- ``adam``: L2 added to the gradient *before* the moments
  (``optax.add_decayed_weights``, torch-Adam ``weight_decay`` semantics),
  ``optax.scale_by_adam``, ``scale_by_learning_rate``;
- ``hybrid_adam``: the same L2, then the fused-Adam kernel K1
  (``ops/fused_adam.py``), which applies the learning rate itself;
- ``adamw``: ``scale_by_adam``, then the weight decay added to the
  *update* (decoupled), then the learning rate;
- ``sgd``: L2 added to the gradient, then ``optax.trace(momentum,
  nesterov)`` (no trace state at momentum 0), then the learning rate;
- ``lamb``: ``scale_by_adam``, the decoupled decay, then
  ``optax.scale_by_trust_ratio``: each tensor's update times ``‖p‖ / ‖u‖``
  (1 where either norm is 0), then the learning rate.

``hybrid_adam`` reads the schedule at the 1-based step ``t``; every other
chain reads it at ``t - 1`` (optax's ``scale_by_schedule`` counts from 0).
That difference is the JAX package's, kept.

With ``ema_decay`` the state also carries an exponential moving average
of the updated parameters (``with_ema``): ``ema = d·ema + (1 − d)·p`` after
each committed update, seeded with the initial parameters. The train
state adds the average of the BatchNorm statistics beside it
(``precision.commit_gradients``).

Schedules take the update count and return the float32 learning rate.
Given the host count (an int) they return a numpy float32 computed on the
host, so the eager step needs no device read for its learning rate; given
the count as a 0-d integer tensor they compute the same float32 numbers
with tensor ops on that tensor's device (optax's arithmetic; the cosine
within an ulp of numpy's ``cos``). The updates are plain tensor ops
(``torch._foreach_*``, a few launches a step whatever the number of
tensors), in optax's order of operations.

The count lives twice in :class:`OptState`: the host int (checkpoints,
eager code) and ``count_t``, the same number as a 0-d int64 tensor on the
parameters' device, advanced in place by every update. A capturable update
(``update(..., capturable=True)``, which ``train/multi_step.py`` asks for)
reads no host number that changes from step to step: its learning rate and
Adam's bias corrections come from ``count_t`` on the card, so a CUDA graph
of N steps replays N new step numbers every time, as JAX's state carries
its count on the device.

Under ZeRO stages 1–3 (``parallel/zero.py``) the chain runs on each rank's
shards: the clip's global norm is the square root of the all-reduced sum
of every rank's squared shard norms (one all-reduce), lamb's per-tensor
norms of the parameters and of the updates likewise (one all-reduce of
one vector), the weight-decay mask is decided by name on the full
parameters (``decay_flags``), and the update (K1 for ``hybrid_adam``)
takes the shards as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from distributed_training_tpu_torch.config import OptimizerConfig, SchedulerConfig
from distributed_training_tpu_torch.ops.fused_adam import (
    adam_scalars_tensor,
    fused_adam_update,
)

Count = int | torch.Tensor
Schedule = Callable[[Count], np.float32 | torch.Tensor]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the Python float a tensor op takes."""
    return float(np.float32(x))


def _constant(value: float) -> Schedule:
    """``optax.constant_schedule`` in float32."""
    def schedule(count: Count):
        if isinstance(count, torch.Tensor):
            return torch.full((), _f32(value), dtype=torch.float32, device=count.device)
        return np.float32(value)
    return schedule


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule`` (polynomial, power 1) in float32."""
    if steps <= 0:
        return _constant(init)

    def schedule(count: Count):
        if isinstance(count, torch.Tensor):
            frac = 1.0 - count.clamp(0, steps).float() / float(steps)
            return frac * _f32(init - end) + _f32(end)
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1.0) - c / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)
    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules`` with one boundary."""
    def schedule(count: Count):
        if isinstance(count, torch.Tensor):
            return torch.where(count < boundary, first(count), second(count - boundary))
        return first(count) if count < boundary else second(count - boundary)
    return schedule


def _cosine(init: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` with alpha 0 and exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: Count):
        if isinstance(count, torch.Tensor):
            c = count.clamp(max=decay_steps).float()
            cos = torch.cos(c * _f32(math.pi) / float(decay_steps))
            return 0.5 * (1.0 + cos) * _f32(init)
        c = np.float32(min(count, decay_steps))
        cos = np.cos(np.float32(math.pi) * c / np.float32(decay_steps))
        decayed = np.float32(0.5) * (np.float32(1.0) + cos)
        return np.float32(init) * decayed
    return schedule


def make_schedule(opt: OptimizerConfig, sched: SchedulerConfig,
                  world_size: int = 1) -> Schedule:
    """The LR schedule: ``count → float32 lr``, the count a host int or a
    0-d integer tensor (see the module docstring)."""
    base_lr = opt.lr * (world_size if opt.scale_lr_by_world else 1)
    if sched.name == "constant":
        return _constant(base_lr)
    if sched.name == "warmup_lr":
        return _join(
            _linear(sched.warmup_min_lr, sched.warmup_max_lr,
                    sched.warmup_num_steps),
            _constant(sched.warmup_max_lr),
            sched.warmup_num_steps)
    if sched.name == "cosine":
        if sched.total_steps is None:
            raise ValueError("cosine schedule needs total_steps")
        return _join(
            _linear(sched.warmup_min_lr, base_lr, sched.warmup_num_steps),
            _cosine(base_lr, sched.total_steps - sched.warmup_num_steps),
            sched.warmup_num_steps)
    raise ValueError(f"unknown scheduler {sched.name!r}")


def decay_mask(opt: OptimizerConfig) -> Callable[[str, torch.Tensor], bool] | None:
    """Which parameters take weight decay: None = all; ``no_1d`` skips
    rank-<2 parameters and biases (Flax's ``bias``/``scale`` leaves)."""
    if opt.weight_decay_mask == "all":
        return None
    if opt.weight_decay_mask == "no_1d":
        return lambda name, p: (p.dim() >= 2
                                and name.rsplit(".", 1)[-1] not in ("bias", "scale"))
    raise ValueError(f"unknown weight_decay_mask {opt.weight_decay_mask!r}")


# Which chains keep Adam's moments, and which add the weight decay to the
# gradient (L2) rather than to the update.
_ADAM_MOMENTS = ("adam", "hybrid_adam", "adamw", "lamb")
_L2 = ("adam", "hybrid_adam", "sgd")
OPTIMIZERS = ("adam", "hybrid_adam", "adamw", "sgd", "lamb")
# The slots :meth:`Optimizer.update` writes (the train state keeps
# ``ema_stats``).
_OWN_SLOTS = ("mu", "nu", "trace", "ema")


@dataclasses.dataclass
class OptState:
    """The optimizer's state: the committed update count and, by slot, a
    tensor per parameter name in the parameter's dtype (float32, or bf16
    for the bench's bf16 parameters, as optax keeps them). The slots are
    ``mu`` and ``nu`` (Adam's moments: adam, hybrid_adam, adamw, lamb),
    ``trace`` (sgd with momentum), ``ema`` (the parameters' EMA) and
    ``ema_stats`` (the BatchNorm statistics' EMA, by buffer name; the
    train state keeps it). ``count_t`` is the count again as a 0-d int64
    tensor on the parameters' device, which every update advances in place
    (a CUDA graph's replays too); set both with :meth:`set_count`.
    A slot reads as an attribute: ``state.mu``."""

    count: int
    slots: dict[str, dict[str, torch.Tensor]]
    count_t: torch.Tensor

    def __getattr__(self, name: str):
        slots = self.__dict__.get("slots")
        if slots is not None and name in slots:
            return slots[name]
        raise AttributeError(name)

    def set_count(self, count: int) -> None:
        """The count, on the host and on the card (a restore's)."""
        self.count = int(count)
        self.count_t.fill_(self.count)


def global_norm(tensors: list[torch.Tensor], zero=None, names=None) -> torch.Tensor:
    """L2 norm over all tensors, as a float32 0-d tensor. With ``zero``
    (a ``parallel.zero.Zero``) at stage 1 or more, or under fsdp, the
    tensors are this rank's shards: their squared norms are summed over the
    ranks the state is split over by one all-reduce. Under tensor parallelism (``zero.tp``; ``names`` the
    tensors' parameter names) a model-sharded tensor's squared norm is
    summed over the model ranks too, a replicated one counted once, and
    under expert parallelism (``zero.ep``) an expert tensor's over the
    expert ranks; under the pipeline (``zero.pp``) the blocks' over the
    stages, the replicated parameters counted once."""
    if zero is not None and zero.pp is not None:
        return zero.global_sq_norm(tensor_norms(tensors, zero, names).square(),
                                   names).sqrt()
    norms = torch._foreach_norm(tensors, 2)
    if zero is not None and (zero.tp is not None or zero.ep is not None):
        return zero.whole_sq_norms(torch.stack(norms).square(), names).sum().sqrt()
    if zero is None or not zero.partitions_optimizer:
        return torch.linalg.vector_norm(torch.stack(norms))
    return zero.sum_shards_(torch.stack(norms).square().sum()).sqrt()


def tensor_norms(tensors: list[torch.Tensor], zero=None, names=None) -> torch.Tensor:
    """Each tensor's L2 norm, as one float32 vector. Under ZeRO (stage 1
    or more) the tensors are shards: each whole tensor's norm is the square
    root of its shards' squared norms summed over the ranks (one
    all-reduce of the vector); under tensor parallelism as in
    :func:`global_norm`."""
    norms = torch.stack(torch._foreach_norm(tensors, 2))
    if zero is not None and (zero.tp is not None or zero.ep is not None):
        return zero.whole_sq_norms(norms.square(), names).sqrt()
    if zero is None or not zero.partitions_optimizer:
        return norms
    return zero.sum_shards_(norms.square()).sqrt()


class Optimizer:
    """The chain of ``opt.name`` (see the module docstring), with the EMA
    when ``opt.ema_decay`` is set."""

    def __init__(self, opt: OptimizerConfig, sched: SchedulerConfig | None = None,
                 world_size: int = 1):
        if opt.name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {opt.name!r}")
        self.name = opt.name
        self.fused = opt.name == "hybrid_adam"
        self.lr = make_schedule(opt, sched or SchedulerConfig(), world_size)
        self.b1, self.b2 = opt.betas
        self.eps = opt.eps
        self.momentum, self.nesterov = opt.momentum, opt.nesterov
        self.clip = opt.grad_clip_norm
        self.weight_decay = opt.weight_decay
        self.mask = decay_mask(opt)
        self.ema_decay = opt.ema_decay

    def init(self, params: dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        slots = {}
        if self.name in _ADAM_MOMENTS:
            slots["mu"], slots["nu"] = zeros(), zeros()
        elif self.momentum:
            slots["trace"] = zeros()
        if self.ema_decay is not None:
            slots["ema"] = {n: p.detach().float().clone() for n, p in params.items()}
        device = next(iter(params.values())).device if params else None
        return OptState(0, slots, torch.zeros((), dtype=torch.int64, device=device))

    def decay_flags(self, params: dict[str, torch.Tensor]) -> dict[str, bool]:
        """Which of the (full) parameters take weight decay, by name."""
        return {n: self.mask is None or bool(self.mask(n, p)) for n, p in params.items()}

    def ema_factors(self) -> tuple[float, float]:
        """``(d, 1 − d)`` as the float32 numbers the EMA multiplies by."""
        d = np.float32(self.ema_decay)
        return float(d), float(np.float32(1.0) - d)

    def transform_grads(self, params: dict[str, torch.Tensor],
                        grads: dict[str, torch.Tensor], *,
                        decay: dict[str, bool] | None = None,
                        zero=None) -> dict[str, torch.Tensor]:
        """Clip, then (adam, hybrid_adam, sgd) L2: the chain's parts before
        the update. ``decay`` (by name) replaces the mask where ``params``
        are shards; ``zero`` makes the clip's norm global over the ranks'
        shards."""
        if self.clip is not None:
            norm = global_norm(list(grads.values()), zero, list(grads))
            keep = norm < self.clip
            grads = {n: torch.where(keep, g, g / norm * self.clip)
                     for n, g in grads.items()}
        if self.weight_decay and self.name in _L2:
            grads = self._add_decay(params, grads, decay)
        return grads

    def _add_decay(self, params, xs, decay) -> dict[str, torch.Tensor]:
        """``x + weight_decay · p`` where the mask says so."""
        if decay is None:
            decay = self.decay_flags(params)
        return {n: x + self.weight_decay * params[n] if decay[n] else x
                for n, x in xs.items()}

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor], state: OptState, *,
               out: dict[str, torch.Tensor] | None = None,
               decay: dict[str, bool] | None = None, zero=None,
               capturable: bool = False) -> OptState:
        """One step. Writes the new parameters into ``params`` (in place)
        or into ``out``; returns the new state, whose slots (and count
        tensor) are new tensors when ``out`` is given and the old ones
        updated in place otherwise. ``decay`` and ``zero`` as in
        :meth:`transform_grads`. ``capturable``: the learning rate and the
        bias corrections come from ``state.count_t`` on its device, not
        from the host count (see the module docstring)."""
        names = list(params)
        grads = self.transform_grads(params, grads, decay=decay, zero=zero)
        count = state.count + 1
        count_t = state.count_t.add_(1) if out is None else state.count_t + 1
        at = count_t if capturable else count
        if out is None:
            p_out, slots = params, state.slots
        else:  # new tensors for the slots this chain writes; others carried
            p_out = out
            slots = {k: {n: torch.empty_like(t) for n, t in v.items()}
                     if k in _OWN_SLOTS else v for k, v in state.slots.items()}
        if self.fused:
            step = (dict(scalars=adam_scalars_tensor(self.lr(at), at, self.b1, self.b2))
                    if capturable else dict(lr=float(self.lr(at)), step=at))
            fused_adam_update(
                [params[n] for n in names],
                [_like(params[n], grads[n]) for n in names],
                [state.mu[n] for n in names], [state.nu[n] for n in names],
                b1=self.b1, b2=self.b2, eps=self.eps,
                out=([p_out[n] for n in names], [slots["mu"][n] for n in names],
                     [slots["nu"][n] for n in names]), **step)
        else:
            u = self._direction(names, params, grads, state, slots, at,
                                decay, zero)
            lr = self.lr(at - 1)
            new = torch._foreach_mul(u, -lr if capturable else -float(lr))
            torch._foreach_add_(new, [params[n] for n in names])
            torch._foreach_copy_([p_out[n] for n in names], new)
        if self.ema_decay is not None:
            d, one_minus = self.ema_factors()
            ema = torch._foreach_mul([state.ema[n] for n in names], d)
            torch._foreach_add_(ema, torch._foreach_mul([p_out[n] for n in names],
                                                        one_minus))
            torch._foreach_copy_([slots["ema"][n] for n in names], ema)
        return OptState(count, slots, count_t)

    def _direction(self, names, params, grads, state, slots, count, decay,
                   zero) -> list[torch.Tensor]:
        """The update before the learning rate, by ``names``; writes the
        new moments or trace into ``slots``."""
        g = [grads[n] for n in names]
        if self.name == "sgd":
            if not self.momentum:
                return g
            # optax.trace: t' = g + m·t; nesterov: g + m·t'.
            trace = torch._foreach_mul([state.trace[n] for n in names], self.momentum)
            torch._foreach_add_(trace, g)
            torch._foreach_copy_([slots["trace"][n] for n in names], trace)
            if not self.nesterov:
                return trace
            u = torch._foreach_mul(trace, self.momentum)
            torch._foreach_add_(u, g)
            return u
        u = self._scale_by_adam(names, g, state, slots, count)
        if self.name == "adam":
            return u
        if self.weight_decay:  # adamw, lamb: decoupled, on the update
            u = list(self._add_decay(params, dict(zip(names, u)), decay).values())
        if self.name == "lamb":
            u = self._trust_ratio(u, [params[n] for n in names], zero, names)
        return u

    def _scale_by_adam(self, names, g, state, slots, count: Count) -> list[torch.Tensor]:
        """``optax.scale_by_adam``: the new moments into ``slots``, and
        ``m̂ / (√v̂ + eps)``; the bias corrections float32 numbers from the
        host ``count``, or 0-d tensors from the count tensor."""
        m = torch._foreach_mul(g, 1.0 - self.b1)
        torch._foreach_add_(m, torch._foreach_mul([state.mu[n] for n in names], self.b1))
        v = torch._foreach_mul(g, g)
        torch._foreach_mul_(v, 1.0 - self.b2)
        torch._foreach_add_(v, torch._foreach_mul([state.nu[n] for n in names], self.b2))
        torch._foreach_copy_([slots["mu"][n] for n in names], m)
        torch._foreach_copy_([slots["nu"][n] for n in names], v)
        if isinstance(count, torch.Tensor):
            t = count.float()
            bc1 = 1.0 - torch.pow(_f32(self.b1), t)
            bc2 = 1.0 - torch.pow(_f32(self.b2), t)
        else:
            t = np.float32(count)
            bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
            bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, den)
        return u

    @staticmethod
    def _trust_ratio(u, params, zero, names) -> list[torch.Tensor]:
        """``optax.scale_by_trust_ratio``: each update times ‖p‖ / ‖u‖, 1
        where either norm is 0; whole-tensor norms under ZeRO and tensor
        parallelism."""
        norms = tensor_norms([*params, *u], zero, [*names, *names])
        p_norm, u_norm = norms[:len(u)], norms[len(u):]
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        return [x * r for x, r in zip(u, ratio.unbind())]


def _like(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` in ``p``'s memory layout (the kernel walks both as one flat
    buffer)."""
    return g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)


def make_optimizer(opt: OptimizerConfig, sched: SchedulerConfig | None = None,
                   world_size: int = 1) -> Optimizer:
    """Build the gradient transformation chain for ``opt.name``."""
    return Optimizer(opt, sched, world_size)
