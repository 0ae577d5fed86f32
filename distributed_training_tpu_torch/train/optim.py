"""Optimizer and LR schedule, with optax's semantics.

The port of ``distributed_training_tpu/train/optim.py`` for the ``adam``
and ``hybrid_adam`` chains that ``make_optimizer`` builds there:

1. clip by global norm (``optax.clip_by_global_norm``);
2. L2 added to the gradient *before* the moments
   (``optax.add_decayed_weights``, torch-Adam ``weight_decay`` semantics);
3. the update: ``hybrid_adam`` is the fused-Adam kernel
   (``ops/fused_adam.py``), ``adam`` is ``optax.scale_by_adam`` followed by
   ``scale_by_learning_rate`` in plain tensor ops, as XLA ran it.

The two differ in one detail kept from the JAX package: ``hybrid_adam``
reads the schedule at the 1-based step ``t``, ``adam`` at ``t - 1``
(optax's ``scale_by_schedule`` counts from 0).

Schedules return float32 numbers computed on the host, so the step needs
no device read for its learning rate.

Under ZeRO stages 1–3 (``parallel/zero.py``) the chain runs on each rank's
shards: the clip's global norm is the square root of the all-reduced sum
of every rank's squared shard norms (one all-reduce), the weight-decay
mask is decided by name on the full parameters (``decay_flags``), and the
update (K1 for ``hybrid_adam``) takes the shards as they are. Not ported yet: ``adamw``, ``sgd``,
``lamb`` and the parameter EMA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from distributed_training_tpu_torch.config import OptimizerConfig, SchedulerConfig
from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

Schedule = Callable[[int], np.float32]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule`` (polynomial, power 1) in float32."""
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count: int) -> np.float32:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1.0) - c / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)
    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules`` with one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def _cosine(init: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` with alpha 0 and exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> np.float32:
        c = np.float32(min(count, decay_steps))
        cos = np.cos(np.float32(math.pi) * c / np.float32(decay_steps))
        decayed = np.float32(0.5) * (np.float32(1.0) + cos)
        return np.float32(init) * decayed
    return schedule


def make_schedule(opt: OptimizerConfig, sched: SchedulerConfig,
                  world_size: int = 1) -> Schedule:
    """The LR schedule: ``count → float32 lr``."""
    base_lr = opt.lr * (world_size if opt.scale_lr_by_world else 1)
    if sched.name == "constant":
        return lambda count: np.float32(base_lr)
    if sched.name == "warmup_lr":
        return _join(
            _linear(sched.warmup_min_lr, sched.warmup_max_lr,
                    sched.warmup_num_steps),
            lambda count: np.float32(sched.warmup_max_lr),
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


@dataclasses.dataclass
class AdamState:
    """Adam's state: committed update count and float32 moments by name."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def global_norm(tensors: list[torch.Tensor], zero=None) -> torch.Tensor:
    """L2 norm over all tensors, as a float32 0-d tensor. With ``zero``
    (a ``parallel.zero.Zero``) at stage 1 or more the tensors are this
    rank's shards: their squared norms are summed over the ranks by one
    all-reduce."""
    norms = torch._foreach_norm(tensors, 2)
    if zero is None or not zero.partitions_optimizer:
        return torch.linalg.vector_norm(torch.stack(norms))
    return zero.all_reduce_(torch.stack(norms).square().sum()).sqrt()


class Adam:
    """The ``adam`` / ``hybrid_adam`` chain (see the module docstring)."""

    def __init__(self, opt: OptimizerConfig, sched: SchedulerConfig | None = None,
                 world_size: int = 1):
        if opt.name not in ("adam", "hybrid_adam"):
            raise NotImplementedError(
                f"optimizer {opt.name!r} is not ported yet (adam, hybrid_adam)")
        if opt.ema_decay is not None:
            raise NotImplementedError("parameter EMA is not ported yet")
        self.fused = opt.name == "hybrid_adam"
        self.lr = make_schedule(opt, sched or SchedulerConfig(), world_size)
        self.b1, self.b2 = opt.betas
        self.eps = opt.eps
        self.clip = opt.grad_clip_norm
        self.weight_decay = opt.weight_decay
        self.mask = decay_mask(opt)

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamState(0, {n: zeros(p) for n, p in params.items()},
                         {n: zeros(p) for n, p in params.items()})

    def decay_flags(self, params: dict[str, torch.Tensor]) -> dict[str, bool]:
        """Which of the (full) parameters take weight decay, by name."""
        return {n: self.mask is None or bool(self.mask(n, p)) for n, p in params.items()}

    def transform_grads(self, params: dict[str, torch.Tensor],
                        grads: dict[str, torch.Tensor], *,
                        decay: dict[str, bool] | None = None,
                        zero=None) -> dict[str, torch.Tensor]:
        """Clip, then L2: the chain's parts before the Adam update.
        ``decay`` (by name) replaces the mask where ``params`` are shards;
        ``zero`` makes the clip's norm global over the ranks' shards."""
        if self.clip is not None:
            norm = global_norm(list(grads.values()), zero)
            keep = norm < self.clip
            grads = {n: torch.where(keep, g, g / norm * self.clip)
                     for n, g in grads.items()}
        if self.weight_decay:
            if decay is None:
                decay = self.decay_flags(params)
            grads = {n: g + self.weight_decay * params[n] if decay[n] else g
                     for n, g in grads.items()}
        return grads

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor], state: AdamState, *,
               out: dict[str, torch.Tensor] | None = None,
               decay: dict[str, bool] | None = None, zero=None) -> AdamState:
        """One step. Writes the new parameters into ``params`` (in place)
        or into ``out``; returns the new state, whose moments are new
        tensors when ``out`` is given and the old ones updated in place
        otherwise. ``decay`` and ``zero`` as in :meth:`transform_grads`."""
        names = list(params)
        grads = self.transform_grads(params, grads, decay=decay, zero=zero)
        count = state.count + 1
        if out is None:
            p_out, mu, nu = params, state.mu, state.nu
        else:
            p_out = out
            mu = {n: torch.empty_like(state.mu[n]) for n in names}
            nu = {n: torch.empty_like(state.nu[n]) for n in names}
        if self.fused:
            fused_adam_update(
                [params[n] for n in names],
                [_like(params[n], grads[n]) for n in names],
                [state.mu[n] for n in names], [state.nu[n] for n in names],
                lr=float(self.lr(count)), step=count, b1=self.b1, b2=self.b2,
                eps=self.eps,
                out=([p_out[n] for n in names], [mu[n] for n in names],
                     [nu[n] for n in names]))
        else:
            self._adam(names, params, grads, state, count, p_out, mu, nu)
        return AdamState(count, mu, nu)

    def _adam(self, names, params, grads, state, count, p_out, mu, nu) -> None:
        """``optax.scale_by_adam`` + ``scale_by_learning_rate`` + apply."""
        t = np.float32(count)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        step_size = -float(self.lr(count - 1))
        for n in names:
            g = grads[n]
            m = (1.0 - self.b1) * g + self.b1 * state.mu[n]
            v = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[n]
            u = (m / bc1) / (torch.sqrt(v / bc2 + 0.0) + self.eps)
            p_out[n].copy_(params[n] + u * step_size)
            mu[n].copy_(m)
            nu[n].copy_(v)


def _like(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` in ``p``'s memory layout (the kernel walks both as one flat
    buffer)."""
    return g if g.stride() == p.stride() else torch.empty_like(p).copy_(g)


def make_optimizer(opt: OptimizerConfig, sched: SchedulerConfig | None = None,
                   world_size: int = 1) -> Adam:
    """Build the gradient transformation chain for ``opt.name``."""
    return Adam(opt, sched, world_size)
