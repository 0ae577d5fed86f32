"""Mixed-precision policy, dynamic loss scaling, and the guarded commit.

The port of ``distributed_training_tpu/train/precision.py``. The loss
scaler follows DeepSpeed's DynamicLossScaler, as the JAX one does:

- the scale starts at ``2**initial_scale_power``;
- on overflow the update is skipped; the scale halves (floored at
  ``min_loss_scale``) once the hysteresis budget is spent, else one
  hysteresis credit is used;
- after ``loss_scale_window`` good steps in a row the scale doubles and
  the hysteresis budget refills.

bf16 needs no scaling: the ``bf16`` policy computes in bfloat16 over
float32 parameters with an inert scaler (scale 1, never updated, no host
read), as ``fp32`` does.

With the parameter EMA (``OptimizerConfig.ema_decay``) the commit also
advances the EMA of the BatchNorm statistics (the JAX
``_with_ema_batch_stats``), from the statistics the step's forward left
in the model; a skipped fp16 step leaves both EMAs as they were.

The JAX step carries the scaler as traced arrays and selects with
``jnp.where``. Here the scaler lives on the host, because the commit
reads one flag from the card per fp16 step anyway (see
:func:`commit_gradients`). Every value it takes is a power of two (or
the static scale), so host floats and the JAX float32 arrays agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.config import PrecisionConfig

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtype policy: float32 master params, ``compute_dtype`` for the
    forward and backward."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def from_config(cfg: PrecisionConfig) -> "Policy":
        return Policy(param_dtype=torch.float32, compute_dtype=_DTYPES[cfg.dtype])


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    """Dynamic loss-scaler state (host values)."""

    scale: float
    good_steps: int
    hysteresis_left: int
    window: int = 500
    hysteresis: int = 2
    min_scale: float = 1.0
    max_scale: float = float(2 ** 24)
    dynamic: bool = True

    @staticmethod
    def create(cfg: PrecisionConfig) -> "LossScaleState":
        if cfg.dtype != "fp16":
            return LossScaleState(scale=1.0, good_steps=0, hysteresis_left=1,
                                  dynamic=False)
        common = dict(good_steps=0, hysteresis_left=cfg.hysteresis,
                      window=cfg.loss_scale_window, hysteresis=cfg.hysteresis,
                      min_scale=cfg.min_loss_scale)
        if cfg.static_loss_scale is not None:
            return LossScaleState(scale=float(np.float32(cfg.static_loss_scale)),
                                  dynamic=False, **common)
        return LossScaleState(scale=cfg.initial_scale, dynamic=True, **common)

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale

    def unscale_grads(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        inv = float(np.float32(1.0) / np.float32(self.scale))
        return {n: g.float() * inv for n, g in grads.items()}

    def update(self, grads_finite: bool) -> "LossScaleState":
        """One scaler transition."""
        if not self.dynamic:
            return self
        if grads_finite:
            good = self.good_steps + 1
            if good >= self.window:
                return dataclasses.replace(
                    self, scale=min(self.scale * 2.0, self.max_scale),
                    good_steps=0, hysteresis_left=self.hysteresis)
            return dataclasses.replace(self, good_steps=good)
        if self.hysteresis_left <= 1:
            return dataclasses.replace(
                self, scale=max(self.scale / 2.0, self.min_scale),
                good_steps=0, hysteresis_left=self.hysteresis)
        return dataclasses.replace(self, good_steps=0,
                                   hysteresis_left=self.hysteresis_left - 1)


def all_finite(tensors: list[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: every element of every tensor is finite. The
    inf-norm of a tensor is NaN or inf exactly when it holds one."""
    if not tensors:
        return torch.tensor(True)
    return torch.isfinite(torch.stack(torch._foreach_norm(tensors, float("inf")))).all()


def _advance_ema_stats(state, slots: dict, in_place: bool) -> None:
    """``ema_stats = d·ema_stats + (1 − d)·stats`` on the rank's shards of
    the model's BatchNorm statistics; in place, or into new tensors in
    ``slots`` (a candidate's). A no-op without that slot."""
    ema = slots.get("ema_stats")
    if not ema:
        return
    d, one_minus = state.tx.ema_factors()
    stats = state.stats()
    names = list(ema)
    now = [state.partition(stats[n]) for n in names]
    new = torch._foreach_mul([ema[n] for n in names], d)
    torch._foreach_add_(new, torch._foreach_mul(now, one_minus))
    if in_place:
        torch._foreach_copy_([ema[n] for n in names], new)
    else:
        slots["ema_stats"] = dict(zip(names, new))


def commit_gradients(state, grads: dict[str, torch.Tensor],
                     old_batch_stats: list[torch.Tensor] | None = None) -> bool:
    """Apply unscaled grads to ``state`` (a ``TrainState``), skipping the
    whole update when the dynamic loss scale overflowed. Returns whether
    the update was committed.

    ``grads`` are for ``state.master_params()``: the whole gradients at
    ZeRO stage 0, this rank's shards from stage 1 on. The update goes
    through ``state.apply_params``, which all-gathers shards where the
    stage keeps whole parameters.

    - Dynamic scaler: the optimizer writes a *candidate* (new params and
      optimizer slots, the EMAs included, in fresh tensors; the old ones
      stay untouched). The guard
      covers the update, not only the gradients: a finite-but-huge
      gradient can still overflow inside Adam (``g² > fp32 max``), and an
      in-place write would then keep an inf moment for good. Under ZeRO
      (stage 1 or more) each rank sees only its shard of the candidate, so
      the finite flag is all-reduced (MIN) first (over the model, expert
      and pipe ranks too, which hold other tensors): every rank then commits
      or skips the same step and keeps the same loss scale. The flag is
      read on the host (one device sync per fp16 step). If it is set, the
      commit swaps references to the candidate, copying nothing; if not,
      the candidate is dropped, ``old_batch_stats`` (a snapshot of the
      BatchNorm buffers taken before the forward) is put back, and neither
      the step count nor the schedule advances.
    - Static or inert scaler: the optimizer updates in place, and with
      ``state.capturable`` reads its count on the card (a CUDA graph can
      capture the commit). The dynamic scaler's host read of its flag
      cannot be captured: under ``state.capturable`` it raises.
    """
    params = state.master_params()
    zero = state.zero
    if state.loss_scale.dynamic and state.capturable:
        raise NotImplementedError(
            "the dynamic loss scale reads its finite flag on the host every "
            "step, which a CUDA graph of steps cannot replay: use bf16, fp32 "
            "or a static loss scale there (ROADMAP.md, queue B)")
    opt_state = state.offload_fetch()
    if not state.loss_scale.dynamic:
        new = state.tx.update(params, grads, opt_state, decay=state.decay, zero=zero,
                              capturable=state.capturable)
        _advance_ema_stats(state, new.slots, in_place=True)
        state.offload_store(new)
        state.apply_params(params)
        state.step += 1
        return True
    out = {n: torch.empty_like(p) for n, p in params.items()}
    candidate = state.tx.update(params, grads, opt_state, out=out,
                                decay=state.decay, zero=zero)
    _advance_ema_stats(state, candidate.slots, in_place=False)
    finite_t = all_finite(
        [*grads.values(), *out.values(),
         *(t for slot in candidate.slots.values() for t in slot.values())])
    contexts = [c for c in (zero.tp, zero.ep, zero.pp) if c is not None]
    if zero.partitions_optimizer or contexts:
        finite_t = finite_t.to(torch.int32)
        if zero.partitions_optimizer:
            zero.all_reduce_(finite_t, op=dist.ReduceOp.MIN)
        for ctx in contexts:  # each model, expert or pipe rank sees its own tensors
            dist.all_reduce(finite_t, op=dist.ReduceOp.MIN, group=ctx.group)
    finite = bool(finite_t)
    state.loss_scale = state.loss_scale.update(finite)
    if finite:
        state.offload_store(candidate)
        state.apply_params(out)
        state.step += 1
    elif old_batch_stats is not None:
        with torch.no_grad():
            for buf, old in zip(state.model.buffers(), old_batch_stats):
                buf.copy_(old)
    return finite
