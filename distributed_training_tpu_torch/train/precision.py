"""Mixed-precision policy, dynamic loss scaling, and the guarded commit.

The port of ``distributed_training_tpu/train/precision.py``. The loss
scaler follows DeepSpeed's DynamicLossScaler, as the JAX one does:

- the scale starts at ``2**initial_scale_power``;
- on overflow the update is skipped; the scale halves (floored at
  ``min_loss_scale``) once the hysteresis budget is spent, else one
  hysteresis credit is used;
- after ``loss_scale_window`` good steps in a row the scale doubles and
  the hysteresis budget refills.

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


def commit_gradients(state, grads: dict[str, torch.Tensor],
                     old_batch_stats: list[torch.Tensor] | None = None) -> bool:
    """Apply unscaled grads to ``state`` (a ``TrainState``), skipping the
    whole update when the dynamic loss scale overflowed. Returns whether
    the update was committed.

    - Dynamic scaler: the optimizer writes a *candidate* (new params and
      moments in fresh tensors; the old ones stay untouched). The guard
      covers the update, not only the gradients: a finite-but-huge
      gradient can still overflow inside Adam (``g² > fp32 max``), and an
      in-place write would then keep an inf moment for good. The finite
      flag is read on the host (one device sync per fp16 step). If it is
      set, the commit swaps references to the candidate, copying nothing;
      if not, the candidate is dropped, ``old_batch_stats`` (a snapshot of
      the BatchNorm buffers taken before the forward) is put back, and
      neither the step count nor the schedule advances.
    - Static or inert scaler: the optimizer updates in place.
    """
    params = state.params()
    if not state.loss_scale.dynamic:
        state.opt_state = state.tx.update(params, grads, state.opt_state)
        state.step += 1
        return True
    out = {n: torch.empty_like(p) for n, p in params.items()}
    candidate = state.tx.update(params, grads, state.opt_state, out=out)
    finite = bool(all_finite(
        [*grads.values(), *out.values(), *candidate.mu.values(),
         *candidate.nu.values()]))
    state.loss_scale = state.loss_scale.update(finite)
    if finite:
        for n, p in state.model.named_parameters():
            p.data = out[n]
        state.opt_state = candidate
        state.step += 1
    elif old_batch_stats is not None:
        with torch.no_grad():
            for buf, old in zip(state.model.buffers(), old_batch_stats):
                buf.copy_(old)
    return finite
