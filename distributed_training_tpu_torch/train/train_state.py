"""Train state: model, optimizer state, loss scaler and step count as one
object.

The JAX package carries these as one immutable pytree through a jitted
step. PyTorch updates in place, so here they are one mutable object that
the step changes: the model's parameters and BatchNorm buffers, the
optimizer's state, the loss scaler and the number of committed updates.
"""

from __future__ import annotations

import dataclasses

import torch

from distributed_training_tpu_torch.train.optim import Adam, AdamState
from distributed_training_tpu_torch.train.precision import LossScaleState


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    tx: Adam
    opt_state: AdamState
    loss_scale: LossScaleState
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Adam,
               loss_scale: LossScaleState | None = None) -> "TrainState":
        if loss_scale is None:
            loss_scale = LossScaleState(scale=1.0, good_steps=0,
                                        hysteresis_left=1, dynamic=False)
        state = cls(model=model, tx=tx, opt_state=None, loss_scale=loss_scale)
        state.opt_state = tx.init(state.params())
        return state

    def params(self) -> dict[str, torch.Tensor]:
        """Parameters by name (the tensors themselves, updated in place)."""
        return dict(self.model.named_parameters())

    def state_dict(self) -> dict:
        """Everything a resume needs, as plain tensors and numbers."""
        return {
            "model": self.model.state_dict(),
            "opt_state": {"count": self.opt_state.count,
                          "mu": self.opt_state.mu, "nu": self.opt_state.nu},
            "loss_scale": dataclasses.asdict(self.loss_scale),
            "step": self.step,
        }

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        with torch.no_grad():
            for key in ("mu", "nu"):
                mine = getattr(self.opt_state, key)
                if set(mine) != set(sd["opt_state"][key]):
                    raise ValueError(f"optimizer state {key} names differ from "
                                     f"the checkpoint's")
                for n, t in sd["opt_state"][key].items():
                    mine[n].copy_(t)
        self.opt_state.count = int(sd["opt_state"]["count"])
        self.loss_scale = LossScaleState(**sd["loss_scale"])
        self.step = int(sd["step"])


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
