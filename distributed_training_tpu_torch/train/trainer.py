"""The Trainer: epoch loop, eval, the ``target_acc`` gate, checkpointing.

The port of ``distributed_training_tpu/train/trainer.py`` for one device.
``Trainer(cfg).fit()`` returns the JAX trainer's keys: ``final_acc``,
``preempted``, ``last_metrics`` and ``steps`` (committed updates).

It runs on the card unless ``device="cpu"`` is passed, and raises when
there is no card and no such request. Checkpoints are written
synchronously (a save is durable when it returns, as an awaited async
save of the JAX trainer is); the port installs no SIGTERM handler, so a
preempted process simply ends and ``auto_resume`` picks up its newest
committed save. Fields of the config whose behaviour is not ported yet
raise ``NotImplementedError`` when set away from their defaults.
"""

from __future__ import annotations

import torch

from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import TrainConfig, effective_batch_sizes
from distributed_training_tpu_torch.data.pipeline import (
    SkipBatches,
    build_dataloaders,
    to_device,
)
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState, Policy
from distributed_training_tpu_torch.train.step import make_eval_step, make_train_step
from distributed_training_tpu_torch.train.train_state import TrainState, param_count
from distributed_training_tpu_torch.utils.device import resolve_device, set_fp32_math


def _refuse_unported(cfg: TrainConfig) -> None:
    """Raise for every field set to a behaviour the port lacks."""
    unported = {
        "remat": cfg.remat,
        "tp_overlap": cfg.tp_overlap,
        "eval_precise_bn_batches": cfg.eval_precise_bn_batches,
        "wall_clock_breakdown": cfg.wall_clock_breakdown,
        "profile_dir": cfg.profile_dir,
        "tensorboard_dir": cfg.tensorboard_dir,
        "metrics_jsonl": cfg.metrics_jsonl,
        "optimizer.ema_decay": cfg.optimizer.ema_decay,
        "zero.stage": cfg.zero.stage,
        "zero.cpu_offload": cfg.zero.cpu_offload,
        "data.decoded_cache": cfg.data.decoded_cache,
        "precision.dtype == 'bf16'": cfg.precision.dtype == "bf16",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not ported yet (see ROADMAP.md): {', '.join(bad)}")


class MetricMeter:
    """Keeps the device metrics of the last steps and reads the newest
    every ``log_interval`` steps; ``history`` holds every read."""

    def __init__(self, log_interval: int = 100):
        self.log_interval = max(1, log_interval)
        self._pending: list[tuple[int, dict]] = []
        self.last: dict[str, float] = {}
        self.history: list[dict[str, float]] = []

    def push(self, step: int, metrics: dict) -> bool:
        self._pending.append((step, metrics))
        if len(self._pending) >= self.log_interval:
            self.flush()
            return True
        return False

    def flush(self) -> dict[str, float]:
        if not self._pending:
            return self.last
        step, metrics = self._pending[-1]
        self._pending.clear()
        self.last = {k: float(v) for k, v in metrics.items()}
        self.last["step"] = step
        self.history.append(self.last)
        return self.last


class Trainer:
    """End-to-end training engine on one device."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device | None = None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        set_fp32_math()
        self.world_size = 1
        policy = Policy.from_config(cfg.precision)
        gen = torch.Generator().manual_seed(cfg.seed)
        model = get_model(cfg.model, num_classes=cfg.data.num_classes,
                          dtype=policy.compute_dtype, generator=gen)
        self.model = model.to(self.device)
        self.tx = make_optimizer(cfg.optimizer, cfg.scheduler, self.world_size)
        self.state = TrainState.create(
            self.model, self.tx, LossScaleState.create(cfg.precision))
        self.train_gbs, self.eval_gbs, self.grad_accum = effective_batch_sizes(
            cfg, self.world_size, allow_derive=True)
        input_affine = ((2.0 / 255.0, -1.0) if cfg.data.augment == "normalize_only"
                        else (1.0 / 255.0, 0.0))
        self.train_step = make_train_step(
            zero_stage=cfg.zero.stage, grad_accum_steps=self.grad_accum,
            label_smoothing=cfg.label_smoothing, input_affine=input_affine)
        self.eval_step = make_eval_step(input_affine=input_affine)
        self.meter = MetricMeter(cfg.log_interval)
        self.last_eval: dict[str, float] = {}
        self._global_step = 0
        print(f"[trainer] model={cfg.model} params={param_count(self.model):,} "
              f"device={self.device} plugin={cfg.plugin} "
              f"dtype={cfg.precision.dtype} optimizer={cfg.optimizer.name}"
              + (f" grad_accum={self.grad_accum}" if self.grad_accum > 1 else ""))

    def make_loaders(self):
        return build_dataloaders(self.cfg, seed=self.cfg.seed,
                                 global_batch_size=self.train_gbs,
                                 eval_global_batch_size=self.eval_gbs)

    def train_epoch(self, epoch: int, loader, skip_steps: int = 0) -> dict:
        """One epoch; ``skip_steps`` drops that many leading batches of the
        epoch's deterministic shuffle (step-accurate resume)."""
        loader.set_epoch(epoch)
        if skip_steps:
            print(f"[trainer] resuming epoch {epoch} at step {skip_steps}")
            loader = SkipBatches(loader, skip_steps)
        for batch in loader:
            metrics = self.train_step(self.state, to_device(batch, self.device))
            self._global_step += 1
            self.meter.push(self._global_step, metrics)
        self.meter.flush()
        print(f"[train] epoch {epoch + 1}: "
              + " ".join(f"{k}={v:.4g}" for k, v in self.meter.last.items()))
        return self.meter.last

    def evaluate(self, loader) -> float:
        """Top-1 accuracy; top-5 is kept on ``self.last_eval``."""
        sums = torch.zeros(3, device=self.device)
        for batch in loader:
            c, c5, t = self.eval_step(self.state, to_device(batch, self.device))
            sums += torch.stack([c, c5, t])
        correct, correct5, total = sums.tolist()
        self.last_eval = {"top1": correct / max(total, 1.0),
                          "top5": correct5 / max(total, 1.0)}
        return self.last_eval["top1"]

    def fit(self) -> dict:
        cfg = self.cfg
        train_loader, eval_loader = self.make_loaders()
        start_epoch = start_step = 0
        resume = ckpt_lib.resolve_resume(cfg.checkpoint)
        if resume >= 0:
            start_epoch, start_step = ckpt_lib.restore_checkpoint(
                cfg.checkpoint.directory, resume, self.state)
            self._global_step = self.state.step
            print(f"[trainer] resumed at epoch {start_epoch}")
        final_acc = None
        last_eval_epoch = -1
        for epoch in range(start_epoch, cfg.num_epochs):
            self.train_epoch(epoch, train_loader,
                             skip_steps=start_step if epoch == start_epoch else 0)
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                final_acc = self.evaluate(eval_loader)
                last_eval_epoch = epoch + 1
                print(f"[eval] epoch {epoch + 1}: top-1 {final_acc:.4f}")
            if cfg.checkpoint.interval and (epoch + 1) % cfg.checkpoint.interval == 0:
                ckpt_lib.save_checkpoint(cfg.checkpoint.directory, epoch, self.state)
                ckpt_lib.prune_checkpoints(cfg.checkpoint.directory,
                                           cfg.checkpoint.keep)
        if cfg.target_acc is not None:
            if final_acc is None or last_eval_epoch != cfg.num_epochs:
                final_acc = self.evaluate(eval_loader)
            if final_acc < cfg.target_acc:
                raise RuntimeError(
                    f"target accuracy {cfg.target_acc} not reached "
                    f"(got {final_acc:.4f})")
        return {"final_acc": final_acc, "preempted": False,
                "last_metrics": self.meter.last, "steps": self.state.step}
