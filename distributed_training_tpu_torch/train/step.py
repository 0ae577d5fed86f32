"""The train and eval steps on one device.

The port of ``distributed_training_tpu/train/step.py``'s single-device
path: forward, loss, backward (with gradient accumulation), loss-scale
handling, the optimizer update. Metrics stay on the device as 0-d tensors;
the trainer reads them every ``log_interval`` steps, as the JAX trainer
does, so the fp32 step itself makes no host read. (The fp16 step reads
one finite flag: see ``precision.commit_gradients``.)

Batches are dicts of tensors with NHWC ``image``, as in the JAX package.
Multi-GPU data parallelism and ZeRO are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.train.precision import commit_gradients
from distributed_training_tpu_torch.train.train_state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy; ``label_smoothing`` blends the one-hot
    target with uniform mass (``optax.smooth_labels``)."""
    return F.cross_entropy(logits, labels.long(), label_smoothing=label_smoothing)


def _input_images(batch: dict, input_affine=None) -> torch.Tensor:
    """uint8 batches map to float with a static affine (default ToTensor's
    ``x/255``); float batches pass through."""
    x = batch["image"]
    if x.dtype == torch.uint8:
        scale, bias = input_affine or (1.0 / 255.0, 0.0)
        x = x.float() * scale + bias
    return x


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def make_train_step(*, zero_stage: int = 0, grad_accum_steps: int = 1,
                    label_smoothing: float = 0.0,
                    input_affine: tuple | None = None) -> Callable:
    """Build ``step(state, batch) -> metrics``.

    ``grad_accum_steps > 1``: the batch is the effective batch; it is cut
    into that many contiguous microbatches, their gradients are summed and
    averaged, and one optimizer update follows. BatchNorm running stats
    tick once per microbatch, in order (torch grad-accum semantics).
    """
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if zero_stage != 0:
        raise NotImplementedError(
            "ZeRO (zero.stage > 0) needs multi-GPU data parallelism, which "
            "is not ported yet")

    def step(state: TrainState, batch: dict) -> dict:
        model = state.model
        model.train()
        images = _input_images(batch, input_affine)
        labels = batch["label"].long()
        if images.shape[0] % grad_accum_steps:
            raise ValueError(
                f"batch dim {images.shape[0]} not divisible by "
                f"gradient_accumulation_steps={grad_accum_steps}")
        ls = state.loss_scale
        snapshot = ([b.clone() for b in model.buffers()] if ls.dynamic else None)
        for p in model.parameters():
            p.grad = None
        losses, accs = [], []
        for x, y in zip(images.chunk(grad_accum_steps),
                        labels.chunk(grad_accum_steps)):
            logits = model(x)
            loss = cross_entropy_loss(logits, y, label_smoothing)
            ls.scale_loss(loss).backward()
            losses.append(loss.detach())
            accs.append(_accuracy(logits.detach(), y))
        grads = {n: p.grad for n, p in model.named_parameters()}
        if grad_accum_steps > 1:
            grads = {n: g / grad_accum_steps for n, g in grads.items()}
        grads = ls.unscale_grads(grads)
        finite = commit_gradients(state, grads, snapshot)
        for p in model.parameters():
            p.grad = None
        return {
            "loss": torch.stack(losses).mean(),
            "accuracy": torch.stack(accs).mean(),
            "loss_scale": state.loss_scale.scale,
            "grads_finite": float(finite),
        }

    return step


def make_eval_step(input_affine: tuple | None = None) -> Callable:
    """Build ``eval(state, batch) -> (top1_count, top5_count, count)`` as
    0-d device tensors; ``batch['mask']`` (0/1) drops the padding of a
    ragged last batch."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        state.model.eval()
        logits = state.model(_input_images(batch, input_affine))
        labels = batch["label"].long()
        correct = (logits.argmax(-1) == labels).float()
        k = min(5, logits.shape[-1])
        topk = logits.topk(k, dim=-1).indices
        correct5 = (topk == labels[:, None]).any(-1).float()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones_like(correct)
        return (correct * mask).sum(), (correct5 * mask).sum(), mask.sum()

    return eval_step
