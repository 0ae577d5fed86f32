"""The train and eval steps, on one device or data-parallel over a
process group with ZeRO stages 0–3.

The port of ``distributed_training_tpu/train/step.py``: forward, loss,
backward (with gradient accumulation), the gradient exchange, loss-scale
handling, the optimizer update. Metrics stay on the device as 0-d tensors;
the trainer reads them every ``log_interval`` steps, as the JAX trainer
does, so the fp32 step itself makes no host read. (The fp16 step reads
one finite flag: see ``precision.commit_gradients``.)

Data parallelism (the state's ``zero``, ``parallel/zero.py``): every rank
runs forward and backward on its own equal slice of the global batch, so
averaging the gradients over the ranks equals the JAX GSPMD step's loss
mean over the global batch. The step then, in order:

1. exchanges the gradients: all-reduce mean at stages 0–1 (stage 1 then
   keeps its shard), reduce-scatter mean at stages 2–3;
2. clips with the global norm over the shards and adds L2 on them, then
   runs the update (K1 for ``hybrid_adam``) on this rank's shard;
3. all-gathers the updated parameters at stages 1–2; at stage 3 keeps
   the shard, and all-gathers the parameters at the next forward.

Under the ``fsdp`` mesh axis the state's ``zero`` holds the parameters as
shards between steps: the step gathers them before the forward and the
exchange reduce-scatters the gradients over ``fsdp`` and then the rest of
the replica group (``parallel/zero.py``); each rank of ``data × fsdp``
runs its own rows, as JAX's ``batch_sharding`` splits them.

BatchNorm statistics are synchronised over the group (SyncBN,
``models/resnet.py``) unless the model was built without it, in which
case ``local_bn=True`` makes this the counterpart of the JAX package's
``make_shard_map_train_step``: each rank keeps its own statistics in the
step and the running statistics (and their EMA, with ``ema_decay``) are
averaged over the ranks after it.

A model with MoE layers (``moe_mlp``) adds its load-balancing loss to the
objective (JAX ``_forward_and_loss``): ``loss`` is CE + aux, and its noisy
gates draw from a generator seeded by the step's seed, step and data rank.
Under an expert axis the state's ``zero`` group is the data group; the
expert ranks of one data rank hold the same rows and compute the same
loss.

Tensor parallelism (a ``vit_*`` model that ``shard_model_`` cut over the
``model`` axis, its ``tp``): the megatron collectives are the model's, so
every model rank computes the same loss and holds whole gradients of the
replicated leaves, and the step is the same; the state's ``zero`` group
is the data group. Under ``tp_overlap`` (JAX ``_overlap_tp_grads_body``)
the step completes the gradients with ``overlap_finalize_grads`` before
the exchange over the data group; BatchNorm models are refused there, as
in JAX. Dropout masks come from the step's generator, seeded by the data
rank: the same on every model rank, their own on each data rank.

Gradient accumulation cuts the rank's batch into contiguous chunks; the
trainers' loaders order the rows so that chunk *m* is this rank's share
of JAX's microbatch *m* where JAX accumulates under GSPMD.

Batches are dicts of tensors with NHWC ``image``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.models.moe import MoEImageClassifier
from distributed_training_tpu_torch.models.vit import ViT
from distributed_training_tpu_torch.parallel.collective_matmul import (
    overlap_finalize_grads,
)
from distributed_training_tpu_torch.train.optim import global_norm
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


def forward_with_aux(model: torch.nn.Module, x: torch.Tensor,
                     generator: torch.Generator | None = None):
    """``(logits, aux)``: the MoE models' load-balancing loss, or 0 (ViT's
    dropout draws from ``generator``)."""
    if isinstance(model, MoEImageClassifier):
        return model(x, generator=generator, return_aux=True)
    logits = model(x, generator=generator) if isinstance(model, ViT) else model(x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def dropout_generator(model: torch.nn.Module, seed: int, step: int, rank: int,
                      device: torch.device,
                      capturable: bool = False) -> torch.Generator | None:
    """The step's generator of dropout masks and the noisy gates' noise:
    seeded by ``(seed, step, rank)``, so each rank and step draws its own;
    None for a model with neither. Its seed is the host step, which a CUDA
    graph of steps would freeze: with ``capturable`` such a model raises."""
    if not (getattr(model, "dropout_rate", 0.0) or getattr(model, "noisy_gate_policy", None)):
        return None
    if capturable:
        raise NotImplementedError(
            "dropout and noisy gates seed their generator from the host step, "
            "which a CUDA graph of steps cannot advance: run such a model one "
            "step a call (ROADMAP.md, queue B)")
    key = int(np.random.SeedSequence([seed, step, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key % 2**63)


def make_train_step(*, zero_stage: int = 0, grad_accum_steps: int = 1,
                    label_smoothing: float = 0.0,
                    input_affine: tuple | None = None,
                    local_bn: bool = False, seed: int = 0,
                    grad_norm_metric: bool = False) -> Callable:
    """Build ``step(state, batch) -> metrics``.

    ``zero_stage`` must be the stage of ``state.zero`` (the state holds the
    partitioned tensors; the argument states the intent, and a mismatch
    raises). ``grad_accum_steps > 1``: the batch is the rank's effective
    batch; it is cut into that many contiguous microbatches, their
    gradients are summed and averaged, and one optimizer update follows.
    BatchNorm running stats tick once per microbatch, in order (torch
    grad-accum semantics). ``local_bn``: BatchNorm without a group, its
    running statistics averaged over the ranks after the step; stage 0
    only, as in the JAX package. ``seed`` seeds the noisy gates' noise.
    ``grad_norm_metric`` adds ``grad_norm``: the global L2 norm of the
    averaged, unscaled gradients the optimizer takes, on the device (each
    shard counted once, ``optim.global_norm``), read at the meter's flush
    like every metric.
    """
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if local_bn and zero_stage != 0:
        raise NotImplementedError(
            "sync_batchnorm=False uses the explicit DP step, which has no "
            "ZeRO sharding; use zero stage 0 with local BN")

    def step(state: TrainState, batch: dict) -> dict:
        zero = state.zero
        if zero.stage != zero_stage:
            raise ValueError(f"the step was built for zero stage {zero_stage}, "
                             f"the state is partitioned for {zero.stage}")
        model = state.model
        tp = getattr(model, "tp", None)
        overlap = tp if tp is not None and tp.overlap else None
        if overlap is not None and any(True for _ in model.buffers()):
            raise NotImplementedError(
                "tp_overlap image step supports BatchNorm-free models only "
                "(ViT); BN statistics under a manual model axis are not "
                "wired — use the declarative TP schedule")
        model.train()
        images = _input_images(batch, input_affine)
        labels = batch["label"].long()
        if images.shape[0] % grad_accum_steps:
            raise ValueError(
                f"batch dim {images.shape[0]} not divisible by "
                f"gradient_accumulation_steps={grad_accum_steps}")
        ls = state.loss_scale
        snapshot = ([b.clone() for b in model.buffers()] if ls.dynamic else None)
        state.gather_params()
        for p in model.parameters():
            p.grad = None
        losses, accs = [], []
        gen = dropout_generator(model, seed, state.step, zero.rank, images.device,
                                state.capturable)
        for x, y in zip(images.chunk(grad_accum_steps),
                        labels.chunk(grad_accum_steps)):
            logits, aux = forward_with_aux(model, x, gen)
            loss = cross_entropy_loss(logits, y, label_smoothing) + aux
            ls.scale_loss(loss).backward()
            losses.append(loss.detach())
            accs.append(_accuracy(logits.detach(), y))
        names = [n for n, _ in model.named_parameters()]
        grads = [p.grad for p in model.parameters()]
        for p in model.parameters():
            p.grad = None
        if grad_accum_steps > 1:
            grads = [g / grad_accum_steps for g in grads]
        if overlap is not None:
            done = overlap_finalize_grads(dict(zip(names, grads)), overlap)
            grads = [done[n] for n in names]
        grads = zero.exchange_grads(grads)
        state.release_params()
        grads = ls.unscale_grads(dict(zip(names, grads)))
        finite = commit_gradients(state, grads, snapshot)
        if local_bn:
            bufs = list(model.buffers())
            ema = list(state.opt_state.slots.get("ema_stats", {}).values())
            with torch.no_grad():
                for b, avg in zip([*bufs, *ema], [*zero.all_reduce_mean(bufs),
                                                  *zero.mean_over_copies(ema)]):
                    b.copy_(avg)
        loss, acc = zero.all_reduce_mean(
            [torch.stack(losses).mean(), torch.stack(accs).mean()])
        metrics = {
            "loss": loss,
            "accuracy": acc,
            "loss_scale": state.loss_scale.scale,
            "grads_finite": 1.0 if finite else 0.0,
        }
        if grad_norm_metric:
            metrics["grad_norm"] = global_norm(list(grads.values()), zero, names)
        return metrics

    return step


def make_eval_step(input_affine: tuple | None = None) -> Callable:
    """Build ``eval(state, batch) -> (top1_count, top5_count, count)`` as
    0-d device tensors, summed over the ranks of ``state.zero``'s group;
    ``batch['mask']`` (0/1) drops the padding of a ragged last batch. At
    ZeRO stage 3 it gathers the parameters and leaves them gathered (the
    trainer releases them after the eval pass)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        state.gather_params()
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
        counts = torch.stack([(correct * mask).sum(), (correct5 * mask).sum(),
                              mask.sum()])
        return tuple(state.zero.all_reduce_(counts))

    return eval_step
