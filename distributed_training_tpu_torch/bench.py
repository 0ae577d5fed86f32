"""Benchmark: the two headline training-throughput metrics, on the port.

    python -m distributed_training_tpu_torch.bench            # both legs
    python -m distributed_training_tpu_torch.bench --image    # one leg
    python -m distributed_training_tpu_torch.bench --lm --lm-optimizer hybrid_adam
    python -m distributed_training_tpu_torch.bench --device cpu --model resnet_micro ...
    python -m distributed_training_tpu_torch.bench --data-only --data-mode both
    python -m distributed_training_tpu_torch.bench --data-concurrent

The port of the root ``bench.py``, with its parser (names and defaults)
and its output: a bare run prints the image leg's JSON line, then the LM
leg's, each with ``metric``, ``value``, ``unit``, ``vs_baseline``, ``mfu``,
``model_flops_per_sec``, ``step_time_p50_ms`` and ``step_time_p95_ms``.

- **Image leg:** ResNet-50 on synthetic ImageNet at 224², bf16 compute
  over float32 parameters, an effective batch of 512 as 2 × 256 gradient
  accumulation, SGD 0.1 with momentum 0.9, through the image train step
  (``train/step.py``) at ``--zero-stage``. ``--remat`` runs each
  block under activation checkpointing, ``--remat-policy conv`` keeps
  only the convolutions' outputs, ``--param-dtype bf16`` keeps the
  parameters and the SGD momentum in bf16 (the BatchNorm statistics stay
  float32, as in the Flax model). ``--model vit_b16`` runs ViT-B/16
  (``models/vit.py``) in the same loop, with ``--remat`` each encoder
  block under activation checkpointing, as the root bench does.
- **LM leg:** GPT-2-small (vocab 50304, 12 layers, 12 heads, hidden 768)
  at B16 T1024, bf16, the flash kernels K2/K3, bf16 logits, no head
  bias, AdamW 3e-4 (optax's defaults: weight decay 1e-4 on every
  tensor), through the LM train step; ``--lm-optimizer hybrid_adam`` runs
  the fused-Adam kernel K1, ``--ce-chunk`` and ``--ce-save-probs`` the
  chunked and saved-probabilities CE.
- **--data-only** (:func:`bench_data_only`): the host input pipeline
  alone, in images/s: live JPEG decode through the imagefolder loader,
  the decoded cache, or the in-memory augment (``--data-mode``), over a
  generated JPEG tree (``--data-images`` at 256², quality 85, 8 classes)
  or ``--data-path``.
- **--data-concurrent** (:func:`bench_data_concurrent`): ResNet-50 (8
  classes) trained on decoded-cache batches through the device
  prefetcher, with a second loader assembling batches flat out beside it
  (``--data-stress``): the train images/s and the host's spare images/s.

**Over the launcher's ranks** (``torchrun``, ``WORLD_SIZE`` > 1; or a
group the caller opened, such as a world-1 NCCL group) every leg but
``--data-only`` runs data-parallel over all W ranks, as the root bench runs
over every device: :func:`main` opens the group (NCCL with each rank on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``) and the legs' setups read
it; rank 0 alone prints, and the metric names ``W gpu chip(s)``. The image
leg's global batch is ``--batch-size`` × W, made from ``RandomState(0)``
as the root makes it, each rank its rows (of each of JAX's accumulation
microbatches); at W > 1 SyncBN's statistics span the global batch (at W 1
each BatchNorm keeps its own, as ``torch.nn.SyncBatchNorm`` does) and
``--zero-stage`` shards over the ranks; ``value`` is images/s a chip and
``mfu`` counts W chips. The LM
leg runs on ``data × model`` (``--tp``), ``--lm-batch`` the global batch,
``value`` tokens/s in all. ``--data-concurrent`` trains ``--batch-size`` ×
W (rank 0 writes the JPEGs and the cache, the others wait), and
``--data-stress`` loads rank 0's host alone.

Both legs time the steady state on batches already on the card: 5
warm-up steps, then 45 steps with a host read of the loss every 15 (the
barrier), by the host clock. The step-time percentiles are over those
sync windows' mean step times. The data modes print the root bench's
keys and extras; their images need Pillow to be written and decoded
(``ImportError`` naming it otherwise). ``mfu`` is the train step's model FLOPs
(``observability.flops``: 3× the forward's matmul FLOPs at the effective
batch) per second over the card's dense bf16 peak; null for a card the
peak table does not know, and on the CPU, unless ``$OBS_PEAK_FLOPS`` gives
one. ``vs_baseline`` is null: the root bench's baselines (6000 images/s,
94,600 tokens/s, and the data modes' device rate) are a TPU's.

``--steps-per-call N`` (15 by default, as in the root bench) runs N steps
a call (``train/multi_step.py``): on the card one CUDA graph of N steps,
the counterpart of the root's ``lax.scan`` of N steps in one dispatch; on
the CPU the same N steps in a loop. As in the root bench, the image leg
takes N on every device and the LM leg on the card only (the root's on the
TPU only); on the card one priming step runs before the capture,
``--warmup`` and ``--steps`` count calls of N steps (rounded down, at
least 1; the image leg says so on stderr when it rounds up, in the root's
words), and throughput counts ``steps × N`` steps.
``--cpu-offload`` forces N to 1 with the root's message. Over the ranks
the graph captures the step's NCCL collectives (``train/multi_step.py``).
Under N > 1 an fp16 loss scale and a model with dropout raise
``NotImplementedError`` naming ROADMAP.md; pass ``--steps-per-call 1`` for
one eager step a call and exact step counts. ``--tp N`` runs the LM leg
megatron-sharded over N of the launcher's ranks (``--tp`` must divide the
ranks, or the bench exits, as the root bench does), and ``--tp-overlap``
on the ring-overlapped schedule (at ``--tp 1`` the plain step, as in the
root bench); the MFU divides by every rank's card. ``--check`` raises ``NotImplementedError`` naming ROADMAP.md,
never silently ignored. There is no CPU clamp: on the CPU (``--device
cpu``) the sizes are what the caller passes.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch



class _WindowTimer:
    """Per-sync-window step times: ``mark(k)`` after every host read
    records the window's mean per-step ms over the k steps it covered."""

    def __init__(self):
        self._last = time.perf_counter()
        self.per_step_ms: list[float] = []

    def mark(self, steps_in_window: int) -> None:
        now = time.perf_counter()
        if steps_in_window > 0:
            self.per_step_ms.append((now - self._last) / steps_in_window * 1e3)
        self._last = now


def observability_fields(step_flops: int | None, per_step_ms: list,
                         total_steps: int, total_seconds: float,
                         n_devices: int = 1) -> dict:
    """``mfu``, ``model_flops_per_sec`` and the step-time percentiles, as
    the root bench computes them (over ``n_devices`` cards)."""
    from distributed_training_tpu_torch.observability import (
        device_peak_flops,
        mfu,
        percentile,
    )

    out: dict = {"mfu": None}
    if per_step_ms:
        out["step_time_p50_ms"] = round(percentile(per_step_ms, 50), 3)
        out["step_time_p95_ms"] = round(percentile(per_step_ms, 95), 3)
    if step_flops and total_seconds > 0:
        fps = step_flops * total_steps / total_seconds
        out["model_flops_per_sec"] = round(fps, 1)
        u = mfu(fps, n_devices, device_peak_flops())
        if u is not None:
            out["mfu"] = round(u, 4)
    return out


def _timed_loop(step, state, batch, args, steps_per_call: int = 1
                ) -> tuple[float, list, float]:
    """Warm-up, then ``args.steps`` calls with a host read of the loss
    every ``sync_interval`` calls: (seconds, per-window step ms, last
    loss). A call is one step, or at ``steps_per_call`` N > 1 N steps
    (``make_multi_step``, which on the card primes and captures first),
    ``args.warmup`` and ``args.steps`` rounded to calls as the root bench
    rounds them."""
    if steps_per_call > 1:
        from distributed_training_tpu_torch.train.multi_step import make_multi_step

        call = make_multi_step(step, state, batch, steps_per_call)
        args.steps = max(1, args.steps // steps_per_call)
        args.warmup = max(1, args.warmup // steps_per_call)
    else:
        def call():
            return step(state, batch)
    for _ in range(args.warmup):
        metrics = call()
    if args.warmup:
        float(metrics["loss"])
    t0 = time.perf_counter()
    wt = _WindowTimer()
    win = 0
    for i in range(args.steps):
        metrics = call()
        win += steps_per_call
        if args.sync_interval > 0 and (i + 1) % args.sync_interval == 0:
            float(metrics["loss"])
            wt.mark(win)
            win = 0
    loss = float(metrics["loss"])
    wt.mark(win)
    return time.perf_counter() - t0, wt.per_step_ms, loss


def _where(device: torch.device, chips: int = 1) -> str:
    return f"{chips} gpu chip(s)" if device.type == "cuda" else "cpu"


PARAM_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def image_train(args, device: torch.device, num_classes: int, group=None):
    """The image leg's ``(model, state, step)``: the model in bf16, SGD;
    over ``group`` (the launcher's ranks) data-parallel, with
    ``--zero-stage``'s partition and, over more than one rank, SyncBN's
    statistics over its ranks (a world-1 SyncBN's all-reduces would only
    slow the step)."""
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.models.resnet import set_batchnorm_group
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.step import make_train_step
    from distributed_training_tpu_torch.train.train_state import TrainState

    # As the root bench: remat_policy only when set (ViT has none), and
    # ViT's positional table sized by the image.
    kwargs = dict(remat=args.remat, param_dtype=PARAM_DTYPES[args.param_dtype])
    if args.remat_policy:
        kwargs["remat_policy"] = args.remat_policy
    if args.model.startswith("vit"):
        kwargs["image_size"] = args.image_size
    model = get_model(args.model, num_classes=num_classes, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0), **kwargs).to(device)
    set_batchnorm_group(model, group if _world(group) > 1 else None)
    # SGD with momentum, as the root bench's optax.sgd(0.1, momentum=0.9).
    tx = make_optimizer(OptimizerConfig(name="sgd", lr=0.1, momentum=0.9))
    state = TrainState.create(model, tx, LossScaleState.create(PrecisionConfig(dtype="bf16")),
                              Zero(args.zero_stage, group, args.cpu_offload))
    step = make_train_step(zero_stage=args.zero_stage, grad_accum_steps=args.grad_accum)
    return model, state, step


def _world(group) -> int:
    return torch.distributed.get_world_size(group) if group is not None else 1


def _is_master(group) -> bool:
    return group is None or torch.distributed.get_rank(group) == 0


def image_step(args, device: torch.device):
    """The image leg's ``(model, state, step, batch)``, as it is timed:
    over the launcher's ranks (the open group) each rank holds its
    ``--batch-size`` rows of one global batch of ``--batch-size`` × ranks,
    made from ``RandomState(0)`` as the root bench makes it, its rows those
    of JAX's microbatches (``data/pipeline.py::process_rows``)."""
    from distributed_training_tpu_torch.data.pipeline import process_rows
    from distributed_training_tpu_torch.runtime.distributed import process_group

    group = process_group()
    model, state, step = image_train(args, device, args.num_classes, group)
    world = _world(group)
    global_batch = args.batch_size * world
    rng = np.random.RandomState(0)
    images = rng.rand(global_batch, args.image_size, args.image_size, 3)
    labels = rng.randint(0, args.num_classes, global_batch).astype(np.int32)
    if world > 1:
        rows = process_rows(np.arange(global_batch), torch.distributed.get_rank(group),
                            world, microbatches=args.grad_accum)
        images, labels = images[rows], labels[rows]
    if args.input_dtype == "uint8":
        images = torch.from_numpy((images * 255).astype(np.uint8))
    else:
        images = torch.from_numpy(images.astype(np.float32)).to(
            torch.bfloat16 if args.input_dtype == "bf16" else torch.float32)
    batch = {"image": images.to(device), "label": torch.from_numpy(labels).to(device)}
    return model, state, step, batch


def bench_image(args, device: torch.device) -> tuple[dict, float]:
    """The image leg: ``(the JSON line's dict, the last loss)``."""
    from distributed_training_tpu_torch.observability import (
        forward_flops,
        train_step_flops,
    )
    from distributed_training_tpu_torch.runtime.distributed import process_group

    steps_per_call = max(1, args.steps_per_call)
    if args.cpu_offload and steps_per_call > 1:
        # The root bench's rule: offload streams host<->device every step,
        # so amortizing dispatch is moot; run per-step.
        print("bench: --cpu-offload forces --steps-per-call 1", file=sys.stderr)
        steps_per_call = 1
    if (steps_per_call > 1 and (args.warmup == 0 or args.steps < steps_per_call)
            and _is_master(process_group())):
        print(f"bench: steps-per-call={steps_per_call} rounds "
              f"warmup {args.warmup}->{max(1, args.warmup // steps_per_call) * steps_per_call} "
              f"and steps {args.steps}->{max(1, args.steps // steps_per_call) * steps_per_call} "
              f"(one priming call always runs; pass --steps-per-call 1 "
              f"for exact counts)", file=sys.stderr)
    model, state, step, batch = image_step(args, device)
    group = state.zero.group
    chips = _world(group)
    dt, per_step_ms, loss = _timed_loop(step, state, batch, args, steps_per_call)

    # The root's images/s over every chip, divided by the chips.
    per_chip = args.steps * steps_per_call * args.batch_size / dt
    step_flops = train_step_flops(forward_flops(model, image_size=args.image_size,
                                                batch=args.batch_size * chips))
    result = {
        "metric": f"{args.model} synthetic-ImageNet train throughput "
                  f"(bf16, batch {args.batch_size}/chip"
                  f"{', zero-' + str(args.zero_stage) if args.zero_stage else ''}"
                  f"{', offload' if args.cpu_offload else ''}"
                  f"{', remat' if args.remat else ''}"
                  f"{', remat:' + args.remat_policy if args.remat_policy else ''}"
                  f"{', params:bf16' if args.param_dtype == 'bf16' else ''}"
                  f"{', in:' + args.input_dtype if args.input_dtype != 'fp32' else ''}"
                  f"{', accum:' + str(args.grad_accum) if args.grad_accum > 1 else ''}"
                  f"{', steps/call:' + str(steps_per_call) if steps_per_call > 1 else ''}"
                  f", {_where(device, chips)})",
        "value": round(per_chip, 2),
        "unit": "images/sec/chip",
        "vs_baseline": None,
        **observability_fields(step_flops, per_step_ms, args.steps * steps_per_call, dt,
                               chips),
    }
    if _is_master(group):
        print(json.dumps(result), flush=True)
    return result, loss


def lm_mesh(args):
    """The LM leg's mesh: ``data × model`` (``--tp``) over the launcher's
    ranks (the open group), after the root bench's check that ``--tp``
    divides them (which exits otherwise); None for one process alone."""
    from distributed_training_tpu_torch.runtime.distributed import process_group

    ranks = _world(process_group())
    if args.tp < 1 or ranks % args.tp:
        raise SystemExit(f"--tp {args.tp} must be >= 1 and divide the "
                         f"device count (= {ranks})")
    if process_group() is None:
        return None
    from distributed_training_tpu_torch.config import MeshSpec
    from distributed_training_tpu_torch.runtime.mesh import Mesh

    return Mesh(MeshSpec(data=-1, model=args.tp))


def lm_step(args, device: torch.device):
    """The LM leg's ``(model, state, step, batch)``, as it is timed: on
    the mesh over the launcher's ranks (:func:`lm_mesh`), the model's
    tensor-parallel shards (the ring-overlapped schedule with
    ``--tp-overlap``) and this data rank's rows of the global batch."""
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.data.pipeline import to_device
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
        shard_model_,
    )
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.lm_step import (
        make_lm_batch,
        make_lm_train_step,
        parse_logits_dtype,
    )
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    mesh = lm_mesh(args)
    model = get_model(
        "transformer_lm", num_classes=50304, dtype=torch.bfloat16,
        num_layers=12, num_heads=12, hidden_dim=768, max_len=args.seq_len,
        attn_impl=args.attn_impl, logits_dtype=parse_logits_dtype(args.logits_dtype),
        head_bias=args.head_bias, generator=torch.Generator().manual_seed(0))
    tp = TensorParallel.from_mesh(mesh, overlap=args.tp_overlap)
    shard_model_(model, tp).to(device)
    if args.lm_optimizer == "hybrid_adam":
        opt = OptimizerConfig(name="hybrid_adam", lr=3e-4)
    else:  # optax.adamw(3e-4): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
        opt = OptimizerConfig(name="adamw", lr=3e-4, weight_decay=1e-4)
    group = mesh.group("data", "sequence") if mesh is not None else None
    state = TrainState.create(model, make_optimizer(opt),
                              LossScaleState.create(PrecisionConfig(dtype="bf16")),
                              Zero(0, group, tp=tp))
    step = make_lm_train_step(accuracy_metric=not args.no_accuracy, max_len=args.seq_len,
                              ce_chunk=args.ce_chunk, ce_save_probs=args.ce_save_probs,
                              logits_dtype=parse_logits_dtype(args.logits_dtype))
    toks = np.random.RandomState(0).randint(
        0, 50304, (args.lm_batch, args.seq_len + 1)).astype(np.int32)
    if mesh is not None:  # this data rank's rows
        rows = args.lm_batch // mesh.size("data")
        toks = toks[mesh.index("data") * rows:(mesh.index("data") + 1) * rows]
    batch = to_device({k: np.ascontiguousarray(v) for k, v in make_lm_batch(toks).items()},
                      device)
    return model, state, step, batch


def bench_lm(args, device: torch.device) -> tuple[dict, float]:
    """The LM leg: ``(the JSON line's dict, the last loss)``; on a mesh
    every rank runs it and rank 0 prints."""
    from distributed_training_tpu_torch.observability import (
        forward_flops,
        train_step_flops,
    )
    from distributed_training_tpu_torch.runtime.distributed import process_group

    # As the root bench's LM leg takes N on the TPU only: N on the card.
    steps_per_call = max(1, args.steps_per_call) if device.type == "cuda" else 1
    model, state, step, batch = lm_step(args, device)
    # Every rank of the mesh: under --tp the state's group is its data group.
    group = process_group()
    dt, per_step_ms, loss = _timed_loop(step, state, batch, args, steps_per_call)

    tok_s = args.lm_batch * args.seq_len * args.steps * steps_per_call / dt
    step_flops = train_step_flops(forward_flops(model, seq_len=args.seq_len,
                                                batch=args.lm_batch))
    chips = _world(group)
    result = {
        "metric": f"GPT-2-small train throughput (bf16 "
                  f"{'HybridAdam' if args.lm_optimizer == 'hybrid_adam' else 'AdamW'}, B"
                  f"{args.lm_batch} T{args.seq_len} {args.attn_impl}"
                  f"{', logits:fp32' if args.logits_dtype == 'fp32' else ''}"
                  f"{', head-bias' if args.head_bias else ''}"
                  f"{', chunked CE' if args.ce_chunk else ''}"
                  f"{', ce-probs' if args.ce_save_probs else ''}"
                  f"{', no-acc-metric' if args.no_accuracy else ''}"
                  f"{', tp:' + str(args.tp) if args.tp > 1 else ''}"
                  f"{', tp-overlap' if args.tp_overlap else ''}"
                  f"{', steps/call:' + str(steps_per_call) if steps_per_call > 1 else ''}"
                  f", {_where(device, chips)})",
        "value": round(tok_s, 1),
        "unit": "tokens/sec",
        "vs_baseline": None,
        **observability_fields(step_flops, per_step_ms, args.steps * steps_per_call, dt,
                               chips),
    }
    if _is_master(group):
        print(json.dumps(result), flush=True)
    return result, loss


def _jpeg_tree(root: str, n: int, classes: int | None) -> tuple[list, list]:
    """``n`` JPEGs of seeded uniform noise at 256² and quality 85 under
    ``root`` (``root/class<c>/`` for ``classes`` classes of ``n // classes``
    each, else flat with label ``i % 8``): real JPEG bytes, so decode costs
    what it costs. Returns (paths, labels)."""
    from distributed_training_tpu_torch.data.imagefolder import pillow

    Image = pillow()
    rng = np.random.RandomState(0)
    paths, labels = [], []
    per_class = n // classes if classes else n
    for c in range(classes or 1):
        d = os.path.join(root, f"class{c}") if classes else root
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.randint(0, 255, (256, 256, 3), dtype=np.uint8)
            path = os.path.join(d, f"im{i}.jpg")
            Image.fromarray(arr).save(path, quality=85)
            paths.append(path)
            labels.append(c if classes else i % 8)
    return paths, labels


def _timed_epoch(loader) -> float:
    """A warm epoch (threads, page cache), then images/s of a timed one."""
    loader.set_epoch(0)
    for _ in loader:
        pass
    loader.set_epoch(1)
    t0 = time.perf_counter()
    n = 0
    for b in loader:
        n += len(b["label"])
    return n / (time.perf_counter() - t0)


def bench_data_only(args) -> tuple[dict, None]:
    """The host input pipeline's images/s, as the root bench's
    ``bench_data_only`` measures it: ``imagefolder`` (JPEG decode, resize,
    crop and flip on ``--data-workers`` threads), ``cached`` (the decoded
    cache, built once and timed apart), ``augment`` (4096 in-memory uint8
    32² images through the pad-crop-flip augment and the float
    conversion), or ``both`` (all three). A warm epoch, then a timed one.
    The primary value is the rate the device would be fed in steady state:
    the cached path when it ran, else live decode, else augment; the
    others are extras. Host only: no device is touched."""
    from distributed_training_tpu_torch.data.pipeline import ShardedDataLoader

    batch = args.data_batch_size
    folder_rate = cached_rate = augment_rate = None
    root = cleanup = None
    try:
        if args.data_mode in ("imagefolder", "cached", "both"):
            from distributed_training_tpu_torch.data.decoded_cache import (
                DecodedCacheLoader,
                build_decoded_cache,
            )
            from distributed_training_tpu_torch.data.imagefolder import (
                ImageFolderLoader,
                scan_imagefolder,
            )

            if args.data_path:
                if not os.path.isdir(args.data_path):
                    raise SystemExit(f"--data-path {args.data_path} does not exist; omit it "
                                     f"to bench a generated JPEG tree")
                root = args.data_path
            else:
                root = cleanup = tempfile.mkdtemp(prefix="bench_imagefolder_")
                _jpeg_tree(os.path.join(root, "train"), args.data_images, 8)
            paths, labels, _ = scan_imagefolder(os.path.join(root, "train"))
            if args.data_mode != "cached":
                folder_rate = _timed_epoch(ImageFolderLoader(
                    paths, labels, global_batch_size=batch, image_size=args.image_size,
                    augment="pad_crop_flip", train=True, num_workers=args.data_workers))
            if args.data_mode in ("cached", "both"):
                cache = os.path.join(root, ".decoded_cache", f"train_{args.image_size}")
                t0 = time.perf_counter()
                build_decoded_cache(paths, labels, cache, image_size=args.image_size,
                                    num_workers=args.data_workers)
                print(json.dumps({"note": "decoded-cache one-time build", "images": len(paths),
                                  "seconds": round(time.perf_counter() - t0, 1)}),
                      file=sys.stderr)
                cached_rate = _timed_epoch(DecodedCacheLoader(
                    cache, global_batch_size=batch, augment="pad_crop_flip", train=True))
        if args.data_mode in ("augment", "both"):
            rng = np.random.RandomState(0)
            images = rng.randint(0, 256, (4096, 32, 32, 3), dtype=np.uint8)
            labels = rng.randint(0, 10, 4096).astype(np.int32)
            augment_rate = _timed_epoch(ShardedDataLoader(
                images, labels, global_batch_size=batch, augment="pad_crop_flip",
                train=True))
    finally:
        if cleanup:
            shutil.rmtree(cleanup, ignore_errors=True)
    primary = next(r for r in (cached_rate, folder_rate, augment_rate) if r is not None)
    extras = {}
    for key, rate in (("cached_images_per_sec", cached_rate),
                      ("jpeg_decode_images_per_sec", folder_rate),
                      ("augment_images_per_sec", augment_rate)):
        if rate is not None and rate is not primary:
            extras[key] = round(rate, 1)
    result = {
        "metric": f"host input pipeline ({args.data_mode}; {os.cpu_count()} core(s), "
                  f"{args.data_workers} threads, batch {batch})",
        "value": round(primary, 2),
        "unit": "images/sec (host)",
        "vs_baseline": None,
        **extras,
    }
    print(json.dumps(result), flush=True)
    return result, None


def bench_data_concurrent(args, device: torch.device) -> tuple[dict, float]:
    """The input pipeline while training runs, as the root bench's
    ``bench_data_concurrent`` measures it: ``--model`` (8 classes, the
    image leg's bf16 SGD step, no accumulation) trained end to end on
    decoded-cache batches (``--data-workers`` assembly threads, the device
    prefetcher at depth 2) from ``--data-images`` JPEGs at 256², while
    with ``--data-stress`` a second loader over the same cache assembles
    batches flat out on a thread. ``value`` is the train images/s,
    ``spare_host_images_per_sec`` what the second loader sustained
    meanwhile: the host's headroom to feed more."""
    from distributed_training_tpu_torch.data.decoded_cache import (
        DecodedCacheLoader,
        build_decoded_cache,
    )
    from distributed_training_tpu_torch.data.prefetch import prefetch_to_device
    from distributed_training_tpu_torch.runtime.distributed import process_group

    group = process_group()
    world = _world(group)
    rank = torch.distributed.get_rank(group) if group is not None else 0
    batch = args.batch_size * world  # the global batch, each rank its rows
    # A batch larger than the data would make every epoch empty (drop_last).
    if args.data_images < 2 * batch:
        if rank == 0:
            print(f"bench: --data-images {args.data_images} < 2x the batch; raising to "
                  f"{2 * batch}", file=sys.stderr)
        args.data_images = 2 * batch
    # Rank 0 writes the JPEGs and the decoded cache; the others wait for it.
    root = [tempfile.mkdtemp(prefix="bench_concurrent_") if rank == 0 else None]
    try:
        cache = os.path.join(root[0], f"cache_{args.image_size}") if rank == 0 else None
        if rank == 0:
            paths, labels = _jpeg_tree(root[0], args.data_images, None)
            build_decoded_cache(paths, labels, cache, image_size=args.image_size,
                                num_workers=args.data_workers)
        if group is not None:
            root.append(cache)
            torch.distributed.broadcast_object_list(root, src=0, group=group)
            cache = root[1]
        args.grad_accum = 1
        _, state, step = image_train(args, device, 8, group)

        def loader():
            return DecodedCacheLoader(cache, global_batch_size=batch, augment="pad_crop_flip",
                                      train=True, num_workers=args.data_workers,
                                      process_index=rank, process_count=world)

        def epochs():
            ld, epoch = loader(), 0
            while True:
                ld.set_epoch(epoch)
                yield from ld
                epoch += 1

        stress_count = [0]
        stop = threading.Event()

        def stress():
            ld, epoch = loader(), 100
            while not stop.is_set():
                ld.set_epoch(epoch)
                for b in ld:
                    stress_count[0] += len(b["label"])
                    if stop.is_set():
                        return
                epoch += 1

        it = iter(prefetch_to_device(epochs(), device, 2))
        try:
            for _ in range(args.warmup):
                metrics = step(state, next(it))
            if args.warmup:
                float(metrics["loss"])
            worker = threading.Thread(target=stress, name="bench-stress", daemon=True)
            stressed = args.data_stress and rank == 0  # rank 0's host alone
            t0 = time.perf_counter()
            if stressed:
                worker.start()
            for i in range(args.steps):
                metrics = step(state, next(it))
                if args.sync_interval > 0 and (i + 1) % args.sync_interval == 0:
                    float(metrics["loss"])
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            stop.set()
            if stressed:
                worker.join(timeout=60)
        finally:
            stop.set()
            it.close()
    finally:
        if group is not None:  # every rank is done with the cache
            torch.distributed.barrier(group=group)
        if rank == 0:
            shutil.rmtree(root[0], ignore_errors=True)
    img_s = args.steps * args.batch_size / dt
    result = {
        "metric": f"{args.model} end-to-end train on decoded cache (real batches, "
                  f"{args.data_workers} workers, prefetch 2, batch {args.batch_size}/chip, "
                  f"{_where(device, world)})"
                  + (f" + concurrent stress loader{' on rank 0' if world > 1 else ''}"
                     if args.data_stress else ""),
        "value": round(img_s, 2),
        "unit": "images/sec/chip",
        "vs_baseline": None,
    }
    if stressed:
        result["spare_host_images_per_sec"] = round(stress_count[0] / dt, 1)
    if rank == 0:
        print(json.dumps(result), flush=True)
    return result, loss


def build_parser() -> argparse.ArgumentParser:
    """The root bench's parser (names and defaults), and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch-size", type=int, default=512,
                    help="per-chip EFFECTIVE batch size")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--zero-stage", type=int, default=0, choices=[0, 1, 2, 3],
                    help="ZeRO stage of the benched step (over the launcher's ranks)")
    ap.add_argument("--cpu-offload", action="store_true", default=False,
                    help="optimizer state in pinned host memory "
                         "(requires --zero-stage >= 1)")
    ap.add_argument("--remat", action="store_true", default=False)
    ap.add_argument("--remat-policy", default=None, choices=[None, "conv"])
    ap.add_argument("--param-dtype", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--input-dtype", default="fp32", choices=["fp32", "bf16", "uint8"],
                    help="batch image dtype (uint8 maps to float on the card)")
    ap.add_argument("--grad-accum", type=int, default=2,
                    help="microbatches a step (batch-size is the effective batch)")
    ap.add_argument("--steps-per-call", type=int, default=15,
                    help="N train steps a call: one CUDA graph of N steps on the "
                         "card, N steps in a loop on the CPU (the LM leg: on the "
                         "card only); see the module docstring")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=45)
    ap.add_argument("--sync-interval", type=int, default=15,
                    help="read the loss on the host every N steps (the barrier)")
    ap.add_argument("--data-only", action="store_true", default=False)
    ap.add_argument("--data-stress", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--data-concurrent", action="store_true", default=False)
    ap.add_argument("--data-mode", default="both",
                    choices=["imagefolder", "cached", "augment", "both"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--data-images", type=int, default=2048)
    ap.add_argument("--data-workers", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--data-batch-size", type=int, default=256)
    ap.add_argument("--lm", action="store_true", default=False,
                    help="bench ONLY the GPT-2-small LM step; a bare run "
                         "emits the image leg then the LM leg")
    ap.add_argument("--image", action="store_true", default=False,
                    help="bench ONLY the image step")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--tp-overlap", action="store_true", default=False)
    ap.add_argument("--lm-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--attn-impl", default="flash", choices=["flash", "exact"])
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--ce-save-probs", action="store_true", default=False)
    ap.add_argument("--logits-dtype", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--head-bias", action=argparse.BooleanOptionalAction, default=False)
    ap.add_argument("--no-accuracy", action="store_true", default=False)
    ap.add_argument("--lm-optimizer", default="adamw", choices=["adamw", "hybrid_adam"],
                    help="hybrid_adam: the fused-Adam kernel K1")
    ap.add_argument("--check", action="store_true", default=False)
    return ap


def unported(args) -> list[str]:
    """The flags set to something the port cannot honour yet."""
    flags = {
        "--check (BENCH_BASELINE.json holds a TPU's numbers)": args.check,
    }
    return [k for k, v in flags.items() if v]


def main(argv: list[str] | None = None) -> list[tuple[dict, float]]:
    """Run the legs ``argv`` asks for; print each JSON line, and return
    each leg's ``(dict, last loss)``."""
    args = build_parser().parse_args(argv)
    bad = unported(args)
    if bad:
        raise NotImplementedError(f"not ported yet (see ROADMAP.md): {', '.join(bad)}")
    if args.data_only:  # the host alone
        return [bench_data_only(args)]
    from distributed_training_tpu_torch.runtime.distributed import (
        initialize_distributed,
        local_device,
    )
    from distributed_training_tpu_torch.utils.device import set_fp32_math

    # Over torchrun's ranks (or the caller's open group): each on its card,
    # before any work; the legs' setups read the group.
    initialize_distributed(device=args.device)
    device = local_device(args.device)
    set_fp32_math()
    legs = ([bench_data_concurrent] if args.data_concurrent
            else [bench_lm] if args.lm else [bench_image] if args.image
            else [bench_image, bench_lm])
    out = []
    for leg in legs:  # each leg gets its own copy of the arguments
        out.append(leg(copy.deepcopy(args), device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
