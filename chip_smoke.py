"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel in ``distributed_training_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel);
3. kernel phase: the fused-Adam kernel against its plain PyTorch version
   on all 62 ResNet-18 parameter shapes for 3 steps, and its time beside
   the plain version's, ``torch.optim.Adam(fused=True)``'s (a yardstick
   only; the port never calls it) and the least time the card could take;
4. train phase: ``Trainer.fit()`` on full-width ResNet-18, batch 100, 20
   steps of ``hybrid_adam`` in fp32, then eval; the loss must be finite
   and fall, and every optimizer step must have gone through the kernel;
   the trained model's logits on the card must match the same model's on
   the CPU;
5. fp16 phase: a few ``torch_ddp_fp16`` steps through the dynamic loss
   scale and its guarded, out-of-place update;
6. a ``{"kernels": [...]}`` line, then the card line, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores
# (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Per element of fused Adam: read p, g, m, v, write p, m, v (float32); and
# 12 float32 operations (3 for m, 4 for v, 5 for p).
ADAM_BYTES, ADAM_FLOPS = 28, 12
# Kernel vs plain version: both round each float32 operation in the same
# order, so they should agree exactly; this is the stated tolerance.
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int, ahead: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after warm-up).

    With ``ahead``, the card first spins for ~0.2 s so that the host
    queues the launches before the first one runs: the events then time
    the device's work, not the host's enqueueing. Without it, the launches
    run as the host issues them (what a caller waiting on each call sees).
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase() -> dict:
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.ops.fused_adam import (
        fused_adam_reference,
        fused_adam_update,
    )

    dev = torch.device("cuda")
    model = get_model("resnet18").to(dev)
    shapes = [p for p in model.parameters()]
    assert len(shapes) == 62, len(shapes)
    n = sum(p.numel() for p in shapes)
    gen = torch.Generator(device=dev).manual_seed(0)
    ps = [torch.randn(p.shape, device=dev, generator=gen).to(
        memory_format=torch.channels_last if p.dim() == 4 else torch.contiguous_format)
        for p in shapes]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    ref = [(p.clone(), m.clone(), v.clone()) for p, m, v in zip(ps, ms, vs)]
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    for step in range(1, 4):
        fused_adam_update(ps, gs, ms, vs, lr=lr, step=step, b1=b1, b2=b2, eps=eps)
        ref = [fused_adam_reference(p, g, m, v, lr, step, b1, b2, eps)
               for (p, m, v), g in zip(ref, gs)]
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for got, want in zip(zip(ps, ms, vs), ref):
        for a, b in zip(got, want):
            d = (a - b).abs()
            max_abs = max(max_abs, d.max().item())
            max_rel = max(max_rel, (d / b.abs().clamp_min(1e-30)).max().item())
            torch.testing.assert_close(a, b, rtol=ADAM_RTOL, atol=ADAM_ATOL)
    print(f"[kernel] fused_adam vs plain on 62 ResNet-18 tensors ({n:,} params), "
          f"3 steps: max_abs_err={max_abs:.3g} max_rel_err={max_rel:.3g} "
          f"(tolerance rtol {ADAM_RTOL} atol {ADAM_ATOL})")

    adam = lambda: fused_adam_update(  # noqa: E731
        ps, gs, ms, vs, lr=lr, step=4, b1=b1, b2=b2, eps=eps)
    kernel_ms = cuda_ms(adam, 50)
    call_ms = cuda_ms(adam, 50, ahead=False)

    def plain():
        for p, g, m, v in zip(ps, gs, ms, vs):
            fused_adam_reference(p, g, m, v, lr, 4, b1, b2, eps)
    plain_ms = cuda_ms(plain, 20)

    lib_params = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(lib_params, gs):
        p.grad = g
    lib = torch.optim.Adam(lib_params, lr=lr, betas=(b1, b2), eps=eps, fused=True)
    library_ms = cuda_ms(lib.step, 50)

    bound_by_bytes = ADAM_BYTES * n / HBM_BYTES_PER_S * 1e3
    bound_by_ops = ADAM_FLOPS * n / FP32_FLOPS * 1e3
    bound_ms = max(bound_by_bytes, bound_by_ops)
    print(f"[kernel] fused_adam wrapper call back to back (host-bound): "
          f"{call_ms:.4f} ms")
    print(f"[kernel] fused_adam ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({ADAM_BYTES * n / 1e6:.1f} MB at 3.35 TB/s) "
          f"achieved {ADAM_BYTES * n / kernel_ms / 1e9:.3f} TB/s")
    return {"max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_by_bytes >= bound_by_ops else "operations"}


def _timed_train_epochs(trainer) -> list[float]:
    """Wrap ``trainer.train_epoch`` to record its synchronised wall time."""
    times = []
    inner = trainer.train_epoch

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    trainer.train_epoch = timed
    return times


def train_phase(ckpt_dir: str) -> int:
    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    steps = 20
    cfg = TrainConfig.from_plugin(
        "torch_ddp", model="resnet18", num_epochs=1, log_interval=5,
        optimizer=OptimizerConfig(name="hybrid_adam", scale_lr_by_world=True),
        data=DataConfig(dataset="synthetic_cifar", batch_size=100,
                        max_steps_per_epoch=steps),
        checkpoint=CheckpointConfig(directory=ckpt_dir))
    trainer = Trainer(cfg)
    times = _timed_train_epochs(trainer)
    fused_adam_update.launches = 0
    out = trainer.fit()
    launches = fused_adam_update.launches
    hist = trainer.meter.history
    losses = [h["loss"] for h in hist]
    print(f"[train] fit -> {out}")
    print(f"[train] logged losses {losses}; {steps} steps in {times[0]:.3f} s: "
          f"{steps / times[0]:.3f} steps/s, {steps * 100 / times[0]:.1f} images/s "
          f"(first step's cuDNN planning included)")
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise SystemExit(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not fall: {losses}")
    if out["steps"] != steps:
        raise SystemExit(f"expected {steps} committed steps, got {out['steps']}")
    if launches != steps or launches == 0:
        raise SystemExit(f"fused_adam launches {launches} != {steps} steps x 1")
    if not 0.0 <= out["final_acc"] <= 1.0:
        raise SystemExit(f"bad accuracy {out['final_acc']}")

    # The trained model on the card against the same weights on the CPU.
    import copy

    model = trainer.model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x.cuda()).cpu()
        want = cpu_model(x)
    assert got.shape == (4, 10) and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    print(f"[train] eval logits card vs CPU: max_abs_err={err:.3g} (tolerance 1e-3)")
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    steady_state(trainer)
    return launches


def steady_state(trainer, steps: int = 10) -> None:
    """Time train steps after warm-up on batches already on the card, and
    profile three of them: where the device time goes, and how much of
    the step the device is busy."""
    from distributed_training_tpu_torch.data.pipeline import to_device

    loader, _ = trainer.make_loaders()
    batches = [to_device(b, trainer.device) for _, b in zip(range(steps), loader)]
    for b in batches[:2]:
        trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    bs = batches[0]["label"].shape[0]
    print(f"[steady] {ms:.3f} ms/step, {1e3 / ms:.3f} steps/s, "
          f"{bs * 1e3 / ms:.1f} images/s (batches on the card, after warm-up)")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[:3]:
            trainer.train_step(trainer.state, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] 3 steps: wall {wall_us / 1e3:.3f} ms (profiled), device busy "
          f"{busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}% of wall")
    for dev_us, key, count in rows[:12]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def fp16_phase(ckpt_dir: str) -> None:
    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    steps = 5
    cfg = TrainConfig.from_plugin(
        "torch_ddp_fp16", model="resnet18", num_epochs=1, log_interval=1,
        eval_every=0,
        optimizer=OptimizerConfig(name="hybrid_adam", scale_lr_by_world=True),
        data=DataConfig(dataset="synthetic_cifar", batch_size=100,
                        max_steps_per_epoch=steps),
        checkpoint=CheckpointConfig(directory=ckpt_dir))
    trainer = Trainer(cfg)
    fused_adam_update.launches = 0
    out = trainer.fit()
    hist = trainer.meter.history
    print(f"[fp16] fit -> {out}")
    print(f"[fp16] per step (loss, loss_scale, committed): "
          f"{[(h['loss'], h['loss_scale'], h['grads_finite']) for h in hist]}")
    if fused_adam_update.launches != steps:
        raise SystemExit(f"fp16 fused_adam launches {fused_adam_update.launches} "
                         f"!= {steps} steps (each builds a candidate)")
    committed = sum(h["grads_finite"] for h in hist)
    if out["steps"] != committed or committed == 0:
        raise SystemExit(f"committed steps {out['steps']} vs flags {committed}")
    if not all(h["loss"] == h["loss"] for h in hist):
        raise SystemExit("non-finite fp16 loss")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from distributed_training_tpu_torch.ops import cuda_build

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"[build] {cuda_build.kernel_names()} built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in cuda_build.build_logs.items():
        print(f"[build] {name}: {' | '.join(log.strip().splitlines())}")

    k = kernel_phase()
    with tempfile.TemporaryDirectory() as ckpt:
        launches = train_phase(os.path.join(ckpt, "fp32"))
        fp16_phase(os.path.join(ckpt, "fp16"))

    kernels = [{
        "name": "fused_adam", "route": "cuda",
        "source": "distributed_training_tpu_torch/csrc/fused_adam.cu",
        "replaces": "distributed_training_tpu/ops/fused_adam.py:40",
        "launches": launches, **k,
        "ok": True,  # every check above raises before this line when it fails
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
