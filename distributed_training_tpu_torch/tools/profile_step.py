"""Per-op profile of the port bench's train step, kernels grouped by category.

The port of the repo's ``tools/profile_step.py`` (which traces the JAX
step with ``jax.profiler`` and reads XLA's categories). This one runs the
step of ``python -m distributed_training_tpu_torch.bench`` (the image leg,
or with ``--lm`` the GPT-2-small leg) under ``torch.profiler`` and writes
one JSON artifact with the JAX tool's keys: ``label``, ``trace_steps``,
``device``, ``num_steps``, ``step_time_ms``, ``op_time_ms_per_step``,
``categories`` and ``top_ops``.

- ``step_time_ms``: host wall time of the traced steps (each ends in a
  synchronise) over their count; ``op_time_ms_per_step``: the device
  events' time (kernels, copies, memsets) a step, so their ratio is the
  card's busy share.
- ``categories``: device time by kernel category (:data:`CATEGORIES`, by
  the kernel's name), each with ``time_ps`` and ``occurrences``;
  ``top_ops``: the kernels by device time. The profiler gives no FLOPs or
  bytes a kernel, so ``flops`` and ``bytes`` are null (JAX's come from
  XLA's cost model).
- ``device``: the card's name and power limit as ``nvidia-smi`` prints
  them, and the published H100 peaks the tables divide by.

    python -m distributed_training_tpu_torch.tools.profile_step --model resnet50 \\
        --batch-size 256 --out profiles/torch_r50_b256
    python -m distributed_training_tpu_torch.tools.profile_step --lm --seq-len 1024 \\
        --batch-size 16 --out profiles/torch_gpt_t1024
    python -m distributed_training_tpu_torch.tools.profile_step --summarize \\
        profiles/torch_r50_b256.json

It runs on the card unless ``--device cpu`` asks for the CPU, where the
rows are the CPU's operators and the artifact says ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

# Kernel categories, first match wins (a kernel's name is all the profiler
# gives). The port's own kernels first, then the libraries' families.
CATEGORIES = (
    ("flash attention (K2-K4)", r"flash_|fwd_kernel|bwd_kernel|dq_kernel"),
    ("fused adam (K1)", r"fused_adam|adam_kernel"),
    ("conv3x3+stats (K5)", r"conv3x3|conv_kernel"),
    ("batchnorm", r"batch_norm|bn_fw|bn_bw|batchnorm"),
    ("convolution", r"conv|cudnn|implicit_convolve|wgrad|dgrad|fprop|winograd"),
    ("matmul", r"gemm|cutlass|sm90_xmma|cublas|ampere_.*(s|h)\d+|nvjet"),
    ("softmax / cross-entropy", r"softmax|cross_entropy|nll_loss|log_softmax"),
    ("reduction", r"reduce|norm_kernel|sum_kernel|argmax|max_kernel"),
    ("copy / memset", r"memcpy|memset|copy|cat_|CatArray"),
    ("gather / scatter / index", r"index|gather|scatter|embedding"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise|foreach"),
)
# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W).
PEAK_BF16_TFLOPS = 989.0
PEAK_HBM_GBPS = 3350.0


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return cat
    return "other"


def aggregate(rows: list, num_steps: int, top: int) -> dict:
    """``rows`` of ``(name, time_us, count)`` (device events, or the CPU's
    operators on the CPU) into the artifact's ``op_time_ms_per_step``,
    ``categories`` and ``top_ops``."""
    cats: dict[str, dict] = {}
    ops: dict[str, dict] = {}
    for name, us, count in rows:
        cat = category(name)
        ps = int(round(us * 1e6))
        c = cats.setdefault(cat, {"time_ps": 0, "flops": None, "bytes": None,
                                  "occurrences": 0})
        c["time_ps"] += ps
        c["occurrences"] += count
        o = ops.setdefault(name, {"category": cat, "time_ps": 0, "flops": None,
                                  "bytes": None, "occurrences": 0, "source_op": ""})
        o["time_ps"] += ps
        o["occurrences"] += count
    total_ps = sum(c["time_ps"] for c in cats.values())
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1]["time_ps"])[:top]
    return {
        "op_time_ms_per_step": total_ps / num_steps / 1e9 if num_steps else None,
        "categories": dict(sorted(cats.items(), key=lambda kv: -kv[1]["time_ps"])),
        "top_ops": [{"name": k, **v} for k, v in top_ops],
    }


def profiler_rows(prof, device_type: str) -> list:
    """``(name, self µs, count)`` of the profile's events on the card (or of
    the CPU's operators), self time only, so nothing counts twice."""
    import torch

    want = (torch.autograd.DeviceType.CUDA if device_type == "cuda"
            else torch.autograd.DeviceType.CPU)
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != want:
            continue
        if device_type == "cuda":
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
        else:
            us = e.self_cpu_time_total
        if us > 0:
            rows.append((e.key, float(us), int(e.count)))
    return rows


def build_step(args, device):
    """The bench's ``(step, state, batch, label)`` for the flags."""
    from distributed_training_tpu_torch import bench

    if args.lm:
        b = bench.build_parser().parse_args([
            "--lm", "--lm-batch", str(args.batch_size), "--seq-len", str(args.seq_len),
            "--attn-impl", args.attn_impl, "--logits-dtype", args.logits_dtype,
            *(["--ce-chunk", str(args.ce_chunk)] if args.ce_chunk else []),
            *(["--no-accuracy"] if args.no_accuracy else []),
            "--head-bias" if args.head_bias else "--no-head-bias"])
        b.device = str(device)
        _, state, step, batch = bench.lm_step(b, device)
        label = f"gpt2s_T{args.seq_len}_B{args.batch_size}_{args.attn_impl}"
    else:
        # JAX's profile builds the bench's step without accumulation.
        b = bench.build_parser().parse_args([
            "--model", args.model, "--batch-size", str(args.batch_size),
            "--image-size", str(args.image_size), "--num-classes", str(args.num_classes),
            "--zero-stage", str(args.zero_stage), "--param-dtype", args.param_dtype,
            "--grad-accum", "1", *(["--remat"] if args.remat else []),
            *(["--remat-policy", args.remat_policy] if args.remat_policy else [])])
        _, state, step, batch = bench.image_step(b, device)
        label = f"{args.model}_b{args.batch_size}"
    return step, state, batch, label


def capture(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch.utils.device import (
        card_line,
        resolve_device,
        set_fp32_math,
    )

    device = resolve_device(args.device)
    set_fp32_math()
    step, state, batch, label = build_step(args, device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(args.warmup):
        metrics = step(state, batch)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.trace_steps):
            metrics = step(state, batch)
        float(metrics["loss"])
        sync()
        wall_s = time.perf_counter() - t0
    rows = profiler_rows(prof, device.type)
    artifact = {
        "label": label, "trace_steps": args.trace_steps,
        "device": ({"type": torch.cuda.get_device_name(device), "card": card_line(),
                    "peak_tflops": PEAK_BF16_TFLOPS, "peak_hbm_gbps": PEAK_HBM_GBPS}
                   if cuda else {"type": "cpu", "card": None, "peak_tflops": None,
                                 "peak_hbm_gbps": None}),
        "num_steps": args.trace_steps,
        "step_time_ms": wall_s * 1e3 / args.trace_steps,
        **aggregate(rows, args.trace_steps, args.top),
        "loss": float(metrics["loss"]),
    }
    if not rows:
        artifact["error"] = f"the profiler recorded no {device.type} events"
    trace_dir = args.out + "_trace"
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(f"[profile] wrote {args.out}.json (trace in {trace_dir})", file=sys.stderr)
    return artifact


def summarize(path: str, top: int) -> None:
    """Print the category and top-kernel tables of a saved artifact."""
    with open(path) as fh:
        a = json.load(fh)
    if "categories" not in a:
        print(f"no parsed profile in {path}: {a.get('error')}")
        return
    n = a["num_steps"] or 1
    fmt = lambda v: f"{v:.2f} ms" if v is not None else "n/a"  # noqa: E731
    dev = a["device"]
    print(f"\n{a['label']}: {a['num_steps']} steps traced, step {fmt(a.get('step_time_ms'))} "
          f"(device busy {fmt(a.get('op_time_ms_per_step'))}); device {dev['type']}"
          + (f" ({dev['card']}), peaks {dev['peak_tflops']} TFLOP/s bf16 / "
             f"{dev['peak_hbm_gbps']} GB/s HBM" if dev.get("card") else ""))
    print("\n| category | ms/step | % | n |")
    print("|---|---|---|---|")
    total = sum(c["time_ps"] for c in a["categories"].values()) or 1
    for cat, c in a["categories"].items():
        print(f"| {cat} | {c['time_ps'] / n / 1e9:.2f} | {100 * c['time_ps'] / total:.1f} "
              f"| {c['occurrences']} |")
    print(f"\ntop {top} kernels by device time:")
    print("| kernel | category | ms/step | n |")
    print("|---|---|---|---|")
    for o in a["top_ops"][:top]:
        print(f"| {o['name'][:60]} | {o['category']} | {o['time_ps'] / n / 1e9:.2f} "
              f"| {o['occurrences']} |")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.tools.profile_step",
        description="per-kernel profile of the port bench's train step")
    ap.add_argument("--device", default="cuda",
                    help="cpu for the CPU; default the card (without one this fails)")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--zero-stage", type=int, default=0)
    ap.add_argument("--remat", action="store_true", default=False)
    ap.add_argument("--remat-policy", default=None, choices=[None, "conv"])
    ap.add_argument("--param-dtype", default="fp32", choices=["fp32", "bf16"])
    ap.add_argument("--lm", action="store_true", default=False,
                    help="profile the GPT-2-small LM step instead")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--attn-impl", default="flash", choices=["flash", "exact"])
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--no-accuracy", action="store_true", default=False)
    ap.add_argument("--head-bias", action=argparse.BooleanOptionalAction, default=False)
    ap.add_argument("--logits-dtype", default="bf16", choices=["fp32", "bf16"])
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--trace-steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None,
                    help="artifact prefix (writes <out>.json and <out>_trace/); "
                         "required unless --summarize")
    ap.add_argument("--summarize", default=None,
                    help="print the tables of an existing artifact")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.summarize:
        summarize(args.summarize, args.top)
        return 0
    if not args.out:
        raise SystemExit("--out is required to capture a profile")
    capture(args)
    summarize(args.out + ".json", args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
