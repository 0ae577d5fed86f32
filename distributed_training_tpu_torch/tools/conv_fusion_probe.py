"""Probe of the fused conv3×3 + BN-statistics kernel (K5): the port of
``tools/conv_fusion_probe.py``.

    python -m distributed_training_tpu_torch.tools.conv_fusion_probe
    python -m distributed_training_tpu_torch.tools.conv_fusion_probe --shapes s0 s1
    python -m distributed_training_tpu_torch.tools.conv_fusion_probe --verify-only
    python -m distributed_training_tpu_torch.tools.conv_fusion_probe --device cpu

At ResNet-50's 3×3 conv shapes (batch 256, bf16), per shape it first holds
the kernel (``ops/conv3x3_stats.py``) against its plain version and raises
on a mismatch, then times on the card (CUDA events, after three warm-up
calls):

- ``torch_conv_ms``: ``F.conv2d`` in bf16 on the channels-last views of x
  and w (cuDNN), the yardstick of the JAX tool's ``xla_conv``;
- ``torch_conv_stats_ms``: that conv, then the float32 Σ and Σ² over N, H
  and W, the yardstick of ``xla_conv_stats``;
- ``fused_ms``: K5, out and both sums;

and prints one JSON line with the JAX tool's keys under torch names, the
readings of the check and the card. The two yardsticks are timed here and
used nowhere in the port. Without a card it raises, unless ``--device
cpu`` asks for the CPU, where it runs the plain version at N 4 and
verifies only, as the JAX tool's interpret-mode path does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.ops.conv3x3_stats import (
    conv3x3_stats,
    conv3x3_stats_reference,
)
from distributed_training_tpu_torch.utils.device import card_line, cuda_ms, resolve_device

# (label, N, H, W, Cin, Cout): ResNet-50 3×3 conv shapes at batch 256.
SHAPES = {
    "s0": ("stage0 3x3", 256, 56, 56, 64, 64),
    "s1": ("stage1 3x3", 256, 28, 28, 128, 128),
    "s2": ("stage2 3x3", 256, 14, 14, 256, 256),
}
CPU_BATCH = 4
# Kernel vs plain version. out, row by row (a row is one pixel's Cout
# channels): the largest error over the RMS of the plain row, that RMS
# held at least a tenth of the whole tensor's. Both sum the same float32
# products in another order, so an element may round to the neighbouring
# bf16 value, one step of up to 2**-7 of the element: about 0.026 of the
# row's RMS at a 64-channel row's largest element. sum: each channel's
# error over the root-sum-square of its terms (the square root of the
# plain sumsq): the two float32 results differ by roundings of random
# sign, which add up as that root-sum-square, so the reading does not
# depend on N·H·W (over the sum of the terms' magnitudes it fell as
# 1/√(N·H·W): 1e-8 at batch 256, 1e-7 at batch 2). sumsq: each channel's
# error over the sum (its terms are positive; these readings were the
# same at every size). Each limit is about three times the worst reading
# over the probe's shapes at batch 256 and 2 and a 7 × 9 image, three
# seeds each, on an H100 80GB HBM3 at 700 W: out 0.0264, sum 1.76e-6,
# sumsq 5.78e-7 (PERF.md).
OUT_TOL, SUM_TOL, SUMSQ_TOL = 0.08, 5e-6, 2e-6
# out's limit by dtype: bf16's above; float16's a step of 2**-10 of the
# element, 8 times finer (3 more mantissa bits), so OUT_TOL / 8; float32's
# only the other summation order of the same float32 products.
OUT_TOLS = {torch.bfloat16: OUT_TOL, torch.float16: OUT_TOL / 8, torch.float32: 1e-4}


def _row_err(got, want) -> float:
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt()
    floor = 0.1 * want.square().mean().sqrt().clamp_min(1e-30)
    return (err / rms.clamp_min(floor)).max().item()


def check(x, w, bn: int = 1) -> dict:
    """The kernel (on x's device) against its plain version: each reading
    as the comment on ``OUT_TOL`` says, and the largest absolute error of
    out; raises above the limits."""
    got_out, got_s, got_ss = conv3x3_stats(x, w, bn=bn)
    out, s, ss = conv3x3_stats_reference(x, w)
    ss = ss.clamp_min(1e-30)
    errs = {"out_err": _row_err(got_out, out),
            "sum_err": ((got_s - s).abs() / ss.sqrt()).max().item(),
            "sumsq_err": ((got_ss - ss).abs() / ss).max().item(),
            "max_abs_err": (got_out.float() - out.float()).abs().max().item()}
    for key, tol in (("out_err", OUT_TOLS[x.dtype]), ("sum_err", SUM_TOL),
                     ("sumsq_err", SUMSQ_TOL)):
        if not errs[key] <= tol:
            raise AssertionError(f"conv3x3_stats {key} {errs[key]:.3g} above {tol} "
                                 f"at x {tuple(x.shape)} -> {w.shape[-1]}")
    return errs


def inputs(n, h, w, cin, cout, device, seed=0, dtype=torch.bfloat16):
    """x ~ N(0, 1) and w ~ 0.05·N(0, 1) in bf16 (or ``dtype``), as the JAX
    tool makes them (from a torch generator on the device, not numpy's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, h, w, cin), device=device, generator=gen).to(dtype)
    wts = (torch.randn((3, 3, cin, cout), device=device, generator=gen) * 0.05).to(dtype)
    return x, wts


def time_shape(x, w, bn: int, iters: int) -> dict:
    """The two yardsticks and K5, in ms on the card."""
    xc = x.permute(0, 3, 1, 2)  # NCHW view with channels-last strides
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def conv_stats():
        of = F.conv2d(xc, wc, padding=1).float()
        return of.sum((0, 2, 3)), of.square().sum((0, 2, 3))

    conv_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters)
    conv_stats_ms = cuda_ms(conv_stats, iters)
    fused_ms = cuda_ms(lambda: conv3x3_stats(x, w, bn=bn), iters)
    return {"torch_conv_ms": conv_ms, "torch_conv_stats_ms": conv_stats_ms,
            "fused_ms": fused_ms, "fused_vs_conv_stats": conv_stats_ms / fused_ms}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--bn", type=int, default=1,
                    help="batch block of the JAX kernel (validated: must divide N)")
    ap.add_argument("--verify-only", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); 'cpu' "
                         "verifies the plain version at N 4")
    return ap


def main(argv=None) -> list[dict]:
    """Run the probe; the per-shape results (none on the CPU or with
    ``--verify-only``)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    card = card_line() if on_card else None
    results = []
    for key in args.shapes:
        label, n, h, w, cin, cout = SHAPES[key]
        n = n if on_card else CPU_BATCH
        x, wts = inputs(n, h, w, cin, cout, device)
        errs = check(x, wts, args.bn)
        print(f"verify {key}: ok " + " ".join(f"{k}={v:.3g}" for k, v in errs.items()),
              file=sys.stderr)
        if args.verify_only or not on_card:
            continue
        results.append({"shape": f"{label} [{n},{h},{w},{cin}]->{cout}",
                        **time_shape(x, wts, args.bn, args.iters), **errs,
                        "card": card})
        print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    main()
