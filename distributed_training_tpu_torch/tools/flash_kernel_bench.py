"""Flash-attention kernel bench and on-card correctness check: the port of
``tools/flash_kernel_bench.py``.

    python -m distributed_training_tpu_torch.tools.flash_kernel_bench
    python -m distributed_training_tpu_torch.tools.flash_kernel_bench --shapes gpt --no-verify
    python -m distributed_training_tpu_torch.tools.flash_kernel_bench --split-bwd --iters 5
    python -m distributed_training_tpu_torch.tools.flash_kernel_bench --exp2
    python -m distributed_training_tpu_torch.tools.flash_kernel_bench --device cpu

First it verifies the forward and the gradients of the public
``flash_attention`` against the tool's own exact attention at ``[4, 512,
64]`` bf16 causal, once, at the JAX tool's tolerances; a failure raises.
(The JAX tool verifies twice, with the requested blocks and with 128×128
blocks, because those are two Pallas tilings; here both would run the same
64×64 kernels on the same inputs.) Then, on the card, it times
one forward and backward through autograd at each shape (CUDA events, after
three warm-up calls) and prints one JSON line per shape. ``--split-bwd``
and ``--exp2`` set the flash module's ``_USE_SPLIT_BWD`` and ``_USE_EXP2``
for the run, as the JAX tool sets its own. Without a card it raises, unless
``--device cpu`` asks for the CPU, where it verifies the plain versions and
times nothing.

``--blocks`` and ``--bwd-blocks`` take the JAX tool's ``QxK`` form and are
validated by the JAX block rule (``_block``) against every sequence length
the run uses, as the JAX tool's calls validate them. The CUDA kernels tile
64×64 whatever they say; the JSON line prints what was asked, and the
kernels' own tiles beside it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from distributed_training_tpu_torch.ops import flash_attention as fa
from distributed_training_tpu_torch.utils.device import card_line, cuda_ms, resolve_device

# (label, bh, t, d): bh = batch·heads flattened, the JAX tool's shapes.
SHAPES = {
    "gpt": ("B16 H12 T1024 D64", 192, 1024, 64),
    "t4096": ("B4 H8 T4096 D64", 32, 4096, 64),
    "t16k": ("B2 H12 T16384 D64", 24, 16384, 64),
    "gpt_d128": ("B16 H6 T1024 D128 (iso-FLOP probe)", 96, 1024, 128),
    "gpt_d32": ("B16 H24 T1024 D32 (iso-FLOP probe)", 384, 1024, 32),
}
VERIFY_T = 512


def exact_attention(q, k, v, causal=True):
    """The JAX tool's oracle: scores in the input dtype, float32 softmax,
    p cast to v's dtype."""
    s = torch.einsum("...qd,...kd->...qk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        t = q.shape[-2]
        s = s.masked_fill(torch.ones((t, t), dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    p = torch.softmax(s.float(), -1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


def _out_and_grads(fn, q, k, v):
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*xs)
    (out.float() ** 2).sum().backward()
    return out.detach(), [x.grad for x in xs]


def _assert_close(got, want, atol, rtol, what):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=atol, rtol=rtol, err_msg=what)


def verify(flash_kwargs: dict, device: torch.device) -> None:
    """Forward and gradients against :func:`exact_attention`, with the
    requested blocks (validated; the kernels tile 64×64 whatever they
    say); raises on a mismatch."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(4, VERIFY_T, 64)).to(device, torch.bfloat16)
               for _ in range(3))
    ref_out, ref_g = _out_and_grads(exact_attention, q, k, v)
    out, g = _out_and_grads(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True, **flash_kwargs), q, k, v)
    _assert_close(out, ref_out, 2e-2, 2e-2, "out")
    for name, a, b in zip("qkv", g, ref_g):
        _assert_close(a, b, 2e-1, 5e-2, f"d{name}")
    print(f"verify: fwd+bwd on {device} matches exact attention", file=sys.stderr)


def bench_shape(label, bh, t, d, flash_kwargs, iters, card, device) -> dict:
    """ms of one forward and backward through autograd, bf16 causal, on the
    card."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((bh, t, d), device=device, generator=gen)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))

    def fwd_bwd():
        loss = fa.flash_attention(q, k, v, causal=True, **flash_kwargs).float().sum()
        return torch.autograd.grad(loss, (q, k, v))

    ms = cuda_ms(fwd_bwd, iters)
    # The JAX tool's count, kept for comparability: causal, ~0.5 of 2
    # forward and 5 backward products of 2·d operations a (q, k) pair.
    flops = 0.5 * (2 + 5) * 2 * bh * t * t * d
    return {"shape": label, "ms": ms, "tflops_per_sec": flops / (ms / 1e3) / 1e12,
            "blocks": flash_kwargs or "auto", "kernel_tiles": "64x64",
            "backward": "split" if fa._USE_SPLIT_BWD else "fused",
            "exp2": fa._USE_EXP2, "card": card}


def _blocks(text: str) -> tuple[int, int]:
    try:
        bq, bk = (int(x) for x in text.split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"blocks must be QxK, got {text!r}") from None
    if bq < 1 or bk < 1:
        raise argparse.ArgumentTypeError(f"blocks must be positive, got {text!r}")
    return bq, bk


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--blocks", type=_blocks, default=None,
                    help="fwd blocks as QxK (e.g. 1024x2048); default auto")
    ap.add_argument("--bwd-blocks", type=_blocks, default=None,
                    help="bwd blocks as QxK (e.g. 512x1024); default auto")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--split-bwd", action="store_true",
                    help="run the two-kernel backward (K4) instead of the fused one")
    ap.add_argument("--exp2", action="store_true",
                    help="softmax exponentials as 2**x with log2(e) folded "
                         "into the score scale")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); 'cpu' "
                         "verifies the plain versions and times nothing")
    return ap


def main(argv=None) -> list[dict]:
    """Run the bench; the per-shape results (none on the CPU)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    kwargs = {}
    if args.blocks:
        kwargs.update(block_q=args.blocks[0], block_k=args.blocks[1])
    if args.bwd_blocks:
        kwargs.update(bwd_block_q=args.bwd_blocks[0], bwd_block_k=args.bwd_blocks[1])
    for t in {VERIFY_T, *(SHAPES[s][2] for s in args.shapes)}:
        for b in kwargs.values():
            fa._block(t, b)

    saved = fa._USE_SPLIT_BWD, fa._USE_EXP2
    fa._USE_SPLIT_BWD, fa._USE_EXP2 = args.split_bwd, args.exp2
    try:
        print(f"device: {device}; backward: {'split' if args.split_bwd else 'fused'}; "
              f"softmax exp: {'exp2' if args.exp2 else 'exp'}; blocks: "
              f"{kwargs or 'auto'} (kernel tiles 64x64)", file=sys.stderr)
        if not args.no_verify:
            verify(kwargs, device)
        if device.type == "cpu":
            return []
        card = card_line()
        results = []
        for s in args.shapes:
            results.append(bench_shape(*SHAPES[s], kwargs, args.iters, card, device))
            print(json.dumps(results[-1]))
        return results
    finally:
        fa._USE_SPLIT_BWD, fa._USE_EXP2 = saved


if __name__ == "__main__":
    main()
