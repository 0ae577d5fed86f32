"""Text generation CLI for checkpoints of ``gpt/torch_cuda/train.py``: the
port of ``gpt/jax_tpu/generate.py``.

It completes the LM's lifecycle in the port (train → checkpoint →
generate). The same flags as the JAX CLI, one for one, plus ``--device``:
the model flags must match the training run so the checkpoint restores
(``distributed_training_tpu_torch/inference/restore.py``); the sampling
flags drive the decode loop (``inference/sampler.py``), or
``--num-beams`` beam search (``inference/beam.py``). This script imports
nothing of the JAX package.

Byte-level I/O: the prompt is encoded as UTF-8 bytes (the LM's default
vocabulary of 256 is one token a byte), and completions are decoded the
same way.

It runs on the card unless ``--device cpu`` asks for the CPU; without a
card it raises.

    python generate.py -c ./ckpt-lm --prompt "The " --temperature 0
    python generate.py -c ./ckpt-lm --num-beams 4 --max-new-tokens 32
"""

from __future__ import annotations

import argparse
import os
import sys

# Run as a script from this directory: the repo root holds the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="TransformerLM generation")
    parser.add_argument("--prompt", type=str, default="The ",
                        help="UTF-8 prompt, byte-tokenized")
    parser.add_argument("--vocab-size", type=int, default=256)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--num-heads", type=int, default=4)
    parser.add_argument("--hidden-dim", type=int, default=256)
    parser.add_argument("--max-len", type=int, default=2048)
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["bf16", "fp16", "fp32"])
    parser.add_argument("--head-bias", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="must mirror training (train.py defaults to no "
                             "head bias); a mismatched flag fails the "
                             "checkpoint restore")
    parser.add_argument("--logits-dtype", type=str, default="bf16",
                        choices=["fp32", "bf16"],
                        help="head compute dtype (train.py's default is "
                             "bf16; the weights do not depend on it)")
    # MoE model flags (must match training, or the checkpoint will not
    # restore; decode runs the MoE FFNs position-wise, as training does).
    parser.add_argument("--moe", action="store_true", default=False)
    parser.add_argument("--num-experts", type=int, nargs="+", default=[8])
    parser.add_argument("--moe-top-k", type=int, default=1,
                        help="MoE gate top-k (train.py calls this --top-k; "
                             "here --top-k is the sampling filter)")
    parser.add_argument("--min-capacity", type=int, default=0)
    parser.add_argument("--mlp-type", type=str, default="standard",
                        choices=["standard", "residual"])
    parser.add_argument("-c", "--checkpoint", type=str, default="./checkpoint")
    parser.add_argument("-r", "--resume", type=int, default=-1,
                        help="epoch to load; -1 = latest (random init if "
                             "no checkpoint exists)")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="must mirror training: an --ema-decay run saves "
                             "the EMA in its optimizer state, and the restore "
                             "template has to match it")
    parser.add_argument("--use-ema", action="store_true", default=False,
                        help="sample from the EMA parameter average instead "
                             "of the raw params (requires --ema-decay)")
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="0 = greedy")
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--eos-id", type=int, default=None)
    parser.add_argument("--num-beams", type=int, default=None,
                        help="deterministic beam search instead of sampling")
    parser.add_argument("--length-penalty", type=float, default=0.0,
                        help="(beam) GNMT length-penalty alpha")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="cpu to run on the CPU; default the card")
    return parser


def decode_bytes(toks) -> str:
    return bytes(int(t) % 256 for t in toks).decode("utf-8", errors="replace")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from distributed_training_tpu_torch.inference import (
        BeamConfig,
        BeamSearcher,
        Generator,
        SampleConfig,
    )
    from distributed_training_tpu_torch.inference.restore import (
        build_lm_and_restore,
        moe_kwargs_from_flags,
    )

    moe_kwargs = moe_kwargs_from_flags(
        enabled=args.moe, num_experts=args.num_experts,
        top_k=args.moe_top_k, min_capacity=args.min_capacity,
        mlp_type=args.mlp_type)
    model, _ = build_lm_and_restore(
        vocab_size=args.vocab_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        hidden_dim=args.hidden_dim,
        max_len=args.max_len,
        dtype=args.dtype,
        head_bias=args.head_bias,
        logits_dtype=args.logits_dtype,
        moe_kwargs=moe_kwargs,
        checkpoint=args.checkpoint,
        resume=args.resume,
        ema_decay=args.ema_decay,
        use_ema=args.use_ema,
        seed=args.seed,
        device=args.device,
        printer=lambda msg: print(f"[generate] {msg}"),
    )

    prompt = np.frombuffer(args.prompt.encode("utf-8"), np.uint8)
    if (prompt >= args.vocab_size).any():
        bad = sorted(set(int(b) for b in prompt[prompt >= args.vocab_size]))
        raise SystemExit(
            f"prompt bytes {bad} are outside vocab_size={args.vocab_size}; "
            "byte-level prompts need --vocab-size 256 (or an ASCII-only "
            "prompt for smaller vocabs)")
    prompt = prompt.astype(np.int64)

    if args.num_beams:
        beams, scores = BeamSearcher(model, BeamConfig(
            num_beams=args.num_beams,
            max_new_tokens=args.max_new_tokens,
            eos_id=args.eos_id,
            length_penalty=args.length_penalty,
        ))(prompt)
        for i in range(args.num_beams):
            print(f"[generate] beam {i} (score {float(scores[0, i]):.3f}): "
                  f"{args.prompt!r} -> {decode_bytes(beams[0, i])!r}")
        return 0

    gen = Generator(model, SampleConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        eos_id=args.eos_id,
    ))
    device = model.pos_embed.device
    out = gen(prompt, generator=torch.Generator(device=device).manual_seed(args.seed))[0]
    print(f"[generate] {args.prompt!r} -> {decode_bytes(out)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
