r"""PyTorch/CUDA backend of the transformer-LM trainer CLI: the port of
``gpt/jax_tpu/train.py``.

The same command line (every flag, name and default of the JAX CLI, plus
``--device``) on the port's ``LMTrainer`` (``distributed_training_tpu_torch``;
this script imports nothing of the JAX package). What works:

- the model and data flags (``--vocab-size``, ``--num-layers``,
  ``--num-heads``, ``--hidden-dim``, ``--seq-len``, ``--max-len``,
  ``--corpus`` or synthetic tokens), ``--attn-impl`` exact or flash (the
  K2/K3 kernels on the card), ``--dtype`` fp32, bf16, fp16,
  ``--logits-dtype``, ``--head-bias``;
- the parallel strategy is the mesh over the launcher's process group
  (``torchrun``): ``--sp N`` rings the sequence over N ranks (ring
  attention; with ``--attn-impl flash`` each hop runs K2/K3), ``--tp N``
  megatron-shards the layers over N ranks, ``--tp-overlap`` swaps the ring
  collective matmuls in for the TP collectives; the rest of the ranks form
  the data axis. ``--stage`` 0–3 (ZeRO over the replica group),
  ``--gradient-accumulation-steps``, ``--remat``, ``--ce-chunk-size`` or
  ``--ce-save-probs``, ``--ema-decay``;
- MoE: ``--moe`` swaps every ``--moe-every``-th FFN for ``--num-experts``
  experts (``--top-k``, ``--min-capacity``, ``--noisy-gate-policy``,
  ``--mlp-type``), with the gate global over the data ranks (local to
  each shard under ``--sp``, and to each microbatch under ``--pp``, as in
  JAX), and ``--ep-world-size N`` shards
  the experts over N ranks that hold the same rows (the rest form the data
  axis; ZeRO ≥ 1 with N > 1 needs the config's ``moe_param_group``, which
  this CLI, like JAX's, has no flag for); MoE composes with ``--sp`` and
  ``--tp``, not with ``--tp-overlap`` (the trainer raises JAX's error);
- ``--pp S`` pipelines the decoder blocks over S ranks (GPipe over
  ``--microbatches`` microbatches of each data shard's rows, times
  ``--gradient-accumulation-steps``; ``--virtual-stages v`` the circular
  schedule); it composes with ``--tp``, ``--sp``, ``--stage`` 1–2 and
  ``--moe --moe-every 1`` (with ``--ep-world-size``); ZeRO 3,
  ``--tp-overlap`` and other MoE layouts raise JAX's errors;
- ``-c``, ``-i``, ``-r``, ``--auto-resume`` (SIGTERM saves a step-accurate
  checkpoint that it picks up), ``--log-interval``, ``--steps-per-epoch``,
  ``--seed``, ``--wall-clock-breakdown``, ``--profile-dir``,
  ``--tensorboard-dir``, ``--metrics-jsonl``.

- the flight instruments, mapped field for field as the JAX CLI maps
  them: ``--flight-recorder`` (on by default, as in JAX), ``--flight-dir``
  (default ``<checkpoint>/flight``), ``--grad-norm-metric`` and
  ``--anomaly-detection`` (which turns the grad norm on too),
  ``--anomaly-action``, ``--anomaly-trace-steps``; read a dump with
  ``python -m distributed_training_tpu_torch.tools.flight_report``;
- ``--trace``/``--no-trace`` and ``--trace-dir`` (the span trace, written
  at the run's end; read it with ``python -m
  distributed_training_tpu_torch.tools.trace_report``), ``--metrics-port``
  (the live ``/metrics``, ``/healthz``, ``/vars`` on rank 0; 0 picks a
  free port);
- every ``--chaos-*`` flag (``ChaosConfig.from_flags``, the JAX CLI's
  mapping): the kill at a step (SIGTERM saves and exits, SIGKILL dies),
  torn and corrupted saves, data-read faults, slow steps on one rank or
  all.

No flag of the JAX CLI is refused.

It runs on the card (``cuda:LOCAL_RANK`` under ``torchrun``) unless
``--device cpu`` asks for the CPU; without a card it raises.

    ./run.sh                                                   # one card
    torchrun --nproc-per-node 1 train.py -b 8 --seq-len 512 --attn-impl flash
    torchrun --nproc-per-node 4 train.py --sp 2 --tp 2 --attn-impl flash  # 4 cards
    torchrun --nproc-per-node 4 train.py --moe --ep-world-size 2 --attn-impl flash
    torchrun --nproc-per-node 4 train.py --pp 4 --microbatches 4 -b 16 --attn-impl flash
    python train.py --device cpu --num-layers 2 --hidden-dim 32 --seq-len 16 \
        --steps-per-epoch 2 -e 1                               # CPU, micro
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

# Run as a script from this directory: the repo root holds the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="TransformerLM on an NVIDIA GPU (PyTorch backend)")
    parser.add_argument("-b", "--batch_size", type=int, default=32,
                        help="per-data-shard batch size")
    parser.add_argument("-e", "--epochs", type=int, default=5)
    parser.add_argument("--gradient-accumulation-steps", type=int, default=1,
                        help="microbatches per optimizer update (tensor/dp "
                             "strategy; effective batch scales by this)")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="activation-checkpoint each decoder block")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="parameter EMA decay; eval uses the average")
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--vocab-size", type=int, default=256)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--num-heads", type=int, default=4)
    parser.add_argument("--hidden-dim", type=int, default=256)
    parser.add_argument("--max-len", type=int, default=2048)
    parser.add_argument("--corpus", type=str, default=None,
                        help="byte-level text file; default synthetic tokens")
    parser.add_argument("--attn-impl", type=str, default="exact",
                        choices=["exact", "flash"],
                        help="flash = the K2/K3 CUDA kernels (blockwise "
                             "attention, no [T, T] scores in memory); under "
                             "--sp it becomes the per-hop ring compute")
    parser.add_argument("--ce-chunk-size", type=int, default=None,
                        help="chunked cross-entropy: tokens per lm_head+CE "
                             "chunk (never materializes [B,T,vocab] logits; "
                             "for long-context × large-vocab runs)")
    parser.add_argument("--logits-dtype", type=str, default="bf16",
                        choices=["fp32", "bf16"],
                        help="head/logits compute dtype. Default bf16: "
                             "half the bytes of the [B,T,vocab] logits; "
                             "the CE still reduces in fp32")
    parser.add_argument("--ce-save-probs", action="store_true", default=False,
                        help="CE backward from saved bf16 softmax probs "
                             "(meant for --logits-dtype fp32); refused with "
                             "--ce-chunk-size, warns under bf16 logits")
    parser.add_argument("--head-bias", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="lm_head bias. Default off: GPT-2's head has "
                             "none, and its gradient costs a full pass over "
                             "the [B,T,vocab] logits")
    # MoE surface (DeepSpeed flag names, resnet/deepspeed parity) — here
    # they swap alternating decoder FFNs for expert-parallel MoE layers.
    parser.add_argument("--moe", action="store_true", default=False)
    parser.add_argument("--ep-world-size", type=int, default=1,
                        help="expert mesh axis size")
    parser.add_argument("--num-experts", type=int, nargs="+", default=[8])
    parser.add_argument("--moe-every", type=int, default=2,
                        help="swap every Nth decoder FFN for MoE (GShard "
                             "alternating at 2); 1 = every layer — the "
                             "homogeneous layout the pipeline strategy "
                             "(--pp) can carry")
    parser.add_argument("--top-k", type=int, default=1)
    parser.add_argument("--min-capacity", type=int, default=0)
    parser.add_argument("--noisy-gate-policy", type=str, default=None,
                        choices=[None, "RSample", "Jitter"])
    parser.add_argument("--mlp-type", type=str, default="standard",
                        choices=["standard", "residual"])
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["bf16", "fp16", "fp32"])
    parser.add_argument("--stage", type=int, default=0, choices=[0, 1, 2, 3],
                        help="ZeRO stage (composes with --tp / pure DP)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel (model axis) size")
    parser.add_argument("--tp-overlap", action="store_true", default=False,
                        help="ring-overlapped tensor parallelism: decompose "
                             "the megatron layer collectives into ppermute "
                             "rings fused with the partial matmuls "
                             "(latency-hiding collective matmul; needs "
                             "--tp > 1 to do anything, and seq_len/--sp "
                             "divisible by --tp)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline-parallel (pipe axis) size")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence-parallel (ring) size")
    parser.add_argument("--virtual-stages", type=int, default=1,
                        help="interleaved/circular pipeline: layer chunks "
                             "per pipe device (1 = GPipe); cuts the bubble "
                             "to (S-1)/(v*M+S-1)")
    parser.add_argument("--microbatches", type=int, default=2,
                        help="GPipe microbatches (only with --pp)")
    parser.add_argument("-c", "--checkpoint", type=str, default="./checkpoint")
    parser.add_argument("-i", "--interval", type=int, default=5)
    parser.add_argument("-r", "--resume", type=int, default=-1)
    parser.add_argument("--log-interval", type=int, default=50)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--wall-clock-breakdown", action="store_true")
    parser.add_argument("--profile-dir", type=str, default=None)
    parser.add_argument("--auto-resume", action="store_true", default=False,
                        help="resume from the newest checkpoint if present")
    parser.add_argument("--tensorboard-dir", type=str, default=None)
    parser.add_argument("--metrics-jsonl", type=str, default=None)
    # Observability (flight instruments; docs/OBSERVABILITY.md).
    parser.add_argument("--flight-recorder",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="ring buffer of per-step timestamps + flushed "
                             "metrics; step-time p50/p95 + goodput, dumped "
                             "to JSON on anomaly/crash (read it with "
                             "tools/flight_report.py)")
    parser.add_argument("--flight-dir", type=str, default=None,
                        help="where anomaly/crash forensics land (flight "
                             "JSON, offending batch, HLO, profiler trace)")
    parser.add_argument("--trace", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="span-level Perfetto trace: step/eval/ckpt "
                             "phases, the async checkpoint writer's own "
                             "track, chaos injections — written at run "
                             "end (open in ui.perfetto.dev, or summarize "
                             "with tools/trace_report.py)")
    parser.add_argument("--trace-dir", type=str, default=None,
                        help="trace output directory (default: "
                             "<flight dir>/trace)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="live telemetry plane: serve /metrics "
                             "(Prometheus text), /healthz and /vars from "
                             "a background thread on this port while the "
                             "run is alive (loopback; 0 = ephemeral; "
                             "master process only). Scrapes read cached "
                             "host-side summaries — never a device value")
    parser.add_argument("--grad-norm-metric", action="store_true",
                        default=False,
                        help="global L2 grad norm as an on-device step "
                             "metric (no extra host syncs; also arms the "
                             "anomaly detector's spike rule)")
    parser.add_argument("--anomaly-detection", action="store_true",
                        default=False,
                        help="NaN/Inf-loss + grad-norm-spike detection at "
                             "meter flushes; on trigger: flight dump + "
                             "batch/HLO save + N-step profiler trace, then "
                             "--anomaly-action")
    parser.add_argument("--anomaly-action", default="raise",
                        choices=["raise", "skip"])
    parser.add_argument("--anomaly-trace-steps", type=int, default=3,
                        help="profiler-trace steps captured after an "
                             "anomaly trigger (0 = no trace)")
    add_chaos_arguments(parser)
    return parser


def add_chaos_arguments(parser: argparse.ArgumentParser) -> None:
    """The JAX CLI's fault-injection flags (``resilience/chaos.py``), all
    inert at their defaults; ``ChaosConfig.from_flags`` maps them."""
    parser.add_argument("--chaos-seed", type=int, default=0)
    parser.add_argument("--chaos-kill-at-step", type=int, default=None,
                        help="deliver --chaos-kill-signal from inside the "
                             "step loop at this global step (simulated "
                             "eviction)")
    parser.add_argument("--chaos-kill-signal", type=str, default="sigterm",
                        choices=["sigterm", "kill"],
                        help="sigterm = graceful grace-window eviction "
                             "(preemption save); kill = SIGKILL, hard "
                             "death with no save")
    parser.add_argument("--chaos-torn-ckpt-epoch", type=int, default=None,
                        help="after this epoch's checkpoint save lands, "
                             "truncate it and drop its COMMITTED marker "
                             "(torn write; auto-resume must fall back)")
    parser.add_argument("--chaos-torn-bytes", type=int, default=64,
                        help="bytes to leave in the torn file")
    parser.add_argument("--chaos-corrupt-ckpt-epoch", type=int,
                        default=None,
                        help="tear-AFTER-commit: corrupt this epoch's "
                             "save payload while keeping its COMMITTED "
                             "marker (checksum-level bit rot; the "
                             "hot-swap watcher's verify stage must "
                             "quarantine it)")
    parser.add_argument("--chaos-data-error-rate", type=float, default=0.0,
                        help="seeded per-key probability of a one-shot "
                             "transient data-read error (the retry "
                             "policy must absorb it)")
    parser.add_argument("--chaos-slow-step-every", type=int, default=None,
                        help="inject a host stall every N steps "
                             "(straggler simulation)")
    parser.add_argument("--chaos-slow-step-ms", type=float, default=50.0)
    parser.add_argument("--chaos-slow-step-host", type=int, default=None,
                        help="restrict the slow-step injection to this "
                             "process index (multihost straggler drill: "
                             "one slow host for the flight aggregation "
                             "to attribute); default: every host")


def build_config(args: argparse.Namespace):
    """The port's ``TrainConfig`` for ``args``, field for field what the
    JAX CLI's ``build_config`` builds."""
    from distributed_training_tpu_torch.config import (
        ChaosConfig,
        CheckpointConfig,
        DataConfig,
        LMConfig,
        MeshSpec,
        MoEConfig,
        ObservabilityConfig,
        TraceConfig,
        TrainConfig,
        ZeroConfig,
    )

    cfg = TrainConfig(model="transformer_lm")
    if args.ema_decay is not None:
        cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer,
                                                        ema_decay=args.ema_decay))
    return cfg.replace(
        moe=MoEConfig(
            enabled=args.moe, ep_world_size=args.ep_world_size,
            num_experts=tuple(args.num_experts), every=args.moe_every,
            top_k=args.top_k, min_capacity=args.min_capacity,
            noisy_gate_policy=args.noisy_gate_policy, mlp_type=args.mlp_type),
        num_epochs=args.epochs,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        remat=args.remat,
        tp_overlap=args.tp_overlap,
        seed=args.seed,
        log_interval=args.log_interval,
        wall_clock_breakdown=args.wall_clock_breakdown,
        profile_dir=args.profile_dir,
        tensorboard_dir=args.tensorboard_dir,
        metrics_jsonl=args.metrics_jsonl,
        observability=ObservabilityConfig(
            flight_recorder=args.flight_recorder,
            dump_dir=args.flight_dir,
            metrics_port=args.metrics_port,
            grad_norm=args.grad_norm_metric or args.anomaly_detection,
            anomaly_detection=args.anomaly_detection,
            anomaly_action=args.anomaly_action,
            anomaly_trace_steps=args.anomaly_trace_steps,
            trace=TraceConfig(enabled=args.trace, dir=args.trace_dir),
        ),
        chaos=ChaosConfig.from_flags(args),
        precision=dataclasses.replace(cfg.precision, dtype=args.dtype),
        zero=ZeroConfig(stage=args.stage),
        mesh=MeshSpec(data=-1, model=args.tp, pipe=args.pp, sequence=args.sp,
                      expert=args.ep_world_size if args.moe else 1),
        checkpoint=CheckpointConfig(
            directory=args.checkpoint, interval=args.interval,
            resume=args.resume, auto_resume=args.auto_resume),
        data=DataConfig(batch_size=args.batch_size,
                        max_steps_per_epoch=args.steps_per_epoch),
        lm=LMConfig(
            seq_len=args.seq_len, vocab_size=args.vocab_size,
            num_layers=args.num_layers, num_heads=args.num_heads,
            hidden_dim=args.hidden_dim, max_len=args.max_len,
            num_microbatches=args.microbatches,
            virtual_stages=args.virtual_stages, attn_impl=args.attn_impl,
            ce_chunk_size=args.ce_chunk_size, ce_save_probs=args.ce_save_probs,
            logits_dtype=args.logits_dtype, head_bias=args.head_bias,
            corpus_path=args.corpus),
    )


def build_trainer(argv: list[str] | None = None):
    """Parse ``argv`` and build the ``LMTrainer`` it asks for (which opens
    or joins the process group)."""
    from distributed_training_tpu_torch import LMTrainer

    args = build_parser().parse_args(argv)
    return LMTrainer(build_config(args), device=args.device)


def main(argv: list[str] | None = None) -> dict:
    """:func:`build_trainer`, then ``fit()``; returns its result."""
    trainer = build_trainer(argv)
    result = trainer.fit()
    trainer.coord.print(f"[done] {result}")
    return result


if __name__ == "__main__":
    main()
