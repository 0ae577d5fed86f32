"""PyTorch/CUDA backend trainer: the port of ``resnet/jax_tpu/train.py``.

The same command line (every flag, name and default of the JAX CLI, plus
``--device``), on the port's ``Trainer`` (``distributed_training_tpu_torch``;
this script imports nothing of the JAX package):

- ``-p/--plugin`` selects the preset (``TrainConfig.from_plugin``);
  ``deepspeed`` ingests ``--deepspeed_config`` or the reference's in-code
  ds_config (``from_ds_config``), patched by ``--dtype`` and ``--stage``;
- ``-r``, ``-c``, ``-i``, ``--target_acc``, ``--auto-resume``, the
  optimizer flags (``--optimizer`` adam, adamw, sgd, lamb, hybrid_adam;
  ``--lr``, ``--momentum``, ``--nesterov``, ``--weight-decay``,
  ``--weight-decay-mask``), ``--ema-decay``, ``--dtype`` fp32, bf16,
  fp16, ``--remat``, ``--precise-bn-batches``, ``--wall-clock-breakdown``,
  ``--profile-dir``, ``--tensorboard-dir`` and ``--metrics-jsonl`` all
  work; SIGTERM saves a step-accurate checkpoint that ``--auto-resume``
  picks up;
- ``--dataset imagefolder --data-path <root>`` reads ``<root>/train`` and
  ``<root>/val`` class trees at ImageNet's size and classes by default
  (decoding needs Pillow), and ``--decoded-cache`` decodes them once into
  ``<root>/.decoded_cache`` and trains from there;
- ``--moe`` switches the model to ``moe_mlp`` (the patch MLP with MoE
  FFNs) as the JAX CLI does, with ``--num-experts``, ``--top-k``,
  ``--min-capacity``, ``--noisy-gate-policy``, ``--mlp-type`` and
  ``--moe-param-group``; ``--ep-world-size N`` shards its experts over N
  ranks of the launcher's group (the rest form the data axis);
- ``--model`` takes every name of the registry, ``vit_b16`` (ViT-B/16)
  included, as the JAX CLI's does;
- the flight instruments, mapped field for field as the JAX CLI maps
  them: ``--flight-recorder`` (on by default, as in JAX), ``--flight-dir``,
  ``--grad-norm-metric``, ``--anomaly-detection`` (the grad norm with
  it), ``--anomaly-action``, ``--anomaly-trace-steps``;
- ``--trace``/``--no-trace`` and ``--trace-dir`` (the span trace; read it
  with ``python -m distributed_training_tpu_torch.tools.trace_report``),
  ``--metrics-port`` (the live exporter on rank 0) and every
  ``--chaos-*`` flag, mapped field for field as the JAX CLI maps them.
  No flag of the JAX CLI is refused or silently ignored.

It runs on the card (``cuda:LOCAL_RANK`` under a launcher such as
``torchrun``, which sets the process group's environment) unless
``--device cpu`` asks for the CPU; without a card it raises.

    python train.py -p torch_ddp_fp16 -c ./ckpt-fp16      # run.sh
    python train.py -p deepspeed --dtype bf16 --stage 2 --optimizer sgd --lr 0.1
    python train.py --model resnet50 --dataset imagefolder --data-path /data/imagenet \
        --decoded-cache --dtype bf16 -b 256
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# Run as a script from this directory: the repo root holds the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="CIFAR on an NVIDIA GPU (PyTorch backend)")

    # -- model / plugin (Colossal style) ------------------------------------
    parser.add_argument("-p", "--plugin", type=str, default="torch_ddp",
                        choices=["torch_ddp", "torch_ddp_fp16",
                                 "low_level_zero", "gemini", "deepspeed"],
                        help="parallelism plugin to use")
    parser.add_argument("--model", type=str, default="resnet18",
                        help="model name from the registry")
    parser.add_argument("-r", "--resume", type=int, default=-1,
                        help="resume from the epoch's checkpoint")
    parser.add_argument("-c", "--checkpoint", type=str, default="./checkpoint",
                        help="checkpoint directory")
    parser.add_argument("-i", "--interval", type=int, default=5,
                        help="interval of saving checkpoint (epochs)")
    parser.add_argument("--precise-bn-batches", type=int, default=0,
                        help="refresh BatchNorm running stats with N "
                             "train-mode forwards before each eval (the EMA "
                             "stats lag fast-moving params; 0 = raw stats)")
    parser.add_argument("--target_acc", type=float, default=None,
                        help="target accuracy; raise if not reached")
    parser.add_argument("--local-rank", "--local_rank", type=int, default=-1,
                        help="accepted for launcher compat; the process group "
                             "comes from the launcher's environment")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default; raises without a card) or cpu")

    # -- train (DeepSpeed style) --------------------------------------------
    parser.add_argument("-b", "--batch_size", type=int, default=100,
                        help="per-device mini-batch size")
    parser.add_argument("-e", "--epochs", type=int, default=5,
                        help="number of total epochs")
    parser.add_argument("--gradient-accumulation-steps", type=int, default=1,
                        help="microbatches accumulated per optimizer update "
                             "(effective batch = batch_size × world × this)")
    parser.add_argument("--label-smoothing", type=float, default=0.0,
                        help="uniform label smoothing for the train CE")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="activation checkpointing per block (fit "
                             "bigger batches; ~30%% extra backward FLOPs)")

    # -- optimizer overrides (None = keep the plugin preset) ----------------
    parser.add_argument("--optimizer", type=str, default=None,
                        choices=["adam", "adamw", "sgd", "lamb",
                                 "hybrid_adam"])
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=None,
                        help="SGD momentum (sgd only)")
    parser.add_argument("--nesterov", action="store_true", default=False)
    parser.add_argument("--weight-decay", type=float, default=None)
    parser.add_argument("--weight-decay-mask", type=str, default=None,
                        choices=["all", "no_1d"],
                        help="no_1d = don't decay biases/norm params "
                             "(ImageNet recipe)")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="parameter EMA decay (e.g. 0.9999); eval uses "
                             "the averaged params")
    parser.add_argument("--log-interval", type=int, default=100,
                        help="steps between metric fetches/logs")
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["bf16", "fp16", "fp32"],
                        help="compute datatype")
    parser.add_argument("--stage", type=int, default=0, choices=[0, 1, 2, 3],
                        help="ZeRO optimization stage (deepspeed plugin)")
    parser.add_argument("--deepspeed", action="store_true", default=False,
                        help="accepted for launcher compat (config comes "
                             "from --deepspeed_config / built-in defaults)")
    parser.add_argument("--deepspeed_config", type=str, default=None,
                        help="path to a DeepSpeed-style JSON config to ingest")

    # -- MoE (DeepSpeed style, deepspeed_train.py:61-106) -------------------
    parser.add_argument("--moe", action="store_true", default=False,
                        help="use mixture of experts")
    parser.add_argument("--ep-world-size", type=int, default=1,
                        help="(moe) expert parallel world size")
    parser.add_argument("--num-experts", type=int, nargs="+", default=[1],
                        help="number of experts list, MoE related.")
    parser.add_argument("--mlp-type", type=str, default="standard",
                        help="only applicable when num-experts > 1; "
                             "accepts [standard, residual]")
    parser.add_argument("--top-k", type=int, default=1,
                        help="(moe) gating top 1 and 2 supported")
    parser.add_argument("--min-capacity", type=int, default=0,
                        help="(moe) minimum expert capacity")
    parser.add_argument("--noisy-gate-policy", type=str, default=None,
                        help="(moe) None, RSample, or Jitter")
    parser.add_argument("--moe-param-group", action="store_true",
                        default=False,
                        help="(moe) separate moe param groups for ZeRO")

    # -- data / misc --------------------------------------------------------
    parser.add_argument("--dataset", type=str, default="cifar10",
                        choices=["cifar10", "synthetic_cifar",
                                 "synthetic_cifar_hard",
                                 "synthetic_imagenet", "imagefolder"])
    parser.add_argument("--data-path", type=str, default=None,
                        help="dataset root (default: $DATA or ../data); "
                             "imagefolder expects <root>/train and "
                             "<root>/val class-directory trees")
    parser.add_argument("--decoded-cache", action="store_true", default=False,
                        help="(imagefolder) decode the tree once into a "
                             "uint8 memmap cache under <root>/.decoded_cache "
                             "and serve epochs from it — decode-bound hosts "
                             "become augment-bound (DALI-cache analogue)")
    parser.add_argument("--image-size", type=int, default=None,
                        help="square input size (default: 224 for "
                             "imagenet-style datasets, 32 for CIFAR)")
    parser.add_argument("--num-classes", type=int, default=None,
                        help="label count (default by dataset)")
    parser.add_argument("--steps-per-epoch", type=int, default=None,
                        help="cap train steps per epoch (smoke runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wall-clock-breakdown", action="store_true",
                        default=False)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="profiler trace output directory")
    parser.add_argument("--auto-resume", action="store_true", default=False,
                        help="resume from the newest checkpoint if present "
                             "(pairs with SIGTERM preemption saves)")
    parser.add_argument("--tensorboard-dir", type=str, default=None,
                        help="TensorBoard scalar log directory")
    parser.add_argument("--metrics-jsonl", type=str, default=None,
                        help="append metric flushes to this JSONL file")
    # Observability (flight instruments, the span trace, the exporter).
    parser.add_argument("--flight-recorder",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="ring buffer of per-step timestamps + flushed "
                             "metrics (step-time percentiles, goodput; "
                             "dumped on anomaly/crash)")
    parser.add_argument("--flight-dir", type=str, default=None,
                        help="anomaly/crash forensics directory")
    parser.add_argument("--trace", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="span-level Perfetto trace (step/eval/ckpt "
                             "phases, ckpt-writer track, chaos marks); "
                             "summarize with tools/trace_report.py")
    parser.add_argument("--trace-dir", type=str, default=None,
                        help="trace output directory (default: "
                             "<flight dir>/trace)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="live telemetry plane: /metrics (Prometheus "
                             "text), /healthz and /vars served from a "
                             "background thread on this port while the "
                             "run is alive (loopback; 0 = ephemeral; "
                             "master process only)")
    parser.add_argument("--grad-norm-metric", action="store_true",
                        default=False,
                        help="global L2 grad norm as an on-device metric")
    parser.add_argument("--anomaly-detection", action="store_true",
                        default=False,
                        help="NaN/Inf-loss + grad-norm-spike detection at "
                             "meter flushes (flight dump + batch/HLO + "
                             "profiler trace on trigger)")
    parser.add_argument("--anomaly-action", default="raise",
                        choices=["raise", "skip"])
    parser.add_argument("--anomaly-trace-steps", type=int, default=3)

    # Chaos harness (resilience/chaos.py), the JAX CLI's flags; all
    # defaults inert.
    parser.add_argument("--chaos-seed", type=int, default=0)
    parser.add_argument("--chaos-kill-at-step", type=int, default=None,
                        help="deliver --chaos-kill-signal at this global "
                             "step (simulated preemption)")
    parser.add_argument("--chaos-kill-signal", type=str, default="sigterm",
                        choices=["sigterm", "kill"])
    parser.add_argument("--chaos-torn-ckpt-epoch", type=int, default=None,
                        help="tear this epoch's save after it lands "
                             "(truncate + drop COMMITTED; auto-resume "
                             "must fall back)")
    parser.add_argument("--chaos-torn-bytes", type=int, default=64)
    parser.add_argument("--chaos-corrupt-ckpt-epoch", type=int,
                        default=None,
                        help="tear-AFTER-commit: corrupt this epoch's "
                             "save payload, COMMITTED marker intact "
                             "(checksum pass must catch it)")
    parser.add_argument("--chaos-data-error-rate", type=float, default=0.0,
                        help="seeded one-shot transient data-read faults "
                             "(the retry policy must absorb them)")
    parser.add_argument("--chaos-slow-step-every", type=int, default=None)
    parser.add_argument("--chaos-slow-step-ms", type=float, default=50.0)
    parser.add_argument("--chaos-slow-step-host", type=int, default=None,
                        help="restrict slow-step injection to this "
                             "process index (straggler drill)")

    return parser


# The DeepSpeed trainer's in-code engine config
# (resnet/deepspeed/deepspeed_train.py:172-220), reproduced as the default
# ds_config for the 'deepspeed' plugin; --dtype/--stage patch it exactly the
# way the reference's args do.
def default_ds_config(dtype: str, stage: int, batch_size: int) -> dict:
    return {
        "train_batch_size": batch_size,
        "steps_per_print": 2000,
        "optimizer": {
            "type": "Adam",
            "params": {
                "lr": 0.001,
                "betas": [0.8, 0.999],
                "eps": 1e-8,
                "weight_decay": 3e-7,
            },
        },
        "scheduler": {
            "type": "WarmupLR",
            "params": {
                "warmup_min_lr": 0,
                "warmup_max_lr": 0.001,
                "warmup_num_steps": 1000,
            },
        },
        "gradient_clipping": 1.0,
        "prescale_gradients": False,
        "bf16": {"enabled": dtype == "bf16"},
        "fp16": {
            "enabled": dtype == "fp16",
            "fp16_master_weights_and_grads": False,
            "loss_scale": 0,
            "loss_scale_window": 500,
            "hysteresis": 2,
            "min_loss_scale": 1,
            "initial_scale_power": 15,
        },
        "wall_clock_breakdown": False,
        "zero_optimization": {
            "stage": stage,
            "allgather_partitions": True,
            "reduce_scatter": True,
            "allgather_bucket_size": 50000000,
            "reduce_bucket_size": 50000000,
            "overlap_comm": True,
            "contiguous_gradients": True,
            "cpu_offload": False,
        },
    }



def build_config(args: argparse.Namespace):
    """The port's ``TrainConfig`` for ``args``, field for field what the
    JAX CLI's ``build_config`` builds."""
    from distributed_training_tpu_torch.config import (
        ChaosConfig,
        CheckpointConfig,
        DataConfig,
        MoEConfig,
        ObservabilityConfig,
        TraceConfig,
        TrainConfig,
        from_ds_config,
    )

    cfg = TrainConfig.from_plugin(args.plugin)
    if args.moe and not args.model.startswith("moe"):
        # The reference parses --moe and trains a dense ResNet regardless;
        # here, as in the JAX CLI, the flag selects the MoE model.
        print(f"[moe] switching model {args.model!r} -> 'moe_mlp'")
        args.model = "moe_mlp"
    if args.plugin == "deepspeed":
        if args.deepspeed_config:
            with open(args.deepspeed_config) as fh:
                ds = json.load(fh)
        else:
            ds = default_ds_config(args.dtype, args.stage, args.batch_size)
        cfg = from_ds_config(ds, base=cfg)
    elif args.dtype != "fp32":
        cfg = cfg.replace(precision=dataclasses.replace(cfg.precision, dtype=args.dtype))

    imagenet_style = args.dataset in ("synthetic_imagenet", "imagefolder")
    cfg = cfg.replace(
        model=args.model,
        num_epochs=args.epochs,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        label_smoothing=args.label_smoothing,
        seed=args.seed,
        log_interval=args.log_interval,
        target_acc=args.target_acc,
        # --remat opts in; it never clears a remat the ds_config set.
        remat=args.remat or cfg.remat,
        eval_precise_bn_batches=args.precise_bn_batches,
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
        checkpoint=CheckpointConfig(directory=args.checkpoint, interval=args.interval,
                                    resume=args.resume, auto_resume=args.auto_resume),
        data=DataConfig(
            dataset=args.dataset, data_path=args.data_path, batch_size=args.batch_size,
            # DeepSpeed normalizes; DDP and Colossal pad, crop and flip.
            augment="normalize_only" if args.plugin == "deepspeed" else "pad_crop_flip",
            image_size=args.image_size or (224 if imagenet_style else 32),
            num_classes=args.num_classes or (1000 if imagenet_style else 10),
            max_steps_per_epoch=args.steps_per_epoch, decoded_cache=args.decoded_cache),
        moe=MoEConfig(
            enabled=args.moe, ep_world_size=args.ep_world_size,
            num_experts=tuple(args.num_experts), mlp_type=args.mlp_type,
            top_k=args.top_k, min_capacity=args.min_capacity,
            noisy_gate_policy=args.noisy_gate_policy,
            moe_param_group=args.moe_param_group),
        # --ep-world-size sizes the expert axis, under --moe only (a dense
        # run keeps the whole data axis), as in the JAX CLI.
        mesh=dataclasses.replace(cfg.mesh, expert=args.ep_world_size if args.moe else 1),
    )
    # Optimizer overrides on top of the plugin preset (None = keep preset).
    opt_overrides = {k: v for k, v in (
        ("name", args.optimizer), ("lr", args.lr), ("momentum", args.momentum),
        ("weight_decay", args.weight_decay), ("weight_decay_mask", args.weight_decay_mask),
        ("ema_decay", args.ema_decay)) if v is not None}
    if args.nesterov:
        opt_overrides["nesterov"] = True
    if opt_overrides:
        cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, **opt_overrides))
    return cfg


def build_trainer(argv: list[str] | None = None):
    """Parse ``argv`` and build the ``Trainer`` it asks for (which opens or
    joins the process group)."""
    from distributed_training_tpu_torch import Trainer

    args = build_parser().parse_args(argv)
    return Trainer(build_config(args), device=args.device)


def main(argv: list[str] | None = None) -> dict:
    """:func:`build_trainer`, then ``fit()``; returns its result."""
    trainer = build_trainer(argv)
    result = trainer.fit()
    trainer.coord.print(f"[done] {result}")
    return result


if __name__ == "__main__":
    main()
