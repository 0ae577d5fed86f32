"""Configuration: the dataclasses of ``distributed_training_tpu/config.py``
that the PyTorch port reads.

Field names and defaults are the JAX package's, so a config written for
one package means the same run in the other. The port keeps its own copy:
importing anything of ``distributed_training_tpu`` would import JAX.

Not carried over yet (see ROADMAP.md): ``from_ds_config``, ``MoEConfig``,
``LMConfig``, ``ServeConfig``, ``ObservabilityConfig``, ``ChaosConfig``,
``TraceConfig`` and ``MeshSpec``. ``TrainConfig`` therefore has no
``moe``, ``lm``, ``mesh``, ``observability`` or ``chaos`` field; passing
one raises ``TypeError``. Fields that exist but whose behaviour the port
does not provide yet raise ``NotImplementedError`` in the ``Trainer``
when set away from their defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Any

PLUGINS = (
    "torch_ddp",        # pure DP, fp32
    "torch_ddp_fp16",   # DP + fp16 loss scaling
    "low_level_zero",   # ZeRO-1/2 class
    "gemini",           # ZeRO-3 class
    "deepspeed",        # stage-selected ZeRO
)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam hyperparameters (DeepSpeed ds_config optimizer block defaults)."""

    # adam | adamw | sgd | lamb | hybrid_adam (the port: adam, hybrid_adam)
    name: str = "adam"
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    weight_decay_mask: str = "all"  # all | no_1d
    momentum: float = 0.9
    nesterov: bool = False
    ema_decay: float | None = None
    scale_lr_by_world: bool = False
    grad_clip_norm: float | None = None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DeepSpeed WarmupLR parity."""

    name: str = "constant"  # constant | warmup_lr | cosine
    warmup_min_lr: float = 0.0
    warmup_max_lr: float = 1e-3
    warmup_num_steps: int = 1000
    total_steps: int | None = None  # for cosine decay


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Mixed-precision policy + DeepSpeed-style dynamic loss scaling."""

    dtype: str = "fp32"  # bf16 | fp16 | fp32  (compute dtype)
    initial_scale_power: int = 15
    loss_scale_window: int = 500
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    static_loss_scale: float | None = None

    @property
    def initial_scale(self) -> float:
        return float(2 ** self.initial_scale_power)


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """ZeRO sharding. The port runs on one device: only ``stage=0``."""

    stage: int = 0
    allgather_partitions: bool = True
    reduce_scatter: bool = True
    allgather_bucket_size: int = 50_000_000
    reduce_bucket_size: int = 50_000_000
    overlap_comm: bool = True
    contiguous_gradients: bool = True
    cpu_offload: bool = False


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint/resume. The port writes every save synchronously; a
    save is durable (payload, manifest, then ``COMMITTED``) before
    ``save_checkpoint`` returns, whatever ``async_save`` says."""

    directory: str = "./checkpoint"
    interval: int = 5          # epochs between saves
    resume: int = -1           # epoch to resume from; -1 = fresh
    keep: int = 3              # retained checkpoints
    auto_resume: bool = False
    save_on_preemption: bool = True
    async_save: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # cifar10 | synthetic_cifar | synthetic_cifar_hard | synthetic_imagenet
    # (imagefolder is not ported yet)
    dataset: str = "cifar10"
    data_path: str | None = None  # None → $DATA or ../data
    batch_size: int = 100      # per-device
    global_batch_size: int | None = None  # ds-style; overrides batch_size
    augment: str = "pad_crop_flip"  # pad_crop_flip | normalize_only | none
    num_workers: int = 4
    image_size: int = 32
    num_classes: int = 10
    drop_last: bool = True
    synthetic_ok: bool = True  # fall back to synthetic data if not on disk
    max_steps_per_epoch: int | None = None  # cap train steps (smoke/bench runs)
    prefetch: int = 2
    decoded_cache: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = "resnet18"
    plugin: str = "torch_ddp"
    num_epochs: int = 5
    gradient_accumulation_steps: int = 1
    label_smoothing: float = 0.0
    eval_with_ema: bool = True
    remat: bool = False
    tp_overlap: bool = False
    seed: int = 0
    log_interval: int = 100    # steps between host-side metric fetches
    target_acc: float | None = None
    eval_every: int = 1        # epochs between eval passes
    eval_precise_bn_batches: int = 0
    sync_batchnorm: bool = True
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    precision: PrecisionConfig = dataclasses.field(default_factory=PrecisionConfig)
    zero: ZeroConfig = dataclasses.field(default_factory=ZeroConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    wall_clock_breakdown: bool = False
    profile_dir: str | None = None
    tensorboard_dir: str | None = None
    metrics_jsonl: str | None = None

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_plugin(plugin: str, **overrides: Any) -> "TrainConfig":
        """Build a config from a ColossalAI-style plugin name (the JAX
        package's presets, ``distributed_training_tpu/config.py``)."""
        if plugin not in PLUGINS:
            raise ValueError(f"unknown plugin {plugin!r}; choose from {PLUGINS}")
        opt = OptimizerConfig(scale_lr_by_world=True)
        prec = PrecisionConfig()
        zero = ZeroConfig()
        if plugin == "torch_ddp_fp16":
            prec = PrecisionConfig(dtype="fp16")
        elif plugin == "low_level_zero":
            prec = PrecisionConfig(dtype="fp16", initial_scale_power=5)
            zero = ZeroConfig(stage=1)
        elif plugin == "gemini":
            prec = PrecisionConfig(dtype="fp16", initial_scale_power=5)
            zero = ZeroConfig(stage=3)
        elif plugin == "deepspeed":
            opt = OptimizerConfig(
                betas=(0.8, 0.999), eps=1e-8, weight_decay=3e-7,
                grad_clip_norm=1.0,
            )
        cfg = TrainConfig(plugin=plugin, optimizer=opt, precision=prec, zero=zero)
        return cfg.replace(**overrides) if overrides else cfg


def effective_batch_sizes(cfg: TrainConfig, world: int,
                          allow_derive: bool = True) -> tuple[int, int, int]:
    """Resolve ``(train_global_batch, eval_global_batch, accum_steps)``
    with DeepSpeed's batch-triple semantics (train = micro × accum × world).

    - no ``global_batch_size``: effective = batch_size × world × accum;
    - ``global_batch_size`` an exact >1 multiple of batch_size × world with
      accum left at 1: accum is derived;
    - otherwise ``global_batch_size`` is the effective batch and must
      divide by accum.

    Eval always runs micro-sized batches.
    """
    accum = cfg.gradient_accumulation_steps
    if accum < 1:
        raise ValueError(f"gradient_accumulation_steps must be >= 1, got {accum}")
    micro_gbs = cfg.data.batch_size * world
    gbs = cfg.data.global_batch_size
    if gbs is None:
        return micro_gbs * accum, micro_gbs, accum
    if allow_derive and accum == 1 and gbs > micro_gbs and gbs % micro_gbs == 0:
        accum = gbs // micro_gbs
    if gbs % accum:
        raise ValueError(
            f"global batch {gbs} not divisible by "
            f"gradient_accumulation_steps={accum}")
    return gbs, gbs // accum, accum
