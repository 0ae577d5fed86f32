"""Configuration: the dataclasses of ``distributed_training_tpu/config.py``
that the PyTorch port reads.

Field names and defaults are the JAX package's, so a config written for
one package means the same run in the other. The port keeps its own copy:
importing anything of ``distributed_training_tpu`` would import JAX.

``ChaosConfig.swap_error_rate`` is read by the serving hot swap's staging
read (``serving/hotswap.py``), as in JAX.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Mapping, Sequence

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

    # adam | adamw | sgd | lamb | hybrid_adam (the fused-Adam kernel K1)
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
    """ZeRO sharding over the data-parallel ranks (``parallel/zero.py``):
    ``stage`` 0–3 and ``cpu_offload`` in the image ``Trainer``. The bucket
    and overlap knobs are DeepSpeed's and are read by nothing: each
    exchange of a step is one collective on one flat buffer."""

    stage: int = 0
    allgather_partitions: bool = True
    reduce_scatter: bool = True
    allgather_bucket_size: int = 50_000_000
    reduce_bucket_size: int = 50_000_000
    overlap_comm: bool = True
    contiguous_gradients: bool = True
    cpu_offload: bool = False


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts surface (DeepSpeed's MoE flags): the ``moe_*``
    image models and the LM's MoE layers (``models/moe.py``).
    ``moe_param_group`` is a contract marker, as in JAX: expert optimizer
    state is always partitioned within the expert rank's data group, and
    the LM trainer requires the flag under ZeRO × expert parallelism."""

    enabled: bool = False
    ep_world_size: int = 1
    every: int = 2
    num_experts: Sequence[int] = (1,)
    mlp_type: str = "standard"  # standard | residual
    top_k: int = 1
    min_capacity: int = 0
    capacity_factor: float = 1.25
    noisy_gate_policy: str | None = None  # None | RSample | Jitter
    moe_param_group: bool = False


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint/resume. ``async_save``: the trainers snapshot the state
    to host memory and a background thread writes it
    (``resilience/async_ckpt.py``); else each save is written before the
    step loop goes on. ``save_on_preemption``: on SIGTERM the trainers
    save where the epoch stopped (``runtime/preemption.py``)."""

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
    # | imagefolder (<data_path>/{train,val}/<class>/<image> trees)
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
    prefetch: int = 2  # batches copied to the device ahead; 0 in the loop
    decoded_cache: bool = False  # imagefolder: decode once into a uint8 memmap


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh axis sizes; -1 infers from the device count
    (``runtime/mesh.py``). Both trainers run every axis; the image
    trainer splits its batch over ``data × fsdp`` and replicates its step
    over ``sequence`` and ``pipe``, as JAX's does."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    expert: int = 1
    sequence: int = 1
    pipe: int = 1


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Transformer-LM model and token-data surface (``models/gpt.py``,
    ``train/lm_trainer.py``). Defaults are the JAX package's;
    ``num_microbatches`` and ``virtual_stages`` shape the pipeline (a
    ``pipe`` axis above 1) and are read by nothing without it."""

    seq_len: int = 128
    vocab_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    hidden_dim: int = 256
    mlp_ratio: int = 4
    max_len: int = 2048
    num_microbatches: int = 1
    virtual_stages: int = 1
    attn_impl: str = "exact"  # exact | flash (the K2/K3 CUDA kernels)
    ce_chunk_size: int | None = None
    ce_save_probs: bool = False
    # Per-step train token accuracy (tie-inclusive top-1, from the CE's
    # own row max); False drops the metric key.
    metrics_accuracy: bool = True
    logits_dtype: str = "bf16"  # bf16 | fp32: the lm_head's compute dtype
    head_bias: bool = False
    corpus_path: str | None = None  # byte-level text file; None → synthetic
    train_sequences: int = 2048     # synthetic dataset size
    eval_sequences: int = 256


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Span-level event tracing (``observability/trace.py``): JAX's
    fields, defaults and validation. Off by default; when on, the trainers
    write ``<dir or dump_dir/trace>/trace.json`` (``trace_p<rank>.json``
    on several ranks) at the run's end and on a crash."""

    enabled: bool = False
    dir: str | None = None
    max_events: int = 500_000

    def __post_init__(self):
        if self.max_events < 1:
            raise ValueError(
                f"max_events must be >= 1, got {self.max_events}")


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Flight instruments (``observability/``): MFU accounting, the flight
    recorder, device-memory telemetry, anomaly-triggered forensics and the
    cross-rank straggler view. JAX's fields, defaults and validation.

    Per step they cost one host timestamp; every other input is read at the
    meter's flush from values it fetched anyway. ``metrics_port`` starts
    the live exporter (``observability/exporter.py``: ``/metrics``,
    ``/healthz``, ``/vars``) on ``metrics_host`` on rank 0; ``trace`` the
    span trace.
    """

    flight_recorder: bool = True
    ring_size: int = 1024
    # None resolves to ``<checkpoint.directory>/flight`` in the trainers.
    dump_dir: str | None = None
    mfu: bool = True
    peak_flops: float | None = None
    memory_telemetry: bool = True
    grad_norm: bool = False
    anomaly_detection: bool = False
    anomaly_action: str = "raise"  # raise | skip
    anomaly_trace_steps: int = 3
    grad_norm_spike_factor: float = 10.0
    straggler_attribution: bool = True
    straggler_window: int = 256
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    metrics_port: int | None = None
    metrics_host: str = "127.0.0.1"

    def __post_init__(self):
        if self.metrics_port is not None and not (
                0 <= self.metrics_port <= 65535):
            raise ValueError(
                f"metrics_port must be in [0, 65535], got "
                f"{self.metrics_port}")
        if self.anomaly_action not in ("raise", "skip"):
            raise ValueError(
                f"anomaly_action must be 'raise' or 'skip', got "
                f"{self.anomaly_action!r}")
        if self.anomaly_trace_steps < 0:
            raise ValueError(
                f"anomaly_trace_steps must be >= 0, got "
                f"{self.anomaly_trace_steps}")
        if self.straggler_window < 2:
            raise ValueError(
                f"straggler_window must be >= 2, got "
                f"{self.straggler_window}")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection (``resilience/chaos.py``): JAX's
    fields, defaults, ``active`` and validation.

    Every fault is step- or epoch-addressed and seeded, a pure function of
    this config, so a chaos run replays exactly. All defaults are inert;
    the trainers build a ``ChaosMonkey`` only when :attr:`active`.
    """

    seed: int = 0
    # Deliver a signal from inside the step loop at this global step:
    # "sigterm" goes through the PreemptionGuard (finish the step, save,
    # return); "kill" is SIGKILL, death with no save (the resume falls back
    # to the last committed interval save).
    kill_at_step: int | None = None
    kill_signal: str = "sigterm"  # sigterm | kill
    # After this epoch's save lands, truncate its largest file and drop its
    # COMMITTED marker: what a crash mid-write leaves.
    torn_ckpt_epoch: int | None = None
    torn_truncate_bytes: int = 64
    # Corrupt this epoch's payload and keep its marker and manifest: caught
    # only by the checksum pass.
    corrupt_ckpt_epoch: int | None = None
    # Probability (per distinct read key, seeded) that a data read raises a
    # one-shot ChaosIOError, which the loaders' RetryPolicy absorbs.
    data_error_rate: float = 0.0
    # The same for the serving hot swap's staging read
    # (serving/hotswap.py).
    swap_error_rate: float = 0.0
    # A host stall of slow_step_ms every slow_step_every-th step, on every
    # rank or on rank slow_step_host alone.
    slow_step_every: int | None = None
    slow_step_ms: float = 50.0
    slow_step_host: int | None = None

    @property
    def active(self) -> bool:
        return (self.kill_at_step is not None
                or self.torn_ckpt_epoch is not None
                or self.corrupt_ckpt_epoch is not None
                or self.data_error_rate > 0
                or self.swap_error_rate > 0
                or self.slow_step_every is not None)

    def __post_init__(self):
        if self.kill_signal not in ("sigterm", "kill"):
            raise ValueError(
                f"kill_signal must be 'sigterm' or 'kill', got "
                f"{self.kill_signal!r}")
        if not 0.0 <= self.data_error_rate <= 1.0:
            raise ValueError(
                f"data_error_rate must be in [0, 1], got "
                f"{self.data_error_rate}")
        if not 0.0 <= self.swap_error_rate <= 1.0:
            raise ValueError(
                f"swap_error_rate must be in [0, 1], got "
                f"{self.swap_error_rate}")
        if self.slow_step_every is not None and self.slow_step_every < 1:
            raise ValueError(
                f"slow_step_every must be >= 1, got {self.slow_step_every}")
        if self.slow_step_host is not None and self.slow_step_host < 0:
            raise ValueError(
                f"slow_step_host must be >= 0, got {self.slow_step_host}")
        if self.torn_truncate_bytes < 0:
            raise ValueError(
                f"torn_truncate_bytes must be >= 0, got "
                f"{self.torn_truncate_bytes}")

    @classmethod
    def from_flags(cls, args) -> "ChaosConfig":
        """The CLIs' ``--chaos-*`` flags (an ``argparse.Namespace``), field
        for field as the JAX CLIs map them."""
        return cls(
            seed=args.chaos_seed,
            kill_at_step=args.chaos_kill_at_step,
            kill_signal=args.chaos_kill_signal,
            torn_ckpt_epoch=args.chaos_torn_ckpt_epoch,
            torn_truncate_bytes=args.chaos_torn_bytes,
            corrupt_ckpt_epoch=args.chaos_corrupt_ckpt_epoch,
            data_error_rate=args.chaos_data_error_rate,
            slow_step_every=args.chaos_slow_step_every,
            slow_step_ms=args.chaos_slow_step_ms,
            slow_step_host=args.chaos_slow_step_host,
        )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving engine knobs (``serving/``): JAX's
    fields, defaults and validation.

    Every shape is static: the paged engine runs one fused prefill-chunk
    + decode step and one decode-only step for ``max_batch`` slots, the
    legacy engine one bucketed prefill family and one decode step, and
    any request mix is served without a new shape. The fields of the
    prefix cache, speculation, weight quantization, int8 KV pages, the
    journal and the SLO alerting are validated here as in JAX, and the
    ``Engine`` serves them all.
    """

    # Decode slots, refilled from the queue at iteration boundaries.
    max_batch: int = 8
    # Per-slot KV positions (prompt + generated); None = the model's max_len.
    max_len: int | None = None
    # Default completion budget per request (requests may ask for less).
    max_new_tokens: int = 128
    # Sampling transforms (sampler.py; 0 temperature = greedy).
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    eos_id: int | None = None
    pad_id: int = 0
    # Paged KV cache: a pool of kv_page_size-token pages and a page table
    # per slot; None = the legacy contiguous slot per sequence.
    kv_page_size: int | None = 8
    # Pool size in pages; None = max_batch x ceil(budget / kv_page_size).
    # Fewer oversubscribe: admission then gates on committed pages.
    kv_pages: int | None = None
    # Chunked prefill (paged only): one chunk of this many prompt tokens
    # rides each decode iteration in the fused step.
    prefill_chunk: int = 64
    # Legacy prefill: prompts pad up to a multiple of this (batch-1 prefill).
    prefill_bucket: int = 64
    # Flight-recorder ring (one entry per iteration) and flush cadence.
    ring_size: int = 4096
    flush_every: int = 32
    seed: int = 0
    # Bounded queue (QueueFullError past it; None = unbounded) and the
    # per-request deadlines (finish reason "timeout"; None = off).
    max_queue_depth: int | None = None
    ttft_deadline_ms: float | None = None
    deadline_ms: float | None = None
    # Speculative decoding (serving/speculative.py).
    spec_k: int = 0
    spec_drafter: str = "ngram"
    spec_ngram: int = 3
    spec_draft_window: int = 16
    # SLO tiers (0 = highest), the per-tenant seat quota, weighted-fair
    # tenant shares, tier-0 headroom and lossless preempt-and-requeue.
    num_tiers: int = 1
    tenant_quota: int | None = None
    tenant_weights: dict | None = None
    tier_reserved_slots: int = 0
    tier_reserved_pages: int = 0
    preempt: bool = True
    # The write-ahead request journal (serving/journal.py).
    journal_dir: str | None = None
    journal_fsync: str = "batch"
    journal_segment_bytes: int = 1 << 20
    # The radix-tree prefix cache (serving/prefix_cache.py).
    prefix_cache: bool = False
    prefix_cache_pages: int | None = None
    # int8 weights and int8 KV pages (serving/quantize.py, PagedCache).
    quantize_weights: bool = False
    kv_dtype: str | None = None
    # The control room: the time-series ring's cadence and capacity (the
    # engine samples it always); SLO rules (serving/alerts.py's grammar,
    # evaluated at each sample) and the incident bundles' directory.
    sample_every: int = 16
    timeseries_capacity: int = 1024
    slo_rules: str | None = None
    incident_dir: str | None = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        for name in ("ttft_deadline_ms", "deadline_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.prefill_bucket < 1:
            raise ValueError(
                f"prefill_bucket must be >= 1, got {self.prefill_bucket}")
        if self.kv_page_size is not None and self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1 (or None for the legacy "
                f"contiguous cache), got {self.kv_page_size}")
        if self.kv_pages is not None:
            if self.kv_page_size is None:
                raise ValueError(
                    "kv_pages requires kv_page_size (the legacy "
                    "contiguous cache has no page pool)")
            if self.kv_pages < 1:
                raise ValueError(
                    f"kv_pages must be >= 1, got {self.kv_pages}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.prefix_cache and self.kv_page_size is None:
            raise ValueError(
                "prefix_cache requires the paged KV cache (set "
                "kv_page_size): the legacy contiguous slot reservation "
                "has no pages to alias across requests")
        if self.prefix_cache_pages is not None \
                and self.prefix_cache_pages < 1:
            raise ValueError(
                f"prefix_cache_pages must be >= 1 (or None), "
                f"got {self.prefix_cache_pages}")
        if self.flush_every < 1:
            raise ValueError(
                f"flush_every must be >= 1, got {self.flush_every}")
        if self.max_len is not None and self.max_len < 2:
            raise ValueError(
                f"max_len must be >= 2 (one prompt token + one generated), "
                f"got {self.max_len}")
        if self.spec_k < 0:
            raise ValueError(
                f"spec_k must be >= 0 (0 = speculation off), "
                f"got {self.spec_k}")
        if self.spec_drafter not in ("ngram", "gpt"):
            raise ValueError(
                f"spec_drafter must be 'ngram' or 'gpt', "
                f"got {self.spec_drafter!r}")
        if self.spec_ngram < 1:
            raise ValueError(
                f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.spec_draft_window < 1:
            raise ValueError(
                f"spec_draft_window must be >= 1, "
                f"got {self.spec_draft_window}")
        if self.num_tiers < 1:
            raise ValueError(
                f"num_tiers must be >= 1, got {self.num_tiers}")
        if self.tenant_quota is not None and self.tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1, got {self.tenant_quota}")
        if self.tenant_weights is not None:
            for t, w in self.tenant_weights.items():
                if not w > 0:
                    raise ValueError(
                        f"tenant weight must be > 0, got {t!r}: {w}")
        if not 0 <= self.tier_reserved_slots < self.max_batch:
            raise ValueError(
                f"tier_reserved_slots must be in [0, max_batch-1] (a "
                f"full reserve would starve every non-top tier), got "
                f"{self.tier_reserved_slots} of {self.max_batch} slots")
        if self.tier_reserved_pages < 0:
            raise ValueError(
                f"tier_reserved_pages must be >= 0, "
                f"got {self.tier_reserved_pages}")
        if self.journal_fsync not in ("none", "batch", "always"):
            raise ValueError(
                f"journal_fsync must be 'none', 'batch' or 'always', "
                f"got {self.journal_fsync!r}")
        if self.journal_segment_bytes < 4096:
            raise ValueError(
                f"journal_segment_bytes must be >= 4096 (a segment "
                f"must hold more than one compaction header), got "
                f"{self.journal_segment_bytes}")
        if self.kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None (model dtype) or 'int8', "
                f"got {self.kv_dtype!r}")
        if self.kv_dtype is not None and self.kv_page_size is None:
            raise ValueError(
                "kv_dtype requires the paged KV cache (set "
                "kv_page_size): the legacy contiguous path keeps "
                "full-precision slots")
        if self.sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {self.sample_every}")
        if self.timeseries_capacity < 2:
            raise ValueError(
                f"timeseries_capacity must be >= 2, "
                f"got {self.timeseries_capacity}")
        if self.incident_dir is not None and self.slo_rules is None:
            raise ValueError(
                "incident_dir without slo_rules captures nothing: an "
                "incident bundle is written when a rule fires")


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
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    lm: LMConfig = dataclasses.field(default_factory=LMConfig)
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    wall_clock_breakdown: bool = False
    profile_dir: str | None = None
    tensorboard_dir: str | None = None
    metrics_jsonl: str | None = None
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)

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


def resolve_data_axis(mesh: MeshSpec, world: int) -> int:
    """The data-parallel replica count of ``mesh`` over ``world``
    processes: ``data × fsdp`` once the sizes are resolved as
    ``create_mesh`` resolves them (one axis may be -1 and takes what the
    others leave; the product must be the world size, or this raises)."""
    from distributed_training_tpu_torch.runtime.mesh import data_axis_size, mesh_sizes

    return data_axis_size(mesh_sizes(mesh, world))


def from_ds_config(ds: Mapping[str, Any], base: TrainConfig | None = None) -> TrainConfig:
    """Ingest a DeepSpeed-style config dict, as the JAX package's
    ``from_ds_config`` does: every field of the reference's ds_config
    (``resnet/deepspeed/deepspeed_train.py:172-220``) maps onto the
    dataclasses, and unknown keys raise ``ValueError``. What asks for a
    ``activation_checkpointing`` turns ``remat`` on only with an opt-in
    signal, as in the JAX package (below), and ``wall_clock_breakdown``
    maps onto the field of that name. ``prescale_gradients`` and the ZeRO bucket and overlap knobs are
    validated and read by nothing (each exchange is one collective on one
    flat buffer, which averages either way)."""
    cfg = base or TrainConfig.from_plugin("deepspeed")
    known = {
        "train_batch_size", "train_micro_batch_size_per_gpu", "steps_per_print",
        "gradient_accumulation_steps", "activation_checkpointing",
        "optimizer", "scheduler", "gradient_clipping", "prescale_gradients",
        "bf16", "fp16", "wall_clock_breakdown", "zero_optimization",
    }
    unknown = set(ds) - known
    if unknown:
        raise ValueError(f"unknown ds_config keys: {sorted(unknown)}")

    opt = cfg.optimizer
    if "optimizer" in ds:
        p = ds["optimizer"].get("params", {})
        opt_type = ds["optimizer"].get("type", "Adam").lower()
        if opt_type in ("adam", "adamw", "lamb"):
            opt = dataclasses.replace(
                opt, name=opt_type, lr=p.get("lr", opt.lr),
                betas=tuple(p.get("betas", opt.betas)), eps=p.get("eps", opt.eps),
                weight_decay=p.get("weight_decay", opt.weight_decay))
        elif opt_type == "sgd":
            opt = dataclasses.replace(
                opt, name="sgd", lr=p.get("lr", opt.lr),
                momentum=p.get("momentum", opt.momentum),
                nesterov=bool(p.get("nesterov", opt.nesterov)),
                weight_decay=p.get("weight_decay", opt.weight_decay))
        else:
            raise ValueError(
                f"unsupported ds optimizer type {ds['optimizer'].get('type')!r}"
                " (adam | adamw | sgd | lamb)")
    if "gradient_clipping" in ds:
        opt = dataclasses.replace(opt, grad_clip_norm=float(ds["gradient_clipping"]))

    sched = cfg.scheduler
    if "scheduler" in ds:
        if ds["scheduler"].get("type") != "WarmupLR":
            raise ValueError("only WarmupLR scheduler is supported from ds_config")
        p = ds["scheduler"].get("params", {})
        sched = SchedulerConfig(
            name="warmup_lr", warmup_min_lr=p.get("warmup_min_lr", 0.0),
            warmup_max_lr=p.get("warmup_max_lr", opt.lr),
            warmup_num_steps=p.get("warmup_num_steps", 1000))

    prec = cfg.precision
    if ds.get("bf16", {}).get("enabled"):
        prec = dataclasses.replace(prec, dtype="bf16")
    fp16 = ds.get("fp16", {})
    if fp16.get("enabled"):
        loss_scale = fp16.get("loss_scale", 0)
        prec = PrecisionConfig(
            dtype="fp16", initial_scale_power=fp16.get("initial_scale_power", 15),
            loss_scale_window=fp16.get("loss_scale_window", 500),
            hysteresis=fp16.get("hysteresis", 2),
            min_loss_scale=fp16.get("min_loss_scale", 1.0),
            static_loss_scale=None if loss_scale == 0 else float(loss_scale))

    zero = cfg.zero
    if "zero_optimization" in ds:
        z = dict(ds["zero_optimization"])
        zero = ZeroConfig(
            stage=z.pop("stage", 0),
            allgather_partitions=z.pop("allgather_partitions", True),
            reduce_scatter=z.pop("reduce_scatter", True),
            allgather_bucket_size=z.pop("allgather_bucket_size", 50_000_000),
            reduce_bucket_size=z.pop("reduce_bucket_size", 50_000_000),
            overlap_comm=z.pop("overlap_comm", True),
            contiguous_gradients=z.pop("contiguous_gradients", True),
            cpu_offload=z.pop("cpu_offload", False))
        if z:
            raise ValueError(f"unknown zero_optimization keys: {sorted(z)}")

    data = cfg.data
    if "train_batch_size" in ds:
        data = dataclasses.replace(data, global_batch_size=int(ds["train_batch_size"]))
    if "train_micro_batch_size_per_gpu" in ds:
        data = dataclasses.replace(data, batch_size=int(ds["train_micro_batch_size_per_gpu"]))

    if not isinstance(ds.get("prescale_gradients", False), bool):
        raise ValueError("prescale_gradients must be a bool")

    # DeepSpeed's activation_checkpointing block only configures its
    # checkpointing API; nothing is checkpointed unless the model calls it.
    # So, as in the JAX package, remat needs an opt-in signal: the
    # "enabled" key (authoritative both ways) or a truthy functional
    # sub-knob. An all-false block leaves remat off, with a warning;
    # profile / synchronize_checkpoint_boundary carry no intent.
    remat = cfg.remat
    if "activation_checkpointing" in ds:
        ac = ds["activation_checkpointing"]
        if isinstance(ac, Mapping):
            functional = {"enabled", "partition_activations", "cpu_checkpointing",
                          "contiguous_memory_optimization", "number_checkpoints"}
            unknown_ac = set(ac) - functional - {"synchronize_checkpoint_boundary",
                                                 "profile"}
            if unknown_ac:
                raise ValueError(f"unknown activation_checkpointing keys: "
                                 f"{sorted(unknown_ac)}")
            if "enabled" in ac:
                remat = bool(ac["enabled"])
            elif any(ac.get(k) for k in functional):
                remat = True
            elif not remat:
                warnings.warn(
                    "activation_checkpointing block present but all functional "
                    "sub-knobs are false — remat stays OFF. "
                    'Set {"activation_checkpointing": {"enabled": true}} to opt in.',
                    stacklevel=2)
        else:
            remat = bool(ac)
    return cfg.replace(
        optimizer=opt, scheduler=sched, precision=prec, zero=zero, data=data,
        remat=remat,
        wall_clock_breakdown=bool(ds.get("wall_clock_breakdown",
                                         cfg.wall_clock_breakdown)),
        gradient_accumulation_steps=int(
            ds.get("gradient_accumulation_steps", cfg.gradient_accumulation_steps)),
        log_interval=int(ds.get("steps_per_print", cfg.log_interval)))
