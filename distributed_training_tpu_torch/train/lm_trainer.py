"""LMTrainer: transformer-LM training over the data, sequence and model
axes, with ZeRO 0–3.

The port of ``distributed_training_tpu/train/lm_trainer.py``.
``LMTrainer(cfg).fit()`` returns the JAX trainer's keys:
``final_perplexity``, ``preempted``, ``last_metrics`` and ``steps``
(committed updates).

The strategy follows from the mesh (``cfg.mesh`` over the world size,
``runtime/mesh.py``), as in the JAX trainer:

- ``sequence > 1`` → the sequence strategy: each rank holds its data
  shard's rows and its time chunk, attention runs the ring over the
  ``sequence`` group, and gradients, metrics and ZeRO run over ``data ×
  sequence``; eval runs the same sharded forward;
- otherwise the tensor/dp strategy: plain data parallelism at ``model ==
  1``, megatron tensor parallelism (``parallel/tensor_parallel.py``) at
  ``model > 1``;
- ``model > 1`` composes with either (TP×SP), and ``tp_overlap`` swaps
  the ring-overlapped collective matmuls in (``parallel/collective_matmul.py``);
  at ``model == 1`` it runs the plain step, as in JAX;
- ``pipe > 1`` → the pipeline strategy (``parallel/pipeline.py``, JAX
  ``make_pp_lm_train_step``): each rank holds its stage's blocks, the
  GPipe (``lm.virtual_stages`` 1) or circular schedule runs
  ``lm.num_microbatches × accum`` microbatches of the rank's rows (the
  accumulation multiplies the microbatches, one update a step), and the
  embeddings, final norm and head are replicated over ``pipe``. It
  composes with ``data`` (ZeRO 1/2 over each stage's replica group),
  ``model`` (the stage's blocks by the rule table, the embedding and head
  vocab-parallel), ``sequence`` (the ring inside each tick) and
  homogeneous MoE (``moe.every`` 1, one expert count; with an ``expert``
  axis); ZeRO 3, ``tp_overlap`` and other MoE layouts raise JAX's
  errors. Eval runs through the same schedule;
- MoE (``cfg.moe.enabled``, ``models/moe.py``) runs under every strategy,
  with the gate scoped as JAX scopes it: global over the
  data group under tensor/dp (the GSPMD step), local to each (data,
  sequence) shard under the sequence strategy (JAX's shard_map is manual
  over both axes), local to each microbatch under the pipeline. An ``expert`` axis shards every MoE layer's experts
  over its ranks, which hold the same rows (ZeRO partitions over the data
  group only, JAX's ``moe_param_group``); under ``model > 1`` every model
  rank computes the MoE FFN whole, as GSPMD does with leaves the rule
  table leaves unsharded over ``model``. ``tp_overlap`` with MoE raises
  JAX's ``NotImplementedError``.
- Gradient accumulation: where JAX accumulates under GSPMD (tensor/dp
  without ``tp_overlap``) microbatch *m* is a contiguous block of the
  global batch, split over the data ranks, and the loaders give each rank
  its shares of the blocks in order (``data/pipeline.py::process_rows``);
  the sequence strategy, ``tp_overlap`` and the pipeline take shard-local
  microbatches, as JAX's shard_map steps do (pipe ranks at one data index
  read the same rows).

- ``fsdp > 1`` composes with every strategy above: it shards the
  parameters and the optimizer state (``parallel/zero.py``, JAX
  ``zero_stage_axes``; with the stage, over the whole replica group), and
  the replica count ``data × fsdp`` sizes the global batch and scales the
  learning rate. The batch splits over ``data`` alone, as in every JAX LM
  strategy: the fsdp ranks of a data index run the same rows (and draw
  the same dropout masks and MoE gates), and their gradients are averaged
  over ``data × fsdp``. Splitting the rows over ``fsdp`` as well would
  save the duplicated compute, but the MoE gate's and dropout's scopes
  are JAX's only as they stand, so the rows are duplicated.

The configuration checks are the JAX trainer's, with its messages.

It runs on the card unless ``device="cpu"`` is passed, and raises when
there is no card and no such request. With ``cfg.lm.attn_impl="flash"``
every layer's attention runs the K2 (forward) and K3 (backward) kernels
on the card (each ring hop, under the sequence strategy); with ``remat``
each block's recompute runs K2 again. The chunked and saved-probabilities
CE are the step's (``train/lm_step.py``); under the pipeline each live
tick's layers run them. The process group, the
preemption guard, the background checkpoint writer, the metric sinks, the
wall-clock breakdown, the profiler trace, the flight instruments, the span
trace, the live exporter and chaos are the image trainer's
(``train/trainer.py``, :class:`Engine`). Checkpoints are saved in the
world-1 format (the ZeRO partitions, the TP shards and the pipeline's
stages gathered, in layer order) and load at any layout.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from distributed_training_tpu_torch.config import TrainConfig, effective_batch_sizes
from distributed_training_tpu_torch.data.lm_text import (
    TokenLoader,
    byte_corpus,
    synthetic_tokens,
)
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.models.moe import MoEContext, shard_experts_
from distributed_training_tpu_torch.observability.flops import (
    forward_flops,
    train_step_flops,
)
from distributed_training_tpu_torch.ops.flash_attention import check_seq_len
from distributed_training_tpu_torch.parallel.pipeline import (
    PipelinedLM,
    check_pipeline,
)
from distributed_training_tpu_torch.parallel.tensor_parallel import (
    ExpertParallel,
    TensorParallel,
    shard_model_,
)
from distributed_training_tpu_torch.parallel.zero import Zero
from distributed_training_tpu_torch.runtime.coordinator import Coordinator
from distributed_training_tpu_torch.runtime.distributed import (
    initialize_distributed,
    local_device,
)
from distributed_training_tpu_torch.runtime.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQUENCE,
    Mesh,
)
from distributed_training_tpu_torch.train.lm_step import (
    make_lm_batch,
    make_lm_eval_fn,
    make_lm_train_step,
    make_pp_lm_train_step,
    mean_over_model,
    parse_logits_dtype,
)
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState, Policy
from distributed_training_tpu_torch.train.train_state import TrainState, param_count
from distributed_training_tpu_torch.train.trainer import Engine, MetricMeter
from distributed_training_tpu_torch.utils.device import set_fp32_math


def check_lm_config(cfg: TrainConfig, seq: int, model_par: int, expert: int = 1,
                    pipe: int = 1, grad_accum: int | None = None) -> None:
    """The JAX trainer's checks of the LM configuration against the
    sequence, model, expert and pipe axis sizes, with its messages (and
    JAX ``PipelinedLM``'s on the schedule); ``grad_accum`` defaults to
    ``cfg.gradient_accumulation_steps``."""
    pipeline = pipe > 1
    if cfg.tp_overlap and pipeline:
        raise NotImplementedError(
            "tp_overlap does not compose with the pipeline strategy "
            "(the stacked-stage scan keeps `model` automatic for "
            "GSPMD); use the tensor/dp or sequence strategy")
    if cfg.tp_overlap and cfg.moe.enabled:
        raise NotImplementedError(
            "tp_overlap does not compose with MoE (expert dispatch "
            "relies on GSPMD's expert axis, which the full-manual "
            "overlap region unbinds)")
    if pipeline and cfg.zero.stage >= 3:
        raise NotImplementedError(
            f"zero stage {cfg.zero.stage} does not compose with the "
            "pipeline strategy (params sharded over data would be "
            "all-gathered every tick); use stage 1/2 or another "
            "strategy")
    if cfg.moe.enabled and expert > 1 and cfg.zero.stage >= 1 \
            and not cfg.moe.moe_param_group:
        raise ValueError(
            "zero stage >= 1 with expert parallelism requires "
            "--moe-param-group (expert optimizer state is partitioned "
            "per expert group, DeepSpeed's split_params_into_"
            "different_moe_groups_for_optimizer semantics)")
    if cfg.moe.enabled and pipeline:
        homogeneous = (cfg.moe.every == 1
                       and len(set(cfg.moe.num_experts)) == 1)
        if not homogeneous:
            raise NotImplementedError(
                "the pipeline engine carries MoE only in the "
                "HOMOGENEOUS layout (--moe-every 1, one expert count: "
                "the stacked-stage scan requires congruent per-layer "
                "param trees, which the alternating/per-layer layouts "
                "break). That already exceeds the parity bar — "
                "DeepSpeed's PipelineModule cannot carry MoE layers at "
                "all (deepspeed.moe routes through the non-pipeline "
                "engine only; the reference's MoE surface, "
                "resnet/deepspeed/deepspeed_train.py:61-106, drives "
                "plain DP training). Use tensor/dp or sequence for "
                "alternating/per-layer MoE")
    if expert > 1 and not cfg.moe.enabled:
        raise ValueError(
            f"expert mesh axis sized {expert} with MoE disabled would "
            "replicate the dense model over it (idle chips); enable "
            "--moe or drop the expert axis")
    if cfg.moe.enabled and expert > 1:
        for ne in cfg.moe.num_experts:
            if int(ne) % expert:
                raise ValueError(
                    f"expert-parallel size {expert} must divide every "
                    f"per-layer num_experts "
                    f"(= {tuple(cfg.moe.num_experts)})")
    lm = cfg.lm
    if seq > 1 and lm.seq_len % seq:
        raise ValueError(
            f"sequence-parallel size {seq} must divide seq_len "
            f"(= {lm.seq_len})")
    if lm.ce_chunk_size is not None:
        if lm.ce_chunk_size < 1:
            raise ValueError(f"ce_chunk_size must be >= 1, got {lm.ce_chunk_size}")
        # The shifted loss length is seq_len: seq_len/sp a ring shard (the
        # full seq_len for the pipeline, whose CE JAX runs over the global
        # time axis), and tp_overlap time-shards it over the model axis too.
        t_loss = lm.seq_len if pipeline else lm.seq_len // seq
        if cfg.tp_overlap and not pipeline:
            t_loss //= model_par
        if t_loss % lm.ce_chunk_size:
            raise ValueError(
                f"ce_chunk_size {lm.ce_chunk_size} must divide the "
                f"per-shard loss sequence length (= {t_loss})")
    if pipeline:
        if lm.num_layers % pipe:
            raise ValueError(
                f"pipeline size {pipe} must divide num_layers "
                f"(= {lm.num_layers})")
        if cfg.data.batch_size % lm.num_microbatches:
            raise ValueError(
                f"num_microbatches {lm.num_microbatches} must divide "
                f"the per-shard batch_size (= {cfg.data.batch_size})")
    if model_par > 1:
        checks = [("num_heads", lm.num_heads),
                  ("mlp dim", lm.hidden_dim * lm.mlp_ratio)]
        if not cfg.tp_overlap:  # the overlap schedule keeps vocab replicated
            checks.append(("vocab_size", lm.vocab_size))
        for what, n in checks:
            if n % model_par:
                raise ValueError(
                    f"tensor parallelism size {model_par} must divide "
                    f"{what} (= {n})")
        if cfg.tp_overlap and (lm.seq_len // seq) % model_par:
            raise ValueError(
                f"tp_overlap time-shards activations over the model "
                f"axis: the per-sequence-shard length "
                f"(= {lm.seq_len // seq}) must divide by the "
                f"tensor-parallel size {model_par}")
    if lm.attn_impl == "flash":  # ROADMAP C (e), at each shard's length
        check_seq_len(lm.seq_len // seq)
    if pipeline:
        micro = lm.num_microbatches * (cfg.gradient_accumulation_steps
                                       if grad_accum is None else grad_accum)
        if cfg.data.batch_size % micro:
            raise ValueError(
                f"with the pipeline strategy, gradient_accumulation_steps "
                f"multiplies the microbatch count (DeepSpeed pipeline "
                f"semantics): num_microbatches × accum = "
                f"{micro} must divide the per-shard "
                f"batch_size (= {cfg.data.batch_size})")
        check_pipeline(lm.num_layers, pipe, micro, lm.virtual_stages)


class LMTrainer(Engine):
    """Epoch-loop engine for :class:`TransformerLM` over the mesh of the
    default process group (world 1 without one)."""

    tag, epoch_tag = "lm_trainer", "lm_train"

    def __init__(self, cfg: TrainConfig, device: str | torch.device | None = None):
        lm = cfg.lm
        # num_microbatches and virtual_stages shape the pipeline alone;
        # without the pipe axis the JAX trainer reads neither, and neither
        # does this one.
        self.cfg = cfg
        group = initialize_distributed(device=device)
        self.coord = Coordinator()
        self.device = local_device(device)
        set_fp32_math()
        self.mesh = Mesh(cfg.mesh)
        seq, model_par = self.mesh.size(AXIS_SEQUENCE), self.mesh.size(AXIS_MODEL)
        pipe = self.mesh.size(AXIS_PIPE)
        self.strategy = ("pipeline" if pipe > 1 else "sequence" if seq > 1
                         else "tensor/dp")
        pipeline = self.strategy == "pipeline"
        self.tp_size = model_par
        expert = self.mesh.size(AXIS_EXPERT)
        self.world_size = self.mesh.data_size
        self.train_gbs, self.eval_gbs, self.grad_accum = effective_batch_sizes(
            cfg, self.world_size)
        check_lm_config(cfg, seq, model_par, expert, pipe, self.grad_accum)
        policy = Policy.from_config(cfg.precision)
        logits_dtype = parse_logits_dtype(lm.logits_dtype)
        moe = cfg.moe
        moe_kwargs = dict(
            moe_num_experts=tuple(int(n) for n in moe.num_experts),
            moe_every=moe.every, moe_top_k=moe.top_k,
            moe_capacity_factor=moe.capacity_factor,
            moe_min_capacity=moe.min_capacity,
            moe_noisy_gate_policy=moe.noisy_gate_policy,
            moe_mlp_type=moe.mlp_type) if moe.enabled else {}
        self.model = get_model(
            "transformer_lm", num_classes=lm.vocab_size,
            dtype=policy.compute_dtype, num_layers=lm.num_layers,
            num_heads=lm.num_heads, hidden_dim=lm.hidden_dim,
            mlp_ratio=lm.mlp_ratio, max_len=lm.max_len,
            attn_impl=lm.attn_impl, remat=cfg.remat,
            logits_dtype=logits_dtype, head_bias=lm.head_bias,
            seq_axis=AXIS_SEQUENCE if seq > 1 else None, mesh=self.mesh,
            generator=torch.Generator().manual_seed(cfg.seed), **moe_kwargs,
        )
        # One optimizer step's model FLOPs over the effective global batch
        # (None with MoE layers, as in JAX).
        step_flops = train_step_flops(forward_flops(self.model, seq_len=lm.seq_len,
                                                    batch=self.train_gbs))
        if pipeline:
            # Accumulation multiplies the microbatches (JAX _pp_microbatches).
            self._pp_microbatches = lm.num_microbatches * self.grad_accum
            self.model = PipelinedLM(self.model, num_microbatches=self._pp_microbatches,
                                     virtual_stages=lm.virtual_stages, mesh=self.mesh)
        self.tp = TensorParallel.from_mesh(self.mesh, overlap=cfg.tp_overlap)
        self.ep = ExpertParallel.from_mesh(self.mesh)
        pp = self.model.stage if pipeline else None
        shard_model_(self.model, self.tp)
        if moe.enabled:
            shard_experts_(self.model, MoEContext.for_pipeline(self.mesh) if pipeline
                           else MoEContext.from_mesh(self.mesh))
        # JAX's microbatch order where it accumulates under GSPMD; the
        # shard_map steps (sequence, tp_overlap, the pipeline) take
        # shard-local microbatches.
        self.global_microbatches = (seq == 1 and not pipeline
                                    and not (cfg.tp_overlap and model_par > 1))
        self.model.to(self.device)
        self.param_count = param_count(self.model, self.tp, self.ep, pp)
        self.tx = make_optimizer(cfg.optimizer, cfg.scheduler, self.world_size)
        # ZeRO over the replica group: data × fsdp × sequence (JAX
        # zero_stage_axes), at this rank's pipe index; under an expert axis,
        # each expert rank's own. The fsdp ranks of a data index read the
        # same rows (the batch splits over data alone, as in JAX), so the
        # exchange's mean over the group is the data ranks' mean.
        self.state = TrainState.create(
            self.model, self.tx, LossScaleState.create(cfg.precision),
            Zero(cfg.zero.stage, self.mesh.group(AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE),
                 cfg.zero.cpu_offload, tp=self.tp, ep=self.ep, pp=pp,
                 fsdp=self.mesh.group(AXIS_FSDP),
                 inner=self.mesh.group(AXIS_DATA, AXIS_SEQUENCE)))
        step_kw = dict(zero_stage=cfg.zero.stage, accuracy_metric=lm.metrics_accuracy,
                       max_len=lm.max_len, ce_chunk=lm.ce_chunk_size,
                       ce_save_probs=lm.ce_save_probs, logits_dtype=logits_dtype,
                       seed=cfg.seed, grad_norm_metric=cfg.observability.grad_norm)
        self.train_step = (make_pp_lm_train_step(cpu_offload=cfg.zero.cpu_offload, **step_kw)
                           if pipeline else
                           make_lm_train_step(grad_accum_steps=self.grad_accum, **step_kw))
        self.eval_loss = make_lm_eval_fn(lm.ce_chunk_size, logits_dtype, pipeline=pipeline)
        self.meter = MetricMeter(cfg.log_interval)
        self._init_run(step_flops)
        overlap = self.tp is not None and self.tp.overlap
        label = (self.strategy + ("×sp" if pipeline and seq > 1 else "")
                 + ("×tp" if model_par > 1 and (seq > 1 or pipeline) else "")
                 + ("(tp-overlap)" if overlap else ""))
        if pipeline:
            label += (f"(v={lm.virtual_stages} M={self._pp_microbatches} "
                      f"bubble={self.model.bubble_fraction:.3f})")
        layout = {a: n for a, n in self.mesh.sizes.items() if n > 1}
        params = self.param_count
        self.coord.print(
            f"[lm_trainer] params={params:,} "
            f"device={self.device} dtype={cfg.precision.dtype} "
            f"attn={lm.attn_impl} seq_len={lm.seq_len} "
            f"optimizer={cfg.optimizer.name}"
            + (f" moe={tuple(moe.num_experts)}x{moe.every} top{moe.top_k}"
               f" {moe.mlp_type}" if moe.enabled else "")
            + (f" mesh={layout} strategy={label}" if self.mesh.world > 1 else "")
            + (f" world={self.world_size} zero={cfg.zero.stage}"
               + (" cpu_offload" if cfg.zero.cpu_offload else "")
               if group is not None or cfg.zero.stage else "")
            + (" remat" if cfg.remat else "")
            + (f" ce_chunk={lm.ce_chunk_size}" if lm.ce_chunk_size else "")
            + (" ce_save_probs" if lm.ce_save_probs else "")
            + (f" grad_accum={self.grad_accum}" if self.grad_accum > 1 else ""))

    # -- data ---------------------------------------------------------------
    def make_loaders(self) -> tuple[TokenLoader, TokenLoader]:
        lm, seed = self.cfg.lm, self.cfg.seed
        if lm.corpus_path:
            # Disjoint byte spans: eval windows never overlap training text.
            train = byte_corpus(lm.corpus_path, lm.train_sequences, lm.seq_len,
                                seed=seed, span=(0.0, 0.9))
            evals = byte_corpus(lm.corpus_path, lm.eval_sequences, lm.seq_len,
                                seed=seed + 1, span=(0.9, 1.0))
        else:
            train = synthetic_tokens(lm.train_sequences, lm.seq_len,
                                     lm.vocab_size, seed=seed)
            evals = synthetic_tokens(lm.eval_sequences, lm.seq_len,
                                     lm.vocab_size, seed=seed + 1)
        # Train consumes effective batches; eval stays micro-sized. Each
        # data shard reads its contiguous slice of every global batch, or
        # of every microbatch of it (see the module docstring).
        shard = dict(process_index=self.mesh.index(AXIS_DATA),
                     process_count=self.mesh.size(AXIS_DATA))
        micro = self.grad_accum if self.global_microbatches else 1
        return (TokenLoader(train, global_batch_size=self.train_gbs,
                            shuffle=True, seed=seed, microbatches=micro,
                            max_steps=self.cfg.data.max_steps_per_epoch, **shard),
                TokenLoader(evals, global_batch_size=self.eval_gbs,
                            shuffle=False, seed=seed, **shard))

    def host_batch(self, batch: dict) -> dict:
        """A loader batch shifted into tokens and targets (the shift before
        the time cut, so it crosses the chunks' boundaries), cut to this
        rank's time chunk under the sequence strategy."""
        n, i = self.mesh.size(AXIS_SEQUENCE), self.mesh.index(AXIS_SEQUENCE)
        out = {}
        for k, v in make_lm_batch(batch["tokens"]).items():
            tl = v.shape[1] // n
            out[k] = np.ascontiguousarray(v[:, i * tl:(i + 1) * tl])
        return out

    # -- eval ---------------------------------------------------------------
    def evaluate(self, loader: TokenLoader) -> float:
        """Mean held-out perplexity: exp of the mean over batches of each
        global batch's token CE (the ranks' shards averaged in one
        all-reduce over the replica group, and over the model ranks under
        ``tp_overlap``), with one host read for the whole pass; through the
        sharded forward of the strategy; with the parameters' EMA when
        ``optimizer.ema_decay`` and ``eval_with_ema`` are set; at ZeRO
        stage 3 through the gathered parameters."""
        ema = self.cfg.optimizer.ema_decay is not None and self.cfg.eval_with_ema
        with self.state.ema_weights() if ema else contextlib.nullcontext():
            self.state.gather_params()
            losses = [self.eval_loss(self.model, b) for b in self._batches(loader)]
            self.state.release_params()
        if not losses:
            raise ValueError(
                f"eval loader yielded no batches (eval_sequences "
                f"{self.cfg.lm.eval_sequences} < global batch "
                f"{loader.global_batch_size}? drop_last discards partials)")
        losses = self.state.zero.all_reduce_mean([torch.stack(losses)])[0]
        if self.tp is not None and self.tp.overlap:
            losses = mean_over_model([losses], self.tp)[0]
        ppl = float(np.exp(np.mean(losses.tolist())))
        self.metrics_writer.write(self._global_step, {"perplexity": ppl},
                                  prefix="eval")
        return ppl

    # -- full run -----------------------------------------------------------
    def _fit(self) -> dict:
        train_loader, eval_loader = self.make_loaders()

        def evaluate(epoch: int) -> float:
            ppl = self.evaluate(eval_loader)
            self.coord.print(f"[eval] epoch {epoch + 1}: perplexity {ppl:.4f}")
            return ppl

        ppl, _, preempted = self._run_epochs(train_loader, evaluate)
        return {"final_perplexity": ppl, "preempted": preempted,
                "last_metrics": self.meter.last, "steps": self.state.step}
