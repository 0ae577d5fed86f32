"""LMTrainer: transformer-LM training on one device or data-parallel over
a process group with ZeRO 0–3.

The port of ``distributed_training_tpu/train/lm_trainer.py`` for its
``tensor/dp`` strategy at ``model == 1``. ``LMTrainer(cfg).fit()`` returns
the JAX trainer's keys: ``final_perplexity``, ``preempted``,
``last_metrics`` and ``steps`` (committed updates).

It runs on the card unless ``device="cpu"`` is passed, and raises when
there is no card and no such request. With ``cfg.lm.attn_impl="flash"``
every layer's attention runs the K2 (forward) and K3 (backward) kernels
on the card; with ``remat`` each block's recompute runs K2 again. Data
parallelism, ZeRO, the chunked and saved-probabilities CE are the step's
(``train/lm_step.py``); the process group, the rank's slice of every
batch, the preemption guard, the background checkpoint writer, the metric
sinks, the wall-clock breakdown and the profiler trace are the image
trainer's (``train/trainer.py``, :class:`Engine`). Fields whose behaviour
is not ported raise ``NotImplementedError``: the image trainer's list
(the pipeline among the mesh axes).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from distributed_training_tpu_torch.config import (
    TrainConfig,
    effective_batch_sizes,
    resolve_data_axis,
)
from distributed_training_tpu_torch.data.lm_text import (
    TokenLoader,
    byte_corpus,
    synthetic_tokens,
)
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.parallel.zero import Zero
from distributed_training_tpu_torch.runtime.coordinator import Coordinator
from distributed_training_tpu_torch.runtime.distributed import (
    initialize_distributed,
    local_device,
)
from distributed_training_tpu_torch.train.lm_step import (
    make_lm_batch,
    make_lm_eval_fn,
    make_lm_train_step,
    parse_logits_dtype,
)
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState, Policy
from distributed_training_tpu_torch.train.train_state import TrainState, param_count
from distributed_training_tpu_torch.train.trainer import (
    Engine,
    MetricMeter,
    refuse_unported,
    unported_fields,
)
from distributed_training_tpu_torch.utils.device import set_fp32_math


class LMTrainer(Engine):
    """Epoch-loop engine for :class:`TransformerLM`, data-parallel over the
    default process group when one is open."""

    tag, epoch_tag = "lm_trainer", "lm_train"

    def __init__(self, cfg: TrainConfig, device: str | torch.device | None = None):
        lm = cfg.lm
        # num_microbatches and virtual_stages shape the pipeline alone (the
        # pipe axis, refused with the other mesh axes); without it the JAX
        # trainer reads neither, and neither does this one.
        refuse_unported(unported_fields(cfg))
        self.cfg = cfg
        group = initialize_distributed(device=device)
        self.coord = Coordinator()
        self.device = local_device(device)
        set_fp32_math()
        self.world_size = resolve_data_axis(cfg.mesh, self.coord.world_size)
        policy = Policy.from_config(cfg.precision)
        logits_dtype = parse_logits_dtype(lm.logits_dtype)
        self.model = get_model(
            "transformer_lm", num_classes=lm.vocab_size,
            dtype=policy.compute_dtype, num_layers=lm.num_layers,
            num_heads=lm.num_heads, hidden_dim=lm.hidden_dim,
            mlp_ratio=lm.mlp_ratio, max_len=lm.max_len,
            attn_impl=lm.attn_impl, remat=cfg.remat,
            logits_dtype=logits_dtype, head_bias=lm.head_bias,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        self.train_gbs, self.eval_gbs, self.grad_accum = effective_batch_sizes(
            cfg, self.world_size)
        self.tx = make_optimizer(cfg.optimizer, cfg.scheduler, self.world_size)
        self.state = TrainState.create(
            self.model, self.tx, LossScaleState.create(cfg.precision),
            Zero(cfg.zero.stage, group, cfg.zero.cpu_offload))
        self.train_step = make_lm_train_step(
            zero_stage=cfg.zero.stage, grad_accum_steps=self.grad_accum,
            accuracy_metric=lm.metrics_accuracy, max_len=lm.max_len,
            ce_chunk=lm.ce_chunk_size, ce_save_probs=lm.ce_save_probs,
            logits_dtype=logits_dtype, seed=cfg.seed)
        self.eval_loss = make_lm_eval_fn(lm.ce_chunk_size, logits_dtype)
        self.meter = MetricMeter(cfg.log_interval)
        self._init_run()
        self.coord.print(
            f"[lm_trainer] params={param_count(self.model):,} "
            f"device={self.device} dtype={cfg.precision.dtype} "
            f"attn={lm.attn_impl} seq_len={lm.seq_len} "
            f"optimizer={cfg.optimizer.name}"
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
        # rank reads its contiguous slice of every global batch.
        shard = dict(process_index=self.coord.process_index,
                     process_count=self.coord.process_count)
        return (TokenLoader(train, global_batch_size=self.train_gbs,
                            shuffle=True, seed=seed,
                            max_steps=self.cfg.data.max_steps_per_epoch, **shard),
                TokenLoader(evals, global_batch_size=self.eval_gbs,
                            shuffle=False, seed=seed, **shard))

    def host_batch(self, batch: dict) -> dict:
        """A loader batch shifted into tokens and targets."""
        return {k: np.ascontiguousarray(v)
                for k, v in make_lm_batch(batch["tokens"]).items()}

    # -- eval ---------------------------------------------------------------
    def evaluate(self, loader: TokenLoader) -> float:
        """Mean held-out perplexity: exp of the mean over batches of each
        global batch's token CE (the ranks' slices averaged in one
        all-reduce), with one host read for the whole pass; with the
        parameters' EMA when ``optimizer.ema_decay`` and ``eval_with_ema``
        are set; at ZeRO stage 3 through the gathered parameters."""
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
