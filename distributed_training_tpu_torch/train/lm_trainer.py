"""LMTrainer: transformer-LM training on one device.

The port of ``distributed_training_tpu/train/lm_trainer.py`` for its
unsharded (``tensor/dp`` on one device) strategy. ``LMTrainer(cfg).fit()``
returns the JAX trainer's keys: ``final_perplexity``, ``preempted``,
``last_metrics`` and ``steps`` (committed updates).

It runs on the card unless ``device="cpu"`` is passed, and raises when
there is no card and no such request. With ``cfg.lm.attn_impl="flash"``
every layer's attention runs the K2 (forward) and K3 (backward) kernels
on the card. Checkpoints use the port's format and commit protocol
(``checkpoint.py``), written synchronously. Fields whose behaviour is not
ported raise ``NotImplementedError``: the image trainer's list, plus
pipeline microbatches and virtual stages, chunked CE and the
saved-probabilities CE.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import TrainConfig, effective_batch_sizes
from distributed_training_tpu_torch.data.lm_text import (
    TokenLoader,
    byte_corpus,
    synthetic_tokens,
)
from distributed_training_tpu_torch.data.pipeline import SkipBatches, to_device
from distributed_training_tpu_torch.models import get_model
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
    MetricMeter,
    data_parallel_fields,
    refuse_unported,
    unported_fields,
)
from distributed_training_tpu_torch.utils.device import resolve_device, set_fp32_math


class LMTrainer:
    """Epoch-loop engine for :class:`TransformerLM` on one device."""

    def __init__(self, cfg: TrainConfig, device: str | torch.device | None = None):
        lm = cfg.lm
        refuse_unported({
            **unported_fields(cfg),
            **data_parallel_fields(cfg),
            "lm.num_microbatches > 1": lm.num_microbatches != 1,
            "lm.virtual_stages > 1": lm.virtual_stages != 1,
            "lm.ce_chunk_size": lm.ce_chunk_size is not None,
            "lm.ce_save_probs": lm.ce_save_probs,
        })
        self.cfg = cfg
        self.device = resolve_device(device)
        set_fp32_math()
        self.world_size = 1
        policy = Policy.from_config(cfg.precision)
        self.model = get_model(
            "transformer_lm", num_classes=lm.vocab_size,
            dtype=policy.compute_dtype, num_layers=lm.num_layers,
            num_heads=lm.num_heads, hidden_dim=lm.hidden_dim,
            mlp_ratio=lm.mlp_ratio, max_len=lm.max_len,
            attn_impl=lm.attn_impl,
            logits_dtype=parse_logits_dtype(lm.logits_dtype),
            head_bias=lm.head_bias,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        self.train_gbs, self.eval_gbs, self.grad_accum = effective_batch_sizes(
            cfg, self.world_size)
        self.tx = make_optimizer(cfg.optimizer, cfg.scheduler, self.world_size)
        self.state = TrainState.create(self.model, self.tx,
                                       LossScaleState.create(cfg.precision))
        self.train_step = make_lm_train_step(
            grad_accum_steps=self.grad_accum,
            accuracy_metric=lm.metrics_accuracy, max_len=lm.max_len)
        self.eval_loss = make_lm_eval_fn()
        self.meter = MetricMeter(cfg.log_interval)
        self._global_step = 0
        print(f"[lm_trainer] params={param_count(self.model):,} "
              f"device={self.device} dtype={cfg.precision.dtype} "
              f"attn={lm.attn_impl} seq_len={lm.seq_len} "
              f"optimizer={cfg.optimizer.name}"
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
        # Train consumes effective batches; eval stays micro-sized.
        return (TokenLoader(train, global_batch_size=self.train_gbs,
                            shuffle=True, seed=seed,
                            max_steps=self.cfg.data.max_steps_per_epoch),
                TokenLoader(evals, global_batch_size=self.eval_gbs,
                            shuffle=False, seed=seed))

    def place_batch(self, host_batch: dict) -> dict:
        """A loader batch, shifted into tokens and targets, on the device."""
        batch = make_lm_batch(host_batch["tokens"])
        return to_device({k: np.ascontiguousarray(v) for k, v in batch.items()},
                         self.device)

    # -- train --------------------------------------------------------------
    def train_epoch(self, epoch: int, loader: TokenLoader,
                    skip_steps: int = 0) -> dict:
        """One epoch; ``skip_steps`` drops that many leading batches of the
        epoch's deterministic shuffle (step-accurate resume)."""
        loader.set_epoch(epoch)
        if skip_steps:
            print(f"[lm_trainer] resuming epoch {epoch} at step {skip_steps}")
            loader = SkipBatches(loader, skip_steps)
        for batch in loader:
            metrics = self.train_step(self.state, self.place_batch(batch))
            self._global_step += 1
            self.meter.push(self._global_step, metrics)
        self.meter.flush()
        print(f"[lm_train] epoch {epoch + 1}: "
              + " ".join(f"{k}={v:.4g}" for k, v in self.meter.last.items()))
        return self.meter.last

    # -- eval ---------------------------------------------------------------
    def evaluate(self, loader: TokenLoader) -> float:
        """Mean held-out perplexity (exp of the mean of the batches' token
        CE), with one host read for the whole pass; with the parameters'
        EMA when ``optimizer.ema_decay`` and ``eval_with_ema`` are set."""
        ema = self.cfg.optimizer.ema_decay is not None and self.cfg.eval_with_ema
        with self.state.ema_weights() if ema else contextlib.nullcontext():
            losses = [self.eval_loss(self.model, self.place_batch(b)) for b in loader]
        if not losses:
            raise ValueError(
                f"eval loader yielded no batches (eval_sequences "
                f"{self.cfg.lm.eval_sequences} < global batch "
                f"{loader.global_batch_size}? drop_last discards partials)")
        return float(np.exp(np.mean(torch.stack(losses).tolist())))

    # -- full run -----------------------------------------------------------
    def fit(self) -> dict:
        cfg = self.cfg
        train_loader, eval_loader = self.make_loaders()
        start_epoch = start_step = 0
        resume = ckpt_lib.resolve_resume(cfg.checkpoint)
        if resume >= 0:
            start_epoch, start_step = ckpt_lib.restore_checkpoint(
                cfg.checkpoint.directory, resume, self.state)
            self._global_step = self.state.step
            print(f"[lm_trainer] resumed at epoch {start_epoch}")
        ppl = None
        for epoch in range(start_epoch, cfg.num_epochs):
            self.train_epoch(epoch, train_loader,
                             skip_steps=start_step if epoch == start_epoch else 0)
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                ppl = self.evaluate(eval_loader)
                print(f"[eval] epoch {epoch + 1}: perplexity {ppl:.4f}")
            if cfg.checkpoint.interval and (epoch + 1) % cfg.checkpoint.interval == 0:
                ckpt_lib.save_checkpoint(cfg.checkpoint.directory, epoch, self.state)
                ckpt_lib.prune_checkpoints(cfg.checkpoint.directory,
                                           cfg.checkpoint.keep)
        return {"final_perplexity": ppl, "preempted": False,
                "last_metrics": self.meter.last, "steps": self.state.step}
