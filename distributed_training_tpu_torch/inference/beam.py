"""Beam search over the KV-cache decode path.

The port of ``distributed_training_tpu/inference/beam.py``: keep the K
continuations of highest log-probability per prompt, expand all beams in
one batched forward (the model sees batch ``B·K``), and choose the top K
of the K·V candidates each step, reordering the cache's rows by parent
(``KVCache.select_rows``). The prompt is prefilled once at batch B and its
cache rows repeated K-fold.

A finished beam (it emitted ``eos_id``) is frozen: every continuation but
``pad_id`` is masked and the pad adds no log-probability, so its score
stays while the live beams compete. The result is the final top K by
score, with an optional GNMT length penalty at the selection. Ties go to
the lower flat index, as ``lax.top_k`` and ``jnp.argsort`` break them
(stable sorts).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from distributed_training_tpu_torch.inference.sampler import (
    as_prompt,
    check_cache_fits,
    check_unsharded,
    decode_step,
    prefill,
)

NEG_INF = -1e30  # large and finite: -inf - -inf would be nan in the masks


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """Beam-search knobs (JAX's fields, defaults and validation)."""

    num_beams: int = 4
    max_new_tokens: int = 128
    eos_id: int | None = None
    pad_id: int = 0
    # GNMT length penalty alpha: scores are divided by
    # ((5 + len) / 6) ** alpha at the final selection; 0 = log-prob alone.
    length_penalty: float = 0.0

    def __post_init__(self):
        if self.num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {self.num_beams}")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class BeamSearcher:
    """Beam search for a ``TransformerLM`` (put in eval mode).

    >>> bs = BeamSearcher(model, BeamConfig(num_beams=4, max_new_tokens=32))
    >>> tokens, scores = bs(prompt)   # [B, Tp] -> ([B, K, 32], [B, K])

    Sequences come back best first along K; ``scores`` are total
    log-probabilities (length-penalised if configured).
    """

    def __init__(self, model: Any, cfg: BeamConfig):
        check_unsharded(model)
        self.model = model.eval()
        self.cfg = cfg

    @staticmethod
    def _log_probs(logits: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(logits.float(), dim=-1)

    @torch.no_grad()
    def __call__(self, prompt_tokens) -> tuple[np.ndarray, np.ndarray]:
        cfg, model = self.cfg, self.model
        prompt = as_prompt(prompt_tokens, model.pos_embed.device)
        b, t_prompt = prompt.shape
        k, dev = cfg.num_beams, prompt.device
        check_cache_fits(model, t_prompt, cfg.max_new_tokens)
        logits, cache = prefill(model, prompt, cfg.max_new_tokens)
        cache.select_rows(torch.arange(b, device=dev).repeat_interleave(k))
        vocab = logits.shape[-1]
        step_lp = self._log_probs(logits[:, -1])[:, None, :].expand(b, k, vocab)
        # Only beam 0 is live at first: the beams share the prompt, and K
        # live copies would fill the beam with duplicates.
        scores = torch.where(torch.arange(k, device=dev) == 0, 0.0, NEG_INF
                             ).expand(b, k).float()
        seqs = torch.full((b, k, cfg.max_new_tokens), cfg.pad_id, dtype=torch.long,
                          device=dev)
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        lengths = torch.zeros((b, k), dtype=torch.float32, device=dev)  # incl. EOS
        pad_only = torch.full((vocab,), NEG_INF, device=dev)
        pad_only[cfg.pad_id] = 0.0
        offset = torch.arange(b, device=dev)[:, None] * k

        for step in range(cfg.max_new_tokens):
            # One expansion: frozen beams emit pad at no cost; the top K of
            # the K·V candidates; every beam-major state reordered by parent.
            step_lp = torch.where(finished[..., None], pad_only, step_lp)
            cand = (scores[..., None] + step_lp).reshape(b, k * vocab)
            scores, top_idx = _top_k_stable(cand, k)
            parent, token = top_idx // vocab, top_idx % vocab
            seqs = torch.gather(seqs, 1, parent[..., None].expand_as(seqs)).clone()
            seqs[:, :, step] = token
            finished = torch.gather(finished, 1, parent)
            # The emitted token counts toward the length (EOS included)
            # unless the beam was already frozen (pad is a real token too).
            lengths = torch.gather(lengths, 1, parent) + (~finished).float()
            if cfg.eos_id is not None:
                finished = finished | (token == cfg.eos_id)
            if step == cfg.max_new_tokens - 1:
                break  # the last selection needs no forward
            cache.select_rows((offset + parent).reshape(-1))
            step_lp = self._log_probs(decode_step(
                model, token.reshape(-1), t_prompt + step, cache)).reshape(b, k, vocab)

        ranked = scores
        if cfg.length_penalty:
            ranked = scores / ((5.0 + lengths.clamp_min(1.0)) / 6.0) ** cfg.length_penalty
        order = torch.argsort(-ranked, dim=-1, stable=True)
        seqs = torch.gather(seqs, 1, order[..., None].expand_as(seqs))
        ranked = torch.gather(ranked, 1, order)
        return seqs.cpu().numpy(), ranked.cpu().numpy()
