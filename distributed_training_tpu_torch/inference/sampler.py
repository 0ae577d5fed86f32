"""Autoregressive generation: the KV-cache decode loop and the sampling
transforms.

The port of ``distributed_training_tpu/inference/sampler.py``:

- **Prefill**: one decode-mode forward over the whole prompt fills every
  layer's cache (``parallel/ring_attention.py``'s ``decode_attend``, the
  plain product JAX's prefill runs too: no flash kernel).
- **The decode loop**: N − 1 one-token steps, each emitting the token it
  carries and decoding the next, then the last carried token, as JAX's
  ``lax.scan``. Here it is an eager Python loop over one cache the model
  updates in place; its index is a host int, so no step reads the card
  until the tokens are copied out at the end. Each step is a few dozen
  small kernel launches: the loop is bound by the host, not the card (a
  CUDA graph of the step is later work, ROADMAP.md queue B).
- **The cache** is right-sized to the call: ``prompt + max_new_tokens``
  slots (``TransformerLM.init_cache``). After ``eos_id`` a row emits
  ``pad_id`` (a carried ``finished`` mask, as in JAX; the loop never
  breaks early).

Sampling: greedy (``temperature=0``, ``argmax``: the first of equal
maxima, as ``jnp.argmax``), temperature, top-k and nucleus (top-p),
composed in that order. Randomness comes from an explicit
``torch.Generator``: the caller's, or one seeded from the
:class:`Generator`'s seed and a call counter (JAX folds the counter into
its key), so repeated calls without one differ and a seeded call repeats.
Only greedy decoding can match JAX token for token (their random streams
differ).

**Per-row draws** (:func:`sample_rows`, the serving engine's sampler):
JAX's engine samples each row under ``fold_in(fold_in(seed, uid),
position)``, so a request's tokens do not depend on the batch it shares,
the page size or the prefill chunk. A ``torch.Generator`` draws a whole
batch from one stream, which has no such property; here each row's
uniform is a counter-based integer hash of its key (:func:`stream_key`
of the seed and the request's uid, host-side, then :func:`row_keys`
folds in the position on the device), and the token is the inverse-CDF
pick over the row's filtered probabilities: static shapes, no host
generator per row, the same row arithmetic whatever the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Decode-time knobs (JAX's fields, defaults and validation)."""

    max_new_tokens: int = 128
    temperature: float = 1.0  # 0 → greedy (argmax)
    top_k: int | None = None
    top_p: float | None = None
    eos_id: int | None = None  # stop emitting after this token appears
    pad_id: int = 0            # filler after EOS

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature} "
                "(negative values would invert the distribution)")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits to -inf. ``[..., V]`` → ``[..., V]``."""
    if k < 1:
        raise ValueError(f"top_k must be >= 1, got {k}")
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the vocabulary sorted
    by probability whose mass reaches ``p`` (the most probable token
    always survives: the exclusive cumulative sum is 0 at rank 0)."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {p}")
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    exclusive_cum = torch.cumsum(probs, dim=-1) - probs
    dropped = exclusive_cum >= p
    # The threshold is the smallest kept logit.
    thresh = sorted_logits.masked_fill(dropped, float("inf")).amin(-1, keepdim=True)
    return logits.masked_fill(logits < thresh, float("-inf"))


def sample_token(generator: torch.Generator | None, logits: torch.Tensor,
                 cfg: SampleConfig) -> torch.Tensor:
    """Next-token ids ``[B]`` from logits ``[B, V]`` per ``cfg``; the draw
    comes from ``generator`` (unused when greedy)."""
    logits = logits.float()
    if cfg.temperature == 0.0:
        return logits.argmax(-1)
    logits = logits / cfg.temperature
    if cfg.top_k is not None:
        logits = apply_top_k(logits, cfg.top_k)
    if cfg.top_p is not None:
        logits = apply_top_p(logits, cfg.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


_M32 = 0xFFFFFFFF


def _mix32(h):
    """A 32-bit integer finaliser (xor-shift, multiply) on a Python int or
    a non-negative int64 tensor; each multiplier is below 2**31, so the
    products of 32-bit values never leave int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 16)


def stream_key(seed: int, uid: int) -> int:
    """A request's sampling stream, keyed by the engine seed and its uid
    (JAX's ``fold_in(seed_key, uid)``), as a host int below 2**32."""
    return _mix32(_mix32((int(seed) & _M32) ^ 0x9E3779B9) ^ (int(uid) & _M32))


def row_keys(streams: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Each row's key: its stream with its position folded in (JAX's
    ``fold_in(stream, position)``); long tensors of one shape."""
    return _mix32(_mix32(streams ^ (positions & _M32)) ^ 0x85EBCA6B)


def sample_rows(logits: torch.Tensor, keys: torch.Tensor,
                cfg: SampleConfig) -> torch.Tensor:
    """Next-token ids ``[N]`` from logits ``[N, V]`` per ``cfg``, row ``i``
    drawn from ``keys[i]`` alone (:func:`row_keys`): the uniform
    ``(key >> 8) / 2**24``, then the first token whose cumulative
    probability exceeds it times the row's total. Greedy is ``argmax``."""
    logits = logits.float()
    if cfg.temperature == 0.0:
        return logits.argmax(-1)
    logits = logits / cfg.temperature
    if cfg.top_k is not None:
        logits = apply_top_k(logits, cfg.top_k)
    if cfg.top_p is not None:
        logits = apply_top_p(logits, cfg.top_p)
    probs = torch.softmax(logits, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = (keys >> 8).float() * (1.0 / (1 << 24)) * cdf[:, -1]
    tok = torch.searchsorted(cdf, u[:, None], right=True)[:, 0]
    # Rounding can put u at the total: take the last token with mass.
    v = probs.shape[-1]
    last = v - 1 - (probs > 0).flip(-1).int().argmax(-1)
    return torch.minimum(tok, last)


def check_unsharded(model: Any) -> None:
    """Decode needs an unsharded model (``Generator``, ``BeamSearcher``)."""
    if getattr(model, "seq_axis", None) is not None:
        raise ValueError(
            "generation uses the unsharded decode path; build the model "
            "with seq_axis=None (params are layout-identical)")


class CacheBudgetError(ValueError):
    """A request's tokens do not fit the KV cache (a ``ValueError``, so
    callers that catch that keep working)."""


def cache_budget(model: Any, max_len: int | None = None) -> int:
    """Token capacity of one sequence's KV cache (prompt and generated):
    ``model.max_len``, capped further by ``max_len``."""
    budget = int(model.max_len)
    if max_len is not None:
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        budget = min(budget, int(max_len))
    return budget


def check_cache_fits(model: Any, prompt_len: int, max_new_tokens: int) -> None:
    """:func:`cache_budget` for one generate call."""
    total = prompt_len + max_new_tokens
    budget = cache_budget(model)
    if total > budget:
        raise CacheBudgetError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) = "
            f"{total} exceeds the KV cache (max_len={budget})")


def as_prompt(prompt_tokens, device) -> torch.Tensor:
    """A prompt (``[Tp]`` or ``[B, Tp]`` ints) as a ``[B, Tp]`` long
    tensor on ``device``."""
    prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int64), device=device)
    return prompt[None, :] if prompt.ndim == 1 else prompt


def prefill(model, prompt: torch.Tensor, new_tokens: int):
    """A cache of ``prompt + new_tokens`` slots filled by one decode-mode
    forward over the prompt; returns ``(logits [B, Tp, V], cache)``."""
    b, t = prompt.shape
    cache = model.init_cache(b, t + new_tokens, device=prompt.device)
    positions = torch.arange(t, device=prompt.device).expand(b, t)
    return model(prompt, positions, cache=cache), cache


def decode_step(model, tokens: torch.Tensor, pos: int, cache):
    """One decode-mode forward of ``tokens`` ``[B]`` at position ``pos``;
    returns the last logits ``[B, V]``."""
    b = tokens.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=tokens.device)
    return model(tokens[:, None], positions, cache=cache)[:, -1]


class Generator:
    """Prompt → completion generation for a ``TransformerLM``, whose
    weights it reads as they are (the model is put in eval mode).

    >>> gen = Generator(model, SampleConfig(max_new_tokens=64))
    >>> out = gen(prompt_tokens)   # [B, Tp] ints -> [B, 64] numpy int64
    """

    def __init__(self, model: Any, cfg: SampleConfig, seed: int = 0):
        check_unsharded(model)
        self.model = model.eval()
        self.cfg = cfg
        self.seed = int(seed)
        self._calls = 0

    def _generator(self, device) -> torch.Generator:
        """A fresh stream per call: the seed with the call counter folded
        in, so calls without a generator do not repeat each other."""
        state = np.random.SeedSequence([self.seed, self._calls]).generate_state(1)[0]
        self._calls += 1
        return torch.Generator(device=device).manual_seed(int(state))

    @torch.no_grad()
    def __call__(self, prompt_tokens, generator: torch.Generator | None = None
                 ) -> np.ndarray:
        cfg, model = self.cfg, self.model
        prompt = as_prompt(prompt_tokens, model.pos_embed.device)
        b, t_prompt = prompt.shape
        check_cache_fits(model, t_prompt, cfg.max_new_tokens)
        if generator is None:
            generator = self._generator(prompt.device)
        logits, cache = prefill(model, prompt, cfg.max_new_tokens)
        tok = sample_token(generator, logits[:, -1], cfg)
        pad = torch.full_like(tok, cfg.pad_id)
        finished = torch.zeros_like(tok, dtype=torch.bool)
        out = []
        # N - 1 steps emit tokens 0..N-2 (each emits its carried token and
        # decodes the next); the last carried token is emitted directly.
        for i in range(cfg.max_new_tokens - 1):
            out.append(torch.where(finished, pad, tok))
            next_tok = sample_token(generator, decode_step(model, tok, t_prompt + i, cache),
                                    cfg)
            if cfg.eos_id is not None:
                finished = finished | (tok == cfg.eos_id)
            tok = next_tok
        out.append(torch.where(finished, pad, tok))
        return torch.stack(out, dim=1).cpu().numpy()
