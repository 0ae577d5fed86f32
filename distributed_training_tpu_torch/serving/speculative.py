"""Speculative decoding: draft-and-verify over the slot scheduler.

The port of ``distributed_training_tpu/serving/speculative.py``. A cheap
**drafter** proposes up to ``spec_k`` tokens per decode slot an
iteration, and the target model verifies all ``spec_k + 1`` positions in
one forward: the decode lane widens from ``[max_batch, 1]`` to a fixed
``[max_batch, spec_k + 1]`` verify window (``serving/engine.py``). When
the drafter is right one forward lands several tokens; when it is wrong
the iteration lands one, as the plain step does.

**Acceptance is lossless by construction.** Each row samples under a key
of (seed, uid, position) (``inference/sampler.py``'s ``row_keys``), so
the verify window computes at every position ``i`` the token the
sequential loop would have sampled there, ``t_i``, and accepts draft
position ``i`` iff every draft up to it matched the target stream
(``d_1..d_i == t_0..t_{i-1}``). An accepted prefix emits the target's
own samples ``t_0..t_a`` (the last is the free correction or bonus
token). Every emitted token is the sequential path's, greedy and sampled
alike: drafts decide how many positions one forward computes, never what
any of them is.

**Fixed shapes.** The window width is ``spec_k + 1``; the accept length
is an argmax over a mismatch mask with a sentinel column (all-match
accepts ``k``); rows past a slot's useful draft count (the budget clamp,
a short proposal, an inactive lane) are masked by validity. The rejected
suffix rolls back on the host alone: the write head does not advance
past the accepted prefix, and the next window's leading rows overwrite
the stale K/V before any valid query can attend it.

Two drafters behind one protocol:

- :class:`NGramDrafter` (default): prompt lookup. Match the context's
  longest recent suffix n-gram earlier in the context and propose the
  tokens that followed it. No parameters, no device work.
- :class:`GPTDrafter`: a GPT draft model proposing greedily over a fixed
  right-aligned, pad-filled token window: ``k`` full forwards of the
  model with no cache, each appending its argmax (JAX's ``lax.scan`` of
  the same steps). With ``mirror_target=True`` (what
  ``spec_drafter='gpt'`` builds) it self-drafts with the serving model
  itself, so the hot-swap barrier's new weights are the drafter's too.

A wrong, stale or empty proposal costs acceptance rate, never
correctness. Per request, the verify window bills to the ledger's
``decode`` cause, the host accept bookkeeping to ``spec_rollback``, and
the draft economics to the ``spec_draft``/``spec_accept`` token counters.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

_EMPTY = np.zeros((0,), np.int32)


@runtime_checkable
class Drafter(Protocol):
    """Per-slot draft proposer for the engine's verify window.

    Implementations are deterministic pure functions of the context
    (plus their own weights): proposals depend only on the slot's own
    token stream, so acceptance does not depend on the batch."""

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens (int32 [<=k]) for
        ``context`` (prompt + emitted tokens, host int32 [n]). Fewer (or
        zero) proposals shrink the window's valid width."""
        ...

    def on_weights_swap(self, params: Any, epoch: int) -> None:
        """Hot-swap barrier notification (engine thread, inside the
        barrier): the target model now serves ``params``. Drafters
        holding state derived from the target's weights roll it here."""
        ...


class NGramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most
    recent earlier occurrence of the context's suffix n-gram.

    Backs off from ``max_ngram`` down to ``min_ngram``: the longest
    suffix with an earlier match wins; within one ``n``, the most recent
    match wins.

    ``fallback_repeat`` (default on) pads short or empty lookups to the
    full ``k`` by repeating the last proposed (else last context) token:
    the window is fixed-width, so an empty draft row is compute paid for
    with no bet on it.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 fallback_repeat: bool = True):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.fallback_repeat = bool(fallback_repeat)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        # graftlint: disable=hot-path-transfer -- context is host numpy by protocol (the engine's slot bookkeeping); input normalization only
        ctx = np.asarray(context, np.int32).reshape(-1)
        out = _EMPTY
        n_ctx = ctx.size
        for n in range(min(self.max_ngram, n_ctx - 1),
                       self.min_ngram - 1, -1):
            pat = ctx[n_ctx - n:]
            # Every earlier start whose n-gram equals the suffix (the
            # suffix's own start excluded), vectorized: this runs per
            # decoding slot per iteration.
            grams = np.lib.stride_tricks.sliding_window_view(
                ctx, n)[: n_ctx - n]
            hits = np.flatnonzero((grams == pat).all(axis=1))
            if hits.size:
                s = int(hits[-1])  # most recent match wins
                out = ctx[s + n: s + n + k].astype(np.int32)
                break
        if self.fallback_repeat and out.size < k and n_ctx:
            last = out[-1] if out.size else ctx[-1]
            out = np.concatenate(
                [out, np.full((k - out.size,), last, np.int32)])
        return out

    def on_weights_swap(self, params: Any, epoch: int) -> None:
        pass  # context-only: nothing derived from the target weights


class GPTDrafter:
    """GPT draft model: greedy proposals over a fixed token window.

    The context's last ``window`` tokens sit right-aligned in a
    pad-filled ``[window]`` buffer, and ``k`` full forwards of ``model``
    (no cache) each append the argmax of the last row's float32 logits
    and drop the oldest token. Positions are window-local
    (0..window-1), as in JAX: a mispositioned draft is only rejected.

    ``model`` is any ``TransformerLM``: a separate small draft model, or
    (``mirror_target=True``, what the engine builds for
    ``spec_drafter='gpt'``) the serving model itself, window-truncated.
    A mirror drafter shares the model object, so the leaves the hot-swap
    barrier installs are its weights at once; :meth:`on_weights_swap`
    records them. A separate draft model keeps its own weights.
    """

    def __init__(self, model: Any, *, window: int = 16, pad_id: int = 0,
                 mirror_target: bool = False):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window > int(model.max_len):
            raise ValueError(
                f"draft window {window} exceeds the draft model's "
                f"positional table (max_len={model.max_len})")
        self.model = model
        self.window = int(window)
        self.pad_id = int(pad_id)
        self.mirror_target = bool(mirror_target)
        self.params = None
        self.epoch = None

    @torch.no_grad()
    def _propose_impl(self, window_tokens: torch.Tensor, k: int) -> torch.Tensor:
        """``k`` greedy steps over the rolling window (JAX's ``lax.scan``
        of the same step); the proposals ``[k]`` on the model's device."""
        win = window_tokens
        out = []
        for _ in range(k):
            logits = self.model(win[None])
            nxt = logits[0, -1].float().argmax()
            out.append(nxt)
            win = torch.cat([win[1:], nxt[None]])
        return torch.stack(out)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        # graftlint: disable=hot-path-transfer -- context is host numpy by protocol; input normalization only
        ctx = np.asarray(context, np.int64).reshape(-1)[-self.window:]
        win = np.full((self.window,), self.pad_id, np.int64)
        win[self.window - ctx.size:] = ctx
        device = self.model.pos_embed.device
        toks = self._propose_impl(torch.from_numpy(win).to(device), int(k))
        # graftlint: disable=hot-path-transfer -- the draft landing: proposals must reach the host to assemble the verify window
        return toks.cpu().numpy().astype(np.int32)

    def on_weights_swap(self, params: Any, epoch: int) -> None:
        """Record the barrier's weights when self-drafting: the shared
        model already serves them. A separate draft model keeps its own."""
        if self.mirror_target:
            self.params, self.epoch = params, epoch


def make_drafter(cfg, model: Any):
    """``ServeConfig.spec_drafter``'s backend for an engine: ``ngram``
    needs nothing beyond the config; ``gpt`` self-drafts with the serving
    model (mirror mode). A separate small draft model bypasses this:
    ``Engine(model, cfg, drafter=GPTDrafter(draft_model, window=...))``."""
    if cfg.spec_drafter == "ngram":
        return NGramDrafter(max_ngram=cfg.spec_ngram)
    if cfg.spec_drafter == "gpt":
        return GPTDrafter(
            model, window=min(int(cfg.spec_draft_window), int(model.max_len)),
            pad_id=cfg.pad_id, mirror_target=True)
    raise ValueError(f"unknown spec_drafter {cfg.spec_drafter!r}")


def accept_counts(window_tokens: np.ndarray, targets: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Host/numpy mirror of the engine's accept formulation (the test
    oracle for the device argmax over the mismatch mask): per batch row,
    the number of leading drafts (``window_tokens[:, 1:]``) that match
    the target stream (``targets[:, :-1]``) within the valid width."""
    mismatch = (window_tokens[:, 1:] != targets[:, :-1]) | ~valid[:, 1:]
    sentinel = np.ones((mismatch.shape[0], 1), bool)
    return np.argmax(np.concatenate([mismatch, sentinel], axis=1), axis=1)


def truncate_at_eos(tokens: np.ndarray, eos_id: int | None) -> np.ndarray:
    """Cut an accepted token run at its first EOS (inclusive): the
    sequential loop would have stopped there."""
    if eos_id is None:
        return tokens
    hits = np.flatnonzero(tokens == eos_id)
    return tokens[: hits[0] + 1] if hits.size else tokens
