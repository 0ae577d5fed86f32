"""The port's speculative decoding (``serving/speculative.py`` and the
engine's verify window) against the JAX package's.

At micro size (``transformer_lm`` with 2 layers, 2 heads, hidden 32,
vocab 61, max_len 64; the port's seeded weights carried into JAX's tree
through ``bridge.py``):

1. **Host pieces**: ``NGramDrafter.propose`` and ``accept_counts`` on the
   same contexts and windows give JAX's arrays, and the engine's device
   accept (``Engine._accept_len``) gives ``accept_counts``'.
2. **The window's attention**: ``paged_decode_attend`` with several query
   rows a slot (a causal mask inside the window, padding rows clamped
   under the table and invalid, one row past its table) against JAX's
   ``_paged_decode_attend``, and the legacy slots' per-row write heads
   with a window of rows against JAX's ``vmap`` of ``_decode_attend``:
   outputs at rtol 1e-5 / atol 1e-6, the pools exactly, the NaN poison on
   the same rows.
3. **Lossless acceptance**: the paged and the legacy engines with
   ``spec_k`` > 0 (the n-gram drafter and the GPT self-drafter) give
   their non-speculative tokens exactly, greedy and sampled; JAX's
   speculative engine gives the same greedy tokens and the same drafted
   and accepted counts.

One JAX engine run serves the module.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel.ring_attention import PagedKV as JPagedKV
from distributed_training_tpu.parallel.ring_attention import RingSelfAttention as JAttn
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu.serving import speculative as jspec
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.parallel.ring_attention import (
    KVCache,
    PagedCache,
    PagedKV,
    decode_attend,
    paged_decode_attend,
)
from distributed_training_tpu_torch.serving import Engine
from distributed_training_tpu_torch.serving import speculative as tspec

torch.set_num_threads(1)

VOCAB = 61
LM = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=64,
          head_bias=True)
N_NEW = 12
H, HD, PS = 2, 8, 4


def _model():
    return get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM).eval()


@pytest.fixture(scope="module")
def lm():
    return _model()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(1)
    # Repetitive prompts give the n-gram drafter something to match.
    base = [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in (3, 5, 4, 6)]
    return [np.tile(b, 3)[:n] for b, n in zip(base, (9, 11, 7, 13))] + \
        [rng.randint(0, VOCAB, size=5).astype(np.int32)]


def _serve(model, prompts, **kw):
    eng = Engine(model, ServeConfig(**{"max_batch": 2, "prefill_bucket": 8,
                                       "max_new_tokens": N_NEW, **kw}))
    for p in prompts:
        eng.submit(p)
    done = {f.uid: f.tokens.tolist() for f in eng.run()}
    eng.check_balanced()
    return done, eng.stats()


# -- host pieces ---------------------------------------------------------------
def test_ngram_drafter_matches_jax():
    rng = np.random.RandomState(0)
    for trial in range(60):
        n = rng.randint(1, 30)
        ctx = rng.randint(0, 1 + trial % 7 * 3, size=n).astype(np.int32)
        for max_ngram, k, repeat in ((3, 4, True), (2, 3, False), (1, 5, True)):
            want = jspec.NGramDrafter(max_ngram=max_ngram, fallback_repeat=repeat).propose(ctx, k)
            got = tspec.NGramDrafter(max_ngram=max_ngram, fallback_repeat=repeat).propose(ctx, k)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def test_accept_counts_match_jax_and_the_device_accept():
    rng = np.random.RandomState(2)
    for w in (1, 2, 5):
        tok = rng.randint(0, 3, size=(7, w))
        tgt = rng.randint(0, 3, size=(7, w))
        tgt[:, :-1] = np.where(rng.rand(7, w - 1) < 0.6, tok[:, 1:], tgt[:, :-1])
        valid = np.arange(w)[None, :] < rng.randint(1, w + 1, size=(7, 1))
        want = jspec.accept_counts(tok, tgt, valid)
        np.testing.assert_array_equal(tspec.accept_counts(tok, tgt, valid), want)
        dev = Engine._accept_len(torch.from_numpy(tok), torch.from_numpy(tgt),
                                 torch.from_numpy(valid))
        np.testing.assert_array_equal(dev.numpy(), want)


def test_truncate_at_eos_matches_jax():
    for toks, eos in (([1, 2, 3], 2), ([1, 2, 3], None), ([4, 4], 4), ([5], 7)):
        a = np.asarray(toks, np.int32)
        np.testing.assert_array_equal(tspec.truncate_at_eos(a, eos), jspec.truncate_at_eos(a, eos))


# -- the window's attention ----------------------------------------------------
class _JaxAttend(JAttn):
    """JAX's attention with its two decode attends as the entry point."""

    @nn.compact
    def __call__(self, q, k, v, pages=None):
        if pages is None:
            return self._decode_attend(q, k, v, HD)
        return self._paged_decode_attend(q, k, v, HD, pages)


def test_paged_window_with_clamped_padding_matches_jax():
    """Three slots, a window of 4 rows each: slot 0 all valid, slot 1 two
    valid rows and two padding rows clamped to the table's last position
    (JAX's _draft_window rule), slot 2 a valid row past its table (poisoned
    alone)."""
    rng = np.random.RandomState(5)
    n_pages, pps, w = 14, 3, 4
    l_all = pps * PS
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    positions = np.stack([np.arange(3, 3 + w), np.minimum(np.arange(9, 9 + w), l_all - 1),
                          np.arange(l_all - 1, l_all - 1 + w)])
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 0, 0]], bool)
    pool_k = rng.randn(n_pages * PS, H, HD).astype(np.float32)
    pool_v = rng.randn(n_pages * PS, H, HD).astype(np.float32)
    q, k, v = (rng.randn(3, w, H, HD).astype(np.float32) for _ in range(3))
    mod = _JaxAttend(num_heads=H, causal=True, kv_page_size=PS, kv_pages=n_pages)
    want, state = mod.apply(
        {"cache": {"key_pages": jnp.asarray(pool_k), "value_pages": jnp.asarray(pool_v)}},
        q, k, v, JPagedKV(jnp.asarray(table, jnp.int32), jnp.asarray(positions, jnp.int32),
                          jnp.asarray(valid)), mutable=["cache"])
    want = np.asarray(want)
    cache = PagedCache([torch.from_numpy(pool_k.copy())], [torch.from_numpy(pool_v.copy())], PS)
    got = paged_decode_attend(*(torch.from_numpy(t) for t in (q, k, v)), cache, 0,
                              PagedKV(torch.from_numpy(table), torch.from_numpy(positions),
                                      torch.from_numpy(valid))).numpy()
    np.testing.assert_array_equal(cache.keys[0].numpy()[PS:],
                                  np.asarray(state["cache"]["key_pages"])[PS:])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2, 1]).all() and np.isfinite(got[:2]).all()
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)


def test_legacy_window_rows_match_jax_vmap():
    """The legacy slots' verify window: each lane writes its W rows at its
    own head (one lane's window runs past the cache and is poisoned
    alone), against JAX's vmap with each lane's cache_index forced."""
    rng = np.random.RandomState(3)
    b, length, w = 3, 12, 3
    ck = rng.randn(b, 1, length, H, HD).astype(np.float32)
    cv = rng.randn(b, 1, length, H, HD).astype(np.float32)
    heads = np.array([0, 5, length - 2])
    q, k, v = (rng.randn(b, 1, w, H, HD).astype(np.float32) for _ in range(3))
    mod = _JaxAttend(num_heads=H, causal=True, cache_len=length)

    def lane(ck_s, cv_s, i_s, q_s, k_s, v_s):
        out, state = mod.apply(
            {"cache": {"cached_key": ck_s, "cached_value": cv_s, "cache_index": i_s}},
            q_s, k_s, v_s, mutable=["cache"])
        return out, state["cache"]["cached_key"]

    want, want_k = jax.vmap(lane)(ck, cv, jnp.asarray(heads, jnp.int32), q, k, v)
    cache = KVCache([torch.from_numpy(ck[:, 0].copy())], [torch.from_numpy(cv[:, 0].copy())],
                    index=torch.from_numpy(heads).long())
    got = decode_attend(*(torch.from_numpy(t[:, 0]) for t in (q, k, v)), cache, 0).numpy()
    want = np.asarray(want)[:, 0]
    np.testing.assert_array_equal(cache.keys[0].numpy(), np.asarray(want_k)[:, 0])
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5, atol=1e-6)


# -- lossless acceptance -------------------------------------------------------
SAMPLED = dict(temperature=1.0, top_k=10, seed=5)


@pytest.fixture(scope="module")
def plain(lm, prompts):
    return {"greedy": _serve(lm, prompts)[0], "sampled": _serve(lm, prompts, **SAMPLED)[0]}


@pytest.mark.parametrize("path", ["paged", "legacy"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("drafter", ["ngram", "gpt"])
def test_speculation_is_lossless(lm, prompts, plain, path, mode, drafter):
    kw = dict(spec_k=3, spec_drafter=drafter, **(SAMPLED if mode == "sampled" else {}))
    if path == "legacy":
        # The contiguous window needs spec_k slack under the table.
        kw.update(kv_page_size=None, max_len=LM["max_len"] - 3)
    got, stats = _serve(lm, prompts, **kw)
    assert got == plain[mode]
    assert stats["drafted_tokens"] > 0
    assert stats["tokens_emitted"] == sum(len(t) for t in got.values())


@pytest.fixture(scope="module")
def jax_spec(lm, prompts):
    params, _ = bridge.state_dict_to_flax(lm)
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM)
    eng = JEngine(jm, jax.tree.map(jnp.asarray, params),
                  JServeConfig(max_batch=2, prefill_bucket=8, max_new_tokens=N_NEW, spec_k=3))
    for p in prompts:
        eng.submit(p)
    return {f.uid: f.tokens.tolist() for f in eng.run()}, eng.stats()


def test_speculative_engine_matches_jax(lm, prompts, jax_spec):
    got, stats = _serve(lm, prompts, spec_k=3)
    want, jstats = jax_spec
    assert got == want
    for key in ("drafted_tokens", "accepted_tokens", "tokens_emitted", "decode_iterations"):
        if key in jstats:
            assert stats[key] == jstats[key], key
    assert stats["accepted_tokens"] > 0


def test_budget_clamp_and_eos_cut(lm, prompts):
    """Drafts never write past the request's budget (the pool drains
    balanced at a one-token budget too), and a run stops at EOS as the
    plain engine does."""
    eos = _serve(lm, prompts[:2], max_new_tokens=6)[0][0][2]
    base = _serve(lm, prompts, eos_id=eos)[0]
    got = _serve(lm, prompts, eos_id=eos, spec_k=4)[0]
    assert got == base
    one = _serve(lm, prompts, spec_k=4, max_new_tokens=1)[0]
    assert all(len(t) == 1 for t in one.values())


def test_a_drafter_needs_speculation(lm):
    with pytest.raises(ValueError, match="requires spec_k >= 1"):
        Engine(lm, ServeConfig(), drafter=tspec.NGramDrafter())
    with pytest.raises(ValueError, match="budget \\+ spec_k"):
        Engine(lm, ServeConfig(kv_page_size=None, spec_k=2))
