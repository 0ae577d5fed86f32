"""The port's radix-tree prefix cache (``serving/prefix_cache.py`` and the
engine's hit paths) against the JAX package's.

At micro size (``transformer_lm`` with 2 layers, 2 heads, hidden 32,
vocab 61, max_len 64; the port's seeded weights carried into JAX's tree
through ``bridge.py``), pages of 4:

1. **The trie alone**, driven by the same call script in both packages
   over each package's own ``PagePool``: every return value (claimed and
   probed pages, adopted sets, eviction counts), the trie's held pages
   and the pool's counters after each call, exactly.
2. **The engine**: prompts sharing a 20-token preamble, served in two
   waves so the second hits what the first left; JAX's engine on the
   bridged weights gives the same tokens, the same hit, insert and evict
   counters, the same resident page ids and the same routing probe.
3. **Neutrality**: the port's tokens with the cache on equal its tokens
   with the cache off, greedy and sampled, with speculation on and off,
   and under a page cap that forces LRU eviction; every pool drains
   balanced.

Token and page comparisons are exact. One JAX engine run serves the
module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu.serving import pages as jpages
from distributed_training_tpu.serving import prefix_cache as jpc
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.serving import Engine
from distributed_training_tpu_torch.serving import pages as tpages
from distributed_training_tpu_torch.serving import prefix_cache as tpc

torch.set_num_threads(1)

VOCAB = 61
PS = 4
LM = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=64,
          head_bias=True)
PREAMBLE = (np.arange(1, 21, dtype=np.int32) * 3) % VOCAB  # 20 tokens, 5 pages
TAILS = [[7], [8, 9, 10], [11, 12], [13, 14, 15, 16, 17], [18], [19, 20, 21, 22]]
PROMPTS = [np.concatenate([PREAMBLE, np.asarray(t, np.int32)]) for t in TAILS]
WAVES = (2, 4)  # requests served to completion, then the rest
BASE = dict(max_batch=2, max_new_tokens=6, kv_page_size=PS, prefill_chunk=4,
            temperature=0.0)
STAT_KEYS = ("prefix_cache_hit_tokens", "prefix_cache_inserted_pages",
             "prefix_cache_evicted_pages", "prefix_cache_pages_held",
             "preempted_token_recompute", "tokens_emitted")


def _model():
    return get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM).eval()


def _waves(eng):
    """Serve PROMPTS in two waves, each to completion; tokens by uid, the
    resident pages and the probe of a new prompt after each wave."""
    out, held, probes = {}, [], []
    lo = 0
    for n in WAVES:
        for p in PROMPTS[lo:lo + n]:
            eng.submit(p)
        out |= {f.uid: np.asarray(f.tokens).tolist() for f in eng.run()}
        lo += n
        held.append(sorted(eng.prefix_cache.pages_held()) if eng.prefix_cache else [])
        probes.append(eng.probe_snapshot(np.concatenate([PREAMBLE, [40, 41]]))["hit_tokens"])
    eng.check_balanced()
    return out, held, probes


@pytest.fixture(scope="module")
def port_run():
    eng = Engine(_model(), ServeConfig(prefix_cache=True, **BASE))
    out, held, probes = _waves(eng)
    return out, held, probes, eng.stats()


@pytest.fixture(scope="module")
def jax_run():
    params, _ = bridge.state_dict_to_flax(_model())
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM)
    eng = JEngine(jm, jax.tree.map(jnp.asarray, params),
                  JServeConfig(prefix_cache=True, **BASE))
    out, held, probes = _waves(eng)
    return out, held, probes, eng.stats()


def test_tokens_and_trie_match_jax(port_run, jax_run):
    assert port_run[0] == jax_run[0]
    assert port_run[1] == jax_run[1]  # resident page ids after each wave
    assert port_run[2] == jax_run[2]  # the routing probe's hit tokens
    for k in STAT_KEYS:
        assert port_run[3][k] == jax_run[3][k], k
    # The second wave hit the preamble the first left (4 full pages).
    assert port_run[3]["prefix_cache_hit_tokens"] >= WAVES[1] * 16
    assert port_run[2] == [20, 20]


def _serve_cold_and_warm(model, extra):
    cold = Engine(model, ServeConfig(**{**BASE, **extra}))
    warm = Engine(model, ServeConfig(prefix_cache=True, **{**BASE, **extra}))
    outs = []
    for eng in (cold, warm):
        outs.append(_waves(eng)[0])
    return outs, warm.stats()


@pytest.mark.parametrize("extra", [
    {}, {"temperature": 1.0, "top_k": 10, "seed": 3}, {"spec_k": 2},
    {"spec_k": 2, "temperature": 1.0, "seed": 3}, {"prefix_cache_pages": 6},
    {"kv_pages": 16},
], ids=["greedy", "sampled", "spec", "spec-sampled", "page-cap", "pool-pressure"])
def test_cache_hit_is_token_neutral(extra):
    """The cache on gives the cache-off tokens, whatever the sampling,
    speculation, page cap or pool pressure (the last two evict)."""
    (cold, warm), stats = _serve_cold_and_warm(_model(), extra)
    assert warm == cold
    assert stats["prefix_cache_hit_tokens"] > 0
    if "prefix_cache_pages" in extra:
        assert stats["prefix_cache_evicted_pages"] > 0
        assert stats["prefix_cache_pages_held"] <= extra["prefix_cache_pages"]


def _trie_script(pc_mod, pages_mod):
    """One call script through a package's PrefixCache over its PagePool;
    every observable after each call."""
    pool = pages_mod.PagePool(num_pages=12, page_size=PS)
    cache = pc_mod.PrefixCache(PS, max_pages=6)
    toks = lambda *xs: np.asarray(xs, np.int32)  # noqa: E731
    a = toks(*range(1, 13))                       # 3 full pages
    b = toks(*range(1, 9), 30, 31, 32, 33, 34)    # shares 2 pages with a
    c = toks(*range(40, 52))
    out = []

    def note(res):
        out.append((res, sorted(cache.pages_held()), pool.num_free, pool.num_allocated,
                    pool.committed, pool.available))

    pool.commit(3)
    pa = pool.alloc(3)
    note(cache.insert_chain(a, pa, pool))
    pool.free([p for p in pa if p not in cache.pages_held()], uncommit=0)
    note(cache.probe(b, max_tokens=b.size - 1))
    hit = cache.claim(b, pool, max_tokens=b.size - 1)
    note(hit)
    pool.commit(2)
    pb = hit + pool.alloc(2)
    note(cache.insert_chain(b, pb, pool))
    pool.free([p for p in pb if p not in cache.pages_held()], uncommit=0)
    pool.free(hit)
    pool.commit(3)
    pc_pages = pool.alloc(3)
    note(cache.insert_chain(c, pc_pages, pool))  # the cap evicts LRU leaves
    pool.free([p for p in pc_pages if p not in cache.pages_held()], uncommit=0)
    note(cache.evict_until(pool, 10, pinned=set(cache.probe(c, max_tokens=12))))
    note(cache.holds(pc_pages[0]))
    note(cache.flush(pool))
    pool.check_balanced()
    return out


def test_trie_matches_jax_on_a_call_script():
    assert _trie_script(tpc, tpages) == _trie_script(jpc, jpages)


def test_legacy_path_refuses_the_cache():
    with pytest.raises(ValueError, match="requires the paged KV cache"):
        Engine(_model(), ServeConfig(prefix_cache=True, kv_page_size=None))
