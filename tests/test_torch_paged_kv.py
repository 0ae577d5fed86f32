"""The paged KV cache of the port's serving engine against the JAX
package's: the host allocator (``serving/pages.py``) driven by the same
call sequences in both packages, and the device half,
``parallel/ring_attention.py``'s :func:`paged_decode_attend` against JAX's
``RingSelfAttention._paged_decode_attend`` on the same pool, tables and
q/k/v, and the legacy slots' per-row write heads against JAX's ``vmap`` of
``_decode_attend``.

Tolerances: the allocator is held exactly (page ids, counters, error
types and messages). The attention outputs are float32 at atol 1e-6,
rtol 1e-5 (the same einsum and softmax in another library), the pools
after the scatter exactly (a copy), and the poisoned rows are NaN in
both.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.inference.sampler import CacheBudgetError as JBudget
from distributed_training_tpu.parallel.ring_attention import PagedKV as JPagedKV
from distributed_training_tpu.parallel.ring_attention import RingSelfAttention as JAttn
from distributed_training_tpu.serving import pages as jpages
from distributed_training_tpu_torch.inference.sampler import CacheBudgetError
from distributed_training_tpu_torch.parallel.ring_attention import (
    KVCache,
    PagedCache,
    PagedKV,
    check_kv_dtype,
    decode_attend,
    paged_decode_attend,
)
from distributed_training_tpu_torch.serving import pages as tpages

H, HD, PS = 2, 8, 4


class _JaxPaged(JAttn):
    """JAX's attention module with its two decode attends as the compact
    entry point (the module's own ``__call__`` runs the projections
    first); the methods themselves are JAX's."""

    @nn.compact
    def __call__(self, q, k, v, pages=None):
        if pages is None:
            return self._decode_attend(q, k, v, HD)
        return self._paged_decode_attend(q, k, v, HD, pages)


def _run_pool_script(mod, script):
    """Drive one package's PagePool through ``script`` (a list of (op,
    args)); returns every observable: results, counters, errors."""
    pool = mod.PagePool(num_pages=6, page_size=PS)
    out = []
    for op, args in script:
        try:
            res = getattr(pool, op)(*args)
            out.append((op, res if not isinstance(res, list) else list(res)))
        except Exception as e:  # the typed errors are part of the contract
            out.append((op, type(e).__name__, str(e)))
        out.append((pool.num_free, pool.num_allocated, pool.committed, pool.available))
    return out


SCRIPT = [("commit", (3,)), ("alloc", (2,)), ("can_commit", (4,)), ("commit", (4,)),
          ("alloc", (2,)), ("free", ([1],)), ("alloc", (1, False)), ("release", (5,)),
          ("free", ([1],)), ("free", ([0],)), ("commit", (1,)), ("alloc", (3, False)),
          ("alloc", (1, False)), ("release", (1,))]


def test_page_pool_matches_jax_on_a_call_script():
    assert _run_pool_script(tpages, SCRIPT) == _run_pool_script(jpages, SCRIPT)
    assert tpages.NULL_PAGE == jpages.NULL_PAGE == 0
    assert issubclass(CacheBudgetError, ValueError) and issubclass(JBudget, ValueError)


@pytest.mark.parametrize("n,size", [(0, 8), (1, 8), (8, 8), (9, 8), (17, 4)])
def test_pages_for_matches_jax(n, size):
    assert tpages.pages_for(n, size) == jpages.pages_for(n, size)


def _randomized_cycle(mod, budget_error, seed):
    """The randomized admit / on-demand alloc / evict cycle of JAX's
    ``tests/test_paged_kv.py``; returns the trace of every pool state and
    every page handed out."""
    rng = np.random.RandomState(seed)
    pool = mod.PagePool(num_pages=16, page_size=8)
    live, trace = [], []
    for _ in range(500):
        op = rng.randint(3)
        if op == 0:
            n = int(rng.randint(1, 5))
            if pool.can_commit(n):
                pool.commit(n)
                live.append(([], n))
            else:
                with pytest.raises(budget_error):
                    pool.commit(n)
        elif op == 1 and live:
            i = rng.randint(len(live))
            pages, left = live[i]
            if left > 0:
                got = pool.alloc(1)
                trace.append(tuple(got))
                pages.extend(got)
                live[i] = (pages, left - 1)
        elif op == 2 and live:
            pages, left = live.pop(rng.randint(len(live)))
            pool.free(pages, uncommit=left)
        assert pool.num_free + pool.num_allocated == pool.num_pages
        trace.append((pool.num_free, pool.committed))
    for pages, left in live:
        pool.free(pages, uncommit=left)
    pool.check_balanced()
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_admission_cycle_matches_jax(seed):
    assert (_randomized_cycle(tpages, CacheBudgetError, seed)
            == _randomized_cycle(jpages, JBudget, seed))


def _routing(rng, b, t_in, n_pages, pages_per_slot):
    """Tables with distinct physical pages per row (never the null page
    for a valid token), positions and validity."""
    perm = rng.permutation(np.arange(1, n_pages))
    table = perm[:b * pages_per_slot].reshape(b, pages_per_slot)
    positions = np.stack([rng.randint(0, pages_per_slot * PS - t_in) + np.arange(t_in)
                          for _ in range(b)])
    valid = rng.rand(b, t_in) > 0.25
    valid[:, 0] = True
    return table, positions, valid


def _jax_paged(pool_k, pool_v, q, k, v, table, positions, valid, n_pages):
    mod = _JaxPaged(num_heads=H, causal=True, kv_page_size=PS, kv_pages=n_pages)
    out, state = mod.apply(
        {"cache": {"key_pages": jnp.asarray(pool_k), "value_pages": jnp.asarray(pool_v)}},
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        JPagedKV(jnp.asarray(table, jnp.int32), jnp.asarray(positions, jnp.int32),
                 jnp.asarray(valid)), mutable=["cache"])
    return (np.asarray(out), np.asarray(state["cache"]["key_pages"]),
            np.asarray(state["cache"]["value_pages"]))


@pytest.mark.parametrize("b,t_in", [(3, 1), (1, 5), (2, 3)])
def test_paged_decode_attend_matches_jax(b, t_in):
    """The decode lane (T_in 1), a prefill chunk (B 1) and a wider window,
    on a pool holding stale values in every row."""
    rng = np.random.RandomState(b * 10 + t_in)
    n_pages, pages_per_slot = 12, 3
    table, positions, valid = _routing(rng, b, t_in, n_pages, pages_per_slot)
    pool_k = rng.randn(n_pages * PS, H, HD).astype(np.float32)
    pool_v = rng.randn(n_pages * PS, H, HD).astype(np.float32)
    q, k, v = (rng.randn(b, t_in, H, HD).astype(np.float32) for _ in range(3))
    want, want_k, want_v = _jax_paged(pool_k, pool_v, q, k, v, table, positions, valid,
                                      n_pages)
    cache = PagedCache([torch.from_numpy(pool_k.copy())], [torch.from_numpy(pool_v.copy())], PS)
    got = paged_decode_attend(*(torch.from_numpy(t) for t in (q, k, v)), cache, 0,
                              PagedKV(torch.from_numpy(table).long(),
                                      torch.from_numpy(positions).long(),
                                      torch.from_numpy(valid)))
    # The null page holds whatever the invalid rows wrote last: the order
    # of repeated writes is unspecified in both libraries.
    np.testing.assert_array_equal(cache.keys[0].numpy()[PS:], want_k[PS:])
    np.testing.assert_array_equal(cache.values[0].numpy()[PS:], want_v[PS:])
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-5, atol=1e-6)


def test_paged_row_past_its_table_is_poisoned_alone():
    """A write position past the page table NaN-poisons its own row only
    (JAX's per-row guard), in both packages."""
    rng = np.random.RandomState(7)
    n_pages, pages_per_slot = 8, 2
    table = np.array([[1, 2], [3, 4]])
    positions = np.array([[3], [pages_per_slot * PS]])  # row 1 overflows
    valid = np.ones((2, 1), bool)
    pool_k = np.zeros((n_pages * PS, H, HD), np.float32)
    pool_v = np.zeros_like(pool_k)
    q, k, v = (rng.randn(2, 1, H, HD).astype(np.float32) for _ in range(3))
    want, _, _ = _jax_paged(pool_k, pool_v, q, k, v, table, positions, valid, n_pages)
    cache = PagedCache([torch.zeros(n_pages * PS, H, HD)], [torch.zeros(n_pages * PS, H, HD)],
                       PS)
    got = paged_decode_attend(*(torch.from_numpy(t) for t in (q, k, v)), cache, 0,
                              PagedKV(torch.from_numpy(table), torch.from_numpy(positions),
                                      torch.from_numpy(valid))).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def test_per_row_write_heads_match_jax_vmap():
    """The legacy slots' cache: a write head a row (one past the end, so
    its row is poisoned alone) against JAX's ``vmap`` of the one-sequence
    ``_decode_attend`` with each lane's own ``cache_index``."""
    rng = np.random.RandomState(3)
    b, length, t_in = 3, 10, 1
    ck = rng.randn(b, 1, length, H, HD).astype(np.float32)
    cv = rng.randn(b, 1, length, H, HD).astype(np.float32)
    heads = np.array([0, 4, length])
    q, k, v = (rng.randn(b, 1, t_in, H, HD).astype(np.float32) for _ in range(3))
    mod = _JaxPaged(num_heads=H, causal=True, cache_len=length)

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


def test_pool_dtype_refusals():
    """JAX's pool dtypes: None and "int8" are taken (int8 pools with float32
    per-row, per-head scales beside them); anything else is JAX's
    ValueError, and so is an int8 contiguous cache."""
    check_kv_dtype(None)
    check_kv_dtype("int8")
    with pytest.raises(ValueError, match="kv_dtype must be None or 'int8'"):
        check_kv_dtype("fp8")
    with pytest.raises(ValueError, match="kv_dtype must be None or 'int8'"):
        PagedCache.empty(layers=1, kv_pages=4, page_size=PS, heads=H, head_dim=HD,
                         dtype=torch.float32, kv_dtype="fp8")
    cache = PagedCache.empty(layers=1, kv_pages=4, page_size=PS, heads=H, head_dim=HD,
                             dtype=torch.float32, kv_dtype="int8")
    assert cache.kv_dtype == "int8" and cache.keys[0].dtype == torch.int8
    assert cache.key_scales[0].shape == (4 * PS, H) and cache.key_scales[0].dtype == torch.float32
    with pytest.raises(ValueError, match="requires the paged cache"):
        KVCache.empty(layers=1, batch=1, cache_len=4, heads=H, head_dim=HD,
                      dtype=torch.float32, kv_dtype="int8")


def test_pools_start_zeroed():
    """Masked scores are 0 after the softmax, but 0 × NaN is not: the
    pool rows a gather reads before any write must hold numbers."""
    cache = PagedCache.empty(layers=2, kv_pages=5, page_size=PS, heads=H, head_dim=HD,
                             dtype=torch.float32)
    assert all(bool((t == 0).all()) for t in (*cache.keys, *cache.values))
    assert cache.kv_pages == 5 and cache.keys[0].shape == (5 * PS, H, HD)
