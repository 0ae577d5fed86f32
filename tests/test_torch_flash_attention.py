"""The port's flash attention on the CPU (the wrappers' plain versions)
against the JAX package's ``flash_attention`` / ``flash_attention_lse``
with their Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` runs them.

Inputs come from numpy. Tolerances are those of the JAX package's own
test of the kernels against exact attention (float32, a blockwise sum
against a materialised one): outputs atol 2e-6 / rtol 1e-5, lse 1e-5,
gradients atol 5e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.ops import flash_attention as jfa
from distributed_training_tpu_torch.ops import flash_attention as tfa

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

GRID = [(256, 128, 128), (256, 64, 128), (128, 128, 128), (192, 64, 64)]


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,bq,bk", GRID)
def test_forward_matches_jax(causal, t, bq, bk):
    q, k, v = _qkv((2, 3, t, 32))
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                               block_q=bq, block_k=bk)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              block_q=bq, block_k=bk)
    assert got.shape == (2, 3, t, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,bq,bk", GRID)
def test_lse_and_gradients_with_lse_cotangent_match_jax(causal, t, bq, bk):
    """``flash_attention_lse``: out, lse, and dq/dk/dv of a loss that reads
    both outputs (so the lse cotangent folds into delta)."""
    q, k, v = _qkv((2, 3, t, 32), seed=t + causal)
    rng = np.random.RandomState(7)
    g = rng.randn(2, 3, t, 32).astype(np.float32)
    g_lse = rng.randn(2, 3, t).astype(np.float32)
    blocks = dict(causal=causal, block_q=bq, block_k=bk, bwd_block_q=bq,
                  bwd_block_k=bk)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, **blocks)
        return jnp.sum(o * g) + jnp.sum(lse * g_lse), (o, lse)

    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention_lse(*xs, **blocks)
    ((o * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=2e-6, rtol=1e-5)
    assert lse.shape == (2, 3, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               atol=1e-5, rtol=1e-5)
    for name, x, want in zip("qkv", xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(causal):
    """``flash_attention`` (no lse output): the loss of the JAX package's
    own gradient test."""
    q, k, v = _qkv((2, 2, 256, 32))
    kw = dict(causal=causal, block_q=64, block_k=64, bwd_block_q=64, bwd_block_k=64)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, **kw) ** 2),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tfa.flash_attention(*xs, **kw) ** 2).sum().backward()
    for name, x, want in zip("qkv", xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 48, 96, 160, 256, 320])
def test_other_head_dims_match_jax(d, causal):
    """Head dims between the kernels' sizes (which the card pads to 32, 64,
    128 or 256, and above 256 to a multiple of 64), 256 and one above it:
    out, lse and the gradients of a loss reading both, against the JAX
    kernels, which take any d."""
    q, k, v = _qkv((1, 2, 128, d), seed=d)
    rng = np.random.RandomState(d + 1)
    g = rng.randn(1, 2, 128, d).astype(np.float32)
    g_lse = rng.randn(1, 2, 128).astype(np.float32)
    blocks = dict(causal=causal, block_q=64, block_k=64, bwd_block_q=64, bwd_block_k=64)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, **blocks)
        return jnp.sum(o * g) + jnp.sum(lse * g_lse), (o, lse)

    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention_lse(*xs, **blocks)
    ((o * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), atol=1e-5, rtol=1e-5)
    for name, x, want in zip("qkv", xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=1e-4, err_msg=f"d{name}")


def test_head_dims_pad_to_the_kernels_sizes():
    """Off the CPU, d goes up to the next instantiated size up to 256, and
    above 256 to the next multiple of 64; the padding comes before the
    kernel's checks (a ``meta`` tensor is then refused as not on a card)."""
    assert [tfa.padded_head_dim(d) for d in (1, 16, 32, 33, 48, 64, 96, 128,
                                             129, 160, 256, 257, 320, 321,
                                             512, 700)] == [
        32, 32, 32, 64, 64, 64, 128, 128, 256, 256, 256, 320, 320, 384,
        512, 704]
    with pytest.raises(ValueError, match="at least 1"):
        tfa.padded_head_dim(0)
    q = torch.empty((2, 64, 48), device="meta", dtype=torch.float16)
    padded = tfa._pad_d(q, 64)
    assert padded.shape == (2, 64, 64) and padded.dtype == torch.float16
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, q, q, causal=True)
    wide = torch.empty((2, 64, 257), device="meta")
    assert tfa._pad_d(wide, tfa.padded_head_dim(257)).shape == (2, 64, 320)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(wide, wide, wide, causal=True)


def test_rejects_indivisible_like_jax():
    q, k, v = _qkv((1, 1, 100, 32))
    with pytest.raises(ValueError, match="divisible"):
        jfa.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=64, block_k=64)
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=64, block_k=64)
    # The backward blocks are checked when the backward runs, as in JAX.
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*xs, bwd_block_q=64)
    with pytest.raises(ValueError, match="divisible"):
        out.sum().backward()


def test_block_rule_is_the_jax_rule():
    for t in (8, 100, 128, 384, 640, 768, 1000, 1024, 3072):
        for requested in (64, 128, 256, 512, 1024, 2048):
            try:
                want = jfa._block(t, requested)
            except ValueError:
                with pytest.raises(ValueError):
                    tfa._block(t, requested)
            else:
                assert tfa._block(t, requested) == want


def test_bwd_reference_matches_autograd_of_the_forward_reference():
    """The closed-form gradients against autograd through the plain
    forward, with an lse cotangent."""
    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 96, 64).astype(np.float32))
                  for _ in range(4))
    g_lse = torch.from_numpy(rng.randn(3, 96).astype(np.float32))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tfa.flash_attention_reference(*xs, causal=True)
    ((out * g).sum() + (lse * g_lse).sum()).backward()
    got = tfa.flash_attention_bwd_reference(q, k, v, out.detach(), lse.detach(), g,
                                            g_lse, causal=True)
    for a, x in zip(got, xs):
        torch.testing.assert_close(a, x.grad, atol=2e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 64, 32)))
    n = (tfa.flash_fwd.launches, tfa.flash_bwd.launches)
    out, lse = tfa.flash_fwd(q, k, v, causal=True)
    want_out, want_lse = tfa.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    tfa.flash_bwd(q, k, v, out, lse, q, causal=True)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == n


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: here (no card) a
    ``meta`` tensor is refused by the kernel's checks."""
    q = torch.empty((2, 64, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, q, q, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd(q, q, q, q, torch.empty((2, 64), device="meta"), q,
                      causal=False)
