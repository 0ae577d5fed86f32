"""The port's split flash backward (K4) and exp2 mode on the CPU (the
wrappers' plain versions) against the JAX package with the same switches
set, its Pallas kernels in interpret mode.

``_USE_SPLIT_BWD`` and ``_USE_EXP2`` are set in both packages with
``monkeypatch``, as their flash kernel benches set them. Inputs come from
numpy. Tolerances are those of ``tests/test_torch_flash_attention.py``
(float32, a blockwise sum against a materialised one): outputs atol 2e-6 /
rtol 1e-5, lse 1e-5, gradients atol 5e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.ops import flash_attention as jfa
from distributed_training_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# (T, block): 64-blocks at T 192 make three tiles, as GRID in
# tests/test_torch_flash_attention.py.
GRID = [(256, 64), (256, 128), (192, 64)]


def _inputs(t, seed):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(1, 2, t, 32).astype(np.float32) for _ in range(4))
    return q, k, v, g, rng.randn(1, 2, t).astype(np.float32)


def _switch(monkeypatch, name, on):
    monkeypatch.setattr(jfa, name, on)
    monkeypatch.setattr(tfa, name, on)


def _count_split_calls(monkeypatch):
    calls = []
    inner = tfa.flash_bwd_split

    def spy(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(tfa, "flash_bwd_split", spy)
    return calls


def _lse_op_run(q, k, v, g, g_lse, blocks):
    """out, lse and dq, dk, dv of sum(out·g) + sum(lse·g_lse), in both
    packages."""
    def jloss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, **blocks)
        return jnp.sum(o * g) + jnp.sum(lse * g_lse), (o, lse)

    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention_lse(*xs, **blocks)
    ((o * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(g_lse)).sum()).backward()
    return (jo, jlse, jgrads), (o.detach(), lse.detach(), [x.grad for x in xs])


def _assert_grads(got, want):
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,b", GRID)
def test_split_backward_of_flash_attention_lse_matches_jax(monkeypatch, causal, t, b):
    """The split backward with a random lse cotangent (folded into delta)."""
    _switch(monkeypatch, "_USE_SPLIT_BWD", True)
    calls = _count_split_calls(monkeypatch)
    q, k, v, g, g_lse = _inputs(t, seed=t + b + causal)
    blocks = dict(causal=causal, block_q=b, block_k=b, bwd_block_q=b, bwd_block_k=b)
    (jo, jlse, jgrads), (o, lse, grads) = _lse_op_run(q, k, v, g, g_lse, blocks)
    assert calls == [1]
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5, rtol=1e-5)
    _assert_grads(grads, jgrads)


@pytest.mark.parametrize("causal", [False, True])
def test_split_backward_of_flash_attention_matches_jax(monkeypatch, causal):
    """``flash_attention`` (no lse output) through the split backward."""
    _switch(monkeypatch, "_USE_SPLIT_BWD", True)
    calls = _count_split_calls(monkeypatch)
    q, k, v, g, _ = _inputs(256, seed=11)
    kw = dict(causal=causal, block_q=64, block_k=64, bwd_block_q=64, bwd_block_k=64)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, **kw) * g),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tfa.flash_attention(*xs, **kw) * torch.from_numpy(g)).sum().backward()
    assert calls == [1]
    _assert_grads([x.grad for x in xs], jgrads)


@pytest.mark.parametrize("split_bwd", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("causal", [False, True])
def test_exp2_matches_jax(monkeypatch, causal, split_bwd):
    """exp2 mode: forward out and lse, and the gradients through the fused
    or the split backward."""
    _switch(monkeypatch, "_USE_EXP2", True)
    _switch(monkeypatch, "_USE_SPLIT_BWD", split_bwd)
    q, k, v, g, g_lse = _inputs(256, seed=21 + causal)
    blocks = dict(causal=causal, block_q=64, block_k=64, bwd_block_q=64, bwd_block_k=64)
    (jo, jlse, jgrads), (o, lse, grads) = _lse_op_run(q, k, v, g, g_lse, blocks)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5, rtol=1e-5)
    _assert_grads(grads, jgrads)


def test_exp2_switch_changes_the_plain_arithmetic(monkeypatch):
    """The switch reaches the plain versions: the exp2 forward is a
    different float32 computation of the same function."""
    q, k, v = (torch.from_numpy(x[0]) for x in _inputs(128, seed=3)[:3])
    out, lse = tfa.flash_fwd(q, k, v, causal=True)
    monkeypatch.setattr(tfa, "_USE_EXP2", True)
    out2, lse2 = tfa.flash_fwd(q, k, v, causal=True)
    assert not torch.equal(lse, lse2)
    torch.testing.assert_close(out2, out, atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(lse2, lse, atol=1e-5, rtol=1e-5)


def test_split_plain_versions_equal_the_fused_one():
    """K4a's and K4b's plain versions compute the fused backward's plain
    function, bit for bit, from the same delta."""
    rng = np.random.RandomState(5)
    q, k, v, g = (torch.from_numpy(rng.randn(3, 96, 64).astype(np.float32))
                  for _ in range(4))
    g_lse = torch.from_numpy(rng.randn(3, 96).astype(np.float32))
    out, lse = tfa.flash_attention_reference(q, k, v, causal=True)
    want = tfa.flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, causal=True)
    got = tfa.flash_bwd_split(q, k, v, out, lse, g, g_lse, causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    delta = tfa._delta(g, out, g_lse)
    assert torch.equal(tfa.flash_attention_dq_reference(q, k, v, g, lse, delta,
                                                        causal=True), want[0])


def test_split_wrappers_never_fall_back():
    """Off the CPU the split wrappers go to their kernels or raise: here (no
    card) a ``meta`` tensor is refused by the kernels' checks."""
    q = torch.empty((2, 64, 32), device="meta")
    row = torch.empty((2, 64), device="meta")
    n = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q, q, q, q, row, row, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv(q, q, q, q, row, row, causal=True)
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches) == n
