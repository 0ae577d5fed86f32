"""The port's chunked and saved-probabilities cross-entropies against the
JAX package's, on the same numpy inputs.

- ``chunked_ce_and_accuracy`` (hidden ``[2, 16, 8]``, a head of vocab 64
  with and without its bias, chunks of 4 and 8) against the JAX function:
  the CE, the accuracy, and the gradients of the CE with respect to the
  hidden states, the head's kernel and its bias. float32 logits: the CE
  rtol 1e-6, the gradients within 1e-5 of their largest magnitude (float32
  sums in another order). bfloat16 logits: the limits
  ``tests/test_torch_lm_step.py`` holds the unchunked CE to (rtol 1e-5;
  gradients within one bfloat16 ulp, 2**-8, of their largest magnitude).
  One exception: with the head's bias in bfloat16, XLA on the CPU fuses
  the bias add into the scanned body and rounds there otherwise than the
  same head applied outside the scan, whose CE the port reads to every
  digit; JAX's own chunked and unchunked CE of that head differ by 1.0e-5
  relative. There the port is held to JAX's unchunked CE of the same head
  at rtol 1e-5 and to JAX's chunked CE at 3e-5, three times that gap, and
  the gradients to two bfloat16 ulps (2**-7) of their largest magnitude:
  a logit rounded to the neighbouring value passes into p.
  The accuracy is a count of equal comparisons: exact.
- The saved-probabilities CE (:class:`_SavedProbsCE`) against
  ``_ce_rows_saved_probs``: rows rtol 1e-6 and correctness exact (both are
  the fused CE's arithmetic); the gradient within 2**-8 of its largest
  magnitude (both round p to bfloat16, and a float32 softmax summed in
  another order can round one element to the neighbouring bfloat16 value).
- ``_check_ce_options``: the same error and warning as the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.train import lm_step as jstep
from distributed_training_tpu_torch.models.gpt import Dense
from distributed_training_tpu_torch.train import lm_step

torch.set_num_threads(1)

B, T, D, V = 2, 16, 8, 64
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CE_RTOL = {"fp32": 1e-6, "bf16": 1e-5}
GRAD_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -8}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, D).astype(np.float32),
            (rng.randn(D, V) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.randn(V)).astype(np.float32),
            rng.randint(0, V, (B, T)).astype(np.int32))


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_chunked_ce_matches_jax(dtype, chunk, bias):
    jd, td = DTYPES[dtype]
    hidden, kernel, b, targets = _inputs()
    jparams = {"kernel": jnp.asarray(kernel), **({"bias": jnp.asarray(b)} if bias else {})}

    def jloss(h, p):
        return jstep.chunked_ce_and_accuracy(h, p, jnp.asarray(targets), chunk,
                                             logits_dtype=jd)

    jce, jacc = jloss(jnp.asarray(hidden), jparams)
    jgh, jgp = jax.grad(lambda h, p: jloss(h, p)[0], argnums=(0, 1))(
        jnp.asarray(hidden), jparams)

    head = Dense(D, V, dtype=td, use_bias=bias)
    with torch.no_grad():
        head.kernel.copy_(torch.from_numpy(kernel))
        if bias:
            head.bias.copy_(torch.from_numpy(b))
    h = torch.from_numpy(hidden).requires_grad_()
    ce, acc = lm_step.chunked_ce_and_accuracy(h, head, torch.from_numpy(targets), chunk,
                                              logits_dtype=td)
    ce.backward()
    assert ce.dtype == acc.dtype == torch.float32 and ce.shape == ()
    if bias and dtype == "bf16":
        logits = (jnp.asarray(hidden, jd) @ jparams["kernel"].astype(jd)
                  + jparams["bias"].astype(jd))
        unchunked = jstep._fused_softmax_ce(logits, jnp.asarray(targets))
        np.testing.assert_allclose(float(ce.detach()), float(unchunked), rtol=1e-5)
        np.testing.assert_allclose(float(ce.detach()), float(jce), rtol=3e-5)
    else:
        np.testing.assert_allclose(float(ce.detach()), float(jce), rtol=CE_RTOL[dtype])
    assert float(acc) == float(jacc)
    pairs = [(h.grad, jgh), (head.kernel.grad, jgp["kernel"])]
    if bias:
        pairs.append((head.bias.grad, jgp["bias"]))
    tol = 2.0 ** -7 if bias and dtype == "bf16" else GRAD_TOL[dtype]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=tol * np.abs(want).max())


def test_chunked_ce_never_holds_the_whole_logits():
    """Only [B, chunk, vocab] logits exist at once, in the forward and in
    the recompute of the backward: the largest tensor the head makes is a
    chunk's (read off the autograd graph's saved tensors and a forward
    hook on the matmul's output sizes)."""
    hidden, kernel, _, targets = _inputs(1)
    head = Dense(D, V, use_bias=False)
    with torch.no_grad():
        head.kernel.copy_(torch.from_numpy(kernel))
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: sizes.append(t.numel()) or t, lambda t: t):
        ce, _ = lm_step.chunked_ce_and_accuracy(
            torch.from_numpy(hidden).requires_grad_(), head,
            torch.from_numpy(targets), 4)
    ce.backward()
    assert max(sizes) < B * T * V and max(sizes) >= B * 4 * D
    with pytest.raises(ValueError, match="must divide"):
        lm_step.chunked_ce_and_accuracy(torch.zeros(B, 10, D), head,
                                        torch.zeros(B, 10, dtype=torch.int64), 4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_saved_probs_ce_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(4, 16, 50)).astype(np.float32)
    targets = rng.randint(0, 50, (4, 16)).astype(np.int32)
    g = rng.rand(4, 16).astype(np.float32)
    jl = jnp.asarray(logits, jd)
    jrows, jcorrect = jstep._ce_rows_saved_probs(jl, jnp.asarray(targets), with_correct=True)
    jgrad = jax.grad(lambda x: (jstep._ce_rows_saved_probs(x, jnp.asarray(targets))
                                * jnp.asarray(g)).sum())(jl)
    tl = torch.from_numpy(logits).to(td).requires_grad_()
    rows, correct = lm_step._ce_rows_and_correct(tl, torch.from_numpy(targets), True, True)
    (rows * torch.from_numpy(g)).sum().backward()
    assert tl.grad.dtype == td
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows), rtol=1e-6)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))
    want = np.asarray(jgrad.astype(jnp.float32))
    np.testing.assert_allclose(tl.grad.float().numpy(), want,
                               atol=2.0 ** -8 * np.abs(want).max())
    fused = lm_step._fused_ce_rows(tl.detach(), torch.from_numpy(targets))
    np.testing.assert_array_equal(rows.detach().numpy(), fused.numpy())


def test_ce_options_checked_like_jax():
    with pytest.raises(ValueError) as jerr:
        jstep._check_ce_options(8, True)
    with pytest.raises(ValueError) as terr:
        lm_step._check_ce_options(8, True)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not compose"):
        lm_step.make_lm_train_step(ce_chunk=8, ce_save_probs=True)
    with pytest.warns(UserWarning) as jwarn:
        jstep._check_ce_options(None, True, jnp.bfloat16)
    with pytest.warns(UserWarning) as twarn:
        lm_step._check_ce_options(None, True, torch.bfloat16)
    assert str(twarn[0].message) == str(jwarn[0].message)
