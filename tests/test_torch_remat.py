"""Remat (activation checkpointing) and dropout in the port's models.

- GPT (2 layers, hidden 32, T 16, exact and flash attention; the flash
  kernels' plain versions on the CPU) and ResNet (``resnet_micro``): the
  loss and every parameter's gradient with ``remat=True`` equal those
  without, bit for bit in float32 (the recompute repeats the same float32
  operations on the same inputs).
- ResNet's BatchNorm running statistics tick once a training step under
  remat: equal, bit for bit, to those of the run without it.
- GPT with dropout 0.1: under remat the recompute draws the same masks as
  the forward, so the gradients equal the no-remat run's bit for bit; a
  different step seed draws other masks.
- Dropout at rate 0 is the identity, and eval (no dropout) is
  deterministic and equal to the dropout-free model's output.
"""

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.lm_step import dropout_generator

torch.set_num_threads(1)

GPT = dict(num_classes=64, num_layers=2, num_heads=2, hidden_dim=32, max_len=32)


def _tokens(seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 64, (3, 17)))


def _gpt_grads(remat, attn_impl="exact", dropout_rate=0.0, step=0):
    model = get_model("transformer_lm", attn_impl=attn_impl, remat=remat,
                      dropout_rate=dropout_rate,
                      generator=torch.Generator().manual_seed(0), **GPT)
    model.train()
    calls = []
    model.block0.attn.register_forward_hook(lambda *_: calls.append(1))
    toks = _tokens()
    gen = dropout_generator(model, seed=1, step=step, rank=0, device=torch.device("cpu"))
    logits = model(toks[:, :-1], generator=gen)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 64), toks[:, 1:].reshape(-1))
    loss.backward()
    assert len(calls) == (2 if remat else 1)  # the recompute ran the block again
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
def test_gpt_remat_equals_no_remat_bitwise(attn_impl):
    loss, grads = _gpt_grads(False, attn_impl)
    loss_r, grads_r = _gpt_grads(True, attn_impl)
    assert torch.equal(loss, loss_r)
    for n in grads:
        assert torch.equal(grads[n], grads_r[n]), n


def _resnet_run(remat):
    model = get_model("resnet_micro", remat=remat, generator=torch.Generator().manual_seed(0))
    model.train()
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4))
    loss = torch.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    return (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()})


def test_resnet_remat_equals_no_remat_and_ticks_bn_once():
    loss, grads, bufs = _resnet_run(False)
    loss_r, grads_r, bufs_r = _resnet_run(True)
    assert torch.equal(loss, loss_r)
    for n in grads:
        assert torch.equal(grads[n], grads_r[n]), n
    for n in bufs:
        assert torch.equal(bufs[n], bufs_r[n]), n
    # One tick from the initial (0, 1): mean = 0.1 · batch mean, so not 0.
    assert any(b.abs().sum() > 0 for n, b in bufs_r.items() if n.endswith("running_mean"))


def test_dropout_masks_of_the_recompute_equal_the_forwards():
    loss, grads = _gpt_grads(False, dropout_rate=0.1)
    loss_r, grads_r = _gpt_grads(True, dropout_rate=0.1)
    assert torch.equal(loss, loss_r)
    for n in grads:
        assert torch.equal(grads[n], grads_r[n]), n
    loss_other, _ = _gpt_grads(True, dropout_rate=0.1, step=1)
    loss_none, _ = _gpt_grads(False)
    assert not torch.equal(loss_other, loss) and not torch.equal(loss, loss_none)


def test_dropout_rate_zero_is_identity_and_eval_is_deterministic():
    toks = _tokens(3)[:, :-1]
    plain = get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **GPT)
    zero = get_model("transformer_lm", dropout_rate=0.0,
                     generator=torch.Generator().manual_seed(0), **GPT)
    half = get_model("transformer_lm", dropout_rate=0.5,
                     generator=torch.Generator().manual_seed(0), **GPT)
    plain.train()
    zero.train()
    assert dropout_generator(zero, 0, 0, 0, torch.device("cpu")) is None
    assert torch.equal(plain(toks), zero(toks))
    half.eval()
    plain.eval()
    with torch.no_grad():
        a, b = half(toks), half(toks)
        assert torch.equal(a, b) and torch.equal(a, plain(toks))
    half.train()
    with pytest.raises(ValueError, match="generator"):
        half(toks)
