"""Remat (activation checkpointing) and dropout in the port's models.

- GPT (2 layers, hidden 32, T 16, exact and flash attention; the flash
  kernels' plain versions on the CPU) and ResNet (``resnet_micro``): the
  loss and every parameter's gradient with ``remat=True`` equal those
  without, bit for bit in float32 (the recompute repeats the same float32
  operations on the same inputs).
- ResNet's BatchNorm running statistics tick once a training step under
  remat: equal, bit for bit, to those of the run without it.
- ResNet with ``remat_policy="conv"`` (the convolutions' outputs kept):
  bit for bit the plain model's, no convolution recomputed, and against
  the Flax model's conv policy on bridged weights.
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


# remat_policy="conv": each block keeps its convolutions' outputs and
# recomputes its batch norms and ReLUs in the backward.

def _conv_policy_run(policy_kw, x, y, load=None):
    model = get_model("resnet_micro", generator=torch.Generator().manual_seed(0), **policy_kw)
    if load is not None:
        load(model)
    model.train()
    loss = torch.nn.functional.cross_entropy(model(x), y)
    from torch.profiler import profile

    with profile() as prof:
        loss.backward()
    # CPU convolutions run as aten::mkldnn_convolution beneath aten::_convolution.
    recomputed = sum(e.count for e in prof.key_averages() if e.key == "aten::_convolution")
    return (model, loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}, recomputed)


def _xy(seed=2):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 10, 4)))


def test_resnet_conv_policy_keeps_convs_and_equals_plain_bitwise():
    """Bit for bit in float32 against the plain model (the backward runs
    the same operations on the same saved or recomputed values); the
    BatchNorm statistics tick once; plain remat recomputes all 11 block
    convolutions in the backward, the conv policy none of them."""
    x, y = _xy()
    _, loss, grads, bufs, plain_convs = _conv_policy_run({}, x, y)
    _, loss_r, _, _, remat_convs = _conv_policy_run(dict(remat=True), x, y)
    model, loss_c, grads_c, bufs_c, conv_convs = _conv_policy_run(dict(remat_policy="conv"), x, y)
    assert model.remat and model.remat_policy == "conv"
    assert (plain_convs, remat_convs, conv_convs) == (0, 11, 0)
    assert torch.equal(loss, loss_c) and torch.equal(loss, loss_r)
    for n in grads:
        assert torch.equal(grads[n], grads_c[n]), n
    for n in bufs:
        assert torch.equal(bufs[n], bufs_c[n]), n
    # Names are the plain model's: checkpoints and the bridge carry over.
    assert list(dict(model.named_parameters())) == list(grads)


def test_resnet_conv_policy_grads_match_jax_conv_policy():
    """Against the Flax ResNet with ``remat_policy="conv"`` on bridged
    weights: the loss within 1e-5 and each gradient within atol 1e-5 +
    rtol 1e-4 (float32 on the CPU, XLA's and oneDNN's convolutions summing
    in different orders; the largest difference measured, 2.8e-6, is a
    sixth of that), the ticked statistics within 1e-5."""
    import jax
    import jax.numpy as jnp

    from distributed_training_tpu.models import get_model as jax_model
    from distributed_training_tpu_torch import bridge

    x, y = _xy(3)
    # The port's initial weights, BatchNorm scales and offsets perturbed
    # (each block's zero-initialised last scale would hide its branch),
    # carried to Flax through the bridge.
    base = get_model("resnet_micro", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(5)
    with torch.no_grad():
        for n, p in base.named_parameters():
            if p.dim() == 1:
                p.add_(torch.from_numpy(0.1 * rs.randn(*p.shape).astype(np.float32)))
    params, stats0 = bridge.state_dict_to_flax(base)
    jm = jax_model("resnet_micro", remat_policy="conv")

    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats0},
                               jnp.asarray(x.numpy()), train=True, mutable=["batch_stats"])
        onehot = jax.nn.one_hot(jnp.asarray(y.numpy()), 10)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1)), mut

    (jloss, mut), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model, loss, grads, _, _ = _conv_policy_run(
        dict(remat_policy="conv"), x, y,
        load=lambda m: m.load_state_dict(base.state_dict()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = bridge.named_to_flax_tree(model, grads)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5),
                 jax.device_get(jgrads), got)
    _, stats = bridge.state_dict_to_flax(model)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-5),
                 jax.device_get(mut["batch_stats"]), stats)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        get_model("resnet_micro", remat_policy="dots")


def test_trainer_takes_the_conv_policy(tmp_path):
    """The image Trainer builds its ResNet with ``remat_policy``; its
    losses and weights equal the run without, bit for bit."""
    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.config import CheckpointConfig, DataConfig, TrainConfig

    runs = []
    for policy in (None, "conv"):
        cfg = TrainConfig(model="resnet_micro", num_epochs=1, log_interval=1, eval_every=0,
                          data=DataConfig(dataset="synthetic_cifar", batch_size=8,
                                          max_steps_per_epoch=3),
                          checkpoint=CheckpointConfig(directory=str(tmp_path / str(policy)),
                                                      interval=0))
        trainer = Trainer(cfg, device="cpu", remat_policy=policy)
        assert trainer.model.remat_policy == policy and trainer.model.remat == bool(policy)
        trainer.fit()
        runs.append(([h["loss"] for h in trainer.meter.history],
                     [p.detach().clone() for p in trainer.model.parameters()]))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 3
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
