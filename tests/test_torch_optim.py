"""The port's optimizer chains and parameter EMA against the JAX package's
``make_optimizer`` (optax) on the CPU.

Every chain runs with the clip (global norm 1, which the large-gradient
steps trigger and the small ones do not), the ``no_1d`` weight-decay mask,
a warm-up schedule (so that the 0-based and 1-based schedule counts give
different rates) and the EMA, for 5 steps from the same numpy parameters
and gradients. One BatchNorm bias starts at zero, so lamb's trust ratio
meets a zero parameter norm (ratio 1) on its first step.

Tolerances: both sides run the same float32 operations in the same order;
the clip's global norm and lamb's per-tensor norms are sums in another
order, and XLA may fuse a multiply-add where torch rounds twice. So the
parameters and their EMA are held to 1e-6 relative (atol 1e-7 for the
elements near zero), as ``test_torch_step.py`` holds parameters;
``hybrid_adam`` to 1e-5, as ``test_torch_fused_adam.py`` holds its chain
(the JAX kernel returns ``new_p − p`` and ``apply_updates`` adds it back);
the moments and the trace to 1e-5 of each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import SchedulerConfig as JSched
from distributed_training_tpu.train.optim import ema_params as jema_params
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import OptimizerConfig, SchedulerConfig
from distributed_training_tpu_torch.models.resnet import BatchNorm, Conv
from distributed_training_tpu_torch.train.optim import make_optimizer, tensor_norms

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

SHAPES = {"conv_init": {"kernel": (3, 3, 2, 4)}, "bn_init": {"scale": (4,), "bias": (4,)},
          "Dense_0": {"kernel": (4, 5), "bias": (5,)}}
CASES = {
    "adam": dict(name="adam", lr=1e-2),
    "hybrid_adam": dict(name="hybrid_adam", lr=1e-2),
    "adamw": dict(name="adamw", lr=1e-2),
    "sgd": dict(name="sgd", lr=0.1),
    "sgd_nesterov": dict(name="sgd", lr=0.1, nesterov=True),
    "sgd_no_momentum": dict(name="sgd", lr=0.1, momentum=0.0),
    "lamb": dict(name="lamb", lr=1e-2),
}
SLOTS = {"adam": ("mu", "nu"), "hybrid_adam": ("mu", "nu"), "adamw": ("mu", "nu"),
         "sgd": ("trace",), "sgd_nesterov": ("trace",), "sgd_no_momentum": (),
         "lamb": ("mu", "nu")}


def _holder():
    """The port's module kinds for the Flax names of SHAPES."""
    holder = torch.nn.Module()
    holder.conv_init, holder.bn_init = Conv(2, 4, 3), BatchNorm(4)
    holder.Dense_0 = torch.nn.Linear(4, 5)
    return holder


def _params(seed=0):
    """Parameters of the holder's names and shapes, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn(p.shape, generator=gen) for n, p in _holder().named_parameters()}


def _tree(rng, scale=1.0):
    return jax.tree.map(lambda s: (scale * rng.randn(*s)).astype(np.float32), SHAPES,
                        is_leaf=lambda s: isinstance(s, tuple))


def _configs(case):
    opt = dict(CASES[case], weight_decay=1e-2, weight_decay_mask="no_1d",
               grad_clip_norm=1.0, ema_decay=0.9)
    sched = dict(name="warmup_lr", warmup_min_lr=opt["lr"] / 4, warmup_max_lr=opt["lr"],
                 warmup_num_steps=3)
    return (JOpt(**opt), JSched(**sched)), (OptimizerConfig(**opt), SchedulerConfig(**sched))


@pytest.mark.parametrize("case", list(CASES))
def test_chain_and_ema_match_optax(case):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    params["bn_init"]["bias"][:] = 0.0
    # Large gradients (clipped) and small ones (not), alternately.
    grads = [_tree(rng, 5.0 if i % 2 == 0 else 0.01) for i in range(5)]
    (jopt, jsched), (topt, tsched) = _configs(case)

    jtx = jmake(jopt, jsched)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    for g in grads:
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)

    holder = _holder()
    tp = bridge.flax_tree_to_named(holder, params)
    ttx = make_optimizer(topt, tsched)
    tstate = ttx.init(tp)
    assert set(tstate.slots) == {*SLOTS[case], "ema"}
    for g in grads:
        tstate = ttx.update(tp, bridge.flax_tree_to_named(holder, g), tstate)
    assert tstate.count == 5

    rtol = 1e-5 if case == "hybrid_adam" else 1e-6
    jstate = jax.device_get(jstate)
    for want, got in ((jp, tp), (jema_params(jstate), tstate.ema)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=rtol, atol=1e-7),
            jax.device_get(want), bridge.named_to_flax_tree(holder, got))
    # The moments / trace, carried into a fresh port state by the bridge.
    loaded = ttx.init(tp)
    bridge.load_optax_state(holder, loaded, jstate)
    assert loaded.count == 5
    for slot in SLOTS[case]:
        for n, t in tstate.slots[slot].items():
            ref = loaded.slots[slot][n]
            np.testing.assert_allclose(t.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-5 * float(ref.abs().max()), err_msg=slot)


def test_ema_is_seeded_with_the_parameters_and_follows_the_update():
    """``ema = d·ema + (1 − d)·p`` after each update, from the initial p."""
    tp = _params()
    tx = make_optimizer(OptimizerConfig(name="sgd", lr=0.1, momentum=0.0, ema_decay=0.75))
    state = tx.init(tp)
    for n, p in tp.items():
        assert torch.equal(state.ema[n], p) and state.ema[n] is not p
    before = {n: p.clone() for n, p in tp.items()}
    state = tx.update(tp, {n: torch.ones_like(p) for n, p in tp.items()}, state)
    for n, p in tp.items():
        torch.testing.assert_close(p, before[n] - 0.1)
        torch.testing.assert_close(state.ema[n], 0.75 * before[n] + 0.25 * p)


def test_out_of_place_update_leaves_the_state():
    """With ``out`` (the fp16 candidate) every slot is a new tensor and the
    old state is untouched."""
    tp = _params()
    tx = make_optimizer(OptimizerConfig(name="lamb", ema_decay=0.9))
    state = tx.init(tp)
    old = {k: {n: t.clone() for n, t in v.items()} for k, v in state.slots.items()}
    out = {n: torch.empty_like(p) for n, p in tp.items()}
    new = tx.update(tp, {n: torch.randn_like(p) for n, p in tp.items()}, state, out=out)
    for k, v in state.slots.items():
        for n, t in v.items():
            assert torch.equal(t, old[k][n])
            assert new.slots[k][n] is not t


def test_tensor_norms_without_a_group_are_the_norms():
    xs = [torch.randn(3, 4), torch.zeros(5), torch.randn(7)]
    norms = tensor_norms(xs)
    torch.testing.assert_close(norms, torch.stack([x.norm() for x in xs]))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(OptimizerConfig(name="adagrad"))
