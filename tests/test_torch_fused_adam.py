"""The port's fused Adam (plain version and optimizer chains) against the
JAX package's Pallas kernel, run in interpret mode as
``tests/test_fused_adam.py`` runs it.

Tolerances: the moments follow the same float32 operations in the same
order, and the bias corrections ``1/(1-b**t)`` are float32 scalars from
numpy's ``powf`` on one side and XLA's on the other, which may differ by
an ulp; rtol 1e-6 covers that. The chains compare at rtol 1e-5: the JAX
``fused_adam`` returns deltas that ``apply_updates`` adds back
(``p + (new_p - p)``, 1 ulp of ``p``), and the clip's global norm sums
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import SchedulerConfig as JSched
from distributed_training_tpu.ops.fused_adam import (
    FusedAdamState,
    fused_adam_kernel_update,
)
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.optim import make_schedule as jschedule
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import OptimizerConfig, SchedulerConfig
from distributed_training_tpu_torch.ops.fused_adam import (
    adam_scalars,
    fused_adam_reference,
    fused_adam_update,
)
from distributed_training_tpu_torch.train.optim import make_optimizer, make_schedule

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(1,), (300, 7), (5, 3, 2), (32768,)])
def test_reference_matches_pallas_kernel(shape):
    rng = np.random.RandomState(0)
    p = rng.randn(*shape).astype(np.float32)
    m = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    jp, jm, jv = jnp.asarray(p), jnp.asarray(m), jnp.asarray(v)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    for step in range(1, 5):
        g = rng.randn(*shape).astype(np.float32)
        jp, jm, jv = fused_adam_kernel_update(
            jp, jnp.asarray(g), jm, jv, jnp.float32(3e-3), jnp.int32(step),
            b1=0.8, b2=0.95, eps=1e-8, interpret=True)
        tp, tm, tv = fused_adam_reference(tp, torch.from_numpy(g), tm, tv,
                                          3e-3, step, 0.8, 0.95, 1e-8)
    for j, t in ((jp, tp), (jm, tm), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_scalars_are_float32_bias_corrections():
    lr, bc1, bc2 = adam_scalars(1e-3, 3, 0.9, 0.999)
    assert all(isinstance(x, np.float32) for x in (lr, bc1, bc2))
    t = jnp.float32(3)
    np.testing.assert_allclose(bc1, 1.0 / (1.0 - 0.9 ** t), rtol=1e-7)
    np.testing.assert_allclose(bc2, 1.0 / (1.0 - 0.999 ** t), rtol=1e-6)


CHAINS = [
    dict(name="hybrid_adam"),
    dict(name="hybrid_adam", weight_decay=1e-2, grad_clip_norm=1.0),
    dict(name="hybrid_adam", weight_decay=1e-2, weight_decay_mask="no_1d",
         betas=(0.8, 0.999)),
    dict(name="adam", weight_decay=1e-2, grad_clip_norm=1.0),
]
SCHEDULES = [
    dict(name="constant"),
    dict(name="warmup_lr", warmup_min_lr=1e-4, warmup_max_lr=2e-3,
         warmup_num_steps=3),
    dict(name="cosine", warmup_min_lr=0.0, warmup_num_steps=2, total_steps=6),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["name"])
def test_schedule_matches_optax(sched):
    opt = dict(lr=2e-3, scale_lr_by_world=True)
    js = jschedule(JOpt(**opt), JSched(**sched), world_size=2)
    ts = make_schedule(OptimizerConfig(**opt), SchedulerConfig(**sched), 2)
    for count in range(9):
        np.testing.assert_allclose(ts(count), np.asarray(js(jnp.int32(count))),
                                   rtol=1e-6)


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["name"])
@pytest.mark.parametrize("chain", CHAINS,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_chain_matches_jax_make_optimizer(chain, sched):
    rng = np.random.RandomState(1)
    init = {"w": rng.randn(16, 8).astype(np.float32),
            "b": rng.randn(8).astype(np.float32)}
    jtx = jmake(JOpt(**chain), JSched(**sched))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jtx.init(jp)
    ttx = make_optimizer(OptimizerConfig(**chain), SchedulerConfig(**sched))
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    tstate = ttx.init(tp)
    for _ in range(4):
        g = {k: (3.0 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in init.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = ttx.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                            tstate)
    assert tstate.count == 4
    for k in init:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


def test_adam_state_carried_from_jax_continues_the_run():
    """``bridge.load_flax_adam_state`` carries a JAX ``hybrid_adam`` state
    (count, mu, nu, in Flax names and layouts) into the port: two more
    steps on each side agree, at the chain tolerance above."""
    rng = np.random.RandomState(3)
    shapes = {"conv_init": {"kernel": (3, 3, 2, 4)},
              "bn_init": {"scale": (4,), "bias": (4,)},
              "Dense_0": {"kernel": (4, 5), "bias": (5,)}}

    def tree():
        return jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                            is_leaf=lambda s: isinstance(s, tuple))
    opt = dict(name="hybrid_adam", weight_decay=1e-2)
    jtx = jmake(JOpt(**opt))
    jp = jax.tree.map(jnp.asarray, tree())
    jstate = jtx.init(jp)
    grads = [tree() for _ in range(4)]

    def jax_step(g):
        nonlocal jp, jstate
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
    for g in grads[:2]:
        jax_step(g)

    ttx = make_optimizer(OptimizerConfig(**opt))
    tp = bridge.flax_tree_to_named(jax.device_get(jp))
    tstate = ttx.init(tp)
    fs = next(s for s in jax.device_get(jstate) if isinstance(s, FusedAdamState))
    bridge.load_flax_adam_state(tstate, fs.count, fs.mu, fs.nu)
    assert tstate.count == 2
    for g in grads[2:]:
        jax_step(g)
        tstate = ttx.update(tp, bridge.flax_tree_to_named(g), tstate)
    assert tstate.count == 4
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=1e-5, atol=1e-7),
        jax.device_get(jp), bridge.named_to_flax_tree(tp))


def test_out_of_place_update_leaves_inputs():
    rng = np.random.RandomState(2)
    p, g = (torch.from_numpy(rng.randn(7, 3).astype(np.float32)) for _ in range(2))
    m, v = torch.zeros(7, 3), torch.zeros(7, 3)
    before = [t.clone() for t in (p, m, v)]
    outs = ([torch.empty(7, 3)], [torch.empty(7, 3)], [torch.empty(7, 3)])
    fused_adam_update([p], [g], [m], [v], lr=1e-3, step=1, out=outs)
    for t, b in zip((p, m, v), before):
        assert torch.equal(t, b)
    want = fused_adam_reference(p, g, m, v, 1e-3, 1)
    for o, w in zip(outs, want):
        assert torch.equal(o[0], w)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = fused_adam_update.launches
    p = torch.ones(10)
    fused_adam_update([p], [torch.ones(10)], [torch.zeros(10)],
                      [torch.zeros(10)], lr=1e-2, step=1)
    assert fused_adam_update.launches == before
    assert torch.all(p < 1.0)


def test_non_cpu_tensors_never_fall_back():
    # A tensor that is not on the CPU must reach the kernel or raise: a
    # meta tensor is neither CPU nor CUDA.
    p = torch.empty(10, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        fused_adam_update([p], [p], [p], [p], lr=1e-2, step=1)
