"""The port's train step against ``make_train_step`` of the JAX package on
a one-device mesh, and the loss scaler and guarded commit against the JAX
precision module.

Inputs and weights come from numpy and the JAX initialiser, carried over
by ``bridge.py``. Tolerances: float32 on the CPU with convolutions summed
in another order. The images are 64×64 so that the last stage's
BatchNorm normalises 2×2 maps: at 32×32 it normalises 1×1 maps over a
few examples, which amplifies that rounding noise in every gradient
below it. Moments compare within 1e-4 of each tensor's largest
magnitude (a near-zero moment carries the gradient's absolute rounding
error, not a relative one), parameters at atol 1e-6 (lr is
1e-3), BatchNorm statistics (whose second update already sees the
first step's rounding) at atol 1e-5 on values of order 0.1, loss and
accuracy at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.ops.fused_adam import FusedAdamState
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_train_step as jax_step
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import (
    LossScaleState,
    all_finite,
    commit_gradients,
)
from distributed_training_tpu_torch.train.step import (
    cross_entropy_loss,
    make_eval_step,
    make_train_step,
)
from distributed_training_tpu_torch.train.train_state import TrainState

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

# eps 1e-4, not 1e-8: a BatchNorm bias whose gradient sums to ~1e-9
# (cancellation over the batch) moves by lr·g/(|g|+eps), which at eps
# 1e-8 turns the gradient's rounding noise into a step of order lr.
OPT = dict(name="hybrid_adam", lr=1e-3, eps=1e-4, weight_decay=1e-3,
           grad_clip_norm=5.0)


def _batches(n_steps, batch=8, size=64):
    rng = np.random.RandomState(0)
    return [{"image": rng.rand(batch, size, size, 3).astype(np.float32),
             "label": rng.randint(0, 10, batch).astype(np.int32)}
            for _ in range(n_steps)]


def _fused_state(opt_state):
    for s in (opt_state if isinstance(opt_state, tuple) else (opt_state,)):
        if isinstance(s, FusedAdamState):
            return s
    raise AssertionError("no FusedAdamState in the chain")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jm = jax_model("resnet_micro")
    jstate = init_train_state(jm, jax.random.PRNGKey(0), (8, 64, 64, 3),
                              jmake(JOpt(**OPT)),
                              loss_scale=JLoss.create(JPrec()))
    tm = get_model("resnet_micro")
    bridge.load_flax_variables(tm, jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    tstate = TrainState.create(tm, make_optimizer(OptimizerConfig(**OPT)),
                               LossScaleState.create(PrecisionConfig()))
    jstep = jax_step(mesh, donate=False, grad_accum_steps=accum)
    tstep = make_train_step(grad_accum_steps=accum)
    for batch in _batches(2):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(1))
        tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "accuracy", "loss_scale", "grads_finite"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)

    assert tstate.step == int(jstate.step) == 2
    params, stats = bridge.state_dict_to_flax(tm.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-6),
                 jax.device_get(jstate.params), params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=1e-4, atol=1e-5),
        jax.device_get(jstate.batch_stats), stats)
    fs = _fused_state(jax.device_get(jstate.opt_state))
    assert tstate.opt_state.count == int(fs.count) == 2
    for mine, ref in ((tstate.opt_state.mu, fs.mu), (tstate.opt_state.nu, fs.nu)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            ref, bridge.named_to_flax_tree(mine))


SEQUENCES = [
    [True] * 7,
    [False, False, False, True, True, True, False],
    [False] * 6 + [True] * 4,
    [True, False, True, False, False, True, True, True, True],
]


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda s: "".join("TF"[not f] for f in s))
@pytest.mark.parametrize("static", [None, 64.0])
def test_loss_scale_transitions_match_jax(seq, static):
    cfg = dict(dtype="fp16", initial_scale_power=3, loss_scale_window=3,
               hysteresis=2, min_loss_scale=2.0, static_loss_scale=static)
    j, t = JLoss.create(JPrec(**cfg)), LossScaleState.create(PrecisionConfig(**cfg))
    assert t.dynamic == j.dynamic
    for finite in seq:
        j, t = j.update(jnp.bool_(finite)), t.update(finite)
        assert (t.scale, t.good_steps, t.hysteresis_left) == (
            float(j.scale), int(j.good_steps), int(j.hysteresis_left))


def test_inert_scaler_for_fp32():
    t = LossScaleState.create(PrecisionConfig())
    assert not t.dynamic and t.scale == 1.0 and t.update(False) is t


def _fp16_state():
    tm = get_model("resnet_micro", generator=torch.Generator().manual_seed(3))
    return TrainState.create(tm, make_optimizer(OptimizerConfig(name="hybrid_adam")),
                             LossScaleState.create(PrecisionConfig(dtype="fp16")))


def _snapshot(state):
    return ([p.clone() for p in state.model.parameters()],
            [b.clone() for b in state.model.buffers()],
            [t.clone() for t in state.opt_state.mu.values()],
            [t.clone() for t in state.opt_state.nu.values()])


def _assert_unchanged(state, snap):
    now = _snapshot(state)
    for a, b in zip(sum(now, []), sum(snap, [])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["inf_grad", "nan_grad", "update_overflow"])
def test_non_finite_candidate_leaves_state_unchanged(bad):
    state = _fp16_state()
    snap = _snapshot(state)
    grads = {n: torch.full_like(p, 1e-3) for n, p in state.params().items()}
    first = next(iter(grads))
    if bad == "inf_grad":
        grads[first][0] = float("inf")
    elif bad == "nan_grad":
        grads[first][0] = float("nan")
    else:
        # Finite, but g² overflows float32 inside Adam: only a guard on
        # the updated state catches it.
        grads[first][0] = 1e30
        assert bool(all_finite(list(grads.values())))
    assert commit_gradients(state, grads, snap[1]) is False
    _assert_unchanged(state, snap)
    assert state.step == 0 and state.opt_state.count == 0
    assert state.loss_scale.hysteresis_left == 1
    assert state.loss_scale.scale == 2.0 ** 15


def test_finite_candidate_is_committed_by_reference_swap():
    state = _fp16_state()
    before = {n: p.data_ptr() for n, p in state.params().items()}
    grads = {n: torch.full_like(p, 1e-3) for n, p in state.params().items()}
    assert commit_gradients(state, grads) is True
    assert state.step == 1 and state.opt_state.count == 1
    after = state.params()
    assert all(after[n].data_ptr() != before[n] for n in before)
    assert all(torch.all(p < 1.0) for n, p in after.items() if n.endswith("weight")
               and "BatchNorm_0" in n)


def test_overflowed_step_restores_batchnorm_stats():
    state = _fp16_state()
    snap = _snapshot(state)
    rng = np.random.RandomState(0)
    image = rng.rand(4, 32, 32, 3).astype(np.float32)
    image[0, 0, 0, 0] = np.inf
    step = make_train_step()
    metrics = step(state, {"image": torch.from_numpy(image),
                           "label": torch.from_numpy(np.arange(4, dtype=np.int32))})
    assert metrics["grads_finite"] == 0.0
    _assert_unchanged(state, snap)
    assert state.step == 0


def test_cross_entropy_label_smoothing_matches_optax():
    import optax

    rng = np.random.RandomState(0)
    logits = rng.randn(6, 10).astype(np.float32)
    labels = rng.randint(0, 10, 6)
    for eps in (0.0, 0.1):
        targets = optax.smooth_labels(jax.nn.one_hot(labels, 10), eps)
        want = float(optax.softmax_cross_entropy(jnp.asarray(logits), targets).mean())
        got = float(cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels), eps))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_eval_step_counts_top1_top5_and_mask():
    tm = get_model("resnet_micro")
    state = TrainState.create(tm, make_optimizer(OptimizerConfig()))
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.rand(6, 32, 32, 3).astype(np.float32)),
             "label": torch.from_numpy(rng.randint(0, 10, 6).astype(np.int32)),
             "mask": torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)}
    c1, c5, n = make_eval_step()(state, batch)
    with torch.no_grad():
        logits = tm(batch["image"])
    top5 = logits.topk(5).indices
    lab = batch["label"].long()
    assert float(n) == 4.0
    assert float(c1) == float((logits.argmax(-1) == lab)[:4].sum())
    assert float(c5) == float((top5 == lab[:, None]).any(-1)[:4].sum())
