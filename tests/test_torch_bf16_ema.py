"""bf16 on the image path, evaluation with the parameter EMA, and
checkpoints of the new optimizer states, against the JAX package on the
CPU.

- A bf16 ResNet step (SGD with momentum, the bench's image optimizer)
  against ``make_train_step`` of the JAX package with the Flax model at
  ``dtype=bfloat16``, from the same weights and batches, two steps. Both
  compute in bfloat16 over float32 parameters with float32 BatchNorm
  statistics, but XLA's and oneDNN's bf16 convolutions round at other
  places. At resnet_micro's size (batch 8, BatchNorm over 2×2 maps) a
  step's update is mostly BatchNorm parameters whose gradients cancel
  over the batch, so bf16 rounding moves it a lot: the JAX package's own
  bf16 update differs from its float32 one by 11.7% (norm of the
  difference over the norm of the update, all tensors), and the port's
  bf16 update from the JAX bf16 one by 16.0%, about √2 times that, as two
  independent roundings of one size would (measured on the CPU). So the
  update is held to twice the JAX package's own bf16-vs-float32 gap,
  computed in the test; the first step's loss (the same weights) to 5e-4
  relative (measured 1.28e-4); the BatchNorm statistics to 3e-2 of each
  tensor's norm (measured 0.92%).
- ``Trainer.fit()`` with ``ema_decay`` against the JAX Trainer (the
  slice test's config and tolerances: loss rtol 1e-4, parameters and
  their EMA atol 2e-5, eval accuracy within one example of 1024), eval
  reading the EMA parameters and BatchNorm statistics on both sides.
- Save and resume of every new slot (SGD trace, lamb's moments, both
  EMAs) at ZeRO stages 0, 1, 3, and 2 with ``cpu_offload`` (world 1):
  the resumed run equals the straight one bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu import config as jcfg
from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.optim import ema_batch_stats, ema_params
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_train_step as jax_step
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import config as tcfg
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.step import make_train_step
from distributed_training_tpu_torch.train.train_state import TrainState
from distributed_training_tpu_torch.train.trainer import Trainer

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

SGD = dict(name="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4)


def _update_norms(p0, a, b):
    """‖Δa − Δb‖ / ‖Δa‖ over every tensor, Δ the change from ``p0``."""
    delta = lambda tree: np.concatenate([(np.asarray(x) - y).ravel() for x, y in zip(  # noqa: E731
        jax.tree.leaves(tree), jax.tree.leaves(p0))])
    da, db = delta(a), delta(b)
    return np.linalg.norm(da - db) / np.linalg.norm(da)


def test_bf16_train_step_matches_jax():
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jstep, tstep = jax_step(mesh, donate=False), make_train_step()
    jstates = {dt: init_train_state(jax_model("resnet_micro", dtype=dt), jax.random.PRNGKey(0),
                                    (8, 64, 64, 3), jmake(JOpt(**SGD)),
                                    loss_scale=JLoss.create(JPrec(dtype="bf16")))
               for dt in (jnp.bfloat16, jnp.float32)}
    p0 = jax.device_get(jstates[jnp.bfloat16].params)
    tm = get_model("resnet_micro", dtype=torch.bfloat16)
    bridge.load_flax_variables(tm, p0, jax.device_get(jstates[jnp.bfloat16].batch_stats))
    tstate = TrainState.create(tm, make_optimizer(tcfg.OptimizerConfig(**SGD)),
                               LossScaleState.create(tcfg.PrecisionConfig(dtype="bf16")))
    seen = []
    tm.conv_init.register_forward_hook(lambda m, args, out: seen.append(out.dtype))
    rng = np.random.RandomState(0)
    for i in range(2):
        batch = {"image": rng.rand(8, 64, 64, 3).astype(np.float32),
                 "label": rng.randint(0, 10, 8).astype(np.int32)}
        jmet = {}
        for dt, js in jstates.items():
            jstates[dt], jmet[dt] = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                                          jax.random.PRNGKey(1))
        tmet = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        if i == 0:
            np.testing.assert_allclose(float(tmet["loss"]), float(jmet[jnp.bfloat16]["loss"]),
                                       rtol=5e-4)
        assert float(tmet["loss_scale"]) == 1.0 and float(tmet["grads_finite"]) == 1.0
    assert seen == [torch.bfloat16] * 2
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    params, stats = bridge.state_dict_to_flax(tm)
    jb16, jf32 = (jax.device_get(jstates[dt]) for dt in (jnp.bfloat16, jnp.float32))
    noise = _update_norms(p0, jb16.params, jf32.params)
    assert 0 < _update_norms(p0, jb16.params, params) < 2 * noise
    jax.tree.map(lambda a, b: np.testing.assert_array_less(
        np.linalg.norm(b - np.asarray(a)), 3e-2 * np.linalg.norm(np.asarray(a))),
        jb16.batch_stats, stats)


def _ema_cfg(mod, tmp_path):
    return mod.TrainConfig(
        model="resnet_micro", num_epochs=1, log_interval=2,
        optimizer=mod.OptimizerConfig(name="hybrid_adam", lr=1e-3, eps=1e-4,
                                      weight_decay=1e-4, ema_decay=0.5),
        data=mod.DataConfig(dataset="synthetic_cifar", batch_size=8,
                            max_steps_per_epoch=4, prefetch=0),
        checkpoint=mod.CheckpointConfig(directory=str(tmp_path), interval=0,
                                        async_save=False))


def test_ema_eval_matches_jax_trainer(tmp_path):
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jt = JaxTrainer(_ema_cfg(jcfg, tmp_path / "jax"), mesh=mesh)
    tt = Trainer(_ema_cfg(tcfg, tmp_path / "torch"), device="cpu")
    assert tt.uses_ema()
    bridge.load_flax_variables(tt.model, jax.device_get(jt.state.params),
                               jax.device_get(jt.state.batch_stats))
    # The EMAs start from the JAX initial weights and statistics too.
    bridge.load_optax_state(tt.model, tt.state.opt_state, jax.device_get(jt.state.opt_state))
    jout, tout = jt.fit(), tt.fit()
    assert tout["steps"] == jout["steps"] == 4
    np.testing.assert_allclose(tout["last_metrics"]["loss"],
                               jout["last_metrics"]["loss"], rtol=1e-4)
    assert abs(tout["final_acc"] - jout["final_acc"]) <= 1 / 1024
    jopt = jax.device_get(jt.state.opt_state)
    opt = tt.state.opt_state
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=2e-5),
                 ema_params(jopt), bridge.named_to_flax_tree(tt.model, opt.ema))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                                         atol=1e-5),
                 ema_batch_stats(jopt), bridge.named_to_flax_stats(tt.model, opt.ema_stats))
    # The EMA context holds the EMA weights, and gives the live ones back.
    live = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    with tt.state.ema_weights():
        for n, p in tt.model.named_parameters():
            assert torch.equal(p, opt.ema[n])
    for n, p in tt.model.named_parameters():
        assert torch.equal(p, live[n])


def _ckpt_cfg(tmp_path, opt, stage, epochs, resume=-1, offload=False):
    return tcfg.TrainConfig(
        model="resnet_micro", num_epochs=epochs, log_interval=1,
        optimizer=tcfg.OptimizerConfig(**opt),
        zero=tcfg.ZeroConfig(stage=stage, cpu_offload=offload),
        data=tcfg.DataConfig(dataset="synthetic_cifar", batch_size=8, max_steps_per_epoch=2),
        checkpoint=tcfg.CheckpointConfig(directory=str(tmp_path), interval=1, resume=resume))


@pytest.mark.parametrize("opt,stage,offload", [
    (dict(name="sgd", lr=0.05, ema_decay=0.9), 0, False),
    (dict(name="lamb", lr=1e-2, ema_decay=0.9), 1, False),
    (dict(name="adamw", lr=1e-2, weight_decay=1e-2, ema_decay=0.9), 3, False),
    (dict(name="sgd", lr=0.05, nesterov=True, ema_decay=0.9), 2, True),
], ids=["sgd_trace_s0", "lamb_s1", "adamw_s3", "sgd_s2_offload"])
def test_new_states_round_trip_through_a_checkpoint(tmp_path, opt, stage, offload):
    straight = Trainer(_ckpt_cfg(tmp_path / "a", opt, stage, 2, offload=offload),
                       device="cpu")
    straight.fit()
    Trainer(_ckpt_cfg(tmp_path / "b", opt, stage, 1, offload=offload), device="cpu").fit()
    resumed = Trainer(_ckpt_cfg(tmp_path / "b", opt, stage, 2, resume=0, offload=offload),
                      device="cpu")
    resumed.fit()
    if offload:
        assert all(t.device.type == "cpu" for slot in resumed.state.opt_state.slots.values()
                   for t in slot.values())
    a, b = straight.state.state_dict(), resumed.state.state_dict()
    assert set(a["opt_state"]) == set(b["opt_state"]) == (
        {"count", "ema", "ema_stats"} | ({"trace"} if opt["name"] == "sgd" else {"mu", "nu"}))
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4
    for key in ("model",):
        for n, t in a[key].items():
            assert torch.equal(b[key][n], t), n
    for slot, tensors in a["opt_state"].items():
        if slot != "count":
            for n, t in tensors.items():
                assert torch.equal(b["opt_state"][slot][n], t), (slot, n)


def test_checkpoint_of_another_optimizer_is_refused(tmp_path):
    """A save whose slots differ from the state's (sgd's trace against
    lamb's moments) raises instead of loading half of it."""
    Trainer(_ckpt_cfg(tmp_path, dict(name="sgd", lr=0.05), 0, 1), device="cpu").fit()
    other = Trainer(_ckpt_cfg(tmp_path, dict(name="lamb"), 0, 2, resume=0), device="cpu")
    with pytest.raises(ValueError, match="slots"):
        other.fit()
