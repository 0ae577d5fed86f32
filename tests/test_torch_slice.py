"""The slice as a whole: the port's ``Trainer.fit()`` against the JAX
package's on a one-device mesh, from the same initial weights, over the
same synthetic-CIFAR batches, with ``hybrid_adam`` (the JAX side runs its
Pallas kernel in interpret mode).

Tolerances: float32 on the CPU with convolutions summed in different
orders, over 4 steps; the last ResNet stage normalises 1×1 maps over 8
images, which amplifies that rounding in the gradients. Adam's eps is
1e-4 so that near-zero gradients do not turn rounding into lr-sized
steps. Loss at rtol 1e-4, parameters at atol 2e-5 (2% of lr 1e-3), eval
accuracy within one example of 1024.
"""

import jax
import numpy as np
import torch

from distributed_training_tpu import config as jcfg
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import config as tcfg
from distributed_training_tpu_torch.train.trainer import Trainer

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _cfg(mod, tmp_path):
    return mod.TrainConfig(
        model="resnet_micro", num_epochs=1, log_interval=2,
        optimizer=mod.OptimizerConfig(name="hybrid_adam", lr=1e-3, eps=1e-4,
                                      weight_decay=1e-4),
        scheduler=mod.SchedulerConfig(name="warmup_lr", warmup_max_lr=1e-3,
                                      warmup_num_steps=2),
        data=mod.DataConfig(dataset="synthetic_cifar", batch_size=8,
                            max_steps_per_epoch=4, prefetch=0),
        checkpoint=mod.CheckpointConfig(directory=str(tmp_path), interval=0,
                                        async_save=False))


def test_fit_matches_jax_trainer(tmp_path):
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jt = JaxTrainer(_cfg(jcfg, tmp_path / "jax"), mesh=mesh)
    tt = Trainer(_cfg(tcfg, tmp_path / "torch"), device="cpu")
    bridge.load_flax_variables(tt.model, jax.device_get(jt.state.params),
                               jax.device_get(jt.state.batch_stats))
    jout = jt.fit()
    tout = tt.fit()
    assert set(tout) == set(jout)
    assert tout["steps"] == jout["steps"] == 4
    assert tout["preempted"] is jout["preempted"] is False
    np.testing.assert_allclose(tout["last_metrics"]["loss"],
                               jout["last_metrics"]["loss"], rtol=1e-4)
    assert abs(tout["final_acc"] - jout["final_acc"]) <= 1 / 1024
    params, _ = bridge.state_dict_to_flax(tt.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=2e-5),
                 jax.device_get(jt.state.params), params)
