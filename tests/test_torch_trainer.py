"""The port's Trainer on the CPU: ``fit()`` returns the JAX trainer's
keys, a checkpoint resume is step-accurate, an uncommitted save is
skipped, and unported options raise instead of being ignored."""

import os

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import checkpoint as ckpt
from distributed_training_tpu_torch.config import (
    CheckpointConfig,
    DataConfig,
    OptimizerConfig,
    TrainConfig,
    ZeroConfig,
)
from distributed_training_tpu_torch.train.trainer import Trainer

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

# distributed_training_tpu/train/trainer.py returns exactly these keys.
JAX_FIT_KEYS = {"final_acc", "preempted", "last_metrics", "steps"}


def _cfg(tmp_path, **kw):
    base = dict(model="resnet_micro", num_epochs=1, log_interval=2,
                optimizer=OptimizerConfig(name="hybrid_adam", lr=3e-3),
                data=DataConfig(dataset="synthetic_cifar", batch_size=8,
                                max_steps_per_epoch=3),
                checkpoint=CheckpointConfig(directory=str(tmp_path / "ck"),
                                            interval=1))
    base.update(kw)
    return TrainConfig(**base)


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def test_fit_returns_jax_keys(tmp_path):
    out = Trainer(_cfg(tmp_path), device="cpu").fit()
    assert set(out) == JAX_FIT_KEYS
    assert out["steps"] == 3 and out["preempted"] is False
    assert 0.0 <= out["final_acc"] <= 1.0
    assert np.isfinite(out["last_metrics"]["loss"])
    assert ckpt.latest_valid_epoch(str(tmp_path / "ck")) == 0


def test_fp16_fit_drives_the_loss_scaler(tmp_path):
    cfg = TrainConfig.from_plugin(
        "torch_ddp_fp16", **{k: v for k, v in vars(_cfg(tmp_path)).items()
                             if k in ("model", "num_epochs", "log_interval",
                                      "optimizer", "data", "checkpoint")})
    out = Trainer(cfg, device="cpu").fit()
    assert out["last_metrics"]["loss_scale"] == 2.0 ** 15
    assert out["steps"] == 3


def test_resume_is_step_accurate(tmp_path):
    straight = Trainer(_cfg(tmp_path / "a", num_epochs=2), device="cpu")
    straight.fit()
    first = Trainer(_cfg(tmp_path / "b", num_epochs=1), device="cpu")
    first.fit()
    resumed = Trainer(_cfg(tmp_path / "b", num_epochs=2,
                           checkpoint=CheckpointConfig(
                               directory=str(tmp_path / "b" / "ck"),
                               interval=1, resume=0)), device="cpu")
    out = resumed.fit()
    assert out["steps"] == straight.state.step == 6
    assert resumed.state.opt_state.count == 6
    a, b = _params(straight), _params(resumed)
    for n in a:
        torch.testing.assert_close(b[n], a[n], rtol=0, atol=0)
    for x, y in zip(straight.model.buffers(), resumed.model.buffers()):
        torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_uncommitted_checkpoint_is_skipped(tmp_path):
    t = Trainer(_cfg(tmp_path, num_epochs=2), device="cpu")
    t.fit()
    d = str(tmp_path / "ck")
    os.remove(os.path.join(d, "epoch_1", ckpt.COMMIT_NAME))
    with pytest.warns(UserWarning, match="UNCOMMITTED"):
        assert ckpt.latest_valid_epoch(d) == 0
    assert os.path.isdir(os.path.join(d, "epoch_1.corrupt"))
    auto = CheckpointConfig(directory=d, auto_resume=True)
    assert ckpt.resolve_resume(auto) == 0
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify_checkpoint(os.path.join(d, "epoch_1.corrupt"))


def test_altered_payload_is_refused(tmp_path):
    t = Trainer(_cfg(tmp_path), device="cpu")
    t.fit()
    path = os.path.join(str(tmp_path / "ck"), "epoch_0", ckpt.PAYLOAD)
    with open(path, "r+b") as fh:
        fh.seek(100)
        fh.write(b"\x00\x01\x02")
    with pytest.raises(ckpt.CheckpointCorruptError, match="manifest"):
        ckpt.restore_checkpoint(str(tmp_path / "ck"), 0, t.state)


def test_prune_keeps_newest_verified(tmp_path):
    t = Trainer(_cfg(tmp_path, num_epochs=3,
                     checkpoint=CheckpointConfig(directory=str(tmp_path / "ck"),
                                                 interval=1, keep=10)),
                device="cpu")
    t.fit()
    d = str(tmp_path / "ck")
    os.remove(os.path.join(d, "epoch_2", ckpt.COMMIT_NAME))
    ckpt.prune_checkpoints(d, keep=1)
    assert sorted(os.listdir(d)) == ["epoch_1", "epoch_2"]


def test_target_acc_gate(tmp_path):
    with pytest.raises(RuntimeError, match="target accuracy"):
        Trainer(_cfg(tmp_path, target_acc=1.01), device="cpu").fit()


@pytest.mark.parametrize("override", [
    dict(remat=True), dict(eval_precise_bn_batches=2),
    dict(tensorboard_dir="tb"), dict(zero=ZeroConfig(stage=1)),
    dict(optimizer=OptimizerConfig(name="hybrid_adam", ema_decay=0.999)),
    dict(optimizer=OptimizerConfig(name="lamb")),
    dict(model="vit_b16"),
])
def test_unported_options_raise(tmp_path, override):
    with pytest.raises(NotImplementedError):
        Trainer(_cfg(tmp_path, **override), device="cpu")
