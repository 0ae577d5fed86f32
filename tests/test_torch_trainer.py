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
    MeshSpec,
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


PRESETS = {
    "torch_ddp": {}, "torch_ddp_fp16": {}, "low_level_zero": {}, "gemini": {},
    "deepspeed": dict(zero=ZeroConfig(stage=2, cpu_offload=True)),
}


@pytest.mark.parametrize("plugin", list(PRESETS))
def test_every_plugin_preset_fits_and_equals_its_stage0_twin(tmp_path, plugin):
    """All five presets run at world 1 (``low_level_zero`` is ZeRO 1 in
    fp16, ``gemini`` ZeRO 3, the deepspeed one here ZeRO 2 with
    ``cpu_offload``), and each step's loss and the final parameters equal
    those of the same config at ZeRO stage 0: at world 1 a stage partitions
    nothing. Stages 1 and 3 run the same arithmetic bit for bit; the
    deepspeed clip's global norm sums the shards' squared norms, which
    rounds otherwise than one norm over all tensors: atol 1e-6 (lr 3e-3)."""
    def run(zero, tag):
        cfg = TrainConfig.from_plugin(plugin, **{
            k: v for k, v in vars(_cfg(tmp_path / tag)).items()
            if k in ("model", "num_epochs", "log_interval", "data", "checkpoint")},
            **({"zero": zero} if zero else {}))
        cfg = cfg.replace(optimizer=OptimizerConfig(
            **{**vars(cfg.optimizer), "name": "hybrid_adam", "lr": 3e-3}))
        t = Trainer(cfg, device="cpu")
        out = t.fit()
        t.state.gather_params()
        return out, [h["loss"] for h in t.meter.history], _params(t), t

    out, losses, params, t = run(PRESETS[plugin].get("zero"), "preset")
    want_stage = {"low_level_zero": 1, "gemini": 3, "deepspeed": 2}.get(plugin, 0)
    assert t.state.zero.stage == want_stage and out["steps"] == 3
    if plugin == "deepspeed":
        assert all(m.device.type == "cpu" for m in t.state.opt_state.mu.values())
    _, twin_losses, twin, _ = run(ZeroConfig(stage=0), "twin")
    np.testing.assert_allclose(losses, twin_losses, rtol=1e-6)
    for n in twin:
        torch.testing.assert_close(params[n], twin[n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("override", [
    dict(tp_overlap=True), dict(mesh=MeshSpec(fsdp=2)),
    dict(mesh=MeshSpec(pipe=2)), dict(mesh=MeshSpec(model=2)),
    dict(mesh=MeshSpec(sequence=2)), dict(mesh=MeshSpec(expert=2)),
    dict(model="vit_b16"),
])
def test_unported_options_raise(tmp_path, override):
    """What the Trainer still lacks. (remat, precise-BN, the metric sinks,
    the wall-clock breakdown and the profiler, which this test once
    listed, are ported: test_torch_remat.py, test_torch_resilience.py. So
    are ViT, the model axis and ``tp_overlap``, multi-rank in
    test_torch_vit_tp.py: here, at world 1, ``tp_overlap`` over a model
    axis of 1 builds the plain step, as the JAX Trainer does, a model axis
    of 2 is a mesh one process cannot hold, refused as ``create_mesh``
    refuses it, and ``vit_b16`` builds and trains a step. The fsdp axis is
    ported, multi-rank in test_torch_fsdp.py: an fsdp axis of 2 is a mesh
    one process cannot hold too. So are the sequence and pipe axes, which
    replicate the step, multi-rank in test_torch_trainer_axes.py, and so
    is an expert axis on a model without MoE layers: at world 1 an axis of
    2 is refused as ``create_mesh`` refuses it.)"""
    cfg = _cfg(tmp_path, **override)
    if override == dict(tp_overlap=True):
        t = Trainer(cfg, device="cpu")
        assert t.tp is None and t._microbatches == t.grad_accum
        return
    if override in (dict(mesh=MeshSpec(model=2)), dict(mesh=MeshSpec(fsdp=2)),
                    dict(mesh=MeshSpec(sequence=2)), dict(mesh=MeshSpec(pipe=2)),
                    dict(mesh=MeshSpec(expert=2))):
        with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
            Trainer(cfg, device="cpu")
        return
    if override == dict(model="vit_b16"):
        from distributed_training_tpu_torch.models.vit import ViT

        t = Trainer(cfg.replace(data=DataConfig(dataset="synthetic_cifar", batch_size=2,
                                                max_steps_per_epoch=1)), device="cpu")
        assert isinstance(t.model, ViT) and t.model.pos_embed.shape == (1, 5, 768)
        batch = next(iter(t.make_loaders()[0]))
        assert np.isfinite(float(t.train_step(t.state, t.place(batch))["loss"]))