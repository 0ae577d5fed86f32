"""The trainer features the port shares between its trainers: the SIGTERM
guard and the step-accurate preemption save, the background checkpoint
writer, the metric sinks, the wall-clock breakdown, the profiler trace,
and precise-BN. On the CPU, micro models.

- A SIGTERM raised in the process mid-epoch (and in an epoch's last step,
  where the save rolls over to the next epoch) stops ``LMTrainer.fit()``
  with ``preempted``; the resumed run's parameters equal the uninterrupted
  run's bit for bit (float32, the same operations in the same order).
- The background writer's save holds the state of the moment it was
  asked for, though training went on and updated the parameters and
  moments in place before the writer wrote; a failure in the writer
  surfaces on ``wait`` (and on a synchronous save).
- ``MetricsWriter``'s JSONL is byte-equal to the JAX package's for the
  same metrics, and its TensorBoard event file exists; without the
  ``tensorboard`` package a TensorBoard request raises ``ImportError``
  naming the option, and nothing is written instead.
- ``WallClock.report()`` has the JAX ``WallClock``'s keys for the same
  phases; ``trace`` writes a Chrome trace.
- Precise-BN statistics equal the JAX trainer's ``_refresh_batch_stats``
  on the same weights and batches: rtol 1e-4, atol 1e-5, the BatchNorm
  statistics' limits of ``tests/test_torch_step.py`` (Flax and the port
  compute the variance in other float32 orders).
"""

import json
import os
import signal
import sys
import threading
import types
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer
from distributed_training_tpu.utils.metrics_io import MetricsWriter as JaxMetricsWriter
from distributed_training_tpu.utils.profiling import WallClock as JaxWallClock
from distributed_training_tpu_torch import LMTrainer, bridge
from distributed_training_tpu_torch import checkpoint as ckpt
from distributed_training_tpu_torch import config as tcfg
from distributed_training_tpu_torch.resilience import async_ckpt
from distributed_training_tpu_torch.train.trainer import Trainer
from distributed_training_tpu_torch.utils.metrics_io import MetricsWriter
from distributed_training_tpu_torch.utils.profiling import WallClock, trace

torch.set_num_threads(1)


def _lm_cfg(ckpt_dir, **kw):
    return tcfg.TrainConfig(
        model="transformer_lm", num_epochs=2, log_interval=1,
        optimizer=tcfg.OptimizerConfig(name="hybrid_adam", lr=1e-3, eps=1e-4),
        lm=tcfg.LMConfig(seq_len=16, vocab_size=64, num_layers=2, num_heads=2,
                         hidden_dim=32, max_len=32, logits_dtype="fp32",
                         train_sequences=32, eval_sequences=8),
        data=tcfg.DataConfig(batch_size=4, max_steps_per_epoch=4),
        checkpoint=tcfg.CheckpointConfig(directory=str(ckpt_dir), interval=1,
                                         auto_resume=True),
    ).replace(**kw)


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


@pytest.mark.parametrize("async_save", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("at,resume_at", [(2, (0, 2)), (4, (1, 0))],
                         ids=["mid_epoch", "epoch_end"])
def test_sigterm_save_resumes_step_accurately(tmp_path, at, resume_at, async_save):
    straight = LMTrainer(_lm_cfg(tmp_path / "a"), device="cpu")
    straight.fit()
    cfg = _lm_cfg(tmp_path / "b", checkpoint=tcfg.CheckpointConfig(
        directory=str(tmp_path / "b"), interval=1, auto_resume=True,
        async_save=async_save))
    first = LMTrainer(cfg, device="cpu")
    step = first.train_step

    def preempting(state, batch):
        out = step(state, batch)
        if state.step == at:
            signal.raise_signal(signal.SIGTERM)
        return out

    first.train_step = preempting
    out = first.fit()
    assert out["preempted"] and out["steps"] == at
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL or callable(
        signal.getsignal(signal.SIGTERM))  # the guard put the old handler back
    epoch = ckpt.latest_valid_epoch(str(tmp_path / "b"))
    blob = torch.load(os.path.join(tmp_path / "b", f"epoch_{epoch}", ckpt.PAYLOAD),
                      weights_only=True)
    assert (blob["meta"]["next_epoch"], blob["meta"]["epoch_step"]) == resume_at
    resumed = LMTrainer(cfg, device="cpu")
    out = resumed.fit()
    assert not out["preempted"] and out["steps"] == straight.state.step == 8
    a, b = _params(straight), _params(resumed)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_async_save_holds_the_snapshot_step(tmp_path, monkeypatch):
    """The writer is held until training has gone on two more steps (the
    optimizer updates the parameters and moments in place); the save it
    then writes is the state at the moment of the request."""
    t = LMTrainer(_lm_cfg(tmp_path / "x", num_epochs=1), device="cpu")
    loader, _ = t.make_loaders()
    batches = [t.place(b) for b in loader]
    t.train_step(t.state, batches[0])
    at_save = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    mu_at_save = {n: m.clone() for n, m in t.state.opt_state.mu.items()}
    release = threading.Event()
    write = ckpt.write_checkpoint

    def held(*args, **kw):
        assert release.wait(30)
        return write(*args, **kw)

    monkeypatch.setattr(async_ckpt.ckpt_lib, "write_checkpoint", held)
    writer = async_ckpt.AsyncCheckpointWriter()
    writer.save(str(tmp_path / "snap"), 0, t.state)
    for b in batches[1:3]:
        t.train_step(t.state, b)
    assert t.state.step == 3
    assert not torch.equal(t.model.lm_head.kernel, at_save["lm_head.kernel"])
    release.set()
    writer.wait()
    writer.close()
    blob = torch.load(tmp_path / "snap" / "epoch_0" / ckpt.PAYLOAD, weights_only=True)
    assert blob["state"]["step"] == 1
    for n, p in at_save.items():
        assert torch.equal(blob["state"]["model"][n], p), n
    for n, m in mu_at_save.items():
        assert torch.equal(blob["state"]["opt_state"]["mu"][n], m), n


def test_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    t = LMTrainer(_lm_cfg(tmp_path / "y", num_epochs=1), device="cpu")

    def failing(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(async_ckpt.ckpt_lib, "write_checkpoint", failing)
    writer = async_ckpt.AsyncCheckpointWriter(printer=lambda *_: None)
    writer.save(str(tmp_path / "f"), 0, t.state)
    with pytest.raises(RuntimeError, match="disk full"):
        writer.wait()
    writer.wait()  # surfaced once
    with pytest.raises(RuntimeError, match="disk full"):
        writer.save(str(tmp_path / "f"), 1, t.state, sync=True)
    assert writer.counters == {"saves_committed": 0, "saves_failed": 2}
    writer.close()


def test_metrics_jsonl_equals_jax_and_tensorboard_writes(tmp_path):
    flushes = [(1, {"loss": np.float32(2.5), "accuracy": 0.25, "step": 1}, "train"),
               (2, {"loss": torch.tensor(1.125), "grads_finite": True}, "train"),
               (2, {"perplexity": 3.0000001}, "eval")]
    for cls, name in ((JaxMetricsWriter, "jax.jsonl"), (MetricsWriter, "port.jsonl")):
        with cls(jsonl_path=str(tmp_path / name)) as w:
            for step, metrics, prefix in flushes:
                w.write(step, metrics, prefix=prefix)
    want = (tmp_path / "jax.jsonl").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == want
    assert json.loads(want.splitlines()[0]) == {"step": 1, "prefix": "train",
                                                "loss": 2.5, "accuracy": 0.25}
    with MetricsWriter(tensorboard_dir=str(tmp_path / "tb")) as w:
        w.write(1, {"loss": 2.0})
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    MetricsWriter(tensorboard_dir=str(tmp_path / "off"), enabled=False).close()
    assert not os.path.exists(tmp_path / "off")


def test_tensorboard_request_without_the_package_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="--tensorboard-dir"):
        MetricsWriter(tensorboard_dir=str(tmp_path / "tb"),
                      jsonl_path=str(tmp_path / "m.jsonl"))
    assert not os.listdir(tmp_path)


def test_wall_clock_has_jax_keys_and_trace_writes(tmp_path):
    def drive(clock):
        for _ in range(2):
            with clock.phase("data"):
                pass
            with clock.phase("step"):
                with clock.phase("log"):
                    pass
        with clock.phase("eval"):
            with clock.phase("data"):
                pass
        with clock.phase("ckpt"):
            pass
        return clock.report()

    want, got = drive(JaxWallClock(enabled=True)), drive(WallClock(enabled=True))
    assert set(got) == set(want) == {"data", "step", "log", "eval", "ckpt"}
    assert all(v >= 0 for v in got.values())
    assert drive(WallClock(enabled=False)) == {}
    with trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and json.load(open(tmp_path / "prof" / files[0]))


@struct.dataclass
class _BNState:
    """What ``_refresh_batch_stats`` reads of the JAX train state."""

    params: Any
    batch_stats: Any
    apply_fn: Any = struct.field(pytree_node=False)


def test_precise_bn_matches_jax_refresh(tmp_path):
    """The JAX trainer's own ``_refresh_batch_stats`` runs on a stand-in
    holding what it reads (the state, the input affine, a batch placer),
    its variables from one jitted ``init`` (a whole JAX ``Trainer`` and its
    state would take most of a minute on the CPU)."""
    jm = jax_model("resnet_micro")
    variables = jax.jit(lambda rng: jm.init(rng, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(0))
    jstate = _BNState(variables["params"], variables["batch_stats"], jm.apply)
    jt = types.SimpleNamespace(
        state=jstate, _stats_refresh=None, _input_affine=(1.0 / 255.0, 0.0),
        _batches=lambda head: ({k: jnp.asarray(v) for k, v in b.items()} for b in head))
    tt = Trainer(tcfg.TrainConfig(
        model="resnet_micro", num_epochs=1, log_interval=1, eval_precise_bn_batches=3,
        optimizer=tcfg.OptimizerConfig(name="sgd", lr=0.05),
        data=tcfg.DataConfig(dataset="synthetic_cifar", batch_size=8, augment="none",
                             max_steps_per_epoch=2),
        checkpoint=tcfg.CheckpointConfig(directory=str(tmp_path), interval=0,
                                         async_save=False)), device="cpu")
    bridge.load_flax_variables(tt.model, jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    rng = np.random.RandomState(4)
    batches = [{"image": rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
                "label": rng.randint(0, 10, 8).astype(np.int32)} for _ in range(4)]
    JaxTrainer._refresh_batch_stats(jt, batches, 3)
    tt.refresh_batch_stats(batches, 3)
    got = bridge.named_to_flax_stats(tt.model, dict(tt.model.named_buffers()))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                                         atol=1e-5),
                 jax.device_get(jt.state.batch_stats), got)
    # Eval refreshes them (live statistics, no EMA) and fit runs through it.
    out = tt.fit()
    assert out["steps"] == 2 and 0.0 <= out["final_acc"] <= 1.0
