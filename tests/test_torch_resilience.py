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
- Chaos, verification and the typed errors (``resilience/chaos.py``,
  ``verify.py``, ``errors.py``) against the JAX package's: the same keys
  faulted for a seed, the same tears and corruptions on the same files,
  the same manifests from ``write_manifest`` on one tree; JAX's
  ``TestVerifiedSaves``, ``TestMultiprocessManifests`` and
  ``TestLastGoodFallback`` on the port's saves, and the port's earlier
  save layout still verifying and restoring; a chaos kill at a step in
  both trainers, in process, resumed bit for bit; a chaos SIGKILL of each
  CLI in a subprocess, resumed from the interval save to the
  uninterrupted run's saved state, leaf for leaf.
"""

import json
import os
import re
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



# -- chaos, verify, errors (resilience/) --------------------------------------
from distributed_training_tpu import config as jcfg  # noqa: E402
from distributed_training_tpu.resilience import chaos as jchaos  # noqa: E402
from distributed_training_tpu.resilience import verify as jverify  # noqa: E402
from distributed_training_tpu_torch.resilience import chaos as tchaos  # noqa: E402
from distributed_training_tpu_torch.resilience import errors as terrors  # noqa: E402
from distributed_training_tpu_torch.resilience import verify as tverify  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sd(seed=0):
    """A small state dict (what ``write_checkpoint`` takes)."""
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(64, generator=g), "b": torch.ones(4, 4)},
            "opt_state": {"count": 3, "mu": {"w": torch.zeros(64)}},
            "step": 3}


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_chaos_faults_the_keys_jax_faults(seed, rate):
    """For one config both monkeys fault the same keys, once each (a retry
    passes), and count them alike."""
    keys = [f"train/class_{i % 7}/img_{i}.jpg" for i in range(300)]
    faulted = {}
    for name, (mod, cfg_mod) in {"jax": (jchaos, jcfg), "port": (tchaos, tcfg)}.items():
        monkey = mod.ChaosMonkey(cfg_mod.ChaosConfig(seed=seed, data_error_rate=rate))
        hit = []
        for key in keys:
            try:
                monkey.io_check("data", key)
            except mod.ChaosIOError:
                hit.append(key)
                monkey.io_check("data", key)  # one-shot: the retry passes
        faulted[name] = (hit, dict(monkey.counters))
    assert faulted["port"] == faulted["jax"]
    assert 0 < len(faulted["port"][0]) < len(keys)


def test_chaos_config_validation_and_hooks():
    """``ChaosConfig``'s validation and ``active`` as JAX's; a SIGTERM kill
    latches the preemption guard once; a slow step sleeps on its host
    only; ``chaos_io_check`` is free until a monkey is installed."""
    from distributed_training_tpu_torch.runtime.preemption import PreemptionGuard

    for bad, match in ((dict(kill_signal="nuke"), "kill_signal"),
                       (dict(data_error_rate=1.5), "data_error_rate"),
                       (dict(swap_error_rate=-0.1), "swap_error_rate"),
                       (dict(slow_step_every=0), "slow_step_every"),
                       (dict(slow_step_host=-1), "slow_step_host"),
                       (dict(torn_truncate_bytes=-1), "torn_truncate_bytes")):
        for mod in (jcfg, tcfg):
            with pytest.raises(ValueError, match=match):
                mod.ChaosConfig(**bad)
    for kw in ({}, dict(kill_at_step=1), dict(swap_error_rate=0.5), dict(slow_step_every=2),
               dict(torn_ckpt_epoch=0), dict(corrupt_ckpt_epoch=0), dict(data_error_rate=0.1)):
        assert tcfg.ChaosConfig(**kw).active == jcfg.ChaosConfig(**kw).active
    monkey = tchaos.ChaosMonkey(tcfg.ChaosConfig(kill_at_step=3))
    with PreemptionGuard() as guard:
        monkey.on_step(2)
        assert not guard.triggered
        monkey.on_step(3)
        assert guard.triggered
        monkey.on_step(4)  # one-shot
    assert monkey.counters["kills"] == 1
    slow = tchaos.ChaosMonkey(tcfg.ChaosConfig(slow_step_every=2, slow_step_ms=1.0,
                                               slow_step_host=1), process_index=0)
    for step in range(1, 5):
        slow.on_step(step)
    assert slow.counters["slow_steps"] == 0
    slow.process_index = 1
    for step in range(1, 5):
        slow.on_step(step)
    assert slow.counters["slow_steps"] == 2
    tchaos.chaos_io_check("data", "x")  # nothing installed: no fault
    m = tchaos.ChaosMonkey(tcfg.ChaosConfig(data_error_rate=1.0))
    tchaos.install(m)
    try:
        assert tchaos.active_monkey() is m
        with pytest.raises(tchaos.ChaosIOError):
            tchaos.chaos_io_check("data", "x")
    finally:
        tchaos.uninstall()
    assert tchaos.active_monkey() is None


@pytest.mark.parametrize("fault", ["tear", "corrupt"])
def test_tear_and_corrupt_equal_jax(fault, tmp_path):
    """``tear_checkpoint`` and ``corrupt_committed_checkpoint`` pick the
    same victim and leave the same bytes as JAX's on the port's save;
    verification then fails for JAX's reason (``uncommitted`` or
    ``checksum``) and the scan quarantines it."""
    out = {}
    for name, (chaos, verify) in {"jax": (jchaos, jverify), "port": (tchaos, tverify)}.items():
        d = str(tmp_path / name)
        ckpt.write_checkpoint(d, 0, _sd())
        path = ckpt.write_checkpoint(d, 1, _sd(1))
        victim = (chaos.tear_checkpoint(path, 16) if fault == "tear"
                  else chaos.corrupt_committed_checkpoint(path))
        files = sorted(os.listdir(path))
        out[name] = (os.path.basename(victim), files, open(victim, "rb").read())
        with pytest.raises(verify.CheckpointCorruptError) as info:
            verify.verify_checkpoint(path)
        assert info.value.reason == ("uncommitted" if fault == "tear" else "checksum")
        assert info.value.path == path
    assert out["port"] == out["jax"]
    assert out["port"][0] == ckpt.PAYLOAD
    d = str(tmp_path / "port")
    with pytest.warns(UserWarning, match="quarantined"):
        assert ckpt.latest_valid_epoch(d) == 0
    assert os.path.isdir(os.path.join(d, "epoch_1.corrupt"))
    assert _epochs(d) == [0]


def test_errors_are_jax_types():
    """Every typed error, its base and its attributes as in JAX; the
    checkpoint module re-exports ``CheckpointCorruptError``."""
    from distributed_training_tpu.resilience import errors as jerrors

    names = [n for n in vars(jerrors) if n.endswith("Error")]
    assert names and all(hasattr(terrors, n) for n in names)
    for n in names:
        assert getattr(terrors, n).__mro__[1] is getattr(jerrors, n).__mro__[1]
    e = terrors.CheckpointCorruptError("m", path="p", reason="torn")
    assert (str(e), e.path, e.reason) == ("m", "p", "torn")
    assert terrors.SwapError("m", stage="verify", epoch=3).stage == "verify"
    assert ckpt.CheckpointCorruptError is terrors.CheckpointCorruptError


def _epochs(d) -> list[int]:
    """The epochs with a save directory at ``d``, valid or not."""
    return sorted(int(n[len("epoch_"):]) for n in os.listdir(d)
                  if re.fullmatch(r"epoch_\d+", n))


def _train_state():
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.train_state import TrainState

    model = torch.nn.Linear(4, 3)
    return TrainState.create(model, make_optimizer(tcfg.OptimizerConfig(),
                                                   tcfg.SchedulerConfig(), 1))


@pytest.mark.parametrize("case", ["manifest", "truncated", "uncommitted", "empty",
                                  "legacy_manifestless", "manifestless_truncated",
                                  "earlier_layout"])
def test_verified_saves(case, tmp_path):
    """JAX's ``TestVerifiedSaves`` on the port's saves. A save writes
    ``MANIFEST.json`` (files and leaves) and ``COMMITTED``; a truncated
    payload fails its checksums; without the marker a restore refuses it
    as uncommitted; an empty directory is refused naming auto_resume; a
    payload with neither manifest nor marker (a save that died before its
    manifest, whole or truncated) is refused, and auto-resume skips it for
    the older save; and a save of the port's earlier layout (a manifest of
    files alone, then the marker) verifies and restores."""
    state = _train_state()
    d = str(tmp_path)
    if case in ("legacy_manifestless", "manifestless_truncated", "earlier_layout"):
        ckpt.save_checkpoint(d, 0, state)
        path = os.path.join(d, "epoch_1")
        os.makedirs(path)
        payload = os.path.join(path, ckpt.PAYLOAD)
        torch.save({"state": state.state_dict(),
                    "meta": {"epoch": 1, "next_epoch": 2, "epoch_step": 0}}, payload)
        if case == "earlier_layout":
            with open(os.path.join(path, "MANIFEST.json"), "w") as fh:
                json.dump({"files": {ckpt.PAYLOAD: [os.path.getsize(payload),
                                                    tverify._crc_file(payload)]}}, fh)
            open(os.path.join(path, ckpt.COMMIT_NAME), "w").close()
            tverify.verify_checkpoint(path)
            assert ckpt.latest_valid_epoch(d) == 1
            assert ckpt.restore_checkpoint(d, 1, _train_state()) == (2, 0)
            return
        if case == "manifestless_truncated":
            with open(payload, "r+b") as fh:
                fh.truncate(os.path.getsize(payload) // 2)
        with pytest.raises(ckpt.CheckpointCorruptError, match="auto_resume") as info:
            tverify.verify_checkpoint(path)
        assert info.value.reason == "empty"
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.restore_checkpoint(d, 1, _train_state())
        auto = tcfg.CheckpointConfig(directory=d, auto_resume=True)
        with pytest.warns(UserWarning, match="quarantined"):
            assert ckpt.resolve_resume(auto) == 0
        assert _epochs(d) == [0]
        assert ckpt.restore_checkpoint(d, 0, _train_state()) == (1, 0)
        return
    if case == "empty":
        os.makedirs(os.path.join(d, "epoch_0"))
        with pytest.raises(ckpt.CheckpointCorruptError, match="auto_resume") as info:
            ckpt.restore_checkpoint(d, 0, state)
        assert info.value.reason == "empty"
        return
    path = ckpt.save_checkpoint(d, 0, state)
    assert {"MANIFEST.json", ckpt.COMMIT_NAME, ckpt.PAYLOAD} == set(os.listdir(path))
    tverify.verify_checkpoint(path)
    manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
    if case == "manifest":
        assert manifest["manifest_version"] == tverify.MANIFEST_VERSION
        assert manifest["leaves"]["state/model/weight"][1:] == ["float32", [3, 4]]
        assert any(k.startswith("state/opt_state/mu/") for k in manifest["leaves"])
        assert tverify.read_manifest(path) == manifest
        assert tverify.checkpoint_is_valid(path)
    elif case == "truncated":
        payload = os.path.join(path, ckpt.PAYLOAD)
        with open(payload, "r+b") as fh:
            fh.truncate(os.path.getsize(payload) - 8)
        with pytest.raises(ckpt.CheckpointCorruptError) as info:
            tverify.verify_checkpoint(path)
        assert info.value.reason == "checksum" and path in str(info.value)
        assert not tverify.checkpoint_is_valid(path)
    else:
        os.remove(os.path.join(path, ckpt.COMMIT_NAME))
        with pytest.raises(ckpt.CheckpointCorruptError) as info:
            ckpt.restore_checkpoint(d, 0, state)
        assert info.value.reason == "uncommitted"


def _fake_save(root):
    """JAX's multi-process layout: process 0's and 1's files, and a shared
    metadata file process 0 owns."""
    for p in (0, 1):
        os.makedirs(os.path.join(root, f"ocdbt.process_{p}"))
        with open(os.path.join(root, f"ocdbt.process_{p}", f"d{p}"), "w") as fh:
            fh.write(f"proc{p} payload")
    with open(os.path.join(root, "_CHECKPOINT_METADATA"), "w") as fh:
        fh.write("meta")


@pytest.mark.parametrize("case", ["partition", "peer_corruption", "manifest_deleted",
                                  "peer_never_manifests"])
def test_multiprocess_manifests(case, tmp_path):
    """JAX's ``TestMultiprocessManifests``: each process hashes the files it
    owns, process 0 commits last; the port's manifests equal JAX's on the
    same tree; the merged verify catches a peer's bit rot and a deleted
    member; a peer that never manifests leaves the save uncommitted."""
    roots = {}
    for name, verify in (("jax", jverify), ("port", tverify)):
        root = str(tmp_path / name / "epoch_0")
        _fake_save(root)
        roots[name] = root
        if case == "peer_never_manifests":
            with pytest.warns(UserWarning, match="UNCOMMITTED"):
                verify.write_manifest(root, process_index=0, process_count=2,
                                      peer_wait_s=0.2)
            assert not verify.is_committed(root)
            continue
        verify.write_manifest(root, process_index=1, process_count=2)
        assert not verify.is_committed(root)
        verify.write_manifest(root, process_index=0, process_count=2, peer_wait_s=5.0)
        assert verify.is_committed(root)
    root = roots["port"]
    if case == "peer_never_manifests":
        with pytest.raises(ckpt.CheckpointCorruptError):
            tverify.verify_checkpoint(root)
        return
    for m in ("MANIFEST.0.json", "MANIFEST.1.json"):
        assert (json.load(open(os.path.join(root, m)))
                == json.load(open(os.path.join(roots["jax"], m))))
    m1 = json.load(open(os.path.join(root, "MANIFEST.1.json")))
    assert set(m1["files"]) == {"ocdbt.process_1/d1"} and m1["process_count"] == 2
    assert [m["process_index"] for m in tverify.read_manifests(root)] == [0, 1]
    tverify.verify_checkpoint(root)
    if case == "peer_corruption":
        with open(os.path.join(root, "ocdbt.process_1", "d1"), "w") as fh:
            fh.write("bit rot!!")
        with pytest.raises(ckpt.CheckpointCorruptError) as info:
            tverify.verify_checkpoint(root)
        assert info.value.reason == "checksum"
    elif case == "manifest_deleted":
        os.remove(os.path.join(root, "MANIFEST.1.json"))
        with pytest.raises(ckpt.CheckpointCorruptError) as info:
            tverify.verify_checkpoint(root)
        assert info.value.reason == "torn" and "process(es) [1]" in str(info.value)


@pytest.mark.parametrize("case", ["skip_and_quarantine", "resolve_resume", "prune"])
def test_last_good_fallback(case, tmp_path):
    """JAX's ``TestLastGoodFallback`` on the port's saves: the scan skips
    and quarantines a torn newest save (``.corrupt``, then ``.corrupt1``);
    ``auto_resume`` falls back while an explicit ``resume`` of a bad save
    raises; pruning keeps the newest verified save."""
    d = str(tmp_path)
    for e in range(4 if case == "prune" else 3):
        ckpt.write_checkpoint(d, e, _sd(e))
    if case == "skip_and_quarantine":
        tchaos.tear_checkpoint(os.path.join(d, "epoch_2"))
        os.makedirs(os.path.join(d, "epoch_2.corrupt"))
        with pytest.warns(UserWarning, match="quarantined"):
            assert ckpt.latest_valid_epoch(d) == 1
        assert os.path.isdir(os.path.join(d, "epoch_2.corrupt1"))
        assert _epochs(d) == [0, 1]
    elif case == "resolve_resume":
        os.remove(os.path.join(d, "epoch_2", ckpt.COMMIT_NAME))
        auto = tcfg.CheckpointConfig(directory=d, auto_resume=True)
        with pytest.warns(UserWarning):
            assert ckpt.resolve_resume(auto) == 1
        # An explicit resume of a bad save raises: the user named it.
        ckpt.write_checkpoint(d, 5, _sd(5))
        os.remove(os.path.join(d, "epoch_5", ckpt.COMMIT_NAME))
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.restore_checkpoint(d, 5, _train_state())
    else:
        tchaos.tear_checkpoint(os.path.join(d, "epoch_3"))
        os.remove(os.path.join(d, "epoch_2", ckpt.COMMIT_NAME))
        ckpt.prune_checkpoints(d, keep=1)
        left = sorted(x for x in os.listdir(d) if x.startswith("epoch_"))
        assert "epoch_1" in left and "epoch_0" not in left
        assert ckpt.latest_valid_epoch(d, quarantine=False) == 1


def _kill_cfg(kind, ckpt_dir, **kw):
    common = dict(num_epochs=1, log_interval=2, eval_every=0,
                  checkpoint=tcfg.CheckpointConfig(directory=str(ckpt_dir), interval=0,
                                                   auto_resume=True))
    common.update(kw)
    if kind == "image":
        # normalize_only: the augment's random stream restarts on a resume.
        return tcfg.TrainConfig(model="resnet_micro", data=tcfg.DataConfig(
            dataset="synthetic_cifar", batch_size=4, augment="normalize_only",
            max_steps_per_epoch=4, prefetch=0), **common)
    return tcfg.TrainConfig(
        model="transformer_lm", data=tcfg.DataConfig(batch_size=2, max_steps_per_epoch=4,
                                                     prefetch=0),
        lm=tcfg.LMConfig(seq_len=16, vocab_size=32, num_layers=1, num_heads=2,
                         hidden_dim=32, max_len=32, train_sequences=128, eval_sequences=16),
        **common)


def _state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for part in ("model", "opt_state"):
        for k, v in sa[part].items():
            w = sb[part][k]
            if isinstance(v, dict):
                for n in v:
                    assert torch.equal(v[n], w[n]), (part, k, n)
            elif isinstance(v, torch.Tensor):
                assert torch.equal(v, w), (part, k)
            else:
                assert v == w, (part, k)


@pytest.mark.parametrize("kind", ["image", "lm"])
def test_chaos_kill_resumes_bit_for_bit(kind, tmp_path):
    """JAX's ``TestCrashResumeBitwise``: a chaos SIGTERM at step 2 saves
    and stops (``preempted``, 2 steps); the auto-resumed run ends with the
    uninterrupted run's parameters, optimizer state and step, bit for bit;
    the flight dump's resilience section counts the kill."""
    from distributed_training_tpu_torch import LMTrainer, Trainer

    cls = Trainer if kind == "image" else LMTrainer
    base = cls(_kill_cfg(kind, tmp_path / "base"), device="cpu")
    assert base.fit()["preempted"] is False
    killed = cls(_kill_cfg(kind, tmp_path / "chaos", chaos=tcfg.ChaosConfig(kill_at_step=2)),
                 device="cpu")
    r = killed.fit()
    assert r["preempted"] is True and r["steps"] == 2
    assert killed._resilience_snapshot()["resilience"]["chaos_faults"]["kills"] == 1
    resumed = cls(_kill_cfg(kind, tmp_path / "chaos"), device="cpu")
    r = resumed.fit()
    assert r["preempted"] is False and r["steps"] == 4
    _state_equal(resumed.state, base.state)


def test_torn_newest_save_auto_resume_falls_back(tmp_path):
    """Through the trainer and the async writer's ``post_save``: chaos tears
    epoch 1's save; auto-resume quarantines it, falls back to epoch 0 and
    reruns epoch 1; the flight dump carries the counters."""
    from distributed_training_tpu_torch import Trainer

    cfg = _kill_cfg("image", tmp_path, num_epochs=2).replace(
        checkpoint=tcfg.CheckpointConfig(directory=str(tmp_path), interval=1,
                                         auto_resume=True, async_save=True),
        chaos=tcfg.ChaosConfig(torn_ckpt_epoch=1))
    first = Trainer(cfg, device="cpu")
    assert first.fit()["preempted"] is False
    assert first.chaos.counters["torn_ckpts"] == 1
    with pytest.warns(UserWarning, match="quarantined"):
        resumed = Trainer(cfg.replace(chaos=tcfg.ChaosConfig()), device="cpu")
        r = resumed.fit()
    assert r["preempted"] is False and r["steps"] == 8
    assert os.path.isdir(tmp_path / "epoch_1.corrupt")
    res = json.load(open(resumed.obs.dump()))["resilience"]
    assert res["saves_committed"] >= 1 and "io_retries" in res


_CLI_ARGS = {
    "gpt/torch_cuda/train.py": ["-e", "2", "--steps-per-epoch", "2", "-b", "4",
                                "--seq-len", "16", "--num-layers", "1", "--num-heads", "2",
                                "--hidden-dim", "32", "--max-len", "32"],
    "resnet/torch_cuda/train.py": ["-p", "deepspeed", "--model", "resnet_micro",
                                   "--dataset", "synthetic_cifar", "--steps-per-epoch", "2",
                                   "-b", "8", "-e", "2"],
}


def _run_cli(script, args, expect=0):
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, script), *args,
                          "--device", "cpu", "--log-interval", "1", "-i", "1",
                          "--auto-resume", "--no-flight-recorder"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == expect, (out.returncode, out.stdout[-1000:], out.stderr[-2000:])
    return out


def _leaves(ckpt_dir, epoch):
    manifest = json.load(open(os.path.join(ckpt_dir, f"epoch_{epoch}", "MANIFEST.json")))
    return {k: v for k, v in manifest["leaves"].items()
            if k.startswith(("state/model/", "state/opt_state/", "state/step"))}


@pytest.mark.parametrize("script", sorted(_CLI_ARGS))
def test_cli_sigkill_resumes_from_the_interval_save(script, tmp_path):
    """Each CLI in a subprocess with ``--chaos-kill-at-step 3
    --chaos-kill-signal kill``: killed by SIGKILL in epoch 1 with no save,
    leaving epoch 0's interval save; ``--auto-resume`` retrains epoch 1 and
    its save equals the uninterrupted run's, leaf for leaf. (Saves are
    asynchronous: a 500 ms slow step at step 3, which chaos runs before
    the kill, lets the writer commit epoch 0's save first; without it the
    kill can take that save with it, as a real one can.)"""
    import signal as signal_lib

    args = _CLI_ARGS[script]
    base, chaos = str(tmp_path / "base"), str(tmp_path / "chaos")
    _run_cli(script, [*args, "-c", base])
    _run_cli(script, [*args, "-c", chaos, "--chaos-kill-at-step", "3",
                      "--chaos-kill-signal", "kill", "--chaos-slow-step-every", "3",
                      "--chaos-slow-step-ms", "500"], expect=-signal_lib.SIGKILL)
    assert ckpt.latest_valid_epoch(chaos) == 0 and _epochs(chaos) == [0]
    out = _run_cli(script, [*args, "-c", chaos])
    assert "'preempted': False" in out.stdout
    assert _leaves(chaos, 1) == _leaves(base, 1)


def test_chaos_across_four_ranks(tmp_path):
    """Four gloo ranks (the CPU rehearsal of ``chip_smoke.py --mesh
    resilience``): a slow step on rank 1 alone is named the straggler in
    every rank's cross-rank summary, and every rank writes its own trace
    with the chaos marks on rank 1's; a SIGTERM kill at step 2 on every
    rank saves once and resumes at world 4 to the uninterrupted run's
    state, bit for bit."""
    import torch_dist_worker as worker

    from distributed_training_tpu_torch.observability.trace import load_trace

    cfg = _kill_cfg("lm", tmp_path, num_epochs=1, log_interval=1).replace(
        data=tcfg.DataConfig(batch_size=8, max_steps_per_epoch=4, prefetch=0))
    torch.save({"chaos_cfg": cfg, "chaos_dir": str(tmp_path / "runs")}, tmp_path / "job.pt")
    ranks = worker.spawn(tmp_path, 4, ("_chaos_world",), timeout_s=240.0)()
    for rank, r in enumerate(ranks):
        c = r["chaos"]
        assert c["hosts"]["straggler"]["host"] == 1, c["hosts"]
        assert c["hosts"] == ranks[0]["chaos"]["hosts"]
        assert c["slow_steps"] == (2 if rank == 1 else 0)
        assert c["trace_path"].endswith(f"trace_p{rank}.json")
        marks = [e for e in load_trace(c["trace_path"])["traceEvents"]
                 if e["name"] == "chaos.slow_step"]
        assert len(marks) == c["slow_steps"]
        runs = c["runs"]
        assert runs["killed"]["result"]["preempted"] and runs["killed"]["result"]["steps"] == 2
        assert runs["resumed"]["result"]["steps"] == runs["base"]["result"]["steps"] == 4
        for n, v in runs["base"]["state"]["model"].items():
            assert torch.equal(v, runs["resumed"]["state"]["model"][n]), (rank, n)
        for slot, tensors in runs["base"]["state"]["opt_state"].items():
            if isinstance(tensors, dict):
                for n, v in tensors.items():
                    assert torch.equal(v, runs["resumed"]["state"]["opt_state"][slot][n])
