"""The port's flight instruments (``observability/``) against the JAX
package's on the same inputs, on the CPU.

- The step-time histogram, the flight recorder (ring, gaps, percentiles,
  goodput, the non-finite sanitisation, the dump), the anomaly detector
  and the straggler summary give JAX's numbers and verdicts, exactly, on
  the same observations (numpy's seeded draws). The cross-rank exchange
  runs over gloo: two ranks each end ``fit()`` with the same two-row
  matrix, and rank 0's dump names both.
- A port dump renders through the JAX tool (``tools/flight_report.py``)
  and the port's (``python -m distributed_training_tpu_torch.tools.
  flight_report``) to the same text, JSON and Prometheus exposition, and a
  JAX dump through both likewise; a torn dump exits 2 in both.
- Both trainers record flight at their defaults and ``obs.dump()`` writes
  the record: the FLOP rate at every flush after the first (no MFU and no
  memory keys on the CPU, which has no peak and no allocator counters, as
  in JAX), goodput from the wall clock, the notes on what a port dump
  leaves out.
- The poisoned-parameter anomaly of ``tests/test_anomaly.py``: after the
  second step every parameter is NaN. With ``skip`` the run completes and
  leaves the dump, the batch ``.npz`` and a non-empty ``torch.profiler``
  trace; with ``raise`` the ``AnomalyError`` comes after the trace window,
  or at the flush that saw it with no window. For both trainers.
"""

import glob
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_dist_worker as worker

from distributed_training_tpu.observability import aggregate as jagg
from distributed_training_tpu.observability import anomaly as janom
from distributed_training_tpu.observability import flight_recorder as jfr
from distributed_training_tpu.observability import histogram as jhist
from distributed_training_tpu_torch import LMTrainer, Trainer
from distributed_training_tpu_torch.config import (
    CheckpointConfig,
    DataConfig,
    LMConfig,
    ObservabilityConfig,
    TrainConfig,
)
from distributed_training_tpu_torch.observability import aggregate, anomaly, histogram
from distributed_training_tpu_torch.observability import flight_recorder as fr
from distributed_training_tpu_torch.observability.anomaly import AnomalyError
from distributed_training_tpu_torch.observability.memory import device_memory_metrics
from distributed_training_tpu_torch.tools import flight_report

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_flight_report", os.path.join(ROOT, "tools", "flight_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_TOOL = _jax_tool()


def _observations(seed: int, n: int = 300) -> np.ndarray:
    """Step times in ms: log-normal around 40 ms, a few stalls."""
    rng = np.random.RandomState(seed)
    x = rng.lognormal(np.log(40.0), 0.6, n)
    x[rng.choice(n, 5, replace=False)] *= 200
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_jax(seed):
    xs = _observations(seed)
    mine, theirs = histogram.FixedHistogram(), jhist.FixedHistogram()
    for v in xs:
        mine.observe(v)
        theirs.observe(v)
    assert mine.to_dict() == theirs.to_dict()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert mine.quantile(q) == theirs.quantile(q)
    other = histogram.FixedHistogram.from_dict(jhist.FixedHistogram().to_dict())
    other.observe(3.0)
    mine.merge(other)
    assert mine.total == len(xs) + 1


def _drive(rec, seed: int):
    """The same steps (with a resume skip and epoch gaps), flushes (one
    with NaN and inf) and anomaly into ``rec``."""
    rng = np.random.RandomState(seed)
    t, step = 100.0, 0
    for epoch in range(3):
        rec.mark_gap()
        for _ in range(40):
            step += 1 if rng.rand() > 0.05 else 3
            t += rng.lognormal(np.log(0.04), 0.5)
            rec.record_step(step, t)
            if step % 8 == 0:
                rec.record_flush(step, {"loss": float(rng.rand()), "grad_norm": 1.5,
                                        "mfu": 0.3, "step": step})
    rec.record_flush(step, {"loss": float("nan"), "grad_norm": float("inf")})
    rec.record_anomaly(step, ["non-finite loss (nan)"])
    return {"step": 0.4, "data": 0.1, "log": 0.02, "eval": 0.3}


def _strip_times(snap: dict) -> dict:
    snap = dict(snap)
    snap.pop("wall_time")
    snap["anomalies"] = [{k: v for k, v in a.items() if k != "time"}
                         for a in snap["anomalies"]]
    return snap


@pytest.mark.parametrize("seed,ring", [(0, 64), (1, 1024), (2, 16)])
def test_flight_recorder_matches_jax(seed, ring):
    mine, theirs = fr.FlightRecorder(ring), jfr.FlightRecorder(ring)
    phases = _drive(mine, seed)
    _drive(theirs, seed)
    assert mine.step_deltas_ms() == theirs.step_deltas_ms()
    assert mine.step_time_stats() == theirs.step_time_stats()
    a = mine.snapshot(reason="r", phase_totals=phases, extra={"hosts": {"num_hosts": 1}})
    b = theirs.snapshot(reason="r", phase_totals=phases, extra={"hosts": {"num_hosts": 1}})
    assert _strip_times(a) == _strip_times(b)
    assert a["flushes"][-1]["loss"] == "nan" and a["flushes"][-1]["grad_norm"] == "inf"
    assert fr.percentile([3, 1, 2], 50) == jfr.percentile([3, 1, 2], 50)


def _metric_stream(seed: int) -> list[dict]:
    rng = np.random.RandomState(seed)
    out = []
    for i in range(60):
        m = {"loss": float(rng.rand() + 1), "grad_norm": float(rng.lognormal(0, 0.3)),
             "grads_finite": 1.0}
        if i in (20, 41):
            m["grad_norm"] *= 40  # a spike
        if i == 30:
            m["grads_finite"] = 0.0  # the fp16 skip: not an anomaly
            m["loss"] = float("inf")
        if i == 50:
            m["loss"] = float("nan")
        if i == 55:
            del m["grad_norm"]
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_anomaly_detector_matches_jax(seed):
    mine, theirs = anomaly.AnomalyDetector(), janom.AnomalyDetector()
    flagged = 0
    for m in _metric_stream(seed):
        got, want = mine.check(m), theirs.check(m)
        assert got == want
        flagged += bool(got)
        assert mine.grad_norm_ema == theirs.grad_norm_ema
    assert flagged == 3
    with pytest.raises(ValueError) as a:
        anomaly.AnomalyDetector(spike_factor=1.0)
    with pytest.raises(ValueError) as b:
        janom.AnomalyDetector(spike_factor=1.0)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("hosts", [1, 3])
def test_straggler_summary_matches_jax(hosts):
    """Each host's payload from its own recorder (one host stalls at one
    step), gathered into one matrix: the same payloads and summary."""
    mine, theirs = [], []
    for h in range(hosts):
        a, b = fr.FlightRecorder(512), jfr.FlightRecorder(512)
        for rec in (a, b):
            t = 0.0
            for s in range(1, 200):
                t += 0.05 + (0.4 if (h == hosts - 1 and s == 123) else 0.0) + 1e-4 * (s % 7)
                rec.record_step(s, t)
        mine.append(aggregate.local_payload(a, None, 128))
        theirs.append(jagg.local_payload(b, None, 128))
    np.testing.assert_array_equal(np.stack(mine), np.stack(theirs))
    got = aggregate.summarize_hosts(np.stack(mine), 128)
    assert got == jagg.summarize_hosts(np.stack(theirs), 128)
    assert got["straggler"]["host"] == hosts - 1 and got["straggler"]["step"] == 123
    assert aggregate.gather_payloads(mine[0], 1).shape == (1, mine[0].size)


def test_memory_telemetry_is_empty_on_the_cpu():
    """No card: no allocator counters, ``{}`` as JAX's on a backend without
    them."""
    assert device_memory_metrics() == {}
    assert device_memory_metrics([torch.device("cpu")]) == {}


def _report(tool, argv) -> tuple[int, str]:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv)
    return rc, buf.getvalue()


def _image_cfg(tmp_path, **obs) -> TrainConfig:
    return TrainConfig(
        model="resnet_micro", num_epochs=2, log_interval=2, eval_every=0,
        data=DataConfig(dataset="synthetic_cifar", batch_size=4, max_steps_per_epoch=4,
                        prefetch=0),
        checkpoint=CheckpointConfig(directory=str(tmp_path / "ckpt"), interval=0),
        metrics_jsonl=str(tmp_path / "metrics.jsonl"),
        observability=ObservabilityConfig(**obs))


def _lm_cfg(tmp_path, **obs) -> TrainConfig:
    return TrainConfig(
        model="transformer_lm", num_epochs=1, log_interval=2, eval_every=0,
        data=DataConfig(batch_size=2, prefetch=0),
        checkpoint=CheckpointConfig(directory=str(tmp_path / "ckpt"), interval=0),
        lm=LMConfig(seq_len=16, vocab_size=64, num_layers=1, num_heads=2, hidden_dim=32,
                    max_len=32, train_sequences=64, eval_sequences=16),
        observability=ObservabilityConfig(**obs))


@pytest.fixture(scope="module")
def default_runs(tmp_path_factory):
    """Both trainers at the defaults (the recorder on), one process, and a
    two-rank gloo run of each started beside them."""
    d = tmp_path_factory.mktemp("flight")
    job = {"flight_cfgs": {k: {"cfg": cfg(d / k), "dump": str(d / k / "flight.json")}
                           for k, cfg in (("img", _image_cfg), ("lm", _lm_cfg))},
           "dir": str(d)}
    spawned = d / "spawn"
    spawned.mkdir()
    torch.save({**job, "flight_cfgs": {
        k: {**v, "dump": str(spawned / f"{k}.json")} for k, v in job["flight_cfgs"].items()}},
        spawned / "job.pt")
    join = worker.spawn(spawned, 2, ("_flight_world",), timeout_s=200.0)
    out = {}
    try:
        for k, sc in job["flight_cfgs"].items():
            t = (LMTrainer if k == "lm" else Trainer)(sc["cfg"], device="cpu")
            result = t.fit()
            out[k] = {"trainer": t, "result": result, "dump": t.obs.dump()}
    finally:
        out["ranks"] = join()
    out["spawned"] = spawned
    return out


@pytest.mark.parametrize("kind", ["img", "lm"])
def test_default_run_records_flight_and_dumps(default_runs, kind):
    run = default_runs[kind]
    t = run["trainer"]
    assert t.obs.recorder is not None and t.clock.enabled
    snap = fr.FlightRecorder.load(run["dump"])
    assert run["dump"].endswith(os.path.join("ckpt", "flight", "flight.json"))
    assert snap["steps_recorded_total"] == run["result"]["steps"]
    assert snap["step_time_stats"]["step_time_p50_ms"] > 0
    assert 0 < snap["wall_clock"]["goodput"] <= 1
    assert snap["hosts"]["num_hosts"] == 1
    assert snap["resilience"] == {"io_retries": 0, "saves_committed": 0, "saves_failed": 0}
    assert any("HLO" in n for n in snap["notes"])
    flushes = snap["flushes"]
    assert all(math.isfinite(f["loss"]) for f in flushes)
    assert all("model_flops_per_sec" in f for f in flushes[1:])
    # The CPU has no peak FLOPs and no allocator counters: no MFU, no
    # memory keys (JAX's CPU runs omit both too).
    assert not any("mfu" in f or "mem_peak_bytes" in f for f in flushes)


@pytest.mark.parametrize("kind", ["img", "lm"])
def test_two_ranks_exchange_the_same_matrix(default_runs, kind):
    """The straggler exchange over gloo: both ranks hold the same summary,
    with a row each, after every flush; rank 0's dump carries it."""
    a, b = (r["flight"][kind] for r in default_runs["ranks"])
    assert a["hosts"] == b["hosts"] and a["hosts"]["num_hosts"] == 2
    assert a["recorded"] == b["recorded"] > 0
    assert [f["step"] for f in a["flushes"]] == [f["step"] for f in b["flushes"]]
    snap = fr.FlightRecorder.load(str(default_runs["spawned"] / f"{kind}.json"))
    assert snap["hosts"] == a["hosts"]


def test_host_group_opens_once_per_process(default_runs):
    """Beside a default group that is not gloo (NCCL's on the card), the
    straggler exchange's gloo group of every rank is opened once: a second
    trainer of the process reuses it, and both ranks exchange over it."""
    for r in default_runs["ranks"]:
        g = r["host_group"]
        assert g["same"] and not g["world"] and g["size"] == 2
        np.testing.assert_array_equal(g["rows"], [[0.0] * 3, [1.0] * 3])


@pytest.mark.parametrize("kind", ["img", "lm"])
@pytest.mark.parametrize("mode", [[], ["--json"], ["--prometheus"]],
                         ids=["text", "json", "prometheus"])
def test_both_tools_render_a_port_dump_alike(default_runs, kind, mode):
    path = default_runs[kind]["dump"]
    rc_a, a = _report(flight_report, [*mode, path])
    rc_b, b = _report(JAX_TOOL, [*mode, path])
    assert rc_a == rc_b == 0 and a == b
    if not mode:
        assert a.startswith("flight record: reason='on-demand'")
        assert "goodput:" in a and "hosts: 1" in a


def test_both_tools_render_a_jax_dump_alike(tmp_path):
    rec = jfr.FlightRecorder(64)
    phases = _drive(rec, 4)
    path = str(tmp_path / "jax_flight.json")
    rec.dump(path, reason="anomaly: x", phase_totals=phases,
             extra={"hosts": jagg.summarize_hosts(
                 np.stack([jagg.local_payload(rec, None, 32)] * 2), 32)})
    for mode in ([], ["--json"], ["--prometheus"]):
        assert _report(flight_report, [*mode, path]) == _report(JAX_TOOL, [*mode, path])
    torn = tmp_path / "torn.json"
    torn.write_text(open(path).read()[:100])
    r = subprocess.run([sys.executable, "-m", "distributed_training_tpu_torch.tools.flight_report",
                        str(torn)], cwd=ROOT, capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 2 and r.stderr.startswith("flight_report: error:")


def _poison_after(trainer, n_calls: int) -> list:
    """Wrap the train step so call ``n_calls`` NaNs every parameter (JAX's
    ``_poison_after``): every later loss is non-finite."""
    real_step = trainer.train_step
    calls = []

    def step(state, batch):
        metrics = real_step(state, batch)
        calls.append(1)
        if len(calls) == n_calls:
            with torch.no_grad():
                for p in state.master_params().values():
                    p.mul_(float("nan"))
        return metrics

    trainer.train_step = step
    return calls


ANOMALY = dict(grad_norm=True, anomaly_detection=True)


@pytest.mark.parametrize("kind", ["img", "lm"])
def test_nan_loss_skip_dumps_traces_and_completes(tmp_path, kind):
    cfg = (_image_cfg if kind == "img" else _lm_cfg)(
        tmp_path, anomaly_action="skip", anomaly_trace_steps=2,
        dump_dir=str(tmp_path / "flight"), **ANOMALY)
    t = (Trainer if kind == "img" else LMTrainer)(cfg, device="cpu")
    _poison_after(t, 2)
    result = t.fit()  # skip: the run completes
    assert result["preempted"] is False
    assert math.isnan(result["last_metrics"]["loss"])
    dumps = glob.glob(str(tmp_path / "flight" / "anomaly_step*_flight.json"))
    assert len(dumps) == 1, "forensics fire once a run"
    snap = json.load(open(dumps[0]))
    assert "non-finite loss" in str(snap["anomalies"][0]["reasons"])
    assert snap["reason"].startswith("anomaly") and snap["wall_clock"]["goodput"] > 0
    npz = glob.glob(str(tmp_path / "flight" / "anomaly_step*_batch.npz"))
    keys = {"image", "label"} if kind == "img" else {"tokens", "targets"}
    assert npz and keys <= set(np.load(npz[0]).files)
    traces = glob.glob(str(tmp_path / "flight" / "anomaly_step*_trace" / "trace_*.json"))
    assert traces and os.path.getsize(traces[0]) > 0, "the trace window never closed"
    events = json.load(open(traces[0]))["traceEvents"]
    assert events


@pytest.mark.parametrize("kind", ["img", "lm"])
def test_nan_loss_raise_after_trace_window(tmp_path, kind):
    cfg = (_image_cfg if kind == "img" else _lm_cfg)(
        tmp_path, anomaly_action="raise", anomaly_trace_steps=1,
        dump_dir=str(tmp_path / "flight"), **ANOMALY)
    t = (Trainer if kind == "img" else LMTrainer)(cfg, device="cpu")
    calls = _poison_after(t, 2)
    with pytest.raises(AnomalyError, match="non-finite loss"):
        t.fit()
    # log_interval 2: seen at the step-4 flush, raised one step later.
    assert len(calls) == 5
    assert glob.glob(str(tmp_path / "flight" / "anomaly_step*_flight.json"))
    assert glob.glob(str(tmp_path / "flight" / "anomaly_step*_trace" / "trace_*.json"))


def test_raise_with_no_trace_window_is_immediate(tmp_path):
    cfg = _image_cfg(tmp_path, anomaly_action="raise", anomaly_trace_steps=0,
                     dump_dir=str(tmp_path / "flight"), **ANOMALY)
    t = Trainer(cfg, device="cpu")
    calls = _poison_after(t, 2)
    with pytest.raises(AnomalyError):
        t.fit()
    assert len(calls) == 4


def test_grad_norm_metric_reaches_the_sinks(tmp_path):
    cfg = _image_cfg(tmp_path, grad_norm=True, dump_dir=str(tmp_path / "flight")).replace(
        num_epochs=1)
    Trainer(cfg, device="cpu").fit()
    rows = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    train = [r for r in rows if r["prefix"] == "train"]
    assert train and all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in train)
    assert any("model_flops_per_sec" in r for r in train)


def test_crash_dumps_the_flight_record(tmp_path):
    cfg = _image_cfg(tmp_path, dump_dir=str(tmp_path / "flight"))
    t = Trainer(cfg, device="cpu")
    real, calls = t.train_step, []

    def step(state, batch):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("boom")
        return real(state, batch)

    t.train_step = step
    with pytest.raises(RuntimeError, match="boom"):
        t.fit()
    snap = fr.FlightRecorder.load(str(tmp_path / "flight" / "flight_crash.json"))
    assert snap["reason"] == "crash" and snap["steps_recorded_total"] == 2


def test_recorder_off_records_nothing(tmp_path):
    cfg = _image_cfg(tmp_path, flight_recorder=False).replace(num_epochs=1)
    t = Trainer(cfg, device="cpu")
    t.fit()
    assert t.obs.recorder is None and t.obs.dump() is None and not t.clock.enabled
