"""The port's span traces (``observability/trace.py``), its
``WallClock`` spans and its ``trace_report`` against the JAX package's.

The trace file is the JAX package's Chrome ``trace_event`` object, so the
tests hold the format, not only the behaviour: the same calls on both
sessions give the same events (timestamps aside), a trace from either
package renders through both ``trace_report``s with the same summary
(exactly: timestamps are set through ``complete`` from each session's
epoch, so both files hold the same numbers), and a malformed or torn file
exits 2 in both. Then the trainers: a micro fit of each with the trace on
writes the wall clock's phases, the async writer's track and the chaos
marks.
"""

import collections
import contextlib
import importlib.util
import io
import json
import os
import threading
import time

import pytest
import torch

from distributed_training_tpu.observability import trace as jtrace
from distributed_training_tpu.utils.profiling import WallClock as JaxWallClock
from distributed_training_tpu_torch import config as tcfg
from distributed_training_tpu_torch.observability import trace as ttrace
from distributed_training_tpu_torch.tools import trace_report as port_report
from distributed_training_tpu_torch.utils.profiling import WallClock

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")
SESSIONS = {"jax": jtrace.TraceSession, "port": ttrace.TraceSession}


def _load_jax_report():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_report", os.path.join(ROOT, "tools", "trace_report.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_REPORT = _load_jax_report()
REPORTS = {"jax": JAX_REPORT, "port": port_report}


def assert_valid_trace(obj):
    """Every event has the required keys; ts in order on each (pid, tid)."""
    events = obj["traceEvents"]
    assert events, "empty trace"
    last = collections.defaultdict(lambda: float("-inf"))
    for ev in events:
        for key in REQUIRED_KEYS:
            assert key in ev, (key, ev)
        if ev["ph"] == "M":
            continue
        track = (ev["pid"], ev["tid"])
        assert ev["ts"] >= last[track], (ev, last[track])
        last[track] = ev["ts"]


def _scripted(cls, **kw):
    """A session fed one fixed script with timestamps from its own epoch
    (so both packages' files hold the same numbers)."""
    tr = cls(pid=2, process_name="host 2 train", **kw)
    t0 = tr._t0
    tr.complete("step", t0 + 0.001, t0 + 0.004, track="train", step=1)
    tr.complete("data", t0 + 0.0015, t0 + 0.002, track="train")
    tr.complete("step", t0 + 0.005, t0 + 0.009, track="train", step=2)
    tr.complete("ckpt.persist", t0 + 0.003, t0 + 0.012, track="ckpt-writer", epoch=0)
    tr.instant("chaos.slow_step", track="chaos", t=t0 + 0.006, step=2, ms=5.0)
    tr.counter("depth", 3, t=t0 + 0.007)
    return tr


def _events(obj):
    """The events without their clock readings."""
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in obj["traceEvents"]]


@pytest.mark.parametrize("case", ["script", "nested_and_retro", "bounded", "threads"])
def test_session_events_equal_jax(case, tmp_path):
    """The same calls on both sessions give the same file, timestamps
    aside: the events, their order (sorted by ts), the track metadata and
    the dropped count."""
    out = {}
    for name, cls in SESSIONS.items():
        if case == "script":
            tr = _scripted(cls)
        elif case == "nested_and_retro":
            tr = cls()
            with tr.span("outer", track="t"):
                with tr.span("inner", track="t"):
                    pass
            tr.complete("retro", tr.now() - 1.0, tr.now(), track="t")
        elif case == "bounded":
            tr = cls(max_events=3)
            for i in range(10):
                tr.instant(f"e{i}", t=tr._t0 + i)
        else:
            tr = cls()

            def emit(track, tr=tr):
                for i in range(200):
                    tr.instant("e", track=track, i=i)

            threads = [threading.Thread(target=emit, args=(f"t{j}",)) for j in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
        obj = ttrace.load_trace(tr.save(str(tmp_path / f"{name}.json")))
        assert_valid_trace(obj)
        out[name] = obj
    j, t = out["jax"], out["port"]
    assert t["otherData"]["dropped_events"] == j["otherData"]["dropped_events"]
    assert t["otherData"]["format"] == j["otherData"]["format"]
    assert t["displayTimeUnit"] == j["displayTimeUnit"]
    if case == "threads":  # the threads interleave differently in each run
        count = lambda o: collections.Counter(e["name"] for e in o["traceEvents"])  # noqa: E731
        assert count(t) == count(j) and count(t)["e"] == 800
        return
    assert _events(t) == _events(j)
    if case in ("script", "bounded"):  # timestamps set from each session's epoch
        assert ([(e["ts"], e.get("dur")) for e in t["traceEvents"]]
                == [(e["ts"], e.get("dur")) for e in j["traceEvents"]])
    if case == "bounded":
        assert t["otherData"]["dropped_events"] == 7


def _report(module, path: str, as_json: bool):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main([*(["--json"] if as_json else []), path])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "text"])
def test_both_reports_read_both_packages_traces(writer, as_json, tmp_path):
    """A trace from either package renders through both tools alike, and
    the two packages' traces of one script render alike."""
    paths = {w: _scripted(SESSIONS[w]).save(str(tmp_path / f"{w}.json"))
             for w in SESSIONS}
    got = {r: _report(m, paths[writer], as_json) for r, m in REPORTS.items()}
    assert got["port"] == got["jax"]
    rc, text, _ = got["port"]
    assert rc == 0
    assert _report(port_report, paths["jax" if writer == "port" else "port"],
                   as_json) == got["port"]
    if as_json:
        summary = json.loads(text)
        tracks = {r["track"]: r for r in summary["tracks"]}
        assert tracks["train"]["spans"] == 3 and tracks["chaos"]["instants"] == 1
        assert tracks["ckpt-writer"]["busy_ms"] == pytest.approx(9.0)
        assert summary["longest_spans"][0]["name"] == "ckpt.persist"


@pytest.mark.parametrize("bad", ["missing_key", "torn", "not_a_trace", "no_file"])
def test_malformed_trace_exits_2_in_both_tools(bad, tmp_path):
    """A malformed, torn or missing file: exit 2 with one line naming the
    path, in both tools; ``load_trace`` raises as JAX's does."""
    path = tmp_path / "bad.json"
    body = {"missing_key": '{"traceEvents": [{"ph": "X"}]}', "torn": '{"traceEvents": [',
            "not_a_trace": '{"events": []}', "no_file": None}[bad]
    if body is not None:
        path.write_text(body)
    got = {r: _report(m, str(path), False) for r, m in REPORTS.items()}
    assert got["port"] == got["jax"]
    rc, out, err = got["port"]
    assert rc == 2 and out == "" and str(path) in err and err.count("\n") == 1
    errors = []
    for load in (jtrace.load_trace, ttrace.load_trace):
        with pytest.raises((OSError, ValueError)) as info:
            load(str(path))
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("enabled", [True, False])
def test_wall_clock_spans_equal_jax(enabled, tmp_path):
    """The port's ``WallClock`` with a session emits the phases as JAX's
    does: one inclusive span per phase on the clock's track (exclusive
    totals unchanged); disabled, nothing."""
    names = {}
    for name, (clock_cls, session_cls) in {"jax": (JaxWallClock, jtrace.TraceSession),
                                           "port": (WallClock, ttrace.TraceSession)}.items():
        tr = session_cls()
        clock = clock_cls(enabled, trace=tr, track="train")
        with clock.phase("step"):
            with clock.phase("data"):
                time.sleep(0.001)
        with clock.phase("log"):
            pass
        if not enabled:
            assert len(tr) == 0
            continue
        obj = tr.to_json()
        spans = {e["name"]: e for e in obj["traceEvents"] if e["ph"] == "X"}
        assert spans["step"]["ts"] <= spans["data"]["ts"]
        assert (spans["step"]["ts"] + spans["step"]["dur"]
                >= spans["data"]["ts"] + spans["data"]["dur"])
        assert clock.lifetime["step"] + clock.lifetime["data"] == pytest.approx(
            spans["step"]["dur"] / 1e6, rel=0.2)
        names[name] = _events(obj)
    if enabled:
        assert names["port"] == names["jax"]


@pytest.mark.parametrize("world,rank,want", [(1, 0, "trace.json"), (2, 1, "trace_p1.json")])
def test_session_for_run_names_the_files(world, rank, want, tmp_path):
    off = tcfg.TraceConfig()
    assert ttrace.session_for_run(off, default_dir=str(tmp_path)) == (None, None)
    on = tcfg.TraceConfig(enabled=True)
    tr, path = ttrace.session_for_run(on, default_dir=str(tmp_path), rank=rank, world=world)
    assert path == os.path.join(str(tmp_path), "trace", want)
    assert tr.pid == rank and tr.process_name == f"host {rank} train"
    assert tr.max_events == on.max_events
    tr, path = ttrace.session_for_run(tcfg.TraceConfig(enabled=True, dir=str(tmp_path / "d")),
                                      default_dir="x", rank=rank, world=world)
    assert path == os.path.join(str(tmp_path / "d"), want)
    jtr, jpath = jtrace.session_for_cli(True, str(tmp_path), "serve")
    ptr, ppath = ttrace.session_for_cli(True, str(tmp_path), "serve")
    assert ppath == jpath and ptr.process_name == jtr.process_name
    assert ttrace.session_for_cli(False, str(tmp_path), "serve") == (None, None)


def _lm_cfg(tmp_path, **kw):
    return tcfg.TrainConfig(
        model="transformer_lm", num_epochs=2, log_interval=2, eval_every=1,
        lm=tcfg.LMConfig(seq_len=8, vocab_size=32, num_layers=1, num_heads=2,
                         hidden_dim=16, max_len=8, train_sequences=16, eval_sequences=4),
        data=tcfg.DataConfig(batch_size=4, max_steps_per_epoch=3, prefetch=0),
        checkpoint=tcfg.CheckpointConfig(directory=str(tmp_path), interval=1,
                                         async_save=True),
        observability=tcfg.ObservabilityConfig(trace=tcfg.TraceConfig(enabled=True)),
        **kw)


@pytest.mark.parametrize("kind", ["lm", "image"])
def test_trainers_write_the_trace(kind, tmp_path):
    """A micro fit of each trainer with the trace on: the file at JAX's
    default place holds the wall clock's phases on ``train``, the async
    writer's persists on ``ckpt-writer``, the chaos marks on ``chaos``; it
    renders through both tools."""
    from distributed_training_tpu_torch import LMTrainer, Trainer

    chaos = tcfg.ChaosConfig(slow_step_every=2, slow_step_ms=1.0)
    if kind == "lm":
        trainer = LMTrainer(_lm_cfg(tmp_path, chaos=chaos), device="cpu")
    else:
        cfg = _lm_cfg(tmp_path, chaos=chaos).replace(
            model="resnet_micro", data=tcfg.DataConfig(
                dataset="synthetic_cifar", batch_size=4, max_steps_per_epoch=3,
                prefetch=0, num_classes=10))
        trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    path = os.path.join(str(tmp_path), "flight", "trace", "trace.json")
    obj = ttrace.load_trace(path)
    assert_valid_trace(obj)
    tracks = {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    by_track = collections.defaultdict(collections.Counter)
    for e in obj["traceEvents"]:
        if e["ph"] != "M":
            by_track[tracks[e["tid"]]][e["name"]] += 1
    assert by_track["train"]["step"] == 6
    assert {"data", "log", "eval", "ckpt"} <= set(by_track["train"])
    assert by_track["ckpt-writer"]["ckpt.persist"] == 2
    assert by_track["chaos"]["chaos.slow_step"] == 3
    for module in REPORTS.values():
        assert _report(module, path, True)[0] == 0
