"""The port's fleet tracing against the JAX package's: ``tools/fleet_trace``
merges the same per-process trace files (a coherent failover, a skewed
clock the hop handshake refines, a pid collision, no failover at all)
into the identical merged trace, summary and exit code under every check;
``merge_labeled_expositions`` relabels the same expositions identically;
``trace.fleet_session`` names its file by the real pid, as JAX's."""

import contextlib
import io
import json
import os

import pytest

from distributed_training_tpu.observability import prometheus as jax_prometheus
from distributed_training_tpu.observability import trace as jax_trace
from distributed_training_tpu_torch.observability import prometheus, trace
from distributed_training_tpu_torch.tools import fleet_trace
from tools import fleet_trace as jax_fleet_trace


def _span(name, ts, dur, pid, **args):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "pid": pid,
            "tid": 1, "args": args}


def _instant(name, ts, pid, **args):
    return {"name": name, "ph": "i", "s": "t", "ts": float(ts), "pid": pid, "tid": 1,
            "args": args}


def _write(d, fname, *, pid, pname, origin, events):
    meta = {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0.0,
            "args": {"name": pname}}
    with open(os.path.join(d, fname), "w") as fh:
        json.dump({"traceEvents": [meta] + events, "displayTimeUnit": "ms",
                   "otherData": {"format": "chrome-trace-events", "wall_time_origin": origin,
                                 "dropped_events": 0}}, fh)


def _fleet(d, case):
    """A door relaying hop 1 of one trace id to replica r0 (killed) and hop 2
    to r1; ``case`` varies r1's clock, the pids and the failover."""
    tid = "req-000003"
    r1_origin, r1_recv, r1_pid, r1_tid = 1000.25, 10_000.0, 300, tid
    if case == "skewed":
        r1_recv = 1_000.0          # recv 4 ms before its send: refined forward
    if case == "pid_collision":
        r1_pid = 200               # the OS reused r0's pid
    if case == "no_failover":
        r1_tid = "req-000004"
    _write(d, "door_pid100_trace.json", pid=100, pname="door", origin=1000.0, events=[
        _span("route", 500, 300, 100, trace=tid, seq=3),
        _instant("hop.send", 1000, 100, trace=tid, hop=1, replica="r0"),
        _span("relay", 1000, 150_000, 100, trace=tid, hop=1, died=True),
        _instant("failover_resume", 151_000, 100, trace=tid, replica="r0"),
        _instant("hop.send", 255_000, 100, trace=r1_tid, hop=2, replica="r1"),
        _span("relay", 255_000, 80_000, 100, trace=r1_tid, hop=2, died=False)])
    _write(d, "replica-r0_pid200_trace.json", pid=200, pname="replica-r0", origin=1000.0,
           events=[_instant("hop.recv", 2000, 200, trace=tid, hop=1),
                   _span("serve.decode", 2000, 120_000, 200, trace=tid)])
    _write(d, f"replica-r1_pid{r1_pid}_trace.json", pid=r1_pid, pname="replica-r1",
           origin=r1_origin, events=[_instant("hop.recv", r1_recv, r1_pid, trace=r1_tid, hop=2),
                                     _span("serve.decode", r1_recv, 60_000, r1_pid,
                                           trace=r1_tid)])


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("checks", [[], ["--check-failover", "--slack-ms", "50"],
                                    ["--slack-ms", "0.5"]],
                         ids=["plain", "failover_slack", "tight_slack"])
@pytest.mark.parametrize("case", ["coherent", "skewed", "pid_collision", "no_failover"])
def test_merge_equals_jax(tmp_path, case, checks):
    traces = tmp_path / "traces"
    traces.mkdir()
    _fleet(str(traces), case)
    mine = _run(fleet_trace.main, ["--dir", str(traces), "-o", str(tmp_path / "mine.json"),
                                   "--json", *checks])
    theirs = _run(jax_fleet_trace.main, ["--dir", str(traces), "-o",
                                         str(tmp_path / "theirs.json"), "--json", *checks])
    assert mine == theirs
    assert (tmp_path / "mine.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    summary = json.loads(mine[1])
    merged = trace.load_trace(str(tmp_path / "mine.json"))
    assert len(summary["pids"]) == 3 and merged["traceEvents"]
    if "--check-failover" in checks:
        assert mine[0] == (1 if case == "no_failover" else 0)


def test_malformed_input_exits_2_as_jax(tmp_path):
    bad = tmp_path / "x_trace.json"
    bad.write_text("{not json")
    assert _run(fleet_trace.main, [str(bad)])[0] == 2
    assert _run(fleet_trace.main, [])[0] == _run(jax_fleet_trace.main, [])[0] == 2


EXPOSITIONS = [
    ("# HELP serving_ttft_ms TTFT\n# TYPE serving_ttft_ms histogram\n"
     'serving_ttft_ms_bucket{le="10"} 3\nserving_ttft_ms_bucket{le="+Inf"} 4\n'
     "serving_ttft_ms_sum 31.5\nserving_ttft_ms_count 4\n# TYPE up gauge\nup 1\n"),
    "# TYPE up gauge\nup 0\n# TYPE queue_depth gauge\nqueue_depth{tier=\"0\"} 2\n\n",
]


def test_merge_labeled_expositions_equals_jax():
    parts = [(f'replica="r{i}"', text) for i, text in enumerate(EXPOSITIONS)]
    got = prometheus.merge_labeled_expositions(parts)
    assert got == jax_prometheus.merge_labeled_expositions(parts)
    assert got.count("# TYPE up gauge") == 1 and 'up{replica="r1"} 0' in got


def test_fleet_session_names_the_file_by_pid(tmp_path):
    assert trace.fleet_session("door", None) == (None, None) == jax_trace.fleet_session("door", "")
    session, path = trace.fleet_session("replica-r0", str(tmp_path), max_events=7)
    _, jax_path = jax_trace.fleet_session("replica-r0", str(tmp_path))
    assert path == jax_path == os.path.join(str(tmp_path),
                                            f"replica-r0_pid{os.getpid()}_trace.json")
    assert session.pid == os.getpid() and session.max_events == 7
    session.instant("hop.recv", track="hop", trace="t", hop=1)
    session.checkpoint(path)
    saved = trace.load_trace(path)
    assert saved["otherData"]["wall_time_origin"] == session.to_json()["otherData"][
        "wall_time_origin"]
    assert [e["args"]["name"] for e in saved["traceEvents"] if e["name"] == "process_name"] \
        == [f"replica-r0 pid {os.getpid()}"]
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no temporary left
