"""``python -m distributed_training_tpu_torch.tools.serve_bench`` against the
repo's (JAX-side) ``tools/serve_bench.py`` on the SLO alert drill's flags
(the degrading scenario paced by iterations, ``--max-queue-depth`` shedding,
two rules, ``--incident-dir``): the SLA line carries JAX's keys (and the
device), its schedule counters are equal, the alert logs are byte for
byte the same file, and the incident directories hold the same bundles.
Then the port's tool alone: the live endpoints, and a journaled run
SIGKILLed at request 12 whose restart completes every request once with
the uninterrupted run's tokens."""

import contextlib
import io
import json
import os
import subprocess
import sys
import urllib.request

import pytest

from distributed_training_tpu_torch.tools import serve_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADRILL = ["--scenario", "degrading", "--requests", "64", "--rate", "200", "--virtual-dt", "5",
          "--max-queue-depth", "8", "--max-batch", "4", "--num-layers", "1", "--num-heads", "2",
          "--hidden-dim", "32", "--model-max-len", "64", "--prompt-len", "24",
          "--max-new-tokens", "16", "--prefill-chunk", "16", "--sample-every", "2",
          "--slo-rules", "queue_pressure:queue_depth>2@3,10;"
                         "shed_rate:requests_shed/requests_submitted>0.05@3,10"]
# Counters that are a function of the schedule alone (not of the weights or
# the clock) under --virtual-dt.
SCHEDULE = ("requests_submitted", "requests_shed", "requests_finished", "tokens_emitted",
            "queue_depth_max", "kv_reserved_tokens", "kv_written_tokens",
            "ledger_tokens_prefill", "ledger_tokens_decode", "alerts_fired", "alerts_cleared",
            "incidents_captured", "shed_at_submit", "requests_preempted", "drained")


def _port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = serve_bench.main(["--device", "cpu", *argv])
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    d = tmp_path_factory.mktemp("sb")
    mine, _ = _port([*ADRILL, "--incident-dir", str(d / "inc_p"),
                     "--alert-log-out", str(d / "log_p.json")])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "serve_bench.py"), *ADRILL,
                        "--incident-dir", str(d / "inc_j"), "--alert-log-out",
                        str(d / "log_j.json")], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return d, mine, json.loads(r.stdout.strip().splitlines()[-1])


def test_sla_line_has_jax_s_keys_and_schedule(drill):
    _, mine, theirs = drill
    assert set(mine) == set(theirs) | {"device"} and mine["device"] == "cpu"
    assert {k: mine[k] for k in SCHEDULE} == {k: theirs[k] for k in SCHEDULE}
    assert mine["requests_shed"] > 0 and mine["alerts_fired"] == 2


def test_alert_log_and_bundles_equal_jax(drill):
    d, _, _ = drill
    assert (d / "log_p.json").read_bytes() == (d / "log_j.json").read_bytes()
    assert sorted(os.listdir(d / "inc_p")) == sorted(os.listdir(d / "inc_j")) == [
        "incident_000_queue_pressure.json", "incident_001_shed_rate.json"]


def test_metrics_port_serves_the_control_room(monkeypatch):
    """The bench's exporter answers /alerts, /timeseries and /healthz while
    it runs (scraped from inside the engine's loop through a wrapped
    step)."""
    from distributed_training_tpu_torch.observability import exporter as exporter_mod
    from distributed_training_tpu_torch.serving import engine as engine_mod

    seen, ports = {}, []
    real_attach, real_step = exporter_mod.attach_engine, engine_mod.Engine.step

    def attach(engine, port, **kw):
        exp = real_attach(engine, port, **kw)
        ports.append(exp.port)
        return exp

    def step(self):
        if ports and not seen and self.stats()["requests_submitted"] >= 8:
            for path in ("/alerts", "/timeseries", "/healthz"):
                with urllib.request.urlopen(f"http://127.0.0.1:{ports[0]}{path}",
                                            timeout=10) as r:
                    seen[path] = json.loads(r.read())
        return real_step(self)

    monkeypatch.setattr(exporter_mod, "attach_engine", attach)
    monkeypatch.setattr(engine_mod.Engine, "step", step)
    row, err = _port([*ADRILL, "--requests", "16", "--metrics-port", "0"])
    assert "live metrics: http://127.0.0.1:" in err
    assert [r["name"] for r in seen["/alerts"]["rules"]] == ["queue_pressure", "shed_rate"]
    assert seen["/timeseries"]["sample_every"] == 2 and "phase" in seen["/healthz"]
    assert row["requests"] == 16


def test_kill_and_recover_deliver_every_request_once(tmp_path):
    drill = ["--requests", "24", "--rate", "800", "--max-batch", "2", "--kv-pages", "24",
             "--num-layers", "1", "--num-heads", "2", "--hidden-dim", "32",
             "--model-max-len", "64", "--prompt-len", "8", "--max-new-tokens", "8",
             "--prefill-chunk", "8", "--scenario", "two_tier_burst", "--virtual-dt", "2"]
    oracle, _ = _port([*drill, "--completions-out", str(tmp_path / "oracle.json")])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "distributed_training_tpu_torch.tools.serve_bench",
           "--device", "cpu", *drill, "--journal-dir", str(tmp_path / "j")]
    r = subprocess.run([*cmd, "--kill-at-request", "12"], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -9, r.stderr[-2000:]
    r = subprocess.run([*cmd, "--completions-out", str(tmp_path / "rec.json")], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "journal recovery:" in r.stderr
    rec = {c["uid"]: c for c in json.load(open(tmp_path / "rec.json"))}
    want = {c["uid"]: c for c in json.load(open(tmp_path / "oracle.json"))}
    assert rec.keys() == want.keys()
    assert all(rec[u]["tokens"] == want[u]["tokens"] for u in want)
    assert json.loads(r.stdout.strip().splitlines()[-1])["requests_recovered"] > 0
    assert oracle["requests"] == 24
