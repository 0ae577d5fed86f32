"""``python -m distributed_training_tpu_torch.tools.serve_net`` on the CPU
(``--device cpu``): two replica subprocesses under the supervisor, behind
the port's router, in a subprocess of their own.

In tier-1, the failover drill: the replica serving request 3 is SIGKILLed
mid-stream; its journaled successor is up before the port line, the
breaker opens once, the stream resumes on the other replica, and every
stream equals its ``done`` frame (serve_net exits non-zero otherwise):
exactly 1 restart, 1 breaker open, 1 resume, 0 failed, 0 page leaks, 0
fleet-ledger violations; the port's ``fleet_trace --check-failover``
finds the request on two replica pids; the door's federated scrape marks
the dead replica stale. JAX's other three drills (prefix routing against
round_robin, a rolling deploy mid-load, a client hanging up) run here too,
marked ``slow`` as JAX marks them."""

import json
import os
import subprocess
import sys

import pytest

from distributed_training_tpu_torch.tools import fleet_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_net(*extra, cwd=REPO):
    cmd = [sys.executable, "-m", "distributed_training_tpu_torch.tools.serve_net", "--smoke",
           "--device", "cpu", "--replicas", "2", "--requests", "12", "--max-new-tokens", "8",
           *extra]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:] + out.stdout[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_failover_kill_mid_stream(tmp_path):
    row, err = _serve_net("--journal-dir", str(tmp_path / "j"), "--kill-replica-at-request",
                          "3", "--breaker-threshold", "1", "--breaker-cooldown-s", "600",
                          "--trace-dir", "traces", "--fleet-out", "fleet.json",
                          cwd=str(tmp_path))
    assert row["requests_finished"] == row["requests"] == 12
    assert (row["replica_restarts"], row["breaker_opens"], row["failover_resumes"]) == (1, 1, 1)
    for k in ("requests_failed", "stream_vs_done_mismatches", "balance_violations",
              "fleet_ledger_conservation_violations", "trace_roundtrip_mismatches"):
        assert row[k] == 0, k
    assert row["fleet_ledger_requests"] == 12
    assert err.count("up on port") == 3 and "SIGKILL replica" in err
    traces = sorted(os.listdir(tmp_path / "traces"))
    assert len([t for t in traces if t.startswith("replica-")]) == 3  # r0, r1, the successor
    assert fleet_trace.main(["--dir", str(tmp_path / "traces"), "--check-failover",
                             "--slack-ms", "500", "--json"]) == 0
    fleet = json.load(open(tmp_path / "fleet.json"))
    stale = [ln for ln in fleet["metrics_text"].splitlines()
             if ln.startswith("fleet_replica_stale{")]
    assert sorted(ln.endswith(" 1") for ln in stale) == [False, True]
    assert fleet["vars"]["supervisor"]["replica_restarts"] == 1


@pytest.mark.slow
def test_prefix_routing_beats_round_robin():
    prefix, _ = _serve_net("--policy", "prefix")
    rr, _ = _serve_net("--policy", "round_robin")
    assert prefix["requests_failed"] == rr["requests_failed"] == 0
    assert prefix["prefix_cache_hit_tokens"] > rr["prefix_cache_hit_tokens"]
    assert prefix["router_prefix_routed"] > 0 and rr["router_prefix_routed"] == 0


@pytest.mark.slow
def test_rolling_deploy_mid_load():
    row, _ = _serve_net("--concurrency", "4", "--rolling-deploy-at", "1",
                        "--rolling-deploy-delay-s", "0.5")
    assert row["requests_failed"] == row["stream_vs_done_mismatches"] == 0
    assert row["router_deploys_completed"] == 2 and row["router_deploy_errors"] == 0


@pytest.mark.slow
def test_client_disconnect_cancels_and_stays_balanced():
    row, _ = _serve_net("--max-new-tokens", "16", "--drop-client-at-token", "3",
                        "--drop-client-at-request", "2")
    assert row["requests_cancelled"] >= 1
    assert row["requests_failed"] == row["balance_violations"] == 0
