"""``serving/supervisor.py``: the port's ``ReplicaSupervisor`` against the JAX
package's under the same fault schedules. A FakeProc stands in for the
Popen and a small HTTP server answers ``/healthz`` with a scripted
heartbeat, so each detection channel (waitpid death, an injected kill, a
crash loop, failed probes, a frozen heartbeat, the wedge detector off)
runs deterministically; both supervisors' counters must be equal, and
equal to the schedule's own count. The real subprocess path is
``tests/test_torch_serve_net.py``'s failover smoke."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from distributed_training_tpu.serving import supervisor as jax_supervisor
from distributed_training_tpu_torch.serving import supervisor


class FakeProc:
    """waitpid's stand-in: alive until ``die()`` or ``kill()``."""

    def __init__(self):
        self._rc = None
        self.kills = 0
        self.pid = 4242

    def poll(self):
        return self._rc

    def kill(self):
        self.kills += 1
        self._rc = -9

    def wait(self, timeout=None):
        return self._rc

    def die(self, rc=1):
        self._rc = rc


class FakeHandle:
    def __init__(self, name, url):
        self.name, self.url = name, url
        self.proc = FakeProc()
        self.stopped = False

    def stop(self):
        self.stopped = True
        self.proc.kill()


class Healthz:
    """``/healthz`` answering ``{"serve_loop_heartbeat": n}``, n advancing
    on every answer while ``advance`` is set."""

    def __init__(self):
        self.n, self.advance = 0, True
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if owner.advance:
                    owner.n += 1
                body = json.dumps({"serve_loop_heartbeat": owner.n}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _wait_for(pred, timeout_s=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _run(mod, schedule):
    """``schedule`` against ``mod.ReplicaSupervisor``: its snapshot after the
    schedule settled, and the handles it spawned."""
    hz = Healthz()
    spawned = []
    url = "http://127.0.0.1:1" if schedule == "unreachable" else hz.url

    def spawn(i):
        h = FakeHandle(f"r{i}-gen{len(spawned)}", url)
        spawned.append(h)
        return h

    kw = dict(probe_interval_s=0.02, probe_timeout_s=0.2 if schedule == "unreachable" else 1.0,
              backoff_base_s=0.01)
    if schedule == "crash_loop":
        kw["max_restarts"] = 2
    if schedule == "unreachable":
        kw["max_restarts"] = 1
    if schedule == "wedge":
        kw["wedge_timeout_s"] = 0.15
    if schedule == "wedge_off":
        hz.advance = False
    sup = mod.ReplicaSupervisor(spawn, 1, **kw).start()
    try:
        if schedule == "death":
            spawned[0].proc.die()
            assert _wait_for(lambda: sup.replica_restarts == 1)
        elif schedule == "kill":
            sup.kill(0)
            assert _wait_for(lambda: sup.replica_restarts == 1)
        elif schedule == "crash_loop":
            def keep_killing():
                for h in list(sup.handles):
                    h.proc.die()
                return sup.supervisor_snapshot()["gave_up"][0]
            assert _wait_for(keep_killing)
        elif schedule == "unreachable":
            assert _wait_for(lambda: sup.supervisor_snapshot()["gave_up"][0])
        elif schedule == "wedge":
            time.sleep(0.1)
            hz.advance = False
            assert _wait_for(lambda: sup.replica_restarts == 1)
        elif schedule == "wedge_off":
            time.sleep(0.3)
        snap = sup.supervisor_snapshot()
    finally:
        sup.stop()
        hz.close()
    return snap, spawned


EXPECTED = {
    "death": dict(replica_restarts=1, deaths_detected=1, wedged_kills=0, kills_injected=0),
    "kill": dict(replica_restarts=1, deaths_detected=1, wedged_kills=0, kills_injected=1),
    "crash_loop": dict(replica_restarts=2, deaths_detected=3, wedged_kills=0, gave_up=[True]),
    "unreachable": dict(replica_restarts=1, deaths_detected=2, gave_up=[True]),
    "wedge": dict(replica_restarts=1, deaths_detected=0, wedged_kills=1),
    "wedge_off": dict(replica_restarts=0, deaths_detected=0, wedged_kills=0),
}


@pytest.mark.parametrize("schedule", list(EXPECTED))
def test_counters_equal_jax_under_one_fault_schedule(schedule):
    mine, spawned = _run(supervisor, schedule)
    theirs, _ = _run(jax_supervisor, schedule)
    assert mine == theirs
    for k, v in EXPECTED[schedule].items():
        assert mine[k] == v, (k, mine)
    assert all(h.stopped for h in spawned)  # stop() reaped every generation


def test_needs_a_replica_and_stop_is_idempotent():
    with pytest.raises(ValueError, match="at least one"):
        supervisor.ReplicaSupervisor(lambda i: None, 0)
    assert supervisor.PROBE_FAILURE_THRESHOLD == jax_supervisor.PROBE_FAILURE_THRESHOLD
    mine, _ = _run(supervisor, "wedge_off")
    assert mine["restarts_by_replica"] == [0]
