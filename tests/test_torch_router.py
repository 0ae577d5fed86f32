"""``serving/router.py``: the port's ``Router`` against the JAX package's.

The same scripted replicas (probe answers, failures, an admin state
machine) go through both packages' routers; every routing decision, every
breaker state and the ``router_snapshot`` counters must be identical, and
``rolling_deploy`` must drain, deploy and reopen in the same order and
report the same. Breaker cooldowns are 0 or 60 s, so no decision depends
on the clock. Then two of the port's frontends over CPU engines behind the
port's ``RouterFrontDoor``: prefix routing, the SSE streams equal the
batch engine's greedy tokens, and the door's endpoints."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_training_tpu.serving import router as jax_router
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.serving import Engine, ServingFrontend
from distributed_training_tpu_torch.serving import router

torch.set_num_threads(1)


class FakeReplica:
    """Scripted replica: probe and healthz answers, and an admin state
    machine (drain → drained, deploy → epoch + 1, reopen → serving)."""

    def __init__(self, name, *, hit=0, wait=0.0, depth=0, active=0, phase="serving",
                 unreachable=False, wedge_drain=False, log=None):
        self.name, self.hit, self.wait, self.depth, self.active = name, hit, wait, depth, active
        self.phase, self.unreachable, self.wedge_drain = phase, unreachable, wedge_drain
        self.epoch = 0
        self.probe_calls = 0
        self.log = log if log is not None else []

    def probe(self, prompt):
        self.probe_calls += 1
        if self.unreachable:
            raise OSError("connection refused")
        return {"hit_tokens": self.hit, "queue_wait_p95_ms": self.wait,
                "queue_depth": self.depth, "active_slots": self.active,
                "draining": self.phase in ("draining", "drained"), "phase": self.phase}

    def healthz(self):
        if self.unreachable:
            raise urllib.error.URLError("down")
        return {"phase": self.phase, "weights_epoch": self.epoch}

    def admin(self, cmd):
        self.log.append((self.name, cmd))
        if cmd == "drain" and not self.wedge_drain:
            self.phase = "drained"
        elif cmd == "deploy":
            self.epoch += 1
        elif cmd == "reopen":
            self.phase = "serving"
        return {"ok": True}


def _route(r, prompt=(1, 2, 3)):
    return [tuple(x) for x in r.route(list(prompt))]


def sc_longest_prefix(R):
    r = R([FakeReplica("a", hit=8), FakeReplica("b", hit=24), FakeReplica("c", hit=16)])
    return [_route(r)], r


def sc_queue_wait_fallback(R):
    r = R([FakeReplica("a", wait=5.0), FakeReplica("b", wait=1.0), FakeReplica("c", wait=3.0)])
    return [_route(r)], r


def sc_ties(R):
    r = R([FakeReplica("a", depth=3), FakeReplica("b"), FakeReplica("c", active=1)])
    return [_route(r), _route(r, (1,))], r


def sc_skips(R):
    r = R([FakeReplica("a", phase="draining"), FakeReplica("dead", unreachable=True),
           FakeReplica("c", hit=4), FakeReplica("d", phase="recovering")])
    return [_route(r), list(r.errors_by_replica)], r


def sc_rotation(R):
    r = R([FakeReplica("a", hit=99), FakeReplica("b")])
    r.set_rotation(0, False)
    first = _route(r)
    r.set_rotation(0, True)
    return [first, _route(r), r.in_rotation()], r


def sc_round_robin(R):
    r = R([FakeReplica("a", hit=99), FakeReplica("b"), FakeReplica("c")], policy="round_robin")
    return [_route(r) for _ in range(5)], r


def sc_counters(R):
    r = R([FakeReplica("a"), FakeReplica("b")])
    r.note_routed(0, by_prefix=True)
    r.note_routed(1, by_prefix=False)
    r.note_routed(1, by_prefix=False, retried=True)
    r.note_failover_resume()
    return [], r


def sc_breaker_opens_probe_free(R):
    reps = [FakeReplica("a", hit=99), FakeReplica("b")]
    r = R(reps, breaker_threshold=3, breaker_cooldown_s=60.0)
    states = []
    for _ in range(3):
        r.note_replica_failure(0)
        states.append(r.breaker_state(0))
    before = reps[0].probe_calls
    return [states, _route(r), reps[0].probe_calls - before], r


def sc_breaker_half_open(R):
    reps = [FakeReplica("a", hit=99), FakeReplica("b"), FakeReplica("c")]
    r = R(reps, breaker_threshold=1, breaker_cooldown_s=0.0)
    out = []
    r.note_replica_failure(0)
    out.append(r.breaker_state(0))
    out.append(_route(r))               # → half-open, the trial ordered last
    out.append(r.breaker_state(0))
    r.note_replica_failure(0)           # the trial spent → open again
    out.append(r.breaker_state(0))
    out.append(_route(r))
    r.note_replica_success(0)           # → closed
    out.append(r.breaker_state(0))
    r.note_replica_failure(1)
    r.note_replica_success(1)
    r.note_replica_failure(2)
    out.append([r.breaker_state(i) for i in range(3)])
    return out, r


def sc_breaker_round_robin(R):
    r = R([FakeReplica("a"), FakeReplica("b"), FakeReplica("c")], policy="round_robin",
          breaker_threshold=1, breaker_cooldown_s=0.0)
    r.note_replica_failure(0)
    return [_route(r), _route(r)], r


SCRIPTS = [sc_longest_prefix, sc_queue_wait_fallback, sc_ties, sc_skips, sc_rotation,
           sc_round_robin, sc_counters, sc_breaker_opens_probe_free, sc_breaker_half_open,
           sc_breaker_round_robin]


@pytest.mark.parametrize("script", SCRIPTS, ids=[s.__name__[3:] for s in SCRIPTS])
def test_routing_and_breakers_match_jax(script):
    mine, r = script(router.Router)
    theirs, jr = script(jax_router.Router)
    assert mine == theirs
    assert r.router_snapshot() == jr.router_snapshot()


def test_bad_router_arguments_raise_as_jax():
    for kw in ({"policy": "sticky"}, {"breaker_threshold": 0}):
        with pytest.raises(ValueError) as mine:
            router.Router([FakeReplica("a")], **kw)
        with pytest.raises(ValueError) as theirs:
            jax_router.Router([FakeReplica("a")], **kw)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("wedged", [False, True], ids=["deploy", "wedged_drain"])
def test_rolling_deploy_runs_in_jax_order(wedged):
    def run(R):
        log = []
        r = R([FakeReplica("a", wedge_drain=wedged, log=log), FakeReplica("b", log=log)])
        try:
            report = r.rolling_deploy(poll_s=0.001, timeout_s=0.05 if wedged else 5.0)
        except TimeoutError as e:
            report = f"TimeoutError: {e}"
        return log, report, r.router_snapshot(), r.in_rotation()

    mine, theirs = run(router.Router), run(jax_router.Router)
    assert mine == theirs
    if not wedged:
        assert mine[0] == [("a", "drain"), ("a", "deploy"), ("a", "reopen"),
                           ("b", "drain"), ("b", "deploy"), ("b", "reopen")]
        assert mine[2]["router_deploys_completed"] == 2


def test_parse_sse_frame_as_jax():
    frames = [b'event: tokens\ndata: {"uid": 3, "tokens": [1, 2]}\n\n', b": keepalive\n\n",
              b"event: done\ndata: not json\n\n", b'event: done\ndata: {"uid": 3}\n\n']
    for f in frames:
        assert router._parse_sse_frame(f) == jax_router._parse_sse_frame(f)


VOCAB = 31


@pytest.fixture(scope="module")
def fleet():
    """Two frontends over CPU engines (one seeded model each, the same
    weights) behind the port's front door."""
    lm = get_model("transformer_lm", num_classes=VOCAB, num_layers=1, num_heads=2,
                   hidden_dim=32, max_len=64, generator=torch.Generator().manual_seed(0))
    cfg = ServeConfig(max_batch=2, max_new_tokens=5, temperature=0.0, kv_page_size=4,
                      prefix_cache=True)
    fronts = [ServingFrontend(Engine(lm, cfg), port=0).start() for _ in range(2)]
    rt = router.Router([router.HttpReplica(f.url(""), name=f"r{i}")
                        for i, f in enumerate(fronts)])
    door = router.RouterFrontDoor(rt, port=0).start()
    yield lm, cfg, fronts, rt, door
    door.stop()
    for f in fronts:
        f.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=10.0) as resp:
        return resp.read().decode()


def test_front_door_streams_the_batch_engine_tokens(fleet):
    lm, cfg, fronts, rt, door = fleet
    rng = np.random.RandomState(3)
    preamble = rng.randint(0, VOCAB, 12).tolist()
    prompts = [preamble + rng.randint(0, VOCAB, 3).tolist() for _ in range(4)]
    got = [router.generate_over_http(door.url(), {"prompt": p}, trace_id=f"t-{i}")
           for i, p in enumerate(prompts)]
    batch = Engine(lm, cfg)
    for p in prompts:
        batch.submit(np.asarray(p, np.int32))
    want = {f.uid: f.tokens.tolist() for f in batch.run()}
    for i, d in enumerate(got):
        assert d["streamed_tokens"] == d["tokens"] == want[i]
        assert d["trace_id"] == d["trace_header"] == f"t-{i}"
    snap = json.loads(_get(door.url("/router/stats")))
    # The first request seeds a trie; the other three share its preamble.
    assert snap["router_requests_routed"] == 4
    assert snap["router_prefix_routed"] == 3 and snap["router_fallback_routed"] == 1
    metrics = _get(door.url("/metrics"))
    assert "router_prefix_routed 3" in metrics
    assert 'router_replica_breaker_state{replica="r0"} 0' in metrics
    fed = _get(door.url("/fleet/metrics"))
    assert 'fleet_replica_stale{replica="r0"} 0' in fed and 'replica="r1"' in fed
    fleet_vars = json.loads(_get(door.url("/fleet/vars")))
    assert set(fleet_vars) == {"router", "fleet", "supervisor", "replicas"}
    assert fleet_vars["fleet"]["fleet_ledger_requests"] == 4
    assert fleet_vars["fleet"]["fleet_ledger_conservation_violations"] == 0
    health = json.loads(_get(door.url("/healthz")))
    assert set(health["replicas"]) == {"r0", "r1"}


def test_front_door_rolling_deploy_over_http(fleet):
    _, _, fronts, rt, door = fleet
    req = urllib.request.Request(door.url("/admin/rolling_deploy"), data=b"{}",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10.0) as resp:
        assert resp.status == 202
    door._deploy_thread.join(timeout=60.0)
    snap = rt.router_snapshot()
    assert snap["router_deploys_completed"] == 2 and snap["router_deploy_errors"] == 0
    assert [f._engine.weights_epoch for f in fronts] == [0, 0]
