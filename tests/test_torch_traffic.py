"""The port's ``tools/traffic.py`` against the repo's (JAX-side) one: for the
same ``(seed, params)`` every scenario builds the identical request list
(arrival times, prompts, budgets, tiers, tenants) and the same HTTP
payloads; the trace round-trip counter agrees on the same results. The
port's client replay also times each request's first streamed token."""

import http.server
import json
import threading

import numpy as np
import pytest

from distributed_training_tpu_torch.tools import traffic
from tools import traffic as jax_traffic

PARAMS = dict(requests=40, rate=25.0, mean_prompt_len=12, max_prompt_len=40,
              max_new_tokens=9, vocab_size=97, budget=64)


def test_the_same_nine_scenarios():
    assert sorted(traffic.SCENARIOS) == sorted(jax_traffic.SCENARIOS)
    assert len(traffic.SCENARIOS) == 9
    for name, sc in traffic.SCENARIOS.items():
        theirs = jax_traffic.SCENARIOS[name]
        assert (sc.num_tiers, sc.tenant_weights) == (theirs.num_tiers, theirs.tenant_weights)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(jax_traffic.SCENARIOS))
def test_scenario_identical_to_jax(name, seed):
    got = traffic.make_scenario(name, seed=seed, **PARAMS)
    want = jax_traffic.make_scenario(name, seed=seed, **PARAMS)
    assert len(got) == len(want) == PARAMS["requests"]
    for a, b in zip(got, want):
        assert a.arrival_s == b.arrival_s
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype
        assert (a.max_new_tokens, a.priority, a.tenant) == (b.max_new_tokens, b.priority,
                                                            b.tenant)
        assert traffic.request_payload(a, stream=False) == jax_traffic.request_payload(
            b, stream=False)
        assert a.prompt.size + a.max_new_tokens <= PARAMS["budget"]


def test_bad_scenario_arguments_raise_as_jax():
    for kw in ({"requests": 0}, {"rate": 0.0}):
        args = {**PARAMS, **kw}
        with pytest.raises(ValueError) as mine:
            traffic.make_scenario("poisson", seed=0, **args)
        with pytest.raises(ValueError) as theirs:
            jax_traffic.make_scenario("poisson", seed=0, **args)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown scenario"):
        traffic.make_scenario("nope", seed=0, **PARAMS)


def test_trace_roundtrip_mismatches_as_jax():
    results = [{"trace_id": "cli-0000", "trace_header": "cli-0000"},
               None,
               {"trace_id": "cli-0002", "trace_header": "other"},
               {"trace_id": "cli-0009", "trace_header": "cli-0009"},
               {"trace_id": None, "trace_header": "cli-0004"}]
    for prefix in (None, "cli-"):
        got = traffic.trace_roundtrip_mismatches(results, trace_prefix=prefix)
        assert got == jax_traffic.trace_roundtrip_mismatches(results, trace_prefix=prefix)
    assert traffic.trace_roundtrip_mismatches(results, trace_prefix="cli-") == 3


class _SSEDoor(http.server.BaseHTTPRequestHandler):
    """A stand-in front door: every POST streams two ``tokens`` frames and
    a ``done`` frame, echoing the trace id on the header and the payload."""

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        tid = self.headers.get("X-Graft-Trace")
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        if tid is not None:
            self.send_header("X-Graft-Trace", tid)
        self.end_headers()
        toks = [int(t) for t in body["prompt"][:3]]
        for event, data in (("tokens", {"tokens": toks[:2]}), ("tokens", {"tokens": toks[2:]}),
                            ("done", {"tokens": toks, "trace_id": tid})):
            self.wfile.write(f"event: {event}\ndata: {json.dumps(data)}\n\n".encode())
            self.wfile.flush()

    def log_message(self, *args):
        pass


@pytest.mark.parametrize("concurrency", [1, 3])
def test_replay_times_the_first_token(concurrency):
    reqs = traffic.make_scenario("poisson", seed=0, **{**PARAMS, "requests": 6})
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _SSEDoor)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/generate"
        ttft = ["stale"]
        results = traffic.replay_over_http(url, reqs, concurrency=concurrency,
                                           trace_prefix="cli-", drop_at={1: 1}, ttft_ms=ttft)
    finally:
        server.shutdown()
        server.server_close()
    assert results[1] is None and ttft[1] is None  # the chaos client's hang-up
    assert len(ttft) == len(reqs)
    for i, (r, res) in enumerate(zip(reqs, results)):
        if i == 1:
            continue
        assert res["streamed_tokens"] == res["tokens"] == [int(t) for t in r.prompt[:3]]
        assert 0.0 < ttft[i] < 60e3
    assert traffic.trace_roundtrip_mismatches(results, trace_prefix="cli-") == 0
