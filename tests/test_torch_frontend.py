"""``serving/frontend.py``: the port's SSE front door of one engine against
the JAX package's, both on the CPU over the same weights (``bridge.py``).

- Greedy SSE tokens equal JAX's frontend's and the port's batch engine's,
  each stream's concatenation equal to its ``done`` frame; sampled streams
  equal the port's batch engine (they are the port's own streams, ROADMAP
  C (d)); unary answers equal the streams.
- ``/probe`` answers equal JAX's (every field but the wall-clock queue
  wait); the bodies JAX refuses (no length, malformed framing, bad JSON,
  an unknown path) get the same status codes.
- ``/admin/drain``, ``/admin/deploy`` and ``/admin/reopen`` move both
  through the same phases and weights epochs.
- A client that hangs up mid-stream is not acked: the request is
  cancelled, the pool balances, and a recovery of the journal redelivers
  its completion exactly once, in both packages.

Token comparisons are exact.
"""

import json
import socket
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu.serving.frontend import ServingFrontend as JServingFrontend
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.serving import Engine, ServingFrontend
from distributed_training_tpu_torch.serving.router import generate_over_http

torch.set_num_threads(1)

VOCAB, MAX_LEN = 61, 64
LM = dict(num_classes=VOCAB, num_layers=1, num_heads=2, hidden_dim=16, max_len=MAX_LEN)
PROMPTS = [((np.arange(1, 9 + i, dtype=np.int32) * (2 + i)) % VOCAB) for i in range(5)]
BASE = dict(max_batch=2, max_new_tokens=6, kv_page_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def lm():
    return get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM).eval()


@pytest.fixture(scope="module")
def jlm(lm):
    params, _ = bridge.state_dict_to_flax(lm)
    return (jax_model("transformer_lm", logits_dtype=jnp.float32, **LM),
            jax.tree.map(jnp.asarray, params))


def _port(lm, **kw):
    return Engine(lm, ServeConfig(**{**BASE, **kw}))


def _jax(jlm, **kw):
    return JEngine(*jlm, JServeConfig(**{**BASE, **kw}))


def _http(fe, prompts, stream=True):
    return [generate_over_http(fe.url("/generate"), {"prompt": [int(t) for t in p],
                                                      "stream": stream}, timeout_s=60.0)
            for p in prompts]


def _batch(eng, prompts):
    out = {}
    for p in prompts:
        eng.submit(p)
        out |= {f.uid: f.tokens.tolist() for f in eng.run()}
    return [out[u] for u in sorted(out)]


def _post(url, payload=None, raw=None, headers=None):
    data = raw if raw is not None else json.dumps(payload or {}).encode()
    req = urllib.request.Request(url, data=data,
                                 headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def greedy(lm, jlm):
    fe, jfe = (ServingFrontend(_port(lm, prefix_cache=True)).start(),
               JServingFrontend(_jax(jlm, prefix_cache=True)).start())
    try:
        return _http(fe, PROMPTS), _http(jfe, PROMPTS)
    finally:
        fe.stop()
        jfe.stop()


def test_greedy_sse_equals_jax_and_the_batch_engine(lm, greedy):
    mine, theirs = greedy
    batch = _batch(_port(lm, prefix_cache=True), PROMPTS)
    assert [r["tokens"] for r in mine] == [r["tokens"] for r in theirs] == batch
    for r in mine:
        assert r["streamed_tokens"] == r["tokens"]
        assert r["trace_id"] == r["trace_header"] == f"uid-{r['uid']}"
    keys = set(theirs[0]) - {"ledger"}
    assert set(mine[0]) - {"ledger"} == keys
    assert set(mine[0]["ledger"]) == set(theirs[0]["ledger"])


def test_sampled_sse_equals_the_port_batch_engine(lm):
    kw = dict(temperature=0.7, seed=11)
    fe = ServingFrontend(_port(lm, **kw)).start()
    try:
        net = _http(fe, PROMPTS)
        unary = _http(fe, PROMPTS[:2], stream=False)
    finally:
        fe.stop()
    assert [r["tokens"] for r in net] == _batch(_port(lm, **kw), PROMPTS)
    assert all(r["streamed_tokens"] == r["tokens"] for r in net)
    assert [r["tokens"] for r in unary] == _batch(_port(lm, **kw), PROMPTS + PROMPTS[:2])[5:]


BAD = {
    "no_length": (b'{"prompt": [1]}', {"Content-Type": "application/json",
                                       "Transfer-Encoding": "identity"}, "/generate"),
    "bad_chunk": (b"zz\r\n{}\r\n0\r\n\r\n", {"Transfer-Encoding": "chunked"}, "/generate"),
    "bad_json": (b"{nope", {"Content-Type": "application/json"}, "/generate"),
    "no_prompt": (b"{}", {"Content-Type": "application/json"}, "/generate"),
    "unknown_path": (b"{}", {"Content-Type": "application/json"}, "/nowhere"),
}


def _raw_post(port, path, body, headers):
    """A POST written by hand (urllib always frames its bodies)."""
    head = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    if "Transfer-Encoding" not in headers:
        head += f"Content-Length: {len(body)}\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: t\r\n{head}\r\n".encode() + body)
        return int(s.makefile("rb").readline().split()[1])


def test_probe_and_refusals_equal_jax(lm, jlm):
    fes = [ServingFrontend(_port(lm, prefix_cache=True)).start(),
           JServingFrontend(_jax(jlm, prefix_cache=True)).start()]
    try:
        probes, codes = [], []
        for fe in fes:
            _http(fe, PROMPTS[:2])
            got = [_post(fe.url("/probe"), {"prompt": p})
                   for p in ([9, 9, 9, 9], [int(t) for t in PROMPTS[0]],
                             [int(t) for t in PROMPTS[1]] + [3, 4], None)]
            for _, body in got:
                body.pop("queue_wait_p95_ms")  # the ledger's wall clock
            probes.append(got)
            codes.append({k: _raw_post(fe.port, path, body, hdr)
                          for k, (body, hdr, path) in BAD.items()})
    finally:
        for fe in fes:
            fe.stop()
    assert probes[0] == probes[1]
    assert probes[0][1][1]["hit_tokens"] == 4 and probes[0][0][1]["hit_tokens"] == 0
    assert codes[0] == codes[1] == {"no_length": 411, "bad_chunk": 400, "bad_json": 400,
                                    "no_prompt": 400, "unknown_path": 404}


def _wait_health(fe, pred, timeout_s=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        with urllib.request.urlopen(fe.url("/healthz"), timeout=10.0) as resp:
            h = json.loads(resp.read())
        if pred(h):
            return h
        time.sleep(0.01)
    raise AssertionError(f"health never reached the state: {h}")


def test_drain_deploy_reopen_move_through_jax_s_phases(lm, jlm):
    trails = []
    for fe in (ServingFrontend(_port(lm)).start(), JServingFrontend(_jax(jlm)).start()):
        try:
            trail = [_wait_health(fe, lambda h: True)["phase"]]
            st, body = _post(fe.url("/admin/drain"))
            trail.append((st, sorted(body)))
            trail.append(_wait_health(fe, lambda h: h["phase"] == "drained")["phase"])
            refused = _post(fe.url("/generate"), {"prompt": [1, 2, 3]})
            trail.append((refused[0], refused[1]["kind"]))
            st, body = _post(fe.url("/admin/deploy"))
            trail.append((st, body))
            trail.append(_wait_health(fe, lambda h: h["weights_epoch"] == 0)["swaps_completed"])
            st, body = _post(fe.url("/admin/reopen"))
            trail.append((st, body))
            trail.append(_http(fe, PROMPTS[:1])[0]["tokens"])
            trail.append(_wait_health(fe, lambda h: h["phase"] == "idle")["weights_epoch"])
        finally:
            fe.stop()
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[0][0] == "idle" and trails[0][3] == (503, "DrainingError")


def _hang_up_mid_stream(port, prompt):
    body = json.dumps({"prompt": prompt, "stream": True}).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        buf = b""
        while b"event: tokens" not in buf or not buf.endswith(b"\n\n"):
            buf += s.recv(4096)


def _disconnect_drill(make, front_cls, jdir):
    eng = make(journal_dir=jdir, max_new_tokens=40)
    eng.recover()
    fe = front_cls(eng).start()
    try:
        _hang_up_mid_stream(fe.port, [3, 5, 7])
        t0 = time.monotonic()
        while not eng.idle and time.monotonic() - t0 < 30.0:
            time.sleep(0.01)
        delivered = _http(fe, PROMPTS[:1])[0]
    finally:
        fe.stop()
    eng.check_balanced()
    cancelled = eng.stats()["requests_cancelled"]
    eng.journal.shutdown()
    reports = []
    for _ in range(2):
        again = make(journal_dir=jdir, max_new_tokens=40)
        rep = again.recover()
        reports.append([(f.uid, f.finish_reason) for f in rep["redelivered"]])
        again.journal.ack([f.uid for f in rep["redelivered"]])
        again.journal.shutdown()
    return cancelled, delivered["uid"], reports


def test_hangup_is_not_acked_and_redelivers_once(lm, jlm, tmp_path):
    mine = _disconnect_drill(lambda **kw: _port(lm, **kw), ServingFrontend,
                             str(tmp_path / "port"))
    theirs = _disconnect_drill(lambda **kw: _jax(jlm, **kw), JServingFrontend,
                               str(tmp_path / "jax"))
    assert mine == theirs
    # The hung-up request 0 was cancelled and never acked: the first recovery
    # redelivers it once; the delivered request 1 was acked; after the ack,
    # nothing.
    assert mine == (1, 1, [[(0, "cancelled")], []])
