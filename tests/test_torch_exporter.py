"""The port's live exporter (``observability/exporter.py``) against the JAX
package's, and a live scrape of a micro fit.

The same snapshot served by both exporters gives the same ``/metrics``
body byte for byte (both render through their ``prometheus`` module), the
same ``/vars`` and ``/healthz`` keys; an unknown path answers 404 with the
endpoints, a port in use raises at construction, ``close`` releases the
port, and a provider that raises answers 500 while the server goes on.
Then ``TrainObservability`` with ``metrics_port`` (recorder off: the
minimal snapshot) and a scrape thread during a micro ``LMTrainer.fit``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from distributed_training_tpu.observability.exporter import MetricsExporter as JaxExporter
from distributed_training_tpu.observability.prometheus import families, sample_value
from distributed_training_tpu_torch import config as tcfg
from distributed_training_tpu_torch.observability.exporter import MetricsExporter
from distributed_training_tpu_torch.observability.hooks import TrainObservability

torch.set_num_threads(1)

EXPORTERS = {"jax": JaxExporter, "port": MetricsExporter}

CANNED = {
    "format_version": 1,
    "reason": "scrape",
    "steps_recorded_total": 7,
    "step_time_stats": {"step_time_p50_ms": 3.5, "step_time_p95_ms": 9.0,
                        "step_time_max_ms": 12.0},
    "histograms": {"step_time_ms": {"bounds": [1.0, 10.0], "counts": [2, 3, 1],
                                    "count": 6, "sum": 31.0}},
    "wall_clock": {"goodput": 0.5, "phase_seconds": {"step": 1.0, "data": 1.0}},
    "hosts": {"straggler": {"host": 1, "step": 4, "excess_ms": 50.0}},
    "resilience": {"saves_committed": 2, "saves_failed": 0, "io_retries": 3,
                   "chaos_faults": {"kills": 0, "io_faults": 3}},
}


def _get(url: str, timeout: float = 10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return (resp.status, resp.headers.get("Content-Type", ""),
                resp.read().decode("utf-8"))


@pytest.mark.parametrize("path", ["/metrics", "/vars", "/healthz", "/nope"])
def test_endpoints_answer_as_jax(path):
    """Each endpoint of the port's exporter against JAX's on one snapshot."""
    got = {}
    for name, cls in EXPORTERS.items():
        exp = cls(lambda: dict(CANNED), port=0, phase_provider=lambda: "train").start()
        try:
            try:
                got[name] = _get(exp.url(path))
            except urllib.error.HTTPError as e:
                got[name] = (e.code, e.headers.get("Content-Type", ""), e.read().decode())
        finally:
            exp.close()
    j, t = got["jax"], got["port"]
    assert t[:2] == j[:2]
    if path == "/healthz":
        jh, th = json.loads(j[2]), json.loads(t[2])
        assert set(th) == set(jh) and th["phase"] == "train" and th["status"] == "ok"
        assert th["scrapes"] == 0 and th["uptime_seconds"] >= 0
        return
    if path == "/nope":
        assert t[0] == 404 and json.loads(t[2]) == json.loads(j[2])
        return
    assert t == j
    if path == "/metrics":
        assert t[1].startswith("text/plain")
        assert families(t[2])["flight_step_time_ms"] == "histogram"
        assert sample_value(t[2], 'flight_step_time_ms_bucket{le="+Inf"}') == 6
        assert sample_value(t[2], "resilience_io_retries") == 3
    else:
        assert json.loads(t[2]) == CANNED


@pytest.mark.parametrize("case", ["port_in_use", "close_releases", "broken_provider"])
def test_exporter_lifecycle(case):
    """A taken port raises at construction; ``close`` (twice) frees the
    port for a new exporter; a provider that raises gives a 500 naming the
    error, and the next scrape succeeds."""
    if case == "port_in_use":
        first = MetricsExporter(lambda: {}, port=0).start()
        try:
            with pytest.raises(OSError):
                MetricsExporter(lambda: {}, port=first.port)
        finally:
            first.close()
    elif case == "close_releases":
        exp = MetricsExporter(lambda: dict(CANNED), port=0).start()
        port = exp.port
        assert _get(exp.url("/healthz"))[0] == 200
        exp.close()
        exp.close()
        with pytest.raises(OSError):
            _get(f"http://127.0.0.1:{port}/healthz", timeout=1.0)
        again = MetricsExporter(lambda: {}, port=port).start()
        try:
            assert _get(again.url("/healthz"))[0] == 200
        finally:
            again.close()
    else:
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("torn snapshot")
            return dict(CANNED)

        exp = MetricsExporter(flaky, port=0).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as info:
                _get(exp.url("/metrics"))
            assert info.value.code == 500
            assert "torn snapshot" in info.value.read().decode()
            assert _get(exp.url("/metrics"))[0] == 200
            assert json.loads(_get(exp.url("/healthz"))[2])["scrapes"] == 2
        finally:
            exp.close()


@pytest.mark.parametrize("recorder", [False, True])
def test_train_observability_serves_on_the_master_only(recorder):
    """``metrics_port`` starts an exporter on the master alone (a second
    rank's object has none); with the recorder off the minimal snapshot
    still renders; ``close`` releases the port."""
    cfg = tcfg.ObservabilityConfig(flight_recorder=recorder, metrics_port=0,
                                   straggler_attribution=False)
    assert TrainObservability(cfg, is_master=False).exporter is None
    obs = TrainObservability(cfg)
    port = obs.exporter.port
    try:
        code, _, text = _get(obs.exporter.url("/metrics"))
        assert code == 200 and "flight_steps_recorded_total 0" in text
        health = json.loads(_get(obs.exporter.url("/healthz"))[2])
        assert health["phase"] == "init"
        assert json.loads(_get(obs.exporter.url("/vars"))[2])["reason"] == "scrape"
    finally:
        obs.close()
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/healthz", timeout=1.0)


def test_scrape_during_a_live_lm_fit(tmp_path):
    """A micro ``LMTrainer.fit`` with ``metrics_port``: a thread scrapes
    ``/metrics``, ``/healthz`` and ``/vars`` while it runs, after the first
    flush, and ``fit``'s end closes the port."""
    from distributed_training_tpu_torch import LMTrainer

    cfg = tcfg.TrainConfig(
        model="transformer_lm", num_epochs=1, log_interval=2, eval_every=0,
        data=tcfg.DataConfig(batch_size=2, max_steps_per_epoch=30, prefetch=0),
        lm=tcfg.LMConfig(seq_len=8, vocab_size=32, num_layers=1, num_heads=2,
                         hidden_dim=16, max_len=8, train_sequences=64, eval_sequences=4),
        checkpoint=tcfg.CheckpointConfig(directory=str(tmp_path), interval=0),
        observability=tcfg.ObservabilityConfig(metrics_port=0))
    trainer = LMTrainer(cfg, device="cpu")
    exp = trainer.obs.exporter
    port, got, stop = exp.port, {}, threading.Event()
    step = trainer.train_step

    def slow_step(state, batch):  # room for the scraper between steps
        time.sleep(0.01)
        return step(state, batch)

    trainer.train_step = slow_step

    def scraper():
        while not stop.is_set():
            try:
                text = _get(exp.url("/metrics"), timeout=2.0)[2]
                if sample_value(text, "flight_steps_recorded_total") < 4:
                    time.sleep(0.005)
                    continue
                got["health"] = json.loads(_get(exp.url("/healthz"), timeout=2.0)[2])
                got["vars"] = json.loads(_get(exp.url("/vars"), timeout=2.0)[2])
                got["metrics"] = text
                return
            except (OSError, KeyError):
                time.sleep(0.005)

    th = threading.Thread(target=scraper, daemon=True)
    th.start()
    try:
        trainer.fit()
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert "metrics" in got, "no scrape during the fit"
    assert families(got["metrics"])["flight_steps_recorded_total"] == "gauge"
    assert got["health"]["status"] == "ok" and got["health"]["phase"]
    assert got["vars"]["flushes"][-1]["loss"] > 0
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/healthz", timeout=1.0)
