"""The port's control room (``serving/alerts.py``, the engine's wiring, the
exporter's ``/timeseries`` and ``/alerts``, ``tools/incident_report``)
against the JAX package's.

1. ``parse_slo_rules`` gives the same rules (``to_dict``) for the same
   specs and refuses the same bad specs with the same message.
2. ``AlertEngine`` over the same ring samples (seeded gauges, counters and
   TTFT histogram columns; gauge, rate, zero-tolerance and windowed
   quantile rules) gives an identical alert log.
3. Both packages' engines on the same weights (``bridge.py``) under the
   SLO drill's overload (the degrading scenario paced by iterations, a
   queue bound that sheds): identical alert logs (every rule here reads
   schedule-deterministic columns), the same ``alerts_*`` and
   ``incidents_captured``, bundles with the same sections, and both
   packages' ``incident_report`` exit 0 on each bundle and 2 on a torn one.
4. ``/timeseries`` and ``/alerts`` through ``attach_engine`` carry JAX's
   keys while the engine serves.

Exact equality throughout (the alert arithmetic is host float64 in both).
"""

import contextlib
import io
import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.resilience.errors import QueueFullError as JQueueFullError
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu.serving import alerts as jax_alerts
from distributed_training_tpu.serving import timeseries as jax_timeseries
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.observability.exporter import attach_engine
from distributed_training_tpu_torch.resilience.errors import QueueFullError
from distributed_training_tpu_torch.serving import Engine, alerts, timeseries
from distributed_training_tpu_torch.tools import incident_report
from distributed_training_tpu_torch.tools.traffic import make_scenario
from tools import incident_report as jax_incident_report

torch.set_num_threads(1)

SPECS = ["default", "q:queue_depth>2@3,10", "shed:requests_shed/requests_submitted>0.05@3,9x1.5~0.5",
         "ttft:ttft_window_p95_ms>40@2,6;z:ledger_conservation_violations>0",
         " a:pool_occupancy>0.5 ; ; default "]
BAD_SPECS = ["q:queue_depth<2", "q:queue_depth>2@9,3", "bad name:x>1", "z:a/b>0",
             "q:queue_depth>2;q:queue_depth>3", "q:queue_depth>1~1.5", "q:queue_depth>1x0"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_rules_as_jax(spec):
    mine = [r.to_dict() for r in alerts.parse_slo_rules(spec)]
    assert mine == [r.to_dict() for r in jax_alerts.parse_slo_rules(spec)]
    assert mine


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_slo_rules_refused_as_jax(spec):
    with pytest.raises(ValueError) as mine:
        alerts.parse_slo_rules(spec)
    with pytest.raises(ValueError) as theirs:
        jax_alerts.parse_slo_rules(spec)
    assert str(mine.value) == str(theirs.value)


def _samples(n=80, seed=0):
    """Seeded samples: a quiet stretch, a burst, recovery; counters,
    gauges and the TTFT histogram's cumulative bucket columns."""
    from distributed_training_tpu_torch.observability.histogram import DEFAULT_MS_BOUNDS

    rng = np.random.RandomState(seed)
    sub = shed = viol = 0
    cum = np.zeros(len(DEFAULT_MS_BOUNDS) + 1)
    out = []
    for i in range(n):
        hot = 30 <= i < 55
        sub += int(rng.randint(1, 6))
        shed += int(rng.randint(0, 3)) if hot else 0
        viol += int(i == 61)
        lat = rng.uniform(60, 400, 4) if hot else rng.uniform(1, 30, 4)
        for v in lat:
            cum[np.searchsorted(DEFAULT_MS_BOUNDS, v):] += 1
        s = {"iteration": i, "requests_submitted": sub, "requests_shed": shed,
             "queue_depth": float(rng.randint(3, 9) if hot else rng.randint(0, 2)),
             "pool_occupancy": float(rng.uniform(0.6, 1.0) if hot else rng.uniform(0, 0.3)),
             "ledger_conservation_violations": viol}
        for j, c in enumerate(cum):
            s[f"ttft_ms_le_{j:02d}" if j < len(DEFAULT_MS_BOUNDS) else "ttft_ms_le_inf"] = c
        out.append(s)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_alert_engine_log_equals_jax_over_one_ring(seed):
    spec = ("q:queue_depth>2@3,10;shed:requests_shed/requests_submitted>0.05@3,10;"
            "ttft:ttft_window_p95_ms>100@3,10;z:ledger_conservation_violations>0;"
            "pool:pool_occupancy>0.5@2,8~0.5")
    mine = alerts.AlertEngine(alerts.parse_slo_rules(spec))
    theirs = jax_alerts.AlertEngine(jax_alerts.parse_slo_rules(spec))
    ring, jring = timeseries.TelemetryRing(64, 1), jax_timeseries.TelemetryRing(64, 1)
    fired = []
    for s in _samples(seed=seed):
        ring.record_sample(s)
        jring.record_sample(s)
        a, b = mine.evaluate(ring, s["iteration"]), theirs.evaluate(jring, s["iteration"])
        assert a == b
        fired += a
    assert mine.to_dict() == theirs.to_dict()
    assert {e["rule"] for e in fired} == {"q", "shed", "ttft", "z", "pool"}
    assert mine.cleared >= 3
    with pytest.raises(ValueError, match="unknown metric"):
        alerts.AlertEngine(alerts.parse_slo_rules("x:no_such>1@1,1")).evaluate(ring, 0)


# -- both engines under the SLO drill's overload ---------------------------------
LM = dict(num_classes=64, num_layers=1, num_heads=2, hidden_dim=32, max_len=64)
RULES = ("queue_pressure:queue_depth>2@3,10;"
         "shed_rate:requests_shed/requests_submitted>0.05@3,10;"
         "zero_viol:ledger_conservation_violations>0")
LOAD = dict(requests=64, rate=200.0, mean_prompt_len=24, max_prompt_len=48,
            max_new_tokens=16, vocab_size=64, budget=64)
CFG = dict(max_batch=4, max_new_tokens=16, temperature=0.0, prefill_chunk=16,
           max_queue_depth=8, sample_every=2, slo_rules=RULES)
VIRTUAL_DT_MS = 5.0


def _drive(eng, full_error):
    """The degrading scenario released on an iteration clock (serve_bench's
    ``--virtual-dt`` drive), then a drain; the submits shed at the door."""
    load = make_scenario("degrading", seed=0, **LOAD)
    sub = it = shed = 0
    while sub < len(load):
        while sub < len(load) and load[sub].arrival_s <= it * VIRTUAL_DT_MS / 1e3:
            try:
                eng.submit(load[sub].prompt, max_new_tokens=load[sub].max_new_tokens)
            except full_error:
                shed += 1
            sub += 1
        eng.step()
        it += 1
    eng.drain()
    eng.close_incidents()
    return shed


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    d = tmp_path_factory.mktemp("alerts")
    lm = get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM).eval()
    eng = Engine(lm, ServeConfig(incident_dir=str(d / "port"), **CFG))
    shed = _drive(eng, QueueFullError)
    params, _ = bridge.state_dict_to_flax(lm)
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM)
    jeng = JEngine(jm, jax.tree.map(jnp.asarray, params),
                   JServeConfig(incident_dir=str(d / "jax"), **CFG))
    jshed = _drive(jeng, JQueueFullError)
    return {"port": (eng, shed, str(d / "port")), "jax": (jeng, jshed, str(d / "jax")),
            "dir": d}


def test_engine_alert_log_equals_jax(drills):
    (eng, shed, _), (jeng, jshed, _) = drills["port"], drills["jax"]
    assert shed == jshed > 0
    assert eng.alerts.to_dict() == jeng.alerts.to_dict()
    assert [(e["event"], e["rule"], e["iteration"]) for e in eng.alerts.log] == [
        ("fire", "queue_pressure", 21), ("fire", "shed_rate", 31),
        ("clear", "shed_rate", 43), ("clear", "queue_pressure", 53)]
    keys = ("alerts_fired", "alerts_cleared", "alerts_active", "incidents_captured",
            "requests_shed", "requests_submitted", "requests_finished")
    assert {k: eng.stats()[k] for k in keys} == {k: jeng.stats()[k] for k in keys}
    assert eng.stats()["incidents_captured"] == 2


def _bundles(path):
    return {n: json.load(open(os.path.join(path, n))) for n in sorted(os.listdir(path))}


def test_bundles_have_jax_sections(drills):
    mine, theirs = _bundles(drills["port"][2]), _bundles(drills["jax"][2])
    assert list(mine) == list(theirs) == ["incident_000_queue_pressure.json",
                                          "incident_001_shed_rate.json"]
    for name in mine:
        a, b = mine[name], theirs[name]
        assert set(a) == set(b) == {"format_version", "alert", "alerts", "timeseries", "flight"}
        assert a["alert"] == b["alert"] and a["alerts"] == b["alerts"]
        assert a["timeseries"]["fields"] == b["timeseries"]["fields"]
        assert set(a["timeseries"]) == set(b["timeseries"])
        assert set(a["flight"]["serving"]) == set(b["flight"]["serving"])
        assert a["flight"]["reason"] == b["flight"]["reason"] == f"incident:{a['alert']['rule']}"


@pytest.mark.parametrize("tool", ["port", "jax"])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_incident_report_exit_codes(drills, tool, package):
    main = incident_report.main if tool == "port" else jax_incident_report.main
    path = drills[package][2]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main([path]) == 0
    assert out.getvalue().startswith("incident: rule 'queue_pressure' fired at iteration 21")
    torn = drills["dir"] / f"torn_{tool}_{package}.json"
    torn.write_text(open(os.path.join(path, "incident_000_queue_pressure.json")).read()[:300])
    with contextlib.redirect_stderr(io.StringIO()):
        assert main([str(torn)]) == 2
        assert main([str(drills["dir"] / "missing.json")]) == 2


def test_attach_engine_serves_jax_s_control_room(drills):
    lm = get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM).eval()
    eng = Engine(lm, ServeConfig(**{**CFG, "slo_rules": "default"}))
    jeng = drills["jax"][0]
    exporter = attach_engine(eng, 0, component="test", printer=lambda m: None)
    try:
        for p in make_scenario("poisson", seed=1, **{**LOAD, "requests": 6}):
            eng.submit(p.prompt, max_new_tokens=4)
        for _ in range(5):
            eng.step()
        got = {}
        for path in ("/timeseries", "/alerts", "/healthz"):
            with urllib.request.urlopen(exporter.url(path), timeout=10.0) as resp:
                got[path] = json.loads(resp.read())
        with pytest.raises(urllib.error.HTTPError) as missing:
            urllib.request.urlopen(exporter.url("/nope"), timeout=10.0)
        assert json.loads(missing.value.read())["endpoints"][-2:] == ["/timeseries", "/alerts"]
    finally:
        exporter.close()
    eng.run()
    assert set(got["/timeseries"]) == set(jeng.timeseries_snapshot())
    assert got["/timeseries"]["fields"] == jeng.timeseries_snapshot()["fields"]
    assert got["/timeseries"]["samples"]
    assert set(got["/alerts"]) == set(jeng.alerts_snapshot())
    assert [r["name"] for r in got["/alerts"]["rules"]] == [
        r.name for r in jax_alerts.default_rules()]
    assert got["/healthz"]["phase"] in ("serving", "overloaded")
    assert "weights_epoch" in got["/healthz"]
    assert eng.stats()["alerts_fired"] == 0  # the healthy run fires nothing
