"""The port's serving engine (``distributed_training_tpu_torch/serving/``)
against the JAX package's and against the port's own ``Generator``.

At JAX's test size (``transformer_lm`` with 2 layers, 2 heads, hidden 32,
vocab 61, max_len 64; the port's seeded weights, carried into JAX's trees
through ``bridge.py``), six prompts through two slots:

1. **Oracles.** The paged engine (the default, chunked prefill) and the
   legacy contiguous engine (``kv_page_size=None``) give greedy tokens
   identical to the port's sequential ``Generator`` and to JAX's
   ``Engine`` on the bridged weights.
2. **Independence.** A request's tokens do not depend on the batch, the
   page size or the prefill chunk: the engine at ``max_batch`` 1 with
   chunk 4 (and the legacy engine at ``max_batch`` 1) gives the same
   tokens, greedy and sampled. Sampled streams are the port's own
   (``inference/sampler.py``'s keyed rows), not JAX's (ROADMAP.md C (d)).
3. **Mechanics** as JAX pins them: the oversubscribed pool, EOS eviction,
   the one-token budget, drain, the bounded queue, both deadlines, the
   KV accounting, ``stats()``'s keys (JAX's set), the flight dump through
   the port's ``flight_report``, one device read an iteration, and one
   test per serving option (the features, the SLO rules and the incident
   bundles) and engine method.

Token comparisons are exact; the tests share engines in module fixtures.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.inference.sampler import (
    CacheBudgetError,
    Generator,
    SampleConfig,
)
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.observability.flight_recorder import FlightRecorder
from distributed_training_tpu_torch.serving import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_TIMEOUT,
    DrainingError,
    Engine,
    QueueFullError,
)
from distributed_training_tpu_torch.tools import flight_report

torch.set_num_threads(1)

VOCAB = 61
MAX_LEN = 64
N_NEW = 6
PROMPT_LENS = [3, 5, 9, 5, 3, 9]
LM = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=MAX_LEN,
          head_bias=True)


def _model(eos_bias: int | None = None):
    m = get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM)
    if eos_bias is not None:
        with torch.no_grad():
            m.lm_head.bias[eos_bias] += 1e4
    return m.eval()


@pytest.fixture(scope="module")
def lm():
    return _model()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in PROMPT_LENS]


def _serve(model, prompts, **cfg_kw):
    """One engine over ``prompts``: (engine, {uid: FinishedRequest})."""
    eng = Engine(model, ServeConfig(**{"prefill_bucket": 8, **cfg_kw}))
    for p in prompts:
        eng.submit(p)
    done = eng.run()
    assert len(done) == len(prompts)
    return eng, {f.uid: f for f in done}


GREEDY = dict(max_new_tokens=N_NEW, temperature=0.0)
SAMPLED = dict(max_new_tokens=N_NEW, temperature=1.0, top_k=10, seed=5)


@pytest.fixture(scope="module")
def batched_greedy(lm, prompts):
    return _serve(lm, prompts, max_batch=2, flush_every=2, **GREEDY)


@pytest.fixture(scope="module")
def legacy_greedy(lm, prompts):
    return _serve(lm, prompts, max_batch=2, kv_page_size=None, **GREEDY)


@pytest.fixture(scope="module")
def generator_tokens(lm, prompts):
    gen = Generator(lm, SampleConfig(max_new_tokens=N_NEW, temperature=0.0))
    return [gen(p)[0] for p in prompts]


@pytest.fixture(scope="module")
def jax_tokens(lm, prompts):
    """JAX's paged engine on the bridged weights."""
    params, _ = bridge.state_dict_to_flax(lm)
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM)
    eng = JEngine(jm, jax.tree.map(jnp.asarray, params),
                  JServeConfig(max_batch=2, prefill_bucket=8, **GREEDY))
    for p in prompts:
        eng.submit(p)
    done = {f.uid: f.tokens for f in eng.run()}
    return [done[uid] for uid in range(len(prompts))], eng.stats()


ENGINES = ["paged", "legacy"]


def _run(name, batched_greedy, legacy_greedy):
    return {"paged": batched_greedy, "legacy": legacy_greedy}[name]


@pytest.mark.parametrize("name", ENGINES)
def test_greedy_matches_the_port_generator(name, batched_greedy, legacy_greedy,
                                           generator_tokens):
    _, by_uid = _run(name, batched_greedy, legacy_greedy)
    for uid, want in enumerate(generator_tokens):
        np.testing.assert_array_equal(by_uid[uid].tokens, want, err_msg=f"request {uid}")


@pytest.mark.parametrize("name", ENGINES)
def test_greedy_matches_jax_engine(name, batched_greedy, legacy_greedy, jax_tokens):
    _, by_uid = _run(name, batched_greedy, legacy_greedy)
    for uid, want in enumerate(jax_tokens[0]):
        np.testing.assert_array_equal(by_uid[uid].tokens, want, err_msg=f"request {uid}")


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_solo_chunk4_equals_batched(lm, prompts, mode):
    """Batch 2 with one chunk a prompt vs batch 1 with chunk 4 (prompts 5
    and 9 prefill over several iterations) and a page size of 2."""
    kw = GREEDY if mode == "greedy" else SAMPLED
    _, batched = _serve(lm, prompts, max_batch=2, **kw)
    _, solo = _serve(lm, prompts, max_batch=1, prefill_chunk=4, kv_page_size=2, **kw)
    for uid in batched:
        np.testing.assert_array_equal(batched[uid].tokens, solo[uid].tokens)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_legacy_solo_equals_paged_batched(lm, prompts, mode):
    """The legacy engine at batch 1 (other buckets) gives the paged
    engine's tokens: one stream a request, whatever the cache layout."""
    kw = GREEDY if mode == "greedy" else SAMPLED
    _, paged = _serve(lm, prompts, max_batch=3, **kw)
    _, legacy = _serve(lm, prompts, max_batch=1, kv_page_size=None, prefill_bucket=4, **kw)
    for uid in paged:
        np.testing.assert_array_equal(paged[uid].tokens, legacy[uid].tokens)


def test_oversubscribed_pool_completes_and_matches(lm, prompts, batched_greedy):
    """A pool of 3 pages holds one request's worst case at a time: the
    second slot waits for pages, every request completes with the same
    tokens, and the allocator drains balanced."""
    eng, by_uid = _serve(lm, prompts, max_batch=2, kv_pages=3, **GREEDY)
    _, oracle = batched_greedy
    for uid in by_uid:
        np.testing.assert_array_equal(by_uid[uid].tokens, oracle[uid].tokens)
    eng.check_balanced()
    assert eng.stats()["admission_blocked_s"] > 0


@pytest.mark.parametrize("paged", [True, False])
def test_eos_eviction_frees_slot(paged):
    eos = 7
    eng = Engine(_model(eos_bias=eos), ServeConfig(
        max_batch=1, max_new_tokens=N_NEW, eos_id=eos, prefill_bucket=8,
        kv_page_size=8 if paged else None))
    eng.submit(np.array([1, 2], np.int32))
    eng.submit(np.array([3, 4, 5], np.int32))
    done = eng.run()
    assert len(done) == 2
    for f in done:
        assert f.finish_reason == FINISH_EOS and f.tokens.tolist() == [eos]
    eng.check_balanced()


@pytest.mark.parametrize("paged", [True, False])
def test_one_token_budget(lm, prompts, batched_greedy, paged):
    eng = Engine(lm, ServeConfig(max_batch=2, max_new_tokens=1, prefill_bucket=8,
                                 kv_page_size=8 if paged else None))
    eng.submit(prompts[0])
    done = eng.run()
    assert len(done) == 1 and done[0].tokens.size == 1
    assert done[0].tokens[0] == batched_greedy[1][0].tokens[0]


def test_slot_refill_and_fifo(batched_greedy):
    eng, by_uid = batched_greedy
    assert eng.idle and eng.scheduler.num_active == 0
    for f in by_uid.values():
        assert f.finish_reason == FINISH_LENGTH and f.tokens.size == N_NEW
    assert eng.stats()["queue_depth_max"] >= 4
    times = [by_uid[uid].first_token_t for uid in range(len(by_uid))]
    assert times == sorted(times)


def test_oversized_request_rejected_at_submit(lm):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=2, max_len=16))
    with pytest.raises(CacheBudgetError, match=r"needs 3 KV page\(s\) of 8"):
        eng.submit(np.arange(15, dtype=np.int32))
    eng.submit(np.arange(8, dtype=np.int32))
    assert len(eng.run()) == 1 and eng.queue.rejected == 1
    leg = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=2, max_len=16,
                                 kv_page_size=None))
    with pytest.raises(CacheBudgetError, match="exceeds the KV cache"):
        leg.submit(np.arange(15, dtype=np.int32))


def test_drain_completes_inflight_and_rejects_new(lm, prompts):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=3))
    for p in prompts[:3]:
        eng.submit(p)
    done = eng.drain()
    assert len(done) == 3 and eng.idle and eng.draining and eng.phase == "drained"
    with pytest.raises(DrainingError, match="draining"):
        eng.submit(prompts[0])
    stats = eng.stats()
    assert stats["drained"] is True and stats["requests_drain_rejected"] == 1
    assert stats["requests_finished"] == 3
    assert eng.drain() == []
    eng.reopen()
    assert eng.phase == "idle"


def test_bounded_queue_sheds_typed(lm, prompts):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=2, max_queue_depth=1))
    eng.submit(prompts[0])
    with pytest.raises(QueueFullError, match="max_depth"):
        eng.submit(prompts[1])
    assert eng.stats()["requests_shed"] == 1
    assert len(eng.run()) == 1


@pytest.mark.parametrize("paged", [True, False])
def test_queue_ttft_deadline_evicts_with_timeout(lm, prompts, tmp_path, paged):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=3, ttft_deadline_ms=50.0,
                                 kv_page_size=8 if paged else None))
    eng.submit(prompts[0], arrival_t=time.perf_counter() - 1.0)
    eng.submit(prompts[1])
    by_reason = {f.finish_reason: f for f in eng.run()}
    assert by_reason[FINISH_TIMEOUT].tokens.size == 0
    assert by_reason[FINISH_TIMEOUT].ttft_ms is None
    assert by_reason[FINISH_LENGTH].tokens.size == 3
    assert eng.stats()["requests_timed_out"] == 1
    snap = eng.dump_flight(str(tmp_path / "timeout_flight.json"))
    assert snap["serving"]["requests_timed_out"] == 1
    json.load(open(tmp_path / "timeout_flight.json"))


@pytest.mark.parametrize("paged", [True, False])
def test_total_deadline_evicts_mid_decode(lm, prompts, paged):
    """``deadline_ms``: a decoding request past its total deadline leaves
    with ``timeout`` and its partial tokens; the slot and its pages are
    free again."""
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=8, deadline_ms=60_000.0,
                                 kv_page_size=8 if paged else None))
    eng.submit(prompts[0])
    while not eng.scheduler.active() or len(eng.scheduler.active()[0].tokens) < 2:
        eng.step()
    seq = eng.scheduler.active()[0]
    seq.request = dataclasses.replace(seq.request, deadline_t=time.perf_counter() - 1e-3)
    done = []
    while not done:
        done = eng.step()
    assert [f.finish_reason for f in done] == [FINISH_TIMEOUT]
    assert 2 <= done[0].tokens.size < 8
    eng.check_balanced()
    eng.submit(prompts[1])
    assert [f.finish_reason for f in eng.run()] == [FINISH_LENGTH]


def test_ttft_deadline_evicts_mid_prefill(lm, prompts):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=4, prefill_chunk=4,
                                 ttft_deadline_ms=10_000.0))
    eng.submit(np.arange(12, dtype=np.int32) % VOCAB)
    assert eng.step() == []
    seq = eng.scheduler.active()[0]
    assert seq.prefilling and not seq.tokens
    seq.request = dataclasses.replace(seq.request,
                                      ttft_deadline_t=time.perf_counter() - 1e-3)
    done = eng.step()
    assert [f.finish_reason for f in done] == [FINISH_TIMEOUT]
    eng.check_balanced()


def test_kv_accounting_matches_jax(batched_greedy, legacy_greedy, jax_tokens):
    """The paged run's reserved and written token-iterations are JAX's
    (the same schedule), and the legacy path's over-reservation shows."""
    eng, _ = batched_greedy
    st, jst = eng.stats(), jax_tokens[1]
    for key in ("kv_written_tokens", "kv_reserved_tokens", "kv_pages_allocated_iters",
                "tokens_emitted", "requests_finished"):
        assert st[key] == jst[key], key
    assert legacy_greedy[0].stats()["kv_reserved_vs_written"] > 4.0


def test_stats_keys_are_jax_s(batched_greedy, jax_tokens):
    eng, by_uid = batched_greedy
    stats = eng.stats()
    assert set(stats) == set(jax_tokens[1])
    assert stats["throughput_tok_s"] > 0
    assert stats["ttft_p95_ms"] >= stats["ttft_p50_ms"] > 0
    assert stats["tokens_emitted"] == len(by_uid) * N_NEW
    assert stats["ledger_conservation_violations"] == 0
    assert stats["alerts_fired"] == stats["alerts_active"] == 0
    for f in by_uid.values():
        assert f.ttft_ms > 0 and f.tpot_ms > 0
        assert f.ledger.closed and not f.ledger.violations(ttft_ms=f.ttft_ms)


def test_one_device_read_an_iteration(lm, prompts):
    """The paged engine reads the card once an iteration that runs the
    device; the legacy one once an iteration plus once an admission."""
    eng = Engine(lm, ServeConfig(max_batch=2, **GREEDY))
    for p in prompts:
        eng.submit(p)
    iters = 0
    while not eng.idle:
        before = eng.device_reads
        eng.step()
        assert eng.device_reads - before == 1
        iters += 1
    assert eng.device_reads == iters
    leg, _ = _serve(lm, prompts, max_batch=2, kv_page_size=None, **GREEDY)
    assert leg.device_reads == leg._iteration + len(prompts)


def test_flight_dump_renders_through_the_port_report(batched_greedy, tmp_path):
    eng, by_uid = batched_greedy
    path = str(tmp_path / "serve_flight.json")
    eng.dump_flight(path)
    snap = FlightRecorder.load(path)
    assert snap["serving"]["requests_finished"] == len(by_uid)
    assert snap["flushes"] and snap["timeseries"]["samples"] is not None
    summary = flight_report.summarize(snap)
    text = flight_report.render(summary)
    assert "serving:" in text and "ttft" in text and "latency ledger" in text


def test_trace_draws_slot_tracks(lm, prompts):
    from distributed_training_tpu_torch.observability.trace import TraceSession

    trace = TraceSession(process_name="serve")
    eng = Engine(lm, ServeConfig(max_batch=2, prefill_chunk=4, **GREEDY), trace=trace)
    for p in prompts[:3]:
        eng.submit(p)
    eng.run()
    names = {ev.get("name") for ev in trace.to_json()["traceEvents"]}
    assert {"queued", "prefill", "prefill_chunk", "decode", "first_token"} <= names


# A rule that burns while anything waits: six prompts on two slots queue.
QUEUED = "queued:queue_depth>0.5@1,1"
PORTED = {"prefix_cache": True, "spec_k": 2, "quantize_weights": True, "kv_dtype": "int8",
          "journal_dir": "journal", "slo_rules": "default", "incident_dir": "incidents"}


@pytest.mark.parametrize("field", list(PORTED))
def test_ported_option_runs(field, prompts, batched_greedy, tmp_path):
    """Each serving option runs through the engine: the prefix cache,
    speculation, the journal, the SLO rules and the incident bundles give
    the plain engine's tokens; the int8 weights and KV pages finish every
    request and drain the pool balanced (their tokens are held against
    JAX's in their own files). The default rules fire nothing on this
    healthy run; a rule over the queue fires, and its bundle is written."""
    kw = {field: PORTED[field]}
    if field in ("journal_dir", "incident_dir"):
        kw[field] = str(tmp_path / PORTED[field])
    if field == "incident_dir":
        kw |= {"slo_rules": QUEUED, "sample_every": 1}
    cfg = ServeConfig(max_batch=2, prefill_bucket=8, **GREEDY, **kw)
    eng = Engine(_model(), cfg)
    eng.recover()
    for p in prompts:
        eng.submit(p)
    done = {f.uid: f for f in eng.run()}
    eng.check_balanced()
    assert sorted(done) == list(range(len(prompts)))
    assert all(f.tokens.size == N_NEW for f in done.values())
    if field in ("prefix_cache", "spec_k", "journal_dir", "slo_rules", "incident_dir"):
        for u, f in batched_greedy[1].items():
            np.testing.assert_array_equal(done[u].tokens, f.tokens)
    if field == "journal_dir":
        eng.journal.shutdown()
        assert eng.stats()["journal_records_written"] > 0
    if field == "slo_rules":
        assert len(eng.alerts_snapshot()["rules"]) == 7
        assert eng.stats()["alerts_fired"] == 0
    if field == "incident_dir":
        eng.close_incidents()
        assert eng.stats()["alerts_fired"] == eng.stats()["incidents_captured"] == 1
        assert os.listdir(kw["incident_dir"]) == ["incident_000_queued.json"]


@pytest.mark.parametrize("call", ["recover", "validate_swap", "arm_swap", "rollback"])
def test_ported_engine_method_runs(lm, call):
    """The journal's and the hot swap's engine methods: recover without a
    journal reports nothing; the serving set validates and arms (the
    barrier installs it at the next step); rollback before any swap is
    JAX's typed refusal."""
    from distributed_training_tpu_torch.resilience.errors import SwapError
    from distributed_training_tpu_torch.serving.quantize import serving_params

    eng = Engine(lm, ServeConfig(max_batch=1))
    if call == "recover":
        assert eng.recover() == {"redelivered": [], "completed_at_replay": [],
                                 "resumed": 0, "notes": {}, "torn_bytes": 0}
    elif call == "validate_swap":
        eng.validate_swap(serving_params(lm))
        with pytest.raises(SwapError, match="does not match"):
            eng.validate_swap({"tok_embed.embedding": torch.zeros(3)})
    elif call == "arm_swap":
        eng.arm_swap(serving_params(lm), epoch=3)
        assert eng.phase == "swapping"
        eng.step()
        assert eng.weights_epoch == 3 and eng.stats()["swaps_completed"] == 1
    else:
        with pytest.raises(SwapError, match="nothing to roll back to"):
            eng.rollback()


def test_serve_config_validation_is_jax_s():
    with pytest.raises(ValueError, match="kv_dtype must be None"):
        ServeConfig(kv_dtype="fp8")
    with pytest.raises(ValueError, match="kv_pages requires kv_page_size"):
        ServeConfig(kv_page_size=None, kv_pages=4)
    with pytest.raises(ValueError, match="tier_reserved_slots"):
        ServeConfig(max_batch=2, tier_reserved_slots=2)
