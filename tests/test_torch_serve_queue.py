"""The serving engine's host side in the port against the JAX package's:
the tiered queue, the slot scheduler, the requests, the latency ledger,
the telemetry and the time-series ring, each driven by the same call
sequence in both packages with every observable compared exactly (uids,
counters, tokens, typed errors and their messages, ledger intervals,
ring windows). Then, on the port's engine (``transformer_lm`` at 1
layer, 2 heads, hidden 16, vocab 31, max_len 48), lossless preemption:
a sequence preempted and resumed equals its uninterrupted run, greedy
and sampled, paged and legacy; and the futility bound.
"""

import dataclasses
import time
import types

import numpy as np
import pytest
import torch

import distributed_training_tpu.observability.histogram as jhist
import distributed_training_tpu.resilience.errors as jerrors
import distributed_training_tpu.serving.ledger as jledger
import distributed_training_tpu.serving.metrics as jmetrics
import distributed_training_tpu.serving.queue as jqueue
import distributed_training_tpu.serving.request as jrequest
import distributed_training_tpu.serving.scheduler as jscheduler
import distributed_training_tpu.serving.timeseries as jtimeseries
import distributed_training_tpu_torch.observability.histogram as thist
import distributed_training_tpu_torch.resilience.errors as terrors
import distributed_training_tpu_torch.serving.ledger as tledger
import distributed_training_tpu_torch.serving.metrics as tmetrics
import distributed_training_tpu_torch.serving.queue as tqueue
import distributed_training_tpu_torch.serving.request as trequest
import distributed_training_tpu_torch.serving.scheduler as tscheduler
import distributed_training_tpu_torch.serving.timeseries as ttimeseries
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.serving import (
    FINISH_LENGTH,
    FINISH_PREEMPT_TIMEOUT,
    ActiveSequence,
    Engine,
)

torch.set_num_threads(1)

PKGS = {
    "jax": types.SimpleNamespace(q=jqueue, s=jscheduler, r=jrequest, led=jledger,
                                 m=jmetrics, ts=jtimeseries, h=jhist, err=jerrors),
    "torch": types.SimpleNamespace(q=tqueue, s=tscheduler, r=trequest, led=tledger,
                                   m=tmetrics, ts=ttimeseries, h=thist, err=terrors),
}


def _queue(p, **kw):
    return p.q.RequestQueue(budget=32, default_max_new_tokens=4, **kw)


def _uid(e):
    return e.request.uid if hasattr(e, "request") else e.uid


def _raises(fn):
    try:
        fn()
    except Exception as e:
        return (type(e).__name__, str(e))
    return None


def sc_tier_order(p):
    q = _queue(p, num_tiers=3)
    for prio in (2, 0, 1, 0):
        q.submit([1], priority=prio)
    out = [_uid(q.pop()) for _ in range(4)]
    q2 = _queue(p, num_tiers=2)
    out += [_raises(lambda: q2.submit([1], priority=2)),
            _raises(lambda: q2.submit([1], priority=-1))]
    return out


def sc_weighted_fair(p):
    q = _queue(p, num_tiers=1, tenant_weights={"a": 2.0, "b": 1.0})
    for _ in range(6):
        q.submit([1], tenant="a")
        q.submit([1], tenant="b")
    picks = []
    for _ in range(9):
        cand = q.next_candidate({})
        picks.append((cand.tenant, cand.uid))
        q.take(cand)
    return picks


def sc_quota(p):
    q = _queue(p, num_tiers=2, tenant_quota=2)
    q.submit([1], priority=0, tenant="a")
    q.submit([1], priority=1, tenant="b")
    return [q.next_candidate({"a": 2}).uid, q.next_candidate({"a": 1}).uid]


def sc_tier_aware_shed(p):
    q = _queue(p, num_tiers=2, max_depth=2)
    q.submit([1], priority=1)
    q.submit([1], priority=1)
    q.submit([1], priority=0)
    out = [[_uid(e) for e in q.take_shed()], list(q.shed_by_tier), len(q)]
    out.append(_raises(lambda: q.submit([1], priority=1)))
    out += [list(q.shed_by_tier), q.shed, q.submitted, q.depth_max]
    return out


def sc_requeue_order(p):
    q = _queue(p, num_tiers=2)
    old = q.submit([1], priority=1)
    q.submit([1], priority=1)
    q.take(q.next_candidate({}))
    seq = p.r.ActiveSequence(request=old, slot=0)
    seq.note_token(4, 0.0)
    seq.prepare_resume()
    q.requeue(seq)
    heads = [q.pop() for _ in range(2)]
    return [(type(h).__name__, _uid(h)) for h in heads] + [seq.prefill_tokens.tolist()]


def sc_reserved_slots(p):
    q = _queue(p, num_tiers=2)
    q.submit([1], priority=1)
    q.submit([1], priority=1)
    sched = p.s.SlotScheduler(2, reserved_slots=1)
    out = [[s.request.uid for s in sched.admit(q)], sched.num_active, len(q)]
    q.submit([1], priority=0)
    out += [[(s.slot, s.request.priority) for s in sched.admit(q)], sched.num_active, len(q)]
    return out


def sc_take_tolerates_shed(p):
    q = _queue(p, num_tiers=2, max_depth=1)
    cand = q.submit([1], priority=1)
    picked = q.next_candidate({})
    q.submit([1], priority=0)
    out = [[_uid(e) for e in q.take_shed()], q.take(picked), picked.uid == cand.uid]
    sched = p.s.SlotScheduler(1)
    out.append([s.request.priority for s in sched.admit(q)])
    return out


def sc_futile_preemption(p):
    q = _queue(p, num_tiers=2)
    q.submit([1], priority=1)
    q.submit([1], priority=1)
    sched = p.s.SlotScheduler(2)
    sched.admit(q)
    q.submit([1] * 20, priority=0)
    preempted = []
    seated = sched.admit(q, on_preempt=preempted.append,
                         preempt_helps=lambda entry, victims: False)
    return [seated, preempted, sched.num_active, len(q)]


def sc_rank_ordered_preemption(p):
    q = _queue(p, num_tiers=3)
    q.submit([1], priority=1)
    q.submit([1], priority=2)
    sched = p.s.SlotScheduler(2)
    sched.admit(q)
    q.submit([1], priority=2)
    out = [sched.admit(q), len(q)]
    q.submit([1], priority=0)
    preempted = []
    seated = sched.admit(q, on_preempt=preempted.append)
    out += [[s.request.priority for s in seated],
            [(v.request.uid, v.request.priority, v.preempts) for v in preempted],
            sorted(s.request.priority for s in sched.active()), len(q)]
    return out


def sc_scheduler_refill(p):
    sched = p.s.SlotScheduler(2)
    q = _queue(p)
    for i in range(3):
        q.submit(np.arange(1 + i))
    out = [[s.request.uid for s in sched.admit(q)], sched.active_mask().tolist()]
    for _ in range(4):
        sched.sequence(0).note_token(9, t=1.0)
    done = sched.evict_finished(eos_id=None)
    out += [[(f.uid, f.finish_reason, f.tokens.tolist()) for f in done],
            sched.active_mask().tolist(),
            [(s.request.uid, s.slot) for s in sched.admit(q)]]
    out.append(_raises(lambda: sched.sequence(5)))
    return out


def sc_finish_reasons(p):
    def seq(deadline_t, tokens, max_new=8):
        req = p.r.Request(uid=0, prompt=np.array([1], np.int32), max_new_tokens=max_new,
                          arrival_t=0.0, deadline_t=deadline_t)
        s = p.r.ActiveSequence(request=req, slot=0)
        for i, t in enumerate(tokens):
            s.note_token(t, t=float(i))
        return s

    out = [seq(5.0, [3, 4]).finish_reason(None, now=4.0),
           seq(5.0, [3, 4]).finish_reason(None, now=5.0),
           seq(5.0, [3, 7]).finish_reason(7, now=6.0),
           seq(5.0, [3, 4], max_new=2).finish_reason(None, now=6.0)]
    s = seq(1.0, [5])
    s.prepare_resume()
    out += [s.finish_reason(None, now=2.0), s.preempts]
    req = p.r.Request(uid=0, prompt=np.arange(8, dtype=np.int32), max_new_tokens=4,
                      arrival_t=0.0, ttft_deadline_t=5.0)
    mid = p.r.ActiveSequence(request=req, slot=0, prefill_pos=4)
    out += [mid.finish_reason(None, now=4.0), mid.finish_reason(None, now=5.0)]
    return out


def sc_admission_guards(p):
    q = p.q.RequestQueue(budget=16, default_max_new_tokens=2, page_size=8, pool_pages=4)
    out = [_raises(lambda: q.submit(np.arange(15))), _raises(lambda: q.submit([])),
           q.submit(np.arange(8)).uid, q.rejected]
    q.close()
    out += [_raises(lambda: q.submit([1])), q.drain_rejected, q.closed]
    q.reopen()
    out += [q.closed, q.submit([1]).uid]
    leg = p.q.RequestQueue(budget=16, default_max_new_tokens=2)
    out.append(_raises(lambda: leg.submit(np.arange(15))))
    return out


def sc_deadline_expiry(p):
    q = p.q.RequestQueue(budget=32, default_max_new_tokens=4, ttft_deadline_ms=50.0,
                         deadline_ms=1000.0)
    q.submit([1], arrival_t=0.0)
    q.submit([2], arrival_t=10.0)
    expired = q.pop_expired(0.5)
    return [[(_uid(e), e.ttft_deadline_t, e.deadline_t) for e in expired], len(q),
            _uid(q.peek())]


def sc_ledger(p):
    led = p.led.LatencyLedger(10.0)
    led.stamp("queue_wait", 11.0)
    led.stamp("prefill", 11.5)
    led.stamp("prefill", 12.0)
    led.stamp("decode", 11.0)
    led.stamp("decode", 13.0)
    led.add_tokens("decode", 3)
    led.add_tokens("decode", 2)
    led.close("decode", 13.25)
    out = [led.to_dict(), led.violations(), led.lifetime_ms, led.totals_ms()]
    handoff = p.led.LatencyLedger(0.0)
    handoff.note_admit_done(0.004)
    handoff.stamp(p.led.CAUSE_QUEUE_WAIT, 0.010)
    handoff.close(p.led.CAUSE_DECODE, 0.020)
    out.append(handoff.to_dict())
    bad = p.led.LatencyLedger(0.0)
    bad.stamp("queue_wait", 0.010)
    bad.stamp("prefill", 0.020)
    bad.stamp("decode", 0.050)
    bad.close("decode")
    out += [bad.violations(ttft_ms=20.0), bad.violations(ttft_ms=15.0),
            bad.violations(ttft_ms=60.0)]
    bad.intervals[0][2] = 0.005
    out.append(bad.violations())
    out += [list(p.led.LEDGER_CAUSES), list(p.led.TOKEN_CAUSES), p.led.EPSILON_S]
    return out


def sc_telemetry(p):
    """The SLA accounting of a fixed set of completions (no wall clock:
    every time is given)."""
    tel = p.m.ServeTelemetry(64, num_tiers=2)
    for i in range(6):
        led = p.led.LatencyLedger(float(i))
        led.stamp("queue_wait", i + 0.01 * (i + 1))
        led.stamp("prefill", i + 0.05)
        led.stamp("decode", i + 0.2)
        led.add_tokens("decode", 4)
        led.close("decode", i + 0.2)
        tel.on_admitted(10.0 * (i + 1), 40.0 - i)
        tel.on_finished(p.r.FinishedRequest(
            uid=i, prompt=np.zeros((3,), np.int32), tokens=np.arange(4, dtype=np.int32),
            finish_reason="length", ttft_ms=50.0 + i, tpot_ms=3.0 + 0.5 * i,
            arrival_t=float(i), first_token_t=i + 0.05, priority=i % 2, ledger=led))
    tel.on_preempted(7, 1)
    tel.on_kv(reserved=64, written=40, active=3, slots=4, pages_allocated=8,
              pages_total=16)
    st = tel.stats()
    wall = {"throughput_tok_s", "busy_seconds"}
    return {k: v for k, v in st.items() if k not in wall}


def sc_timeseries(p):
    r = p.ts.TelemetryRing(4, 2)
    for i in range(10):
        r.record_sample({"c": float(i * i), "den": float(i), "g": float(i % 3)})
    bounds = (1.0, 5.0, 25.0)
    names = p.ts.hist_fields("lat_ms", bounds)
    hist = p.h.FixedHistogram(bounds)
    rows = []
    for batch in ((0.5, 3.0), (3.0, 4.0, 20.0, 30.0)):
        for v in batch:
            hist.observe(v)
        rows.append(dict(zip(names, hist.cumulative())))
    hr = p.ts.TelemetryRing(8, 1)
    for row in rows:
        hr.record_sample(row)
    return [len(r), r.samples_recorded_total, r.value("c"), r.value("c", back=3),
            r.window("c", 10), r.delta("c", 2), r.delta("c", 100), r.rate("c", 2),
            r.rate("c", 2, denominator="den"), r.mean("g", 3), r.to_dict(last_n=2),
            names, [hr.window_quantile("lat_ms", bounds, q, 1) for q in (0.5, 0.95)],
            _raises(lambda: r.record_sample({"c": 1.0}))]


SCENARIOS = [sc_tier_order, sc_weighted_fair, sc_quota, sc_tier_aware_shed,
             sc_requeue_order, sc_reserved_slots, sc_take_tolerates_shed,
             sc_futile_preemption, sc_rank_ordered_preemption, sc_scheduler_refill,
             sc_finish_reasons, sc_admission_guards, sc_deadline_expiry, sc_ledger,
             sc_telemetry, sc_timeseries]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_host_side_matches_jax(scenario):
    want, got = scenario(PKGS["jax"]), scenario(PKGS["torch"])
    assert got == want


# -- lossless preemption on the port's engine -------------------------------

VOCAB = 31
MAX_LEN = 48


@pytest.fixture(scope="module")
def lm():
    return get_model("transformer_lm", num_classes=VOCAB, num_layers=1, num_heads=2,
                     hidden_dim=16, max_len=MAX_LEN,
                     generator=torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in (5, 7, 3, 6)]


def _solo_outputs(model, reqs, **cfg_kw):
    """The uninterrupted oracle: each request alone on one slot, uids in
    submission order (the sampling key is (seed, uid, position))."""
    eng = Engine(model, ServeConfig(max_batch=1, **cfg_kw))
    out = {}
    for prompt, max_new in reqs:
        req = eng.submit(prompt, max_new_tokens=max_new)
        for fin in eng.run():
            out[fin.uid] = fin.tokens.tolist()
        assert req.uid in out
    return out


PREEMPT_CASES = [({"prefill_chunk": 4}, 0.0), ({"prefill_chunk": 4}, 0.8),
                 ({"kv_page_size": None, "prefill_bucket": 8}, 0.0),
                 ({"kv_page_size": None, "prefill_bucket": 8}, 0.8)]


@pytest.mark.parametrize("cfg_kw,temp", PREEMPT_CASES,
                         ids=["paged-greedy", "paged-sampled", "legacy-greedy",
                              "legacy-sampled"])
def test_preempted_resumed_equals_uninterrupted(lm, prompts, cfg_kw, temp):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=8, num_tiers=2,
                                 temperature=temp, **cfg_kw))
    low = eng.submit(prompts[0], priority=1, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    assert len(eng.scheduler.sequence(0).tokens) >= 1
    high = eng.submit(prompts[1], priority=0, max_new_tokens=4)
    done = {f.uid: f for f in eng.run()}
    eng.check_balanced()
    stats = eng.stats()
    assert stats["requests_preempted"] >= 1
    assert stats["preempted_token_recompute"] >= prompts[0].size
    assert stats["ledger_conservation_violations"] == 0
    assert done[low.uid].finish_reason == FINISH_LENGTH
    assert done[high.uid].last_token_t < done[low.uid].last_token_t
    solo = _solo_outputs(lm, [(prompts[0], 8), (prompts[1], 4)], temperature=temp, **cfg_kw)
    assert done[low.uid].tokens.tolist() == solo[low.uid]
    assert done[high.uid].tokens.tolist() == solo[high.uid]


def test_preempt_mid_prefill_restarts_clean(lm, prompts):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=6, num_tiers=2,
                                 prefill_chunk=2))
    low = eng.submit(prompts[1], priority=1)
    eng.step()
    seq = eng.scheduler.sequence(0)
    assert seq.prefilling and not seq.tokens
    high = eng.submit(prompts[2], priority=0, max_new_tokens=4)
    done = {f.uid: f for f in eng.run()}
    eng.check_balanced()
    assert eng.stats()["requests_preempted"] == 1
    solo = _solo_outputs(lm, [(prompts[1], 6), (prompts[2], 4)], prefill_chunk=2)
    assert done[low.uid].tokens.tolist() == solo[low.uid]
    assert done[high.uid].tokens.tolist() == solo[high.uid]


def test_repeated_preemption_cycles_leak_free(lm, prompts):
    cfg_kw = dict(max_new_tokens=6, prefill_chunk=4, kv_pages=14, temperature=0.8)
    eng = Engine(lm, ServeConfig(max_batch=2, num_tiers=2, **cfg_kw))
    subs = [(eng.submit(p, priority=1).uid, p, 6) for p in prompts[:2]]
    for _ in range(3):
        eng.step()
    subs += [(eng.submit(p, priority=0, max_new_tokens=4).uid, p, 4) for p in prompts[2:]]
    done = {f.uid: f for f in eng.run()}
    eng.check_balanced()
    stats = eng.stats()
    assert stats["requests_preempted"] >= 2
    assert stats["tier1_requests_preempted"] >= 2 and stats["tier0_requests_preempted"] == 0
    solo = _solo_outputs(lm, [(p, m) for _, p, m in subs], **cfg_kw)
    for uid, _, _ in subs:
        assert done[uid].tokens.tolist() == solo[uid], uid


def test_engine_futility_bound_keeps_best_effort_running(lm, prompts):
    """A tier-0 candidate whose worst case exceeds the free pages plus
    every preemptible page must not evict the best-effort sequence; it
    seats later, once tier-0 work returns pages."""
    eng = Engine(lm, ServeConfig(max_batch=3, num_tiers=2, kv_page_size=8, kv_pages=6,
                                 max_len=32, max_new_tokens=8, prefill_chunk=4))
    a = eng.submit(np.arange(9, dtype=np.int32) % VOCAB, priority=0, max_new_tokens=8)
    low = eng.submit(prompts[2], priority=1, max_new_tokens=8)
    for _ in range(4):
        eng.step()
    assert eng.scheduler.num_active == 2
    c = eng.submit(np.arange(24, dtype=np.int32) % VOCAB, priority=0, max_new_tokens=8)
    eng.step()
    assert eng.stats()["requests_preempted"] == 0
    assert eng.scheduler.num_active == 2 and eng.phase == "overloaded"
    done = {f.uid: f for f in eng.run()}
    eng.check_balanced()
    assert eng.stats()["requests_preempted"] == 0
    for uid in (a.uid, low.uid, c.uid):
        assert done[uid].tokens.size == 8


def test_drain_completes_requeued(lm, prompts):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=8, num_tiers=2,
                                 prefill_chunk=4))
    low = eng.submit(prompts[0], priority=1)
    for _ in range(4):
        eng.step()
    eng.submit(prompts[1], priority=0, max_new_tokens=4)
    eng.step()
    assert eng.stats()["requests_preempted"] == 1
    done = {f.uid: f for f in eng.drain()}
    eng.check_balanced()
    assert done[low.uid].finish_reason == FINISH_LENGTH and done[low.uid].tokens.size == 8
    assert eng.stats()["drained"] is True


def test_preempted_then_expired_reports_preempted_timeout(lm, prompts):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=8, num_tiers=2,
                                 prefill_chunk=4, deadline_ms=600000.0))
    low = eng.submit(prompts[0], priority=1)
    for _ in range(3):
        eng.step()
    emitted_before = len(eng.scheduler.sequence(0).tokens)
    assert emitted_before >= 1
    eng.submit(prompts[1], priority=0, max_new_tokens=8)
    eng.step()
    entry = eng.queue.peek()
    assert isinstance(entry, ActiveSequence) and entry.request.uid == low.uid
    entry.request = dataclasses.replace(entry.request, deadline_t=time.perf_counter() - 1.0)
    done = {f.uid: f for f in eng.drain()}
    eng.check_balanced()
    fin = done[low.uid]
    assert fin.finish_reason == FINISH_PREEMPT_TIMEOUT and fin.slot is None
    assert fin.tokens.size == emitted_before
    stats = eng.stats()
    assert stats["requests_preempt_timed_out"] == 1 and stats["requests_timed_out"] == 0


def test_cancel_frees_the_slot(lm, prompts):
    eng = Engine(lm, ServeConfig(max_batch=1, max_new_tokens=8))
    a = eng.submit(prompts[0])
    b = eng.submit(prompts[1])
    eng.step()
    eng.cancel(a.uid)
    eng.cancel(b.uid)
    done = eng.run()
    assert sorted(f.finish_reason for f in done) == ["cancelled", "cancelled"]
    eng.check_balanced()
    assert eng.stats()["requests_cancelled"] == 2
