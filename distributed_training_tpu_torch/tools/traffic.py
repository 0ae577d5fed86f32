"""Traffic-scenario library for the serving bench (``tools/serve_bench.py``).

The port of the repo's ``tools/traffic.py``, unchanged: a pure function of
``(seed, params)``, so both packages' tools build the same requests.

Production traffic is not one Poisson knob: it is tiered (interactive
vs batch SLOs), multi-tenant, bursty on several timescales, and
heavy-tailed in both prompt and completion length. This module factors
``serve_bench``'s load generator into SEEDED scenario builders so the
same realistic shapes drive benchmarks, the CI overload drill, and the
chaos-composition tests — deterministically: every scenario is a pure
function of ``(seed, params)``, uses one ``np.random.RandomState``, and
never reads a clock, so two runs of a drill submit byte-identical work
(the property the bench's ``--virtual-dt`` drive turns into zero-drift
scheduling counters).

A scenario is a list of :class:`TrafficRequest` sorted by arrival time;
``serve_bench --scenario NAME`` drives the engine with it. Chaos
compositions (a burst landing mid-hot-swap, a preemption storm during
speculation) are scenario × engine-flag products: pick the arrival
shape here and add ``--swap-at-request`` / ``--spec-k`` on the bench.

Every prompt/completion pair is clamped to the engine budget the caller
passes (``prompt + max_new <= budget``), so a generated request can
never die with a CacheBudgetError mid-measurement.

**Client mode** (``python -m distributed_training_tpu_torch.tools.traffic
--url ...``): replay any of
these seeded scenarios over HTTP against the network front door
(serving/frontend.py, serving/router.py) instead of an in-process
engine — the same pure-function-of-seed contract, so the workload a
networked drill submits is byte-identical to what ``serve_bench
--scenario NAME`` submits locally. Sequential replay (the default)
preserves submission order end-to-end, which is what makes the
SSE-vs-batch bitwise pin possible; ``--concurrency N`` trades that for
in-flight parallelism in the routing drills.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One scheduled arrival: WHEN, WHAT, and on WHOSE behalf."""

    arrival_s: float          # seconds from the start of the run
    prompt: np.ndarray        # int32 [T]
    max_new_tokens: int
    priority: int = 0         # SLO tier, 0 = highest
    tenant: str = "default"


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """Shared knobs every scenario builder receives (from the bench
    CLI): request count, mean arrival rate, prompt-length scale and the
    admissibility clamps."""

    requests: int
    rate: float               # mean arrival rate, req/s
    mean_prompt_len: int
    max_prompt_len: int       # so prompt + max_new fits the budget
    max_new_tokens: int
    vocab_size: int
    budget: int               # per-slot token budget (prompt + output)


def _clamp(p: ScenarioParams, prompt_len: int,
           max_new: int) -> tuple[int, int]:
    """Admissibility: 1 <= prompt <= max_prompt and
    prompt + max_new <= budget (with max_new >= 1)."""
    plen = int(min(max(prompt_len, 1), p.max_prompt_len))
    mnt = int(min(max(max_new, 1), p.budget - plen))
    return plen, max(mnt, 1)


def _req(rng: np.random.RandomState, p: ScenarioParams, t: float,
         prompt_len: int, max_new: int, priority: int = 0,
         tenant: str = "default") -> TrafficRequest:
    plen, mnt = _clamp(p, prompt_len, max_new)
    return TrafficRequest(
        arrival_s=float(t),
        prompt=rng.randint(0, p.vocab_size, size=plen).astype(np.int32),
        max_new_tokens=mnt, priority=int(priority), tenant=tenant)


def _uniform_len(rng: np.random.RandomState, p: ScenarioParams) -> int:
    """The classic serve_bench prompt-length draw: uniform in
    [1, 2*mean-1], clamped to the admissible maximum."""
    hi = min(2 * p.mean_prompt_len, p.max_prompt_len + 1)
    return int(rng.randint(1, max(hi, 2)))


# -- scenario builders -------------------------------------------------------
def _poisson(rng: np.random.RandomState,
             p: ScenarioParams) -> list[TrafficRequest]:
    """The original serve_bench workload: memoryless arrivals at
    ``rate``, uniform prompt lengths, one tier, one tenant."""
    t = np.cumsum(rng.exponential(1.0 / p.rate, size=p.requests))
    return [_req(rng, p, t[i], _uniform_len(rng, p), p.max_new_tokens)
            for i in range(p.requests)]


def _bursty(rng: np.random.RandomState,
            p: ScenarioParams) -> list[TrafficRequest]:
    """Cluster (Neyman-Scott-style) arrivals: Poisson burst CENTERS at
    ``rate / mean_burst`` with ~``mean_burst`` requests packed at 10x
    the mean rate inside each burst — the same long-run rate as
    ``poisson`` but with queue-depth spikes that exercise shed/preempt
    paths a smooth process never reaches."""
    mean_burst = 6
    out: list[TrafficRequest] = []
    t = 0.0
    while len(out) < p.requests:
        t += float(rng.exponential(mean_burst / p.rate))
        size = min(1 + int(rng.poisson(mean_burst - 1)),
                   p.requests - len(out))
        dt = np.cumsum(rng.exponential(1.0 / (10.0 * p.rate), size=size))
        for i in range(size):
            out.append(_req(rng, p, t + dt[i], _uniform_len(rng, p),
                            p.max_new_tokens))
    return out


def _diurnal(rng: np.random.RandomState,
             p: ScenarioParams) -> list[TrafficRequest]:
    """Sinusoidally modulated arrivals (a compressed day): candidates
    drawn at the 2x peak rate and thinned by the instantaneous
    intensity ``(1 + sin) / 2`` — peak-hour load at twice the mean with
    near-idle troughs, in one deterministic pass."""
    period_s = max(p.requests / p.rate / 2.0, 1e-3)  # ~2 cycles per run
    out: list[TrafficRequest] = []
    t = 0.0
    while len(out) < p.requests:
        t += float(rng.exponential(1.0 / (2.0 * p.rate)))
        intensity = 0.5 * (1.0 + np.sin(2.0 * np.pi * t / period_s))
        if rng.uniform() < intensity:
            out.append(_req(rng, p, t, _uniform_len(rng, p),
                            p.max_new_tokens))
        else:
            # Burn the length draws anyway so accepted requests' content
            # does not depend on how many candidates were thinned before
            # them (keeps prompt streams stable across small param
            # tweaks).
            rng.randint(1, 2)
    return out


def _heavy_tail(rng: np.random.RandomState,
                p: ScenarioParams) -> list[TrafficRequest]:
    """Poisson arrivals with production-shaped SIZES: lognormal prompt
    lengths (median ``mean_prompt_len``, sigma 0.8 — a few huge
    contexts among many small ones) and Zipf completion budgets (most
    requests stop early, a heavy tail runs to the cap). Exercises the
    page pool's commitment math far harder than uniform sizes."""
    t = np.cumsum(rng.exponential(1.0 / p.rate, size=p.requests))
    out = []
    for i in range(p.requests):
        plen = int(np.exp(rng.normal(np.log(max(p.mean_prompt_len, 1)),
                                     0.8)))
        mnt = int(rng.zipf(1.8))
        out.append(_req(rng, p, t[i], plen,
                        min(mnt, p.max_new_tokens) if mnt > 0
                        else p.max_new_tokens))
    return out


_TENANTS = (
    # (tenant, tier, weight-share of the arrival mass, prompt scale)
    ("gold", 0, 0.3, 1.0),
    ("silver", 1, 0.3, 1.0),
    ("batch", 2, 0.4, 2.0),
)


def _multi_tenant(rng: np.random.RandomState,
                  p: ScenarioParams) -> list[TrafficRequest]:
    """Three tenants on three SLO tiers: interactive ``gold`` (tier 0),
    standard ``silver`` (tier 1), and a long-prompt ``batch`` tenant on
    the best-effort tier submitting the largest share — the workload
    weighted-fair admission and per-tenant quotas are judged on."""
    out: list[TrafficRequest] = []
    for tenant, tier, share, scale in _TENANTS:
        n = max(int(round(p.requests * share)), 1)
        t = np.cumsum(rng.exponential(1.0 / (p.rate * share), size=n))
        for i in range(n):
            out.append(_req(
                rng, p, t[i],
                int(_uniform_len(rng, p) * scale),
                p.max_new_tokens, priority=tier, tenant=tenant))
    out.sort(key=lambda r: (r.arrival_s, r.tenant))
    return out[:p.requests]


def _two_tier_burst(rng: np.random.RandomState,
                    p: ScenarioParams) -> list[TrafficRequest]:
    """The CI overload drill: a steady tier-0 interactive stream
    (``prod``, short prompts, 40% of the mass) while a best-effort
    ``batch`` tenant slams the remaining 60% in four dense bursts of
    long prompts. Driven at ~2x the sustainable rate, the engine MUST
    degrade selectively: tier 0 p99 TTFT holds while batch work is
    preempted/shed — never the other way around."""
    n_prod = max(int(round(p.requests * 0.4)), 1)
    n_batch = p.requests - n_prod
    out: list[TrafficRequest] = []
    t = np.cumsum(rng.exponential(1.0 / (0.4 * p.rate), size=n_prod))
    for i in range(n_prod):
        out.append(_req(rng, p, t[i],
                        max(p.mean_prompt_len // 2, 1),
                        p.max_new_tokens, priority=0, tenant="prod"))
    horizon = float(t[-1]) if n_prod else p.requests / p.rate
    n_bursts = 4
    for b in range(n_bursts):
        t0 = horizon * (b + 0.5) / n_bursts
        size = n_batch // n_bursts + (1 if b < n_batch % n_bursts else 0)
        dt = np.cumsum(rng.exponential(1.0 / (10.0 * p.rate), size=size))
        for i in range(size):
            out.append(_req(rng, p, t0 + dt[i],
                            2 * p.mean_prompt_len, p.max_new_tokens,
                            priority=1, tenant="batch"))
    out.sort(key=lambda r: (r.arrival_s, r.tenant))
    return out


def _preempt_storm(rng: np.random.RandomState,
                   p: ScenarioParams) -> list[TrafficRequest]:
    """Engineered preemption pressure: long best-effort requests land
    FIRST and occupy every slot/page, then high-tier waves keep
    arriving for the rest of the run — each wave must evict (and later
    resume) best-effort work. The chaos-composition drill runs this
    under speculation with a mid-run hot-swap."""
    out: list[TrafficRequest] = []
    n_low = max(p.requests // 3, 1)
    n_high = p.requests - n_low
    t = np.cumsum(rng.exponential(1.0 / p.rate, size=n_low))
    for i in range(n_low):
        out.append(_req(rng, p, t[i], 2 * p.mean_prompt_len,
                        p.max_new_tokens, priority=1, tenant="batch"))
    horizon = float(t[-1]) * 2.0 if n_low else p.requests / p.rate
    tw = np.sort(rng.uniform(horizon * 0.1, horizon, size=n_high))
    for i in range(n_high):
        out.append(_req(rng, p, tw[i],
                        max(p.mean_prompt_len // 2, 1),
                        max(p.max_new_tokens // 2, 1),
                        priority=0, tenant="prod"))
    out.sort(key=lambda r: (r.arrival_s, r.tenant))
    return out


def _degrading(rng: np.random.RandomState,
               p: ScenarioParams) -> list[TrafficRequest]:
    """The SLO alert drill workload: a healthy steady state that takes
    a seeded mid-run step change for the worse. The first 40% of
    requests arrive at the configured rate with short prompts and
    half-budget completions (baseline-shaped: no rule should burn);
    from the knee on, arrivals jump to 8x the rate with double-length
    prompts and full-budget completions — queue depth, shed counters,
    and latency all degrade together, so the burn-rate rules MUST fire
    in the degraded half and provably cannot in the healthy half. A
    pure function of (seed, params) like every scenario: the knee is a
    request index, never a wall-clock time."""
    knee = max(int(round(p.requests * 0.4)), 1)
    n_after = p.requests - knee
    out: list[TrafficRequest] = []
    t = np.cumsum(rng.exponential(1.0 / p.rate, size=knee))
    for i in range(knee):
        out.append(_req(rng, p, t[i],
                        max(p.mean_prompt_len // 2, 1),
                        max(p.max_new_tokens // 2, 1)))
    t0 = float(t[-1]) if knee else 0.0
    dt = np.cumsum(rng.exponential(1.0 / (8.0 * p.rate), size=n_after))
    for i in range(n_after):
        out.append(_req(rng, p, t0 + dt[i], 2 * p.mean_prompt_len,
                        p.max_new_tokens))
    return out


_SHARED_PREFIX_TENANTS = ("alpha", "beta", "gamma")


def _shared_prefix(rng: np.random.RandomState,
                   p: ScenarioParams) -> list[TrafficRequest]:
    """The prefix-cache workload (serving/prefix_cache.py): N tenants,
    each with a small pool of COMMON system-prompt preambles, every
    request = one preamble + a short unique suffix. Preamble choice is
    Zipf-shared (a few boilerplates dominate, a tail is rare) — the
    production shape where most prompt tokens are shared across
    requests, so a radix prefix cache should collapse most prefill
    compute after each preamble's first (cold) request.

    Deterministic like every scenario: the preamble pools are drawn
    ONCE up front from the seeded rng, then arrivals/choices/suffixes
    in one fixed pass — a pure function of (seed, params)."""
    pool_size = 4
    # Long preambles, short suffixes: the shared mass dominates, and a
    # preamble spans several kv_page_size pages so the trie match is
    # deep. Leave 8 suffix positions of admissibility headroom.
    pre_hi = max(p.max_prompt_len - 8, 1)
    pre_lo = min(max(p.mean_prompt_len, 1), pre_hi)
    preambles = {
        tenant: [rng.randint(0, p.vocab_size,
                             size=int(rng.randint(pre_lo, pre_hi + 1))
                             ).astype(np.int32)
                 for _ in range(pool_size)]
        for tenant in _SHARED_PREFIX_TENANTS}
    t = np.cumsum(rng.exponential(1.0 / p.rate, size=p.requests))
    out: list[TrafficRequest] = []
    for i in range(p.requests):
        tenant = _SHARED_PREFIX_TENANTS[
            int(rng.randint(len(_SHARED_PREFIX_TENANTS)))]
        pre = preambles[tenant][
            min(int(rng.zipf(1.5)) - 1, pool_size - 1)]
        suffix = rng.randint(0, p.vocab_size,
                             size=int(rng.randint(1, 9))).astype(np.int32)
        prompt = np.concatenate([pre, suffix])[
            :min(p.max_prompt_len, p.budget - 1)]
        mnt = max(min(p.max_new_tokens, p.budget - prompt.size), 1)
        out.append(TrafficRequest(
            arrival_s=float(t[i]), prompt=prompt, max_new_tokens=mnt,
            priority=0, tenant=tenant))
    return out


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Registry entry: the builder plus the tier/fairness defaults the
    bench applies when the CLI does not override them."""

    build: object             # (rng, ScenarioParams) -> list[TrafficRequest]
    num_tiers: int
    tenant_weights: dict | None
    help: str


SCENARIOS: dict[str, Scenario] = {
    "poisson": Scenario(_poisson, 1, None,
                        "memoryless arrivals, uniform lengths (the "
                        "classic serve_bench workload)"),
    "bursty": Scenario(_bursty, 1, None,
                       "Poisson burst clusters at 10x rate inside "
                       "bursts (queue-depth spikes)"),
    "diurnal": Scenario(_diurnal, 1, None,
                        "sinusoidal rate (compressed day): 2x peaks, "
                        "near-idle troughs"),
    "heavy_tail": Scenario(_heavy_tail, 1, None,
                           "lognormal prompts + Zipf completions "
                           "(page-commitment stress)"),
    "multi_tenant": Scenario(_multi_tenant, 3,
                             {"gold": 3.0, "silver": 2.0, "batch": 1.0},
                             "gold/silver/batch tenants on 3 SLO tiers "
                             "(weighted-fair admission workload)"),
    "two_tier_burst": Scenario(_two_tier_burst, 2, None,
                               "steady tier-0 stream + best-effort "
                               "burst floods (the CI overload drill)"),
    "preempt_storm": Scenario(_preempt_storm, 2, None,
                              "slots filled with best-effort work, "
                              "then high-tier waves force repeated "
                              "lossless preemptions"),
    "degrading": Scenario(_degrading, 1, None,
                          "healthy steady state, then a seeded mid-run "
                          "8x rate + prompt-length step change (the "
                          "SLO alert drill: rules must fire after the "
                          "knee, never before)"),
    "shared_prefix": Scenario(_shared_prefix, 1, None,
                              "tenants sharing Zipf-weighted "
                              "system-prompt preambles + unique "
                              "suffixes (the prefix-cache workload)"),
}


def make_scenario(name: str, *, seed: int, requests: int, rate: float,
                  mean_prompt_len: int, max_prompt_len: int,
                  max_new_tokens: int, vocab_size: int,
                  budget: int) -> list[TrafficRequest]:
    """Build scenario ``name`` deterministically from ``seed``; returns
    arrivals sorted by time (ties broken by tenant so the submission
    order itself is deterministic)."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r} (have: "
            f"{', '.join(sorted(SCENARIOS))})")
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    params = ScenarioParams(
        requests=int(requests), rate=float(rate),
        mean_prompt_len=int(mean_prompt_len),
        max_prompt_len=int(max_prompt_len),
        max_new_tokens=int(max_new_tokens), vocab_size=int(vocab_size),
        budget=int(budget))
    rng = np.random.RandomState(seed)
    out = SCENARIOS[name].build(rng, params)
    out.sort(key=lambda r: (r.arrival_s, r.tenant, r.priority))
    return out


# ---------------------------------------------------------------------------
# Client mode: replay a seeded scenario over HTTP (network front door).
# ---------------------------------------------------------------------------
def request_payload(req: TrafficRequest, *, stream: bool = True) -> dict:
    """The ``POST /generate`` body for one scheduled arrival — the
    HTTP twin of ``engine.submit(prompt, ...)`` in serve_bench."""
    return {"prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "priority": int(req.priority),
            "tenant": req.tenant,
            "stream": bool(stream)}


def _drop_after(url: str, payload: dict, k: int,
                timeout_s: float) -> int:
    """Chaos client: stream one request and HANG UP the socket after
    ``k`` tokens arrive (the serve_net disconnect drill — the server
    must cancel the in-flight request and free its pages). Returns the
    token count actually seen before the hangup."""
    import json as _json
    import urllib.request

    from distributed_training_tpu_torch.serving.router import sse_events

    req = urllib.request.Request(
        url, data=_json.dumps(payload, allow_nan=False).encode(),
        headers={"Content-Type": "application/json"})
    got = 0
    resp = urllib.request.urlopen(req, timeout=timeout_s)
    try:
        for event, data in sse_events(resp):
            if event == "tokens":
                got += len(data.get("tokens", ()))
                if got >= k:
                    break  # hang up mid-stream, done never consumed
            elif event == "done":
                break  # stream ended before K tokens — still a hangup
    finally:
        try:
            resp.close()
        except OSError:
            pass
    return got


def replay_over_http(url: str, reqs: list[TrafficRequest], *,
                     stream: bool = True, concurrency: int = 1,
                     timeout_s: float = 120.0,
                     drop_at: dict[int, int] | None = None,
                     trace_prefix: str | None = None,
                     ttft_ms: list[float | None] | None = None,
                     ) -> list[dict | None]:
    """Replay ``reqs`` against a front door's ``/generate``; returns
    one ``done`` payload (with ``streamed_tokens``) per request, in
    submission order — ``None`` where the request failed.

    ``concurrency=1`` submits strictly sequentially: each request's
    stream is fully consumed before the next is sent, so the server
    sees the exact submission order ``serve_bench`` would produce
    (the bitwise-pin mode). ``concurrency>1`` keeps that many requests
    in flight via worker threads (arrival ORDER is still the seeded
    order; completion interleaving is not) — the routing-drill mode.

    ``drop_at`` maps request index -> token count K: those requests
    are sent by the chaos client, which hangs up after K streamed
    tokens (their result slots stay ``None`` — injected faults, for
    the caller to account separately from real failures).

    ``trace_prefix`` arms the client half of the fleet-trace
    round-trip: request ``i`` goes out with ``X-Graft-Trace:
    <prefix><i>`` (deterministic — the request's submission index,
    never a clock), and :func:`trace_roundtrip_mismatches` can then
    verify the server echoed the SAME id on both the response header
    and the ``done`` payload.

    ``ttft_ms``, where given, is filled with each request's client time
    to its first streamed token in ms (``None`` where none arrived).
    """
    import time

    from distributed_training_tpu_torch.serving.router import generate_over_http

    drop_at = drop_at or {}
    if ttft_ms is not None:
        ttft_ms[:] = [None] * len(reqs)

    def _tid(i: int) -> str | None:
        return (f"{trace_prefix}{i:04d}"
                if trace_prefix is not None else None)

    def _generate(i: int, r: TrafficRequest) -> dict:
        t0 = time.perf_counter()

        def first_token() -> None:
            ttft_ms[i] = (time.perf_counter() - t0) * 1e3

        return generate_over_http(
            url, request_payload(r, stream=stream), timeout_s=timeout_s,
            trace_id=_tid(i),
            on_first_token=first_token if ttft_ms is not None else None)

    results: list[dict | None] = [None] * len(reqs)
    if concurrency <= 1:
        for i, r in enumerate(reqs):
            if i in drop_at:
                _drop_after(url, request_payload(r, stream=True),
                            drop_at[i], timeout_s)
                continue
            results[i] = _generate(i, r)
        return results

    import queue as _queue
    import threading

    work: _queue.Queue = _queue.Queue()
    for item in enumerate(reqs):
        work.put(item)
    errors: list[tuple[int, Exception]] = []
    err_lock = threading.Lock()

    def worker() -> None:
        while True:
            try:
                i, r = work.get_nowait()
            except _queue.Empty:
                return
            try:
                if i in drop_at:
                    _drop_after(url, request_payload(r, stream=True),
                                drop_at[i], timeout_s)
                else:
                    results[i] = _generate(i, r)
            except Exception as e:  # collected, not raised: the drill
                with err_lock:      # counts failures itself
                    errors.append((i, e))

    threads = [threading.Thread(target=worker, name=f"traffic-{k}",
                                daemon=True)
               for k in range(int(concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        i, e = errors[0]
        raise RuntimeError(
            f"{len(errors)}/{len(reqs)} requests failed; first: "
            f"request {i}: {e}") from e
    return results


def trace_roundtrip_mismatches(results: list,
                               trace_prefix: str | None = None) -> int:
    """Count requests whose fleet trace id failed the round-trip: the
    ``done`` payload's ``trace_id`` must equal the ``X-Graft-Trace``
    response header (both set by the server from one source), and —
    when the client supplied ids via ``trace_prefix`` — both must
    equal what request ``i`` sent. Requests that failed outright
    (``None``) are not counted here; the caller's failure gate owns
    them."""
    bad = 0
    for i, r in enumerate(results):
        if r is None:
            continue
        body_id = r.get("trace_id")
        header_id = r.get("trace_header")
        if body_id is None or header_id is None:
            bad += 1
            continue
        if body_id != header_id:
            bad += 1
            continue
        if trace_prefix is not None and body_id != f"{trace_prefix}{i:04d}":
            bad += 1
    return bad


def _client_main(argv: list[str] | None = None) -> int:
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.tools.traffic",
        description="replay a seeded traffic scenario over HTTP "
                    "against a serving front door")
    p.add_argument("--url", type=str, required=True,
                   help="front door base URL, e.g. http://127.0.0.1:8080")
    p.add_argument("--scenario", type=str, default="poisson",
                   choices=sorted(SCENARIOS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=8.0)
    p.add_argument("--mean-prompt-len", type=int, default=32)
    p.add_argument("--max-prompt-len", type=int, default=64)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--budget", type=int, default=96)
    p.add_argument("--unary", action="store_true", default=False,
                   help="plain JSON responses instead of SSE streams")
    p.add_argument("--concurrency", type=int, default=1,
                   help="requests kept in flight (1 = strictly "
                        "sequential, the bitwise-pin mode)")
    p.add_argument("--timeout-s", type=float, default=120.0)
    p.add_argument("--completions-out", type=str, default=None,
                   help="write delivered completions as one JSON list "
                        "(submission order) — the artifact the bitwise "
                        "pin diffs against the batch CLI's")
    p.add_argument("--trace-prefix", type=str, default=None,
                   help="send X-Graft-Trace: <prefix><i> on request i "
                        "and verify the server echoed it back on both "
                        "the response header and the done payload "
                        "(the fleet-trace round-trip check)")
    args = p.parse_args(argv)

    reqs = make_scenario(
        args.scenario, seed=args.seed, requests=args.requests,
        rate=args.rate, mean_prompt_len=args.mean_prompt_len,
        max_prompt_len=args.max_prompt_len,
        max_new_tokens=args.max_new_tokens,
        vocab_size=args.vocab_size, budget=args.budget)
    base = args.url.rstrip("/")
    try:
        results = replay_over_http(
            base + "/generate", reqs, stream=not args.unary,
            concurrency=args.concurrency, timeout_s=args.timeout_s,
            trace_prefix=args.trace_prefix)
    except RuntimeError as e:
        print(f"traffic: error: {e}", file=sys.stderr)
        return 1

    done = [r for r in results if r is not None]
    tokens = sum(len(r["tokens"]) for r in done)
    mismatched = sum(1 for r in done
                     if r.get("streamed_tokens") is not None
                     and r["streamed_tokens"] != r["tokens"])
    trace_bad = trace_roundtrip_mismatches(
        results, trace_prefix=args.trace_prefix)
    if args.completions_out:
        with open(args.completions_out, "w") as fh:
            json.dump([{"uid": int(r["uid"]),
                        "reason": r["finish_reason"],
                        "tokens": [int(t) for t in r["tokens"]]}
                       for r in done], fh)
        print(f"[traffic] completions: {args.completions_out} "
              f"({len(done)} requests)", file=sys.stderr)
    print(json.dumps({
        "scenario": args.scenario, "seed": args.seed,
        "requests": len(reqs), "completed": len(done),
        "failed": len(reqs) - len(done),
        "tokens_received": tokens,
        "stream_vs_done_mismatches": mismatched,
        "trace_roundtrip_mismatches": trace_bad,
        "concurrency": args.concurrency,
    }, allow_nan=False))
    return 0 if (len(done) == len(reqs) and mismatched == 0
                 and trace_bad == 0) else 1


if __name__ == "__main__":
    import sys

    sys.exit(_client_main())
