"""Synthetic-load benchmark for the port's continuous-batching engine.

The port of the repo's ``tools/serve_bench.py``, which imports the JAX
package. It drives ``distributed_training_tpu_torch/serving/`` with a
seeded traffic scenario (``tools/traffic.py``: ``--scenario poisson`` is
the exponential-inter-arrival process at ``--rate`` req/s, the others add
bursts, diurnal cycles, heavy tails, tenant and tier mixes, preemption
storms, a degrading load and shared prefixes) over random-token prompts
against a random-weight GPT, and prints ONE strict-JSON line, last on
stdout, with the SLA summary and JAX's keys (``throughput_tok_s``,
``ttft_*``, ``tpot_*``, the histogram percentiles, queue, KV, swap,
journal, ledger and alert counters, ``requests``, ``scenario``, ...).

    python -m distributed_training_tpu_torch.tools.serve_bench --requests 32 --rate 50
    python -m distributed_training_tpu_torch.tools.serve_bench --device cpu \\
        --scenario degrading --virtual-dt 5 --slo-rules default --incident-dir inc

It serves on the card unless ``--device cpu`` asks for the CPU (without a
card it fails). ``--virtual-dt`` releases arrivals on a clock that
advances that many ms an engine iteration, so the admission, preemption
and shed schedule, and every alert decision over those counters, is a
pure function of ``(--scenario, --seed)``. JAX's ``--check-compiles`` has
no counterpart: eager PyTorch compiles no program to count.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.tools.serve_bench",
        description="seeded-load benchmark for the serving engine")
    p.add_argument("--device", type=str, default="cuda",
                   help="cpu to serve on the CPU; default the card (without "
                        "one this fails)")
    p.add_argument("--requests", type=int, default=32, help="measured requests")
    p.add_argument("--rate", type=float, default=50.0,
                   help="mean arrival rate, requests/second")
    p.add_argument("--scenario", type=str, default="poisson",
                   help="traffic scenario (tools/traffic.py); multi-tier "
                        "scenarios raise --num-tiers and set their tenant "
                        "weights")
    p.add_argument("--virtual-dt", type=float, default=0.0,
                   help="release arrivals on a virtual clock advancing this "
                        "many ms an engine iteration (0 = wall clock)")
    p.add_argument("--num-tiers", type=int, default=0,
                   help="SLO tiers (0 = the scenario's own count)")
    p.add_argument("--tenant-quota", type=int, default=None)
    p.add_argument("--tier-reserved-slots", type=int, default=0)
    p.add_argument("--tier-reserved-pages", type=int, default=0)
    p.add_argument("--no-preempt", action="store_true", default=False)
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="bounded admission: beyond it the newest best-effort "
                        "request is shed")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-len", type=int, default=None,
                   help="per-slot KV budget; default the model's max-len")
    p.add_argument("--prompt-len", type=int, default=32,
                   help="mean prompt length (uniform in [1, 2*mean-1])")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--kv-page-size", type=int, default=8,
                   help="paged KV page size; 0 = the legacy contiguous slots")
    p.add_argument("--kv-pages", type=int, default=None)
    p.add_argument("--prefill-chunk", type=int, default=64)
    p.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--prefix-cache-pages", type=int, default=None)
    p.add_argument("--prefill-bucket", type=int, default=16,
                   help="legacy prefill bucketing (--kv-page-size 0)")
    p.add_argument("--spec-k", type=int, default=0)
    p.add_argument("--spec-drafter", type=str, default="ngram", choices=["ngram", "gpt"])
    p.add_argument("--spec-ngram", type=int, default=3)
    p.add_argument("--spec-draft-window", type=int, default=16)
    p.add_argument("--quantize-weights", action="store_true", default=False)
    p.add_argument("--kv-dtype", type=str, default=None, choices=["int8"])
    # A random-weight model: this benches the engine, not the model.
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=2)
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--model-max-len", type=int, default=256)
    p.add_argument("--no-warmup", action="store_true", default=False)
    p.add_argument("--swap-at-request", type=int, default=0,
                   help="arm a swap to a second seeded init when the Nth "
                        "measured request is submitted (0 = off)")
    p.add_argument("--journal-dir", type=str, default=None)
    p.add_argument("--journal-fsync", type=str, default="batch",
                   choices=["none", "batch", "always"])
    p.add_argument("--journal-segment-bytes", type=int, default=1 << 20)
    p.add_argument("--kill-at-request", type=int, default=0,
                   help="SIGKILL this process once the Nth measured request "
                        "is submitted, the journal on disk first (0 = off)")
    p.add_argument("--completions-out", type=str, default=None)
    p.add_argument("--ledger-out", type=str, default=None)
    p.add_argument("--flight-dump", type=str, default=None)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="/metrics, /healthz, /vars, /timeseries and /alerts "
                        "while the bench runs (loopback; 0 = a free port)")
    p.add_argument("--slo-rules", type=str, default=None,
                   help="'default' or ';'-separated name:metric[/den]>"
                        "objective[@fast,slow][xBURN][~CLEAR] clauses")
    p.add_argument("--incident-dir", type=str, default=None,
                   help="one incident bundle a fired alert (needs --slo-rules)")
    p.add_argument("--sample-every", type=int, default=16,
                   help="time-series sample cadence in iterations")
    p.add_argument("--alert-log-out", type=str, default=None,
                   help="write the alert engine's state as strict JSON at exit")
    p.add_argument("--trace", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--trace-dir", type=str, default="./trace")
    p.add_argument("--seed", type=int, default=0)
    return p


def build_model(args, seed: int, device):
    """The random-weight ``transformer_lm`` of the flags, from ``seed``."""
    import torch

    from distributed_training_tpu_torch.models import get_model

    return get_model(
        "transformer_lm", num_classes=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, hidden_dim=args.hidden_dim, max_len=args.model_max_len,
        generator=torch.Generator().manual_seed(seed)).to(device).eval()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from distributed_training_tpu_torch.config import ServeConfig
    from distributed_training_tpu_torch.observability.exporter import attach_engine
    from distributed_training_tpu_torch.observability.trace import session_for_cli
    from distributed_training_tpu_torch.resilience.errors import QueueFullError
    from distributed_training_tpu_torch.serving import Engine
    from distributed_training_tpu_torch.serving.ledger import dump_ledgers
    from distributed_training_tpu_torch.serving.quantize import serving_params
    from distributed_training_tpu_torch.tools.traffic import SCENARIOS, make_scenario
    from distributed_training_tpu_torch.utils.device import resolve_device

    def log(msg: str) -> None:
        print(f"[serve_bench] {msg}", file=sys.stderr, flush=True)

    # Prompt lengths are clamped to the engine's per-slot budget, so no
    # generated request dies with a CacheBudgetError mid-measurement.
    budget = min(args.max_len or args.model_max_len, args.model_max_len)
    max_prompt = budget - args.max_new_tokens
    if max_prompt < 1:
        raise SystemExit(
            f"--max-new-tokens {args.max_new_tokens} leaves no room for a "
            f"prompt in the {budget}-token per-slot budget "
            f"(--max-len/--model-max-len)")
    if args.scenario not in SCENARIOS:
        raise SystemExit(f"unknown --scenario {args.scenario!r} "
                         f"(have: {', '.join(sorted(SCENARIOS))})")
    scen = SCENARIOS[args.scenario]
    num_tiers = max(args.num_tiers, scen.num_tiers)
    load = make_scenario(
        args.scenario, seed=args.seed, requests=args.requests, rate=args.rate,
        mean_prompt_len=args.prompt_len, max_prompt_len=max_prompt,
        max_new_tokens=args.max_new_tokens, vocab_size=args.vocab_size, budget=budget)

    device = resolve_device(args.device)
    model = build_model(args, args.seed, device)
    trace, trace_path = session_for_cli(args.trace, args.trace_dir, "serve_bench")
    engine = Engine(model, ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        eos_id=args.eos_id, kv_page_size=args.kv_page_size or None,
        kv_pages=args.kv_pages, prefill_chunk=args.prefill_chunk,
        prefill_bucket=args.prefill_bucket, prefix_cache=args.prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages, spec_k=args.spec_k,
        spec_drafter=args.spec_drafter, spec_ngram=args.spec_ngram,
        spec_draft_window=args.spec_draft_window,
        quantize_weights=args.quantize_weights, kv_dtype=args.kv_dtype,
        num_tiers=num_tiers, tenant_quota=args.tenant_quota,
        tenant_weights=scen.tenant_weights,
        tier_reserved_slots=args.tier_reserved_slots,
        tier_reserved_pages=args.tier_reserved_pages, preempt=not args.no_preempt,
        max_queue_depth=args.max_queue_depth, journal_dir=args.journal_dir,
        journal_fsync=args.journal_fsync,
        journal_segment_bytes=args.journal_segment_bytes,
        sample_every=args.sample_every, slo_rules=args.slo_rules,
        incident_dir=args.incident_dir, seed=args.seed), trace=trace)

    # The journal's replay comes before any traffic; its submission cursor
    # says where the scenario left off.
    report = engine.recover()
    recovered_n = (len(report["redelivered"]) + len(report["completed_at_replay"])
                   + report["resumed"])
    submitted_start = int(report["notes"].get("submitted", 0))
    recovering = recovered_n > 0 or submitted_start > 0
    if recovering:
        log(f"journal recovery: {len(report['redelivered'])} redelivered, "
            f"{report['resumed']} resumed, {len(report['completed_at_replay'])} "
            f"completed at replay; scenario continues at request "
            f"{submitted_start}/{args.requests}")

    exporter = None
    if args.metrics_port is not None:
        exporter = attach_engine(engine, args.metrics_port, component="serve_bench",
                                 printer=log)

    rng = np.random.RandomState(args.seed)
    if not args.no_warmup and recovering:
        # The replay ran the same paths; a warm-up would also take uids and
        # move every later request's sampling stream off the oracle's.
        log("warm-up skipped (journal recovery warms the paths)")
    elif not args.no_warmup:
        # One short request at a time, to completion (a tight
        # --max-queue-depth must not shed the warm-up): the paged engine's
        # fused and decode-only steps, or every legacy prefill bucket.
        warm_new = 4 if args.spec_k else 2
        warm_fins = []
        if engine.paged:
            for _ in range(2):
                engine.submit(rng.randint(0, args.vocab_size, size=2).astype(np.int32),
                              max_new_tokens=warm_new)
                warm_fins.extend(engine.run())
        else:
            for lb in range(args.prefill_bucket,
                            2 * args.prompt_len - 1 + args.prefill_bucket,
                            args.prefill_bucket):
                lb = min(lb, engine.budget - warm_new)
                engine.submit(rng.randint(0, args.vocab_size, size=lb).astype(np.int32),
                              max_new_tokens=warm_new)
                warm_fins.extend(engine.run())
        if engine.journal is not None:
            engine.journal.ack([f.uid for f in warm_fins])
        engine.reset_stats()
        log(f"warm-up done ({sum(f.tokens.size for f in warm_fins)} tokens)")

    n = args.requests
    swap_params = None
    if args.swap_at_request:
        if not 1 <= args.swap_at_request <= n:
            raise SystemExit(f"--swap-at-request must be in [1, {n}], "
                             f"got {args.swap_at_request}")
        swap_params = serving_params(build_model(args, args.seed + 1, device))
    if args.kill_at_request and not 1 <= args.kill_at_request <= n:
        raise SystemExit(f"--kill-at-request must be in [1, {n}], "
                         f"got {args.kill_at_request}")

    completions = list(report["redelivered"]) + list(report["completed_at_replay"])
    submitted = submitted_start
    finished = 0
    shed_at_submit = 0

    def submit_next(arrival_t=None):
        """Submit the next arrival. With a journal the submission cursor is
        enqueued before the admission record (the admit persists both), so
        a crash between them drops a request never accepted and never
        duplicates one."""
        nonlocal submitted, shed_at_submit
        r = load[submitted]
        if engine.journal is not None:
            engine.journal.log_note({"submitted": submitted + 1}, flush=False)
        try:
            engine.submit(r.prompt, max_new_tokens=r.max_new_tokens, arrival_t=arrival_t,
                          priority=r.priority, tenant=r.tenant)
        except QueueFullError:
            shed_at_submit += 1
        submitted += 1
        if swap_params is not None and submitted == args.swap_at_request:
            engine.arm_swap(swap_params, epoch=engine.weights_epoch + 1)
        if args.kill_at_request and submitted == args.kill_at_request:
            from distributed_training_tpu_torch.resilience.chaos import hard_kill

            hard_kill(flush=None if engine.journal is None else engine.journal.persist)

    if args.virtual_dt > 0:
        # After a recovery the clock re-anchors at the first pending arrival.
        v0 = load[submitted].arrival_s if recovering and submitted < n else 0.0
        it = 0
        while submitted < n:
            vnow = v0 + it * args.virtual_dt / 1e3
            while submitted < n and load[submitted].arrival_s <= vnow:
                submit_next()
            step_fins = engine.step()
            completions.extend(step_fins)
            finished += len(step_fins)
            it += 1
    else:
        w0 = load[submitted].arrival_s if recovering and submitted < n else 0.0
        t0 = time.perf_counter() - w0
        while submitted < n:
            now = time.perf_counter() - t0
            while submitted < n and load[submitted].arrival_s <= now:
                submit_next(arrival_t=t0 + load[submitted].arrival_s)
            if engine.idle and submitted < n:
                time.sleep(min(load[submitted].arrival_s - now, 0.05))
                continue
            step_fins = engine.step()
            completions.extend(step_fins)
            finished += len(step_fins)
    # A graceful drain: every accepted request completes and is counted.
    drain_fins = engine.drain()
    completions.extend(drain_fins)
    finished += len(drain_fins)
    delivered = finished + len(report["redelivered"]) + len(report["completed_at_replay"])
    expected = (n - submitted_start) + recovered_n
    if delivered + shed_at_submit != expected:
        raise SystemExit(
            f"serve_bench: delivered {delivered} + {shed_at_submit} shed at submit, "
            f"expected {expected} ({n} requests, scenario resumed at "
            f"{submitted_start}, {recovered_n} recovered)")
    if engine.paged:
        engine.check_balanced()  # every page back, speculation and trie included

    stats = engine.stats()
    stats["requests"] = n
    stats["arrival_rate_req_s"] = args.rate
    stats["max_batch"] = args.max_batch
    stats["scenario"] = args.scenario
    stats["shed_at_submit"] = shed_at_submit
    # One engine in process: the router counters are 0 (serve_net fills them).
    stats["router_requests_routed"] = 0
    stats["router_prefix_routed"] = 0
    stats["router_fallback_routed"] = 0
    stats["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")
    if args.completions_out:
        with open(args.completions_out, "w") as fh:
            json.dump([{"uid": int(f.uid), "reason": f.finish_reason,
                        "tokens": [int(t) for t in f.tokens]}
                       for f in sorted(completions, key=lambda f: f.uid)], fh)
        log(f"completions: {args.completions_out} ({len(completions)} requests)")
    if args.ledger_out:
        n_rows, bad = dump_ledgers(args.ledger_out, completions)
        log(f"latency ledgers: {args.ledger_out} ({n_rows} requests, "
            f"{bad} conservation violation(s))")
    if engine.journal is not None:
        engine.journal.ack([f.uid for f in completions])
        engine.journal.shutdown()
    if args.flight_dump:
        engine.dump_flight(args.flight_dump, reason="serve_bench")
        log(f"flight record: {args.flight_dump}")
    engine.close_incidents()
    if engine.incidents is not None:
        log(f"incidents: {args.incident_dir} ({engine.incidents.captured} captured, "
            f"{engine.incidents.write_errors} write error(s))")
    if args.alert_log_out:
        with open(args.alert_log_out, "w") as fh:
            json.dump(engine.alerts.to_dict(), fh, indent=1, allow_nan=False)
            fh.write("\n")
        log(f"alert log: {args.alert_log_out} ({engine.alerts.fired} fired, "
            f"{engine.alerts.cleared} cleared)")
    if trace is not None:
        trace.save(trace_path)
        log(f"trace: {trace_path} ({len(trace)} events)")
    if exporter is not None:
        exporter.close()
    print(json.dumps(stats, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
