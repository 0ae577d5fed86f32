"""Summarize a flight-recorder dump (``observability/flight_recorder.py``).

The port of the repo's ``tools/flight_report.py``, which imports the JAX
package. The trainers (and the anomaly and crash paths) write
``*_flight.json`` ring dumps; this renders one into the questions an
on-call asks: how fast were the steps, where did the wall time go, what
did the last metrics read, which rank straggled, and what tripped. The
dump format and the report are the JAX tool's, so each tool reads the
other package's dumps and prints the same text.

    python -m distributed_training_tpu_torch.tools.flight_report flight/anomaly_step12_flight.json
    python -m distributed_training_tpu_torch.tools.flight_report --json flight/flight_crash.json
    python -m distributed_training_tpu_torch.tools.flight_report --prometheus flight/flight.json

``--json`` emits the summary as one JSON object; ``--prometheus`` the dump
as Prometheus text. A malformed dump exits 2 with one line on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_training_tpu_torch.observability.flight_recorder import FlightRecorder
from distributed_training_tpu_torch.observability.prometheus import prometheus_lines


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} TiB"  # pragma: no cover


def summarize(snap: dict) -> dict:
    """Flatten a flight snapshot into the report's field set."""
    out: dict = {
        "reason": snap.get("reason"),
        "steps_in_ring": len(snap.get("steps", [])),
        "steps_recorded_total": snap.get("steps_recorded_total"),
    }
    steps = snap.get("steps") or []
    if steps:
        out["first_step"], out["last_step"] = steps[0][0], steps[-1][0]
        out["ring_wall_seconds"] = steps[-1][1] - steps[0][1]
    out.update(snap.get("step_time_stats") or {})
    wc = snap.get("wall_clock") or {}
    if wc:
        out["goodput"] = wc.get("goodput")
        out["phase_fraction"] = wc.get("phase_fraction")
        out["tracked_seconds"] = wc.get("tracked_seconds")
    flushes = snap.get("flushes") or []
    if flushes:
        out["last_flush"] = flushes[-1]
    out["anomalies"] = snap.get("anomalies") or []
    # Cross-host aggregation (observability/aggregate.py): step-time
    # skew + straggler attribution, cached at the last flush boundary.
    if snap.get("hosts"):
        out["hosts"] = snap["hosts"]
    if snap.get("histograms"):
        out["histograms"] = snap["histograms"]
    # Serving-engine dumps (serving/metrics.py) carry an SLA section;
    # steps there are decode iterations, so step_time_* above is
    # per-iteration decode latency.
    if snap.get("serving"):
        out["serving"] = snap["serving"]
    # Resilience counters (trainers: saves committed/failed, I/O
    # retries, chaos faults — resilience/; docs/RESILIENCE.md).
    if snap.get("resilience"):
        out["resilience"] = snap["resilience"]
    # Serving control room (serving/alerts.py + serving/timeseries.py):
    # the SLO alert log and the sampled telemetry window ride engine
    # dumps as top-level sections.
    if snap.get("alerts"):
        out["alerts"] = snap["alerts"]
    if snap.get("timeseries"):
        out["timeseries"] = snap["timeseries"]
    # Fleet ledger (serving/router.py::fleet_snapshot, the "fleet" key
    # of the door's /fleet/vars payload): only dumps captured behind
    # the router door carry it — every pre-fleet bundle and every
    # single-process dump lacks the section and must render unchanged.
    if snap.get("fleet"):
        out["fleet"] = snap["fleet"]
    return out


def render(summary: dict) -> str:
    lines = []
    add = lines.append
    add(f"flight record: reason={summary['reason']!r}  "
        f"ring={summary['steps_in_ring']} steps "
        f"(of {summary['steps_recorded_total']} recorded)")
    if "first_step" in summary:
        add(f"  window: steps {summary['first_step']}..{summary['last_step']}"
            f" over {summary['ring_wall_seconds']:.2f}s")
    if "step_time_p50_ms" in summary:
        add(f"  step time: p50 {summary['step_time_p50_ms']:.2f} ms  "
            f"p95 {summary['step_time_p95_ms']:.2f} ms  "
            f"max {summary['step_time_max_ms']:.2f} ms")
    if summary.get("goodput") is not None:
        frac = summary.get("phase_fraction") or {}
        body = "  ".join(f"{k} {v:.1%}" for k, v in sorted(
            frac.items(), key=lambda kv: -kv[1]))
        add(f"  goodput: {summary['goodput']:.1%} of "
            f"{summary['tracked_seconds']:.1f}s tracked  ({body})")
    last = summary.get("last_flush")
    if last:
        keys = ("loss", "perplexity", "accuracy", "grad_norm", "mfu",
                "model_flops_per_sec", "loss_scale", "grads_finite",
                # serving-engine flushes (serving/metrics.py)
                "queue_depth", "active_slots", "tokens_emitted",
                "requests_finished")

        def fmt(v):  # non-finite values arrive as 'nan'/'inf' strings
            return f"{v:.4g}" if isinstance(v, (int, float)) else str(v)

        body = "  ".join(f"{k}={fmt(last[k])}" for k in keys if k in last)
        add(f"  last flush (step {last.get('step')}): {body}")
        if "mem_peak_bytes" in last:
            add(f"  device memory: in-use "
                f"{_fmt_bytes(last.get('mem_bytes_in_use', 0))}  "
                f"peak {_fmt_bytes(last['mem_peak_bytes'])}")
    srv = summary.get("serving")
    if srv:
        add(f"  serving: {srv['requests_finished']} requests  "
            f"{srv['tokens_emitted']} tokens  "
            f"{srv['throughput_tok_s']:.1f} tok/s"
            + ("  [drained]" if srv.get("drained") else ""))
        add(f"    ttft p50 {srv['ttft_p50_ms']:.1f} ms  "
            f"p95 {srv['ttft_p95_ms']:.1f} ms  |  "
            f"tpot p50 {srv['tpot_p50_ms']:.2f} ms  "
            f"p95 {srv['tpot_p95_ms']:.2f} ms  |  "
            f"queue depth max {srv['queue_depth_max']}")
        # KV/slot utilization (serving/metrics.py): the measured
        # max_len over-reservation + admission-latency breakdown.
        if srv.get("kv_written_tokens"):
            add(f"    kv util: written {srv['kv_written_tokens']:.0f} / "
                f"reserved {srv['kv_reserved_tokens']:.0f} token-iters  "
                f"(over-reservation x{srv['kv_reserved_vs_written']:.2f})"
                f"  |  slot occupancy {srv['slot_occupancy_mean']:.1%}")
        # Paged-KV pool view (0 on the legacy contiguous path).
        if srv.get("page_pool_occupancy_mean"):
            add(f"    kv pages: pool occupancy "
                f"{srv['page_pool_occupancy_mean']:.1%}  "
                f"({srv.get('kv_pages_allocated_iters', 0)} "
                f"page-iters allocated)")
        # Radix-tree prefix cache (serving/prefix_cache.py): reuse
        # economics — prefill compute saved, trie page churn/residency.
        if (srv.get("prefix_cache_hit_requests")
                or srv.get("prefix_cache_pages_held")):
            add(f"    prefix cache: "
                f"{srv.get('prefix_cache_hit_tokens', 0):.0f} tok reused "
                f"across {srv.get('prefix_cache_hit_requests', 0):.0f} "
                f"hit(s)  |  pages "
                f"{srv.get('prefix_cache_inserted_pages', 0):.0f} "
                f"indexed / {srv.get('prefix_cache_evicted_pages', 0):.0f}"
                f" evicted / {srv.get('prefix_cache_pages_held', 0):.0f} "
                f"held")
        # Live weight hot-swap (serving/hotswap.py): deployment
        # counters + the explicitly-attributed barrier pause.
        if srv.get("swaps_completed") or srv.get("swaps_rejected"):
            add(f"    swaps: {srv.get('swaps_completed', 0):.0f} "
                f"completed / {srv.get('swaps_rejected', 0):.0f} "
                f"rejected  |  blocked "
                f"{srv.get('swap_blocked_s', 0.0) * 1e3:.1f} ms  |  "
                f"weights epoch {srv.get('weights_epoch', -1):.0f}")
        if srv.get("requests_finished") and "queue_wait_p50_ms" in srv:
            add(f"    admission: queue wait p50 "
                f"{srv['queue_wait_p50_ms']:.1f} / p95 "
                f"{srv['queue_wait_p95_ms']:.1f} ms  |  prefill p50 "
                f"{srv['prefill_p50_ms']:.1f} / p95 "
                f"{srv['prefill_p95_ms']:.1f} ms  |  blocked "
                f"{srv.get('admission_blocked_s', 0.0):.2f}s")
        # Latency ledger (serving/ledger.py): the conserved per-cause
        # decomposition — engine-wide cause totals, the conservation
        # audit, and the slowest requests broken down by cause.
        if srv.get("ledger_requests"):
            totals = {k[len("ledger_"):-len("_ms_total")]: v
                      for k, v in srv.items()
                      if k.startswith("ledger_")
                      and k.endswith("_ms_total") and v}
            body = "  ".join(f"{c} {ms:.0f}" for c, ms in sorted(
                totals.items(), key=lambda kv: -kv[1]))
            viol = srv.get("ledger_conservation_violations", 0)
            add(f"    latency ledger ({srv['ledger_requests']:.0f} "
                f"requests audited, {viol:.0f} conservation "
                f"violation(s)): {body or 'no spans'} ms")
            if viol and srv.get("ledger_violation_last"):
                add(f"      LAST VIOLATION: "
                    f"{srv['ledger_violation_last']}")
            for e in srv.get("ledger_top") or []:
                causes = "  ".join(
                    f"{c} {ms:.1f}" for c, ms in sorted(
                        e.get("causes_ms", {}).items(),
                        key=lambda kv: -kv[1]))
                add(f"      #{e['uid']} ({e['finish_reason']}, "
                    f"{e['tokens']} tok): {e['lifetime_ms']:.1f} ms "
                    f"= {causes}")
        degraded = {k: srv.get(k, 0) for k in (
            "requests_timed_out", "requests_shed",
            "requests_drain_rejected", "requests_preempted",
            "requests_preempt_timed_out")}
        if any(degraded.values()):
            add(f"    degradation: timed out {degraded['requests_timed_out']}"
                f"  shed {degraded['requests_shed']}"
                f"  drain-rejected {degraded['requests_drain_rejected']}"
                f"  preempted {degraded['requests_preempted']}"
                f" (expired {degraded['requests_preempt_timed_out']}, "
                f"recompute "
                f"{srv.get('preempted_token_recompute', 0):.0f} tok)")
    fl = summary.get("fleet")
    if fl:
        # Every access tolerant (.get with a zero default): the section
        # shape may grow counter-by-counter across rounds and an older
        # door's bundle must keep rendering.
        causes = "  ".join(f"{c} {ms:.0f}" for c, ms in sorted(
            (fl.get("fleet_cause_ms") or {}).items(),
            key=lambda kv: -kv[1]))
        viol = fl.get("fleet_ledger_conservation_violations", 0)
        add(f"  fleet ledger: {fl.get('fleet_ledger_requests', 0)} "
            f"request(s) audited cross-hop, {viol} conservation "
            f"violation(s)  |  replica ledgers "
            f"{fl.get('fleet_replica_ledger_joined', 0)} joined / "
            f"{fl.get('fleet_replica_ledger_absent', 0)} absent"
            + (f"  |  {causes} ms" if causes else ""))
        if viol and fl.get("fleet_ledger_violation_last"):
            add(f"    LAST VIOLATION: {fl['fleet_ledger_violation_last']}")
        for e in fl.get("fleet_ledger_top") or []:
            ecauses = "  ".join(f"{c} {ms:.1f}" for c, ms in sorted(
                (e.get("causes_ms") or {}).items(),
                key=lambda kv: -kv[1]))
            rep = e.get("replica_lifetime_ms")
            add(f"    {e.get('trace_id', '?')} (uid {e.get('uid', '?')}"
                f"): {e.get('lifetime_ms', 0.0):.1f} ms door-side"
                + (f" / {rep:.1f} ms replica-side"
                   if isinstance(rep, (int, float)) else "")
                + (f" = {ecauses}" if ecauses else "")
                + ("" if e.get("conserved", True)
                   else "  [NOT CONSERVED]"))
    al = summary.get("alerts")
    if al:
        active = ", ".join(al.get("active") or []) or "none"
        add(f"  alerts: {al.get('fired', 0)} fired  "
            f"{al.get('cleared', 0)} cleared  active: {active}  "
            f"({len(al.get('rules') or [])} rule(s))")
        for ev in (al.get("log") or [])[-8:]:
            add(f"    [{ev['event']}] {ev['rule']} @ iteration "
                f"{ev['iteration']}: {ev['metric']} fast "
                f"{ev['value_fast']:.4g} / slow {ev['value_slow']:.4g} "
                f"(objective {ev['objective']:.4g})")
        if al.get("log_dropped"):
            add(f"    ({al['log_dropped']} older event(s) dropped)")
    ts = summary.get("timeseries")
    if ts and ts.get("samples"):
        fields = ts.get("fields") or []
        samples = ts["samples"]
        idx = {k: i for i, k in enumerate(fields)}

        def col(name, row):
            return row[idx[name]] if name in idx else 0.0

        first, newest = samples[0], samples[-1]
        add(f"  timeseries: {len(samples)} sample(s) retained "
            f"(of {ts.get('samples_recorded_total', 0)} recorded, "
            f"every {ts.get('sample_every', 0)} iteration(s))")
        add(f"    window: iterations {col('iteration', first):.0f}.."
            f"{col('iteration', newest):.0f}  tokens "
            f"+{col('tokens_emitted', newest) - col('tokens_emitted', first):.0f}"
            f"  finished "
            f"+{col('requests_finished', newest) - col('requests_finished', first):.0f}"
            f"  shed "
            f"+{col('requests_shed', newest) - col('requests_shed', first):.0f}")
        if "queue_depth" in idx:
            depths = [r[idx["queue_depth"]] for r in samples]
            add(f"    queue depth: last {depths[-1]:.0f}  mean "
                f"{sum(depths) / len(depths):.1f}  max "
                f"{max(depths):.0f}")
    hosts = summary.get("hosts")
    if hosts:
        line = f"  hosts: {hosts['num_hosts']}"
        if "median_step_ms" in hosts:
            line += (f"  median step {hosts['median_step_ms']:.2f} ms "
                     f"over {hosts['common_steps']} common steps")
        add(line)
        strag = hosts.get("straggler")
        if strag:
            add(f"    straggler: host {strag['host']} step "
                f"{strag['step']}  (+{strag['excess_ms']:.1f} ms, "
                f"score {strag['score']:.2f})")
        for ph in hosts.get("per_host", []):
            if "step_time_mean_ms" not in ph:
                continue
            add(f"    host {ph['process_index']}: mean "
                f"{ph['step_time_mean_ms']:.2f} ms  max "
                f"{ph['step_time_max_ms']:.2f} ms  excess mean "
                f"{ph['mean_excess_ms']:+.2f} / max "
                f"{ph['max_excess_ms']:+.2f} ms (step "
                f"{ph['max_excess_step']})")
    res = summary.get("resilience")
    if res:
        add(f"  resilience: saves committed {res.get('saves_committed', 0)}"
            f" / failed {res.get('saves_failed', 0)}  "
            f"io retries {res.get('io_retries', 0)}")
        faults = res.get("chaos_faults")
        if faults:
            body = "  ".join(f"{k} {v}" for k, v in sorted(faults.items())
                             if v)
            add(f"    chaos faults: {body or 'none fired'}")
    if summary["anomalies"]:
        add("  ANOMALIES:")
        for a in summary["anomalies"]:
            add(f"    step {a['step']}: " + "; ".join(a["reasons"]))
    else:
        add("  anomalies: none")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize a flight-recorder JSON dump")
    ap.add_argument("path", help="flight JSON written by the trainers / "
                                 "TrainObservability.dump()")
    ap.add_argument("--json", action="store_true", default=False,
                    help="emit the summary as one JSON object")
    ap.add_argument("--prometheus", action="store_true", default=False,
                    help="emit the dump as Prometheus text exposition "
                         "(gauges + histogram families) for a scraper")
    args = ap.parse_args(argv)
    try:
        snap = FlightRecorder.load(args.path)
        if args.prometheus:
            out = "\n".join(prometheus_lines(snap))
        elif args.json:
            out = json.dumps(summarize(snap))
        else:
            out = render(summarize(snap))
    except (OSError, ValueError, KeyError, TypeError) as e:
        # A malformed/truncated dump is an expected operational input
        # (the crash it documents may have torn it): one actionable line
        # on stderr + a nonzero exit, never a traceback.
        print(f"flight_report: error: {args.path}: {e}", file=sys.stderr)
        return 2
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
