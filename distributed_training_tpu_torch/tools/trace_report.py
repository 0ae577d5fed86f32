"""Summarise a Chrome/Perfetto trace written by ``observability/trace.py``.

The port of the root ``tools/trace_report.py`` (which imports the JAX
package), with its output and exit codes: per track, the span count, the
busy time (the union of span intervals, so nesting never counts twice),
the utilisation over the track's extent and the largest idle gap; and the
longest spans of the whole trace. Either package's traces read in either
tool.

    python -m distributed_training_tpu_torch.tools.trace_report flight/trace/trace.json
    python -m distributed_training_tpu_torch.tools.trace_report --json flight/trace/trace.json

A malformed or truncated file exits 2 with a one-line error (the crash
the trace documents may have torn it).
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_training_tpu_torch.observability.trace import load_trace


def _merge_intervals(spans):
    """Union of (start, end) µs intervals — busy time without nested or
    overlapping spans double-counting."""
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(obj: dict, top: int = 5) -> dict:
    """Flatten a trace object into the report's field set (all times ms)."""
    procs: dict[int, str] = {}
    names: dict[tuple, str] = {}
    tracks: dict[tuple, dict] = {}
    all_spans = []  # (dur, name, track_key, ts)
    for ev in obj["traceEvents"]:
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "M":
            if ev["name"] == "process_name":
                procs[ev["pid"]] = ev["args"]["name"]
            elif ev["name"] == "thread_name":
                names[key] = ev["args"]["name"]
            continue
        tr = tracks.setdefault(
            key, {"spans": [], "instants": 0, "counter_samples": 0})
        if ev["ph"] == "X":
            dur = float(ev.get("dur", 0.0))
            tr["spans"].append((float(ev["ts"]), float(ev["ts"]) + dur))
            all_spans.append((dur, ev["name"], key, float(ev["ts"])))
        elif ev["ph"] == "C":
            tr["counter_samples"] += 1
        else:
            tr["instants"] += 1

    track_rows = []
    for key in sorted(tracks):
        tr = tracks[key]
        row = {
            "pid": key[0], "tid": key[1],
            "track": names.get(key, f"tid {key[1]}"),
            "process": procs.get(key[0], f"pid {key[0]}"),
            "spans": len(tr["spans"]),
            "instants": tr["instants"],
            "counter_samples": tr["counter_samples"],
        }
        if tr["spans"]:
            merged = _merge_intervals(tr["spans"])
            t0 = merged[0][0]
            t1 = max(end for _, end in merged)
            busy = sum(end - start for start, end in merged)
            extent = t1 - t0
            gaps = [b[0] - a[1] for a, b in zip(merged, merged[1:])]
            row.update({
                "busy_ms": busy / 1e3,
                "extent_ms": extent / 1e3,
                "utilization": busy / extent if extent > 0 else 1.0,
                "largest_gap_ms": max(gaps) / 1e3 if gaps else 0.0,
            })
        track_rows.append(row)

    all_spans.sort(key=lambda s: -s[0])
    longest = [
        {"name": name, "dur_ms": dur / 1e3, "ts_ms": ts / 1e3,
         "track": names.get(key, f"tid {key[1]}"), "pid": key[0]}
        for dur, name, key, ts in all_spans[:top]
    ]
    other = obj.get("otherData") or {}
    return {
        "events": sum(1 for ev in obj["traceEvents"] if ev["ph"] != "M"),
        "dropped_events": other.get("dropped_events", 0),
        "tracks": track_rows,
        "longest_spans": longest,
    }


def render(summary: dict) -> str:
    lines = []
    add = lines.append
    add(f"trace: {summary['events']} events across "
        f"{len(summary['tracks'])} tracks"
        + (f"  ({summary['dropped_events']} DROPPED — raise max_events)"
           if summary["dropped_events"] else ""))
    for row in summary["tracks"]:
        head = (f"  [{row['process']}] {row['track']}: "
                f"{row['spans']} spans, {row['instants']} instants")
        if row.get("counter_samples"):
            head += f", {row['counter_samples']} counter samples"
        add(head)
        if "busy_ms" in row:
            add(f"    busy {row['busy_ms']:.1f} ms of "
                f"{row['extent_ms']:.1f} ms extent "
                f"({row['utilization']:.1%} utilized), largest gap "
                f"{row['largest_gap_ms']:.1f} ms")
    if summary["longest_spans"]:
        add("  longest spans:")
        for s in summary["longest_spans"]:
            add(f"    {s['dur_ms']:9.2f} ms  {s['name']}  "
                f"[{s['track']}] at +{s['ts_ms']:.1f} ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize a Chrome/Perfetto trace JSON "
                    "(observability/trace.py)")
    ap.add_argument("path", help="trace JSON written with --trace / "
                                 "TraceSession.save()")
    ap.add_argument("--json", action="store_true", default=False,
                    help="emit the summary as one JSON object")
    ap.add_argument("--top", type=int, default=5,
                    help="longest spans to list")
    args = ap.parse_args(argv)
    try:
        summary = summarize(load_trace(args.path), top=args.top)
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"trace_report: error: {args.path}: {e}", file=sys.stderr)
        return 2
    print(json.dumps(summary) if args.json else render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
