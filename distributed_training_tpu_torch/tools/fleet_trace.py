"""Merge per-process fleet traces into ONE Perfetto timeline.

The port of the repo's ``tools/fleet_trace.py``, unchanged: the trace
files are the same format in both packages.

A fleet run under ``--trace-dir`` (tools/serve_net.py) writes one
Chrome-JSON trace per participant — the router front door plus every
replica incarnation, each under its REAL os.getpid()
(``<component>_pid<pid>_trace.json``, see
observability/trace.fleet_session). Each file's timestamps are
microseconds relative to ITS OWN session epoch, so side-by-side they
share no clock. This tool aligns and merges them so a SIGKILL-failover
request renders as one continuous track spanning the victim replica's
pid AND its successor's:

1. **Coarse alignment** — every session records ``wall_time_origin``
   (time.time() at session construction, stamped inside the
   allowlisted observability layer); each file is rebased onto the
   earliest origin. Wall clocks on one host agree to well under the
   slack, so this lands every file within a few ms.
2. **Hop refinement** — the door stamps a ``hop.send`` instant before
   every upstream connect and the replica stamps the matching
   ``hop.recv`` on arrival, both tagged with the same deterministic
   ``(trace, hop)`` args (no wall stamp crosses the wire — the pairing
   is by identity, the clocks by each side's own session). After the
   coarse rebase, ``recv − send`` residuals measure the remaining
   offset; any file whose earliest residual is negative (an effect
   before its cause) is shifted forward to causality. The per-file
   shift is reported as ``clock_skew_ms``.
3. **Checks** — ``--slack-ms`` bounds every aligned residual
   (handshake instants must pair within the slack);
   ``--check-failover`` requires at least one trace id whose events
   landed on two or more distinct replica pids — the merged-timeline
   proof that a mid-stream kill was resumed on a second incarnation.

    python -m distributed_training_tpu_torch.tools.fleet_trace traces/*.json -o merged.json
    python -m distributed_training_tpu_torch.tools.fleet_trace --dir traces -o merged.json \\
        --slack-ms 50 --check-failover

Exit codes: 0 ok, 1 a requested check failed, 2 malformed input.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from distributed_training_tpu_torch.observability.trace import load_trace


def _load_files(paths: list[str]) -> list[dict]:
    """Load + validate each trace, keyed for deterministic processing:
    sorted by (wall_time_origin, basename) so pid-collision remapping
    and merge order never depend on argv order."""
    files = []
    for path in paths:
        obj = load_trace(path)
        other = obj.get("otherData") or {}
        files.append({
            "path": path,
            "events": obj["traceEvents"],
            "wall_origin": float(other.get("wall_time_origin", 0.0)),
            "shift_us": 0.0,
        })
    files.sort(key=lambda f: (f["wall_origin"],
                              os.path.basename(f["path"])))
    return files


def _remap_pids(files: list[dict]) -> None:
    """Give every FILE a unique pid space. Real pids collide only on
    OS pid reuse, but a collision would fold two incarnations onto one
    Perfetto track — exactly what the merge exists to separate. The
    remap is deterministic: files are already sorted; a collision gets
    the lowest free pid above the maximum seen."""
    used: set[int] = set()
    for f in files:
        pids = {ev["pid"] for ev in f["events"]}
        remap: dict[int, int] = {}
        for pid in sorted(pids):
            new = pid
            while new in used:
                new = (max(used) if used else 0) + 1
            remap[pid] = new
            used.add(new)
        if any(old != new for old, new in remap.items()):
            for ev in f["events"]:
                ev["pid"] = remap[ev["pid"]]
        f["pids"] = sorted(remap.values())


def _coarse_rebase(files: list[dict]) -> None:
    """Shift every file onto the earliest session's wall origin."""
    t0 = min(f["wall_origin"] for f in files)
    for f in files:
        f["shift_us"] = (f["wall_origin"] - t0) * 1e6


def _hop_instants(files: list[dict], name: str) -> dict[tuple, tuple]:
    """(trace, hop) → (file_index, aligned_ts_us) for one handshake
    side. Duplicate keys keep the FIRST (sorted file order) — a resume
    re-send reuses a fresh hop number, so real runs never collide."""
    out: dict[tuple, tuple] = {}
    for fi, f in enumerate(files):
        for ev in f["events"]:
            if ev.get("ph") == "i" and ev.get("name") == name:
                args = ev.get("args") or {}
                if "hop" not in args:
                    continue
                key = (args.get("trace"), args["hop"])
                if key not in out:
                    out[key] = (fi, float(ev["ts"]) + f["shift_us"])
    return out


def _refine(files: list[dict]) -> dict[str, float]:
    """Causality pass: a file whose earliest ``hop.recv − hop.send``
    residual is negative moves forward by exactly that amount (a recv
    can trail its send by scheduling delay but can never precede it).
    Returns the per-file total shift relative to the coarse wall-origin
    rebase, in ms — the reported clock skew."""
    sends = _hop_instants(files, "hop.send")
    recvs = _hop_instants(files, "hop.recv")
    adjust: dict[int, float] = {}
    for key, (fi, recv_ts) in recvs.items():
        if key not in sends:
            continue
        _, send_ts = sends[key]
        residual = recv_ts - send_ts
        if residual < 0:
            adjust[fi] = max(adjust.get(fi, 0.0), -residual)
    skew: dict[str, float] = {}
    for fi, f in enumerate(files):
        extra = adjust.get(fi, 0.0)
        f["shift_us"] += extra
        skew[os.path.basename(f["path"])] = extra / 1e3
    return skew


def _residuals(files: list[dict]) -> list[dict]:
    """Aligned recv−send residual per paired hop (post-refinement, so
    every residual is >= 0; the slack check bounds them above)."""
    sends = _hop_instants(files, "hop.send")
    recvs = _hop_instants(files, "hop.recv")
    rows = []
    for key in sorted(sends, key=lambda k: (str(k[0]), k[1])):
        if key in recvs:
            rows.append({
                "trace": key[0], "hop": key[1],
                "residual_ms": (recvs[key][1] - sends[key][1]) / 1e3,
            })
    return rows


def _failover_traces(files: list[dict],
                     replica_prefix: str) -> list[dict]:
    """Trace ids whose events landed on >= 2 distinct REPLICA pids —
    each one a request the fleet carried across a process death."""
    proc_names: dict[int, str] = {}
    for f in files:
        for ev in f["events"]:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                proc_names[ev["pid"]] = ev["args"]["name"]
    by_trace: dict[str, set] = {}
    for f in files:
        for ev in f["events"]:
            args = ev.get("args") or {}
            tid = args.get("trace")
            if tid is None:
                continue
            name = proc_names.get(ev["pid"], "")
            if name.startswith(replica_prefix):
                by_trace.setdefault(str(tid), set()).add(ev["pid"])
    return [{"trace": t, "replica_pids": sorted(pids)}
            for t, pids in sorted(by_trace.items())
            if len(pids) >= 2]


def merge(files: list[dict]) -> dict:
    """One Chrome trace object: every file's events, pid-remapped and
    shift-aligned (metadata events keep ts 0), globally ts-sorted."""
    meta, events = [], []
    for f in files:
        for ev in f["events"]:
            if ev.get("ph") == "M":
                meta.append(ev)
            else:
                ev = dict(ev)
                ev["ts"] = float(ev["ts"]) + f["shift_us"]
                events.append(ev)
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "format": "chrome-trace-events",
            "merged_from": [os.path.basename(f["path"]) for f in files],
            "shift_us": {os.path.basename(f["path"]): f["shift_us"]
                         for f in files},
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge per-process fleet traces (serve_net "
                    "--trace-dir) into one aligned Perfetto timeline")
    ap.add_argument("paths", nargs="*",
                    help="trace JSON files (fleet_session naming)")
    ap.add_argument("--dir", default=None,
                    help="glob *_trace.json from this directory "
                         "(alternative to listing paths)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged Chrome trace here")
    ap.add_argument("--slack-ms", type=float, default=None,
                    help="fail (exit 1) when any aligned hop residual "
                         "exceeds this bound")
    ap.add_argument("--check-failover", action="store_true",
                    default=False,
                    help="fail (exit 1) unless some trace id spans "
                         ">= 2 replica pids")
    ap.add_argument("--replica-prefix", default="replica",
                    help="process-name prefix identifying replica "
                         "traces (fleet_session component)")
    ap.add_argument("--json", action="store_true", default=False,
                    help="emit the summary as one JSON object")
    args = ap.parse_args(argv)
    paths = list(args.paths)
    if args.dir:
        paths.extend(sorted(glob.glob(
            os.path.join(args.dir, "*_trace.json"))))
    if not paths:
        print("fleet_trace: error: no trace files given "
              "(paths or --dir)", file=sys.stderr)
        return 2
    try:
        files = _load_files(paths)
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"fleet_trace: error: {e}", file=sys.stderr)
        return 2
    _remap_pids(files)
    _coarse_rebase(files)
    skew = _refine(files)
    residuals = _residuals(files)
    failover = _failover_traces(files, args.replica_prefix)
    merged = merge(files)
    if args.out:
        d = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(merged, fh, allow_nan=False)
    summary = {
        "files": [os.path.basename(f["path"]) for f in files],
        "events": sum(1 for ev in merged["traceEvents"]
                      if ev.get("ph") != "M"),
        "pids": sorted({ev["pid"] for ev in merged["traceEvents"]}),
        "hop_pairs": len(residuals),
        "max_residual_ms": (max(r["residual_ms"] for r in residuals)
                            if residuals else 0.0),
        "clock_skew_ms": skew,
        "failover_traces": failover,
    }
    ok = True
    if args.slack_ms is not None:
        for r in residuals:
            if r["residual_ms"] > args.slack_ms:
                print(f"fleet_trace: FAIL: hop {r['hop']} of trace "
                      f"{r['trace']} residual {r['residual_ms']:.3f}ms "
                      f"> slack {args.slack_ms:.3f}ms", file=sys.stderr)
                ok = False
    if args.check_failover and not failover:
        print("fleet_trace: FAIL: no trace id spans >= 2 replica pids "
              "(expected a failover-resumed request)", file=sys.stderr)
        ok = False
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"fleet_trace: merged {len(files)} files, "
              f"{summary['events']} events, "
              f"{len(summary['pids'])} pids, "
              f"{summary['hop_pairs']} hop pairs "
              f"(max residual {summary['max_residual_ms']:.3f} ms)")
        for name, ms in summary["clock_skew_ms"].items():
            if ms:
                print(f"  clock skew {name}: +{ms:.3f} ms")
        for row in failover:
            print(f"  failover trace {row['trace']}: replica pids "
                  f"{row['replica_pids']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
