"""Render an incident bundle (serving/alerts.py IncidentWriter).

The port of the repo's ``tools/incident_report.py``, rendering through the
port's ``flight_report``: each package's tool prints the same text for a
bundle of either.

When an SLO burn-rate alert fires, the serving engine captures exactly
one bundle — the firing alert, the full alert log, the last
time-series window, and a flight snapshot — and the incident writer
thread lands it atomically in ``--incident-dir``. This tool is the
post-incident read: what fired, what the burn looked like, and what
the engine looked like at that moment.

    python -m distributed_training_tpu_torch.tools.incident_report incidents/incident_000_shed_rate.json
    python -m distributed_training_tpu_torch.tools.incident_report incidents/   # every bundle
    python -m distributed_training_tpu_torch.tools.incident_report --json incidents/incident_000_*.json

Exit codes follow the report-tool contract (flight_report.py): 0 on a
rendered bundle, 2 on a missing/malformed one (one actionable stderr
line, never a traceback).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributed_training_tpu_torch.tools.flight_report import render as render_flight
from distributed_training_tpu_torch.tools.flight_report import summarize as summarize_flight


def load_bundle(path: str) -> dict:
    """Read and validate one incident bundle; raises ValueError on a
    shape this renderer does not understand."""
    with open(path) as fh:
        bundle = json.load(fh)
    if not isinstance(bundle, dict):
        raise ValueError("incident bundle must be a JSON object")
    version = bundle.get("format_version")
    if version != 1:
        raise ValueError(f"unsupported incident format_version {version!r}")
    for key in ("alert", "alerts", "timeseries", "flight"):
        if key not in bundle:
            raise ValueError(f"incident bundle missing {key!r} section")
    return bundle


def render(bundle: dict) -> str:
    """The on-call view of one bundle: the firing alert first, then the
    alert-engine state and the flight summary (which itself renders the
    bundle's time-series window via flight_report)."""
    ev = bundle["alert"]
    lines = [
        f"incident: rule {ev['rule']!r} fired at iteration "
        f"{ev['iteration']} (sample {ev['sample']})",
        f"  metric {ev['metric']}: fast {ev['value_fast']:.4g} / "
        f"slow {ev['value_slow']:.4g}  vs objective "
        f"{ev['objective']:.4g} (burn x{ev['burn_threshold']:.2f})",
    ]
    # flight_report renders the alert log + time-series window from the
    # same section shapes flight dumps carry; the bundle's flight
    # snapshot holds neither (they live at bundle top level), so
    # grafting them in reuses one renderer with no duplication.
    summary = summarize_flight(bundle["flight"])
    summary["alerts"] = bundle["alerts"]
    summary["timeseries"] = bundle["timeseries"]
    # Fleet ledger section (serving/router.py::fleet_snapshot): only
    # bundles captured behind the router door carry it — every older
    # bundle lacks the key and must render exactly as before.
    if bundle.get("fleet"):
        summary["fleet"] = bundle["fleet"]
    lines.append(render_flight(summary))
    return "\n".join(lines)


def _bundle_paths(path: str) -> list[str]:
    """A bundle file as-is; a directory expands to every incident_*.json
    inside, in capture order (the writer's zero-padded sequence
    numbers sort lexically)."""
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("incident_") and n.endswith(".json"))
        if not names:
            raise ValueError("no incident_*.json bundles in directory")
        return [os.path.join(path, n) for n in names]
    return [path]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render serving incident bundles (--incident-dir)")
    ap.add_argument("path", help="one incident_*.json bundle, or an "
                                 "incident directory (renders every "
                                 "bundle in capture order)")
    ap.add_argument("--json", action="store_true", default=False,
                    help="emit each bundle's summary as one JSON object")
    args = ap.parse_args(argv)
    try:
        out = []
        for p in _bundle_paths(args.path):
            bundle = load_bundle(p)
            if args.json:
                summary = summarize_flight(bundle["flight"])
                summary["alert"] = bundle["alert"]
                summary["alerts"] = bundle["alerts"]
                summary["timeseries"] = bundle["timeseries"]
                if bundle.get("fleet"):
                    summary["fleet"] = bundle["fleet"]
                out.append(json.dumps(summary))
            else:
                out.append(render(bundle))
    except (OSError, ValueError, KeyError, TypeError) as e:
        # A torn/missing bundle is an expected operational input (the
        # incident it documents may have killed the process mid-write).
        print(f"incident_report: error: {args.path}: {e}", file=sys.stderr)
        return 2
    print("\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
