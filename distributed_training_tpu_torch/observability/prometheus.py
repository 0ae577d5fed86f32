"""Prometheus text exposition of a flight snapshot.

The port of ``distributed_training_tpu/observability/prometheus.py``'s
renderer, which ``python -m distributed_training_tpu_torch.tools.
flight_report --prometheus`` prints and the live exporter's ``/metrics``
serves (``observability/exporter.py``).

The input is the dict shape :meth:`FlightRecorder.snapshot` produces —
optionally carrying the ``serving`` / ``hosts`` / ``resilience`` extra
sections the trainers and the serving engine attach. Scalar summary
fields become gauges; :class:`~distributed_training_tpu.observability.
histogram.FixedHistogram` dicts become cumulative-``le`` histogram
families (``_bucket`` + ``_sum`` + ``_count``). Non-finite metrics
arrive as ``'nan'``/``'inf'`` strings (``record_flush`` sanitization)
and are skipped — Prometheus text has no place for them.
"""

from __future__ import annotations

# The Prometheus text-format version of the exposition; the live exporter
# advertises it in the /metrics Content-Type.
TEXT_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

def prom_hist(lines: list, name: str, hist: dict,
              help_text: str) -> None:
    """One Prometheus histogram family from a FixedHistogram dict."""
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    acc = 0
    bounds = list(hist["bounds"]) + ["+Inf"]
    for bound, count in zip(bounds, hist["counts"]):
        acc += count
        le = bound if isinstance(bound, str) else f"{bound:g}"
        lines.append(f'{name}_bucket{{le="{le}"}} {acc}')
    lines.append(f"{name}_sum {hist['sum']:g}")
    lines.append(f"{name}_count {hist['count']}")


def prom_gauge(lines: list, name: str, value, help_text: str = "",
               labels: str = "") -> None:
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return  # non-finite metrics arrive as strings; a scrape skips them
    if help_text:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} gauge")
    lines.append(f"{name}{labels} {value:g}")


def prometheus_lines(snap: dict) -> list:
    """A flight snapshot as Prometheus text exposition lines — the bridge
    from flight forensics to a scraper."""
    lines: list = []
    prom_gauge(lines, "flight_steps_recorded_total",
               snap.get("steps_recorded_total", 0),
               "Steps recorded over the run")
    for k, v in (snap.get("step_time_stats") or {}).items():
        prom_gauge(lines, f"flight_{k}", v, "Ring-window step time")
    wc = snap.get("wall_clock") or {}
    if wc:
        prom_gauge(lines, "flight_goodput", wc.get("goodput"),
                   "Step share of tracked wall-time")
        phases = wc.get("phase_seconds") or {}
        if phases:
            lines.append("# HELP flight_phase_seconds Wall-clock phase "
                         "totals")
            lines.append("# TYPE flight_phase_seconds gauge")
            for ph, v in sorted(phases.items()):
                prom_gauge(lines, "flight_phase_seconds", v,
                           labels=f'{{phase="{ph}"}}')
    for name, hist in (snap.get("histograms") or {}).items():
        prom_hist(lines, f"flight_{name}", hist,
                  "Fixed-bucket run-lifetime histogram")
    srv = snap.get("serving") or {}
    for k, v in srv.items():
        if k == "histograms":
            continue
        prom_gauge(lines, f"serving_{k}", v, "Serving SLA summary field")
    for name, hist in (srv.get("histograms") or {}).items():
        prom_hist(lines, f"serving_{name}", hist,
                  "Fixed-bucket serving latency histogram")
    hosts = snap.get("hosts") or {}
    strag = hosts.get("straggler")
    if strag:
        prom_gauge(lines, "flight_straggler_host", strag["host"],
                   "Attributed straggler process index")
        prom_gauge(lines, "flight_straggler_step", strag["step"],
                   "Attributed straggler step")
        prom_gauge(lines, "flight_straggler_excess_ms",
                   strag["excess_ms"], "Straggler excess over baseline")
    res = snap.get("resilience") or {}
    for k in ("saves_committed", "saves_failed", "io_retries"):
        if k in res:
            prom_gauge(lines, f"resilience_{k}", res[k],
                       "Resilience counter")
    return lines


def prometheus_text(snap: dict) -> str:
    """The full exposition body (trailing newline included, per the
    Prometheus text-format contract)."""
    return "\n".join(prometheus_lines(snap)) + "\n"


def merge_labeled_expositions(parts: list) -> list:
    """JAX's merge, unchanged. Merge several Prometheus text expositions into ONE, injecting a
    distinguishing label on every sample — the federated ``/fleet/
    metrics`` surface (router front door) merges each replica's
    ``/metrics`` body through this with ``('replica="r0"', text)``
    pairs.

    Families are grouped: ``# HELP``/``# TYPE`` headers are emitted
    once (first writer wins), immediately before that family's samples,
    and all replicas' samples of one family sit together — the
    text-format contract scrapers rely on. Histogram samples
    (``_bucket``/``_sum``/``_count``) group under their parent family.
    The injected label is prepended to any labels a sample already
    carries.
    """
    order: list = []
    fams: dict = {}  # family -> {"headers": [...], "samples": [...]}

    def fam_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in fams:
                return name[: -len(suffix)]
        return name

    def slot(family: str) -> dict:
        if family not in fams:
            fams[family] = {"headers": [], "samples": []}
            order.append(family)
        return fams[family]

    for label, text in parts:
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                fields = line.split(" ", 3)
                if len(fields) >= 3 and fields[1] in ("HELP", "TYPE"):
                    s = slot(fields[2])
                    if line not in s["headers"]:
                        s["headers"].append(line)
                continue
            name_labels, _, value = line.rpartition(" ")
            if not name_labels:
                continue
            if "{" in name_labels:
                name, _, rest = name_labels.partition("{")
                inner = rest.rstrip("}")
                labeled = (f"{name}{{{label},{inner}}}" if inner
                           else f"{name}{{{label}}}")
            else:
                name = name_labels
                labeled = f"{name_labels}{{{label}}}"
            slot(fam_of(name))["samples"].append(f"{labeled} {value}")
    lines: list = []
    for family in order:
        lines.extend(fams[family]["headers"])
        lines.extend(fams[family]["samples"])
    return lines

