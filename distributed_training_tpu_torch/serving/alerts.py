"""SLO burn-rate alerting + incident capture over the telemetry ring.

The port of ``distributed_training_tpu/serving/alerts.py``, unchanged (host
Python): both packages' engines sample the same columns, so one rule set
gives one alert log.

The classic SRE shape (multi-window, multi-burn-rate alerting), restated
for a deterministic serving engine: declarative :class:`SLORule`\\ s are
evaluated every time the engine appends a sample to its
:class:`~distributed_training_tpu_torch.serving.timeseries.TelemetryRing`,
and an alert fires only when BOTH a fast window (default 5 samples) and
a slow window (default 60 samples) burn past the objective — the fast
window gives detection latency, the slow window immunity to one-sample
blips. Hysteresis clears: a firing alert stands until the fast window
drops back under ``objective × clear_ratio``.

Determinism contract (what the CI alert drill gates): evaluation
happens at the ring's **iteration-count** cadence and every decision is
arithmetic over sampled values — no wall clock, no RNG, no thread
timing. A rule over schedule-deterministic columns (shed/timeout
counts, queue depth, conservation violations) therefore produces a
bitwise-identical alert log across two ``serve_bench --virtual-dt``
runs of the same scenario. Rules over wall-derived columns (windowed
TTFT/TPOT quantiles, ledger ms) alert correctly but are calibrated, not
bitwise — the default objectives are generous enough that healthy
baseline workloads provably never fire (the zero-false-positive pin).

Three rule kinds, inferred from the clause:

- **gauge** — windowed mean of a sampled gauge (queue depth, pool
  occupancy) or a derived windowed quantile (``ttft_window_p95_ms``:
  bucket-interpolated over the window's histogram-count deltas);
- **rate** — counter delta per denominator delta over the window
  (``requests_shed/requests_submitted``);
- **zero-tolerance counter** (``objective == 0``) — any increase over
  the fast window fires immediately (conservation violations, journal
  write errors); these evaluate from the second sample on, while
  burn-rate rules wait for a full slow window (no data, no alert).

Incident capture: when a rule fires the engine builds ONE bundled
snapshot (the firing event + the last time-series window + the full
flight snapshot with ``ledger_top``) and enqueues it here; a dedicated
writer thread (the journal writer-thread discipline) performs the
atomic disk write off the hot path, so ``Engine.step``'s call graph
never reaches ``open()``/``fsync`` and the graftlint hot-path rule
stays clean. At most :data:`MAX_INCIDENTS` bundles per process —
incident storms must not fill a disk.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import re
import threading
from dataclasses import dataclass
from typing import Any

from distributed_training_tpu_torch.observability.histogram import (
    DEFAULT_MS_BOUNDS,
)
from distributed_training_tpu_torch.serving.timeseries import TelemetryRing

FORMAT_VERSION = 1

# Derived window-quantile metrics: name -> (histogram column prefix, q).
# The engine samples each histogram's cumulative bucket counts, so these
# are quantiles over exactly the window's observations.
DERIVED_QUANTILES: dict[str, tuple[str, float]] = {
    "ttft_window_p50_ms": ("ttft_ms", 0.50),
    "ttft_window_p95_ms": ("ttft_ms", 0.95),
    "ttft_window_p99_ms": ("ttft_ms", 0.99),
    "tpot_window_p50_ms": ("tpot_ms", 0.50),
    "tpot_window_p95_ms": ("tpot_ms", 0.95),
    "tpot_window_p99_ms": ("tpot_ms", 0.99),
}

# Bounded evidence: an alert storm must not grow the log without limit
# (events past the cap are counted, not stored) nor fill a disk with
# bundles.
MAX_LOG_EVENTS = 256
MAX_INCIDENTS = 8


@dataclass(frozen=True)
class SLORule:
    """One declarative SLO rule.

    ``metric > objective`` sustained over both windows fires the alert:
    burn means ``value > objective * burn_threshold`` (for the
    zero-tolerance ``objective == 0``: ``value > 0``). ``denominator``
    turns the metric into a windowed rate (delta/delta). ``clear_ratio``
    is the hysteresis band: a firing alert clears only once the fast
    window drops to ``objective * clear_ratio`` or below.
    """

    name: str
    metric: str
    objective: float
    denominator: str | None = None
    fast_window: int = 5
    slow_window: int = 60
    burn_threshold: float = 1.0
    clear_ratio: float = 0.9

    def __post_init__(self) -> None:
        if not re.fullmatch(r"[A-Za-z0-9_.-]+", self.name):
            raise ValueError(f"bad rule name {self.name!r}")
        if self.objective < 0:
            raise ValueError(
                f"rule {self.name}: objective must be >= 0, "
                f"got {self.objective}")
        if not 1 <= self.fast_window <= self.slow_window:
            raise ValueError(
                f"rule {self.name}: need 1 <= fast_window <= "
                f"slow_window, got {self.fast_window},{self.slow_window}")
        if self.burn_threshold <= 0:
            raise ValueError(
                f"rule {self.name}: burn_threshold must be > 0")
        if not 0.0 <= self.clear_ratio <= 1.0:
            raise ValueError(
                f"rule {self.name}: clear_ratio must be in [0, 1]")
        if self.denominator is not None and self.objective == 0:
            raise ValueError(
                f"rule {self.name}: a zero-tolerance rule takes a bare "
                f"counter, not a rate")

    @property
    def zero_tolerance(self) -> bool:
        return self.objective == 0.0

    def window_value(self, ring: TelemetryRing, window: int) -> float:
        if self.metric in DERIVED_QUANTILES:
            prefix, q = DERIVED_QUANTILES[self.metric]
            return ring.window_quantile(prefix, DEFAULT_MS_BOUNDS, q,
                                        window)
        if self.denominator is not None:
            return ring.rate(self.metric, window, self.denominator)
        if self.zero_tolerance:
            return ring.delta(self.metric, window)
        return ring.mean(self.metric, window)

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "metric": self.metric,
            "objective": self.objective,
            "denominator": self.denominator,
            "fast_window": self.fast_window,
            "slow_window": self.slow_window,
            "burn_threshold": self.burn_threshold,
            "clear_ratio": self.clear_ratio,
        }


def default_rules() -> list[SLORule]:
    """The shipped rule set (``--slo-rules default``): latency SLOs with
    objectives generous enough that a healthy CPU-mesh smoke never
    fires (zero-false-positive pin), plus the zero-tolerance invariant
    watchers that should fire on ANY violation."""
    return [
        SLORule("ttft_p95", "ttft_window_p95_ms", 5000.0),
        SLORule("tpot_p95", "tpot_window_p95_ms", 1000.0),
        SLORule("shed_rate", "requests_shed", 0.05,
                denominator="requests_submitted"),
        SLORule("timeout_rate", "requests_timed_out", 0.05,
                denominator="requests_submitted"),
        SLORule("pool_pressure", "pool_occupancy", 0.98),
        SLORule("ledger_conservation",
                "ledger_conservation_violations", 0.0),
        SLORule("journal_write_errors", "journal_write_errors", 0.0),
    ]


# Clause grammar (';'-separated; 'default' expands the shipped set):
#   name:metric[/denominator]>objective[@fast,slow][xBURN][~CLEAR]
# e.g. "shed:requests_shed/requests_submitted>0.05@3,9x1.0~0.5"
_CLAUSE_RE = re.compile(
    r"^(?P<name>[A-Za-z0-9_.-]+):(?P<metric>[A-Za-z0-9_]+)"
    r"(?:/(?P<den>[A-Za-z0-9_]+))?>(?P<obj>[0-9eE.+-]+)"
    r"(?:@(?P<fast>\d+),(?P<slow>\d+))?"
    r"(?:x(?P<burn>[0-9.]+))?(?:~(?P<clear>[0-9.]+))?$")


def parse_slo_rules(spec: str) -> list[SLORule]:
    """Parse a ``--slo-rules`` value into rules. Raises ``ValueError``
    with a one-line message on any malformed clause (the CLIs surface
    it before the engine runs)."""
    rules: list[SLORule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause == "default":
            rules.extend(default_rules())
            continue
        m = _CLAUSE_RE.match(clause)
        if m is None:
            raise ValueError(
                f"bad SLO rule clause {clause!r} (expected "
                f"name:metric[/den]>objective[@fast,slow][xBURN][~CLEAR] "
                f"or 'default')")
        rules.append(SLORule(
            name=m["name"], metric=m["metric"],
            objective=float(m["obj"]), denominator=m["den"],
            fast_window=int(m["fast"]) if m["fast"] else 5,
            slow_window=int(m["slow"]) if m["slow"] else 60,
            burn_threshold=float(m["burn"]) if m["burn"] else 1.0,
            clear_ratio=float(m["clear"]) if m["clear"] else 0.9))
    names = [r.name for r in rules]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate SLO rule name(s): {sorted(dupes)}")
    return rules


class AlertEngine:
    """Evaluates the rule set at sample cadence; owns the alert log.

    One mutating caller ever: the engine thread's sample boundary calls
    :meth:`evaluate` right after the ring append. Everything else
    (scrapes, reports) reads :meth:`to_dict`. The log, the counters and
    each rule's active state describe PROCESS history — ``Engine.
    reset_stats`` carries this object across window resets untouched
    (the ``requests_recovered`` precedent: a warm-up reset must not
    erase a fired alert).
    """

    def __init__(self, rules: list[SLORule]):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule name(s) in {names}")
        self.rules = list(rules)
        self.fired = 0
        self.cleared = 0
        self.log: list[dict[str, Any]] = []
        self.log_dropped = 0
        self._active: set[str] = set()

    @property
    def active(self) -> list[str]:
        """Names of currently-firing rules, sorted (deterministic)."""
        return sorted(self._active)

    def _append(self, event: dict[str, Any]) -> None:
        if len(self.log) >= MAX_LOG_EVENTS:
            self.log_dropped += 1
            return
        self.log.append(event)

    def evaluate(self, ring: TelemetryRing,
                 iteration: int) -> list[dict[str, Any]]:
        """Evaluate every rule against the ring's newest sample; returns
        the FIRE events born this evaluation (the engine captures one
        incident per returned event). Raises ``ValueError`` on a rule
        naming a metric the ring does not sample — fail fast, at the
        first evaluation, not silently never."""
        n = len(ring)
        fired_now: list[dict[str, Any]] = []
        for rule in self.rules:
            if rule.metric not in DERIVED_QUANTILES \
                    and rule.metric not in ring.fields:
                raise ValueError(
                    f"SLO rule {rule.name!r}: unknown metric "
                    f"{rule.metric!r} (sampled fields: "
                    f"{', '.join(ring.fields)})")
            if rule.zero_tolerance:
                if n < 2:
                    continue
            elif n < rule.slow_window + 1:
                continue  # no full slow window: no data, no alert
            fast = rule.window_value(ring, rule.fast_window)
            slow = rule.window_value(ring, rule.slow_window)
            threshold = rule.objective * rule.burn_threshold
            burning = ((fast > 0 and slow > 0) if rule.zero_tolerance
                       else (fast > threshold and slow > threshold))
            if rule.name not in self._active:
                if burning:
                    self._active.add(rule.name)
                    self.fired += 1
                    event = {
                        "event": "fire", "rule": rule.name,
                        "metric": rule.metric,
                        "iteration": int(iteration),
                        "sample": ring.samples_recorded_total,
                        "value_fast": fast, "value_slow": slow,
                        "objective": rule.objective,
                        "burn_threshold": rule.burn_threshold,
                    }
                    self._append(event)
                    fired_now.append(event)
            elif fast <= rule.objective * rule.clear_ratio:
                self._active.discard(rule.name)
                self.cleared += 1
                self._append({
                    "event": "clear", "rule": rule.name,
                    "metric": rule.metric,
                    "iteration": int(iteration),
                    "sample": ring.samples_recorded_total,
                    "value_fast": fast, "value_slow": slow,
                    "objective": rule.objective,
                    "burn_threshold": rule.burn_threshold,
                })
        return fired_now

    def to_dict(self) -> dict[str, Any]:
        """JSON view for dumps, the ``/alerts`` endpoint and
        ``--alert-log-out``. Pure arithmetic over deterministic state —
        two virtual-dt runs of the same deterministic workload+rules
        serialize bitwise-identically."""
        return {
            "format_version": FORMAT_VERSION,
            "rules": [r.to_dict() for r in self.rules],
            "fired": self.fired,
            "cleared": self.cleared,
            "active": self.active,
            "log_dropped": self.log_dropped,
            "log": [dict(e) for e in self.log],
        }


class IncidentWriter:
    """Background atomic writer of incident bundles (one per fire).

    The engine thread calls :meth:`capture` with a fully materialized
    bundle dict — building the dict is host-side arithmetic; the disk
    write happens on this writer thread (the journal writer-thread
    discipline), so the hot path never opens a file. ``captured`` is
    incremented at enqueue time on the engine thread, which keeps the
    ``incidents_captured`` stat a deterministic function of the
    schedule; ``write_errors`` counts wall-world failures (monitored,
    never raised into the serving loop).
    """

    def __init__(self, incident_dir: str,
                 max_incidents: int = MAX_INCIDENTS):
        self.incident_dir = str(incident_dir)
        self.max_incidents = int(max_incidents)
        self.captured = 0
        self.dropped = 0
        self.write_errors = 0
        self.paths: list[str] = []
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._thread = threading.Thread(
            target=self._writer_loop, name="incident-writer", daemon=True)
        self._thread.start()

    def capture(self, rule_name: str, bundle: dict[str, Any]) -> bool:
        """Enqueue one bundle (engine thread; no I/O). Returns False —
        and counts a drop — past the per-process cap."""
        if self.captured >= self.max_incidents:
            self.dropped += 1
            return False
        seq = self.captured
        self.captured += 1
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", rule_name)
        path = os.path.join(self.incident_dir,
                            f"incident_{seq:03d}_{safe}.json")
        self.paths.append(path)
        self._q.put((path, bundle))
        return True

    def _write_bundle(self, path: str, bundle: dict[str, Any]) -> None:
        os.makedirs(self.incident_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            # allow_nan=False: the bundle's flight section is already
            # sanitized the way dumps are; anything non-finite sneaking
            # in fails HERE (counted), not in the renderer.
            json.dump(bundle, fh, indent=1, allow_nan=False)
        os.replace(tmp, path)  # atomic: no torn bundle on crash

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write_bundle(*item)
            except (OSError, ValueError):
                self.write_errors += 1

    def shutdown(self) -> None:
        """Flush queued bundles and stop the writer (idempotent)."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=10.0)
        # Anything still queued (writer died / raced the sentinel):
        # best-effort synchronous drain so a short bench run's bundle
        # always lands before the process exits.
        while True:
            try:
                item = self._q.get_nowait()
            except queue_mod.Empty:
                return
            if item is None:
                continue
            try:
                self._write_bundle(*item)
            except (OSError, ValueError):
                self.write_errors += 1
