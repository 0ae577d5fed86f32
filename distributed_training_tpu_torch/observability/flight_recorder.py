"""The flight recorder: a bounded ring of per-step host timestamps.

The port of ``distributed_training_tpu/observability/flight_recorder.py``,
unchanged: the dump keeps its keys and ``FORMAT_VERSION``, so either
package's ``flight_report`` reads either's dumps.

A production trainer must explain its own failures: a NaN loss or a
straggling host otherwise surfaces as a silent divergence or a hung
barrier with zero forensics. The recorder keeps the last ``ring_size``
steps' host-side timestamps (one ``time.perf_counter()`` per step — no
device interaction whatsoever) plus every meter-flushed metrics dict, and
can render them at any moment into:

- step-time percentiles (p50 / p95 / max) over the recorded window;
- goodput: the fraction of tracked wall-time spent in the ``step`` phase
  vs ``data`` / ``log`` / ``ckpt`` / ``eval`` (from the trainers'
  :class:`~distributed_training_tpu_torch.utils.profiling.WallClock`);
- a JSON dump — written on demand (``tools/flight_report.py`` reads it),
  on anomaly trigger, or on crash.

Memory bound: the ring holds ``(int, float)`` pairs and the flush ring
holds small float dicts, so a ring of 4096 steps is a few hundred KB of
host memory regardless of run length.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any

from distributed_training_tpu_torch.observability.histogram import FixedHistogram

FORMAT_VERSION = 1


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (numpy's default method), self-
    contained so the recorder, bench, and the report tool share one
    definition. ``q`` in [0, 100]; raises on an empty input."""
    if not len(values):
        raise ValueError("percentile of empty sequence")
    xs = sorted(float(v) for v in values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class FlightRecorder:
    """Bounded ring buffer of per-step timestamps + flushed metrics."""

    def __init__(self, ring_size: int = 1024):
        if ring_size < 2:
            raise ValueError(f"ring_size must be >= 2, got {ring_size}")
        self.ring_size = ring_size
        self._steps: list[tuple[int, float] | None] = [None] * ring_size
        self._head = 0          # next write slot
        self._count = 0         # total steps ever recorded
        self._flushes: list[dict[str, Any] | None] = [None] * ring_size
        self._fhead = 0
        self._fcount = 0
        self._last_step: int | None = None
        self._last_t: float | None = None
        self._gaps: set[int] = set()  # steps whose NEXT delta is not a step
        self.anomalies: list[dict[str, Any]] = []
        # Fixed-bucket SLO histogram over the SAME gap-excluded deltas the
        # percentiles use — but unbounded by the ring: every step of the
        # run is counted, so a long run's tail is not forgotten when the
        # ring wraps (observability/histogram.py).
        self.step_hist = FixedHistogram()

    # -- recording (hot path: one list write, no device touch) --------------
    def record_step(self, step: int, t: float | None = None) -> None:
        step = int(step)
        t = time.perf_counter() if t is None else float(t)
        if (self._last_t is not None and step == self._last_step + 1
                and self._last_step not in self._gaps):
            self.step_hist.observe((t - self._last_t) * 1e3)
        self._steps[self._head] = (step, t)
        self._head = (self._head + 1) % self.ring_size
        self._count += 1
        self._last_step = step
        self._last_t = t

    def mark_gap(self) -> None:
        """Declare that non-step work (epoch boundary: eval, checkpoint,
        loader reshuffle) happens before the next recorded step — its
        delta is excluded from the step-time stats. Step NUMBERS stay
        consecutive across epochs, so the numbering heuristic in
        :meth:`step_times_ms` cannot see these pauses on its own; the
        trainers call this at each epoch start."""
        if self._last_step is not None:
            self._gaps.add(self._last_step)

    def record_flush(self, step: int, metrics: dict[str, Any]) -> None:
        entry = {"step": int(step)}
        for k, v in metrics.items():
            if k == "step" or v is None:
                continue
            f = float(v)
            # Non-finite values are the star witness of an anomaly dump —
            # but bare NaN/Infinity tokens are invalid strict JSON (jq /
            # JSON.parse choke on the forensics file). Store their repr
            # ('nan'/'inf'/'-inf') so the value survives AND parses.
            entry[k] = f if math.isfinite(f) else repr(f)
        self._flushes[self._fhead] = entry
        self._fhead = (self._fhead + 1) % self.ring_size
        self._fcount += 1

    def record_anomaly(self, step: int, reasons: list[str]) -> None:
        self.anomalies.append(
            {"step": int(step), "time": time.time(),
             "reasons": list(reasons)})

    # -- views ---------------------------------------------------------------
    def _ring_view(self, buf, head, count) -> list:
        if count < self.ring_size:
            return [e for e in buf[:count]]
        return buf[head:] + buf[:head]

    @property
    def steps(self) -> list[tuple[int, float]]:
        """Recorded (step, t) pairs, oldest first (at most ``ring_size``)."""
        return self._ring_view(self._steps, self._head, self._count)

    @property
    def flushes(self) -> list[dict[str, Any]]:
        return self._ring_view(self._flushes, self._fhead, self._fcount)

    def __len__(self) -> int:
        return min(self._count, self.ring_size)

    # -- derived stats -------------------------------------------------------
    def step_deltas_ms(self, last: int | None = None) -> list[tuple[int, float]]:
        """``(step, delta_ms)`` per consecutive recorded step pair, the
        delta attributed to the LATER step — the step-identity-aligned
        series the cross-host aggregator intersects on
        (``observability/aggregate.py``). Gap-following and non-adjacent
        pairs are excluded exactly as in :meth:`step_times_ms`. ``last``:
        only the latest ``last`` of them, read back from the newest step
        no further than they need (the aggregator's window, every flush)."""
        s = self.steps
        keep = self._gaps
        if last is None:
            return [(n1, (t1 - t0) * 1e3)
                    for (n0, t0), (n1, t1) in zip(s, s[1:])
                    if n1 == n0 + 1 and n0 not in keep]
        out: list[tuple[int, float]] = []
        for i in range(len(s) - 1, 0, -1):
            if len(out) >= last:
                break
            (n0, t0), (n1, t1) = s[i - 1], s[i]
            if n1 == n0 + 1 and n0 not in keep:
                out.append((n1, (t1 - t0) * 1e3))
        out.reverse()
        return out

    def step_times_ms(self) -> list[float]:
        """Wall-time deltas between CONSECUTIVE recorded steps, in ms.

        A pause between two recorded steps (a resume skipping batches, or
        the eval/ckpt work a :meth:`mark_gap` call declares at epoch
        boundaries) would otherwise be billed as a straggler "step";
        non-adjacent step numbers and marked gaps are dropped so the
        percentiles describe steady-state steps only.
        """
        return [dt for _, dt in self.step_deltas_ms()]

    def step_time_stats(self) -> dict[str, float]:
        """``{p50, p95, max}`` step-time ms over the ring; {} when fewer
        than two consecutive steps are recorded."""
        times = self.step_times_ms()
        if not times:
            return {}
        return {
            "step_time_p50_ms": percentile(times, 50),
            "step_time_p95_ms": percentile(times, 95),
            "step_time_max_ms": max(times),
        }

    @staticmethod
    def goodput(phase_totals: dict[str, float]) -> dict[str, Any]:
        """Wall-time accounting from the trainers' WallClock phase totals
        (exclusive attribution — see ``WallClock.phase``): ``goodput`` is
        the ``step`` share of all tracked wall-time; the breakdown names
        where the rest went (data / log / ckpt / eval)."""
        total = sum(phase_totals.values())
        if total <= 0:
            return {}
        return {
            "goodput": phase_totals.get("step", 0.0) / total,
            "tracked_seconds": total,
            "phase_seconds": {k: float(v) for k, v in phase_totals.items()},
            "phase_fraction": {k: float(v) / total
                               for k, v in phase_totals.items()},
        }

    # -- dump / load ---------------------------------------------------------
    def snapshot(self, *, reason: str = "on-demand",
                 phase_totals: dict[str, float] | None = None,
                 extra: dict[str, Any] | None = None) -> dict[str, Any]:
        """The full JSON-serializable record."""
        snap: dict[str, Any] = {
            "format_version": FORMAT_VERSION,
            "reason": reason,
            "wall_time": time.time(),
            "ring_size": self.ring_size,
            "steps_recorded_total": self._count,
            "steps": [[n, t] for n, t in self.steps],
            "gap_after_steps": sorted(self._gaps),
            "flushes": self.flushes,
            "anomalies": self.anomalies,
            "step_time_stats": self.step_time_stats(),
        }
        if self.step_hist.total:
            # Run-lifetime fixed-bucket step-time histogram (SLO view,
            # Prometheus-exportable via tools/flight_report.py).
            snap["histograms"] = {"step_time_ms": self.step_hist.to_dict()}
        if phase_totals:
            snap["wall_clock"] = self.goodput(phase_totals)
        if extra:
            snap |= extra
        return snap

    def dump(self, path: str, **snapshot_kwargs: Any) -> dict[str, Any]:
        """Write :meth:`snapshot` to ``path`` (dirs created); returns it."""
        snap = self.snapshot(**snapshot_kwargs)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            # allow_nan=False enforces the record_flush sanitization: a
            # non-finite value sneaking in through another field raises
            # HERE, not in whatever dashboard reads the dump later.
            json.dump(snap, fh, indent=1, allow_nan=False)
        os.replace(tmp, path)  # atomic: a crash mid-dump leaves no torn JSON
        return snap

    @staticmethod
    def load(path: str) -> dict[str, Any]:
        with open(path) as fh:
            snap = json.load(fh)
        if snap.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"{path}: unsupported flight-record format "
                f"{snap.get('format_version')!r} (expected {FORMAT_VERSION})")
        return snap
