"""Fixed-bucket latency histograms (Prometheus-shaped).

The port of ``distributed_training_tpu/observability/histogram.py``,
unchanged: its dict form is the flight dump's ``histograms`` section,
which both packages' report tools read.

The flight recorder's percentile() is exact but needs every sample in
memory and cannot merge across hosts or scrape windows. SLO tracking
wants the opposite trade: FIXED bucket bounds chosen once, O(buckets)
memory regardless of run length, mergeable by addition, and directly
exportable as a Prometheus histogram (cumulative ``le`` buckets +
``_sum`` + ``_count``). The derived percentiles are bucket-resolution
approximations — that is the accepted SLO-monitoring contract
(Prometheus's ``histogram_quantile`` makes the same interpolation).

One class serves step time in the flight recorder and the
``--prometheus`` exposition of ``tools/flight_report.py``.
"""

from __future__ import annotations

import bisect
from typing import Any, Sequence

# Default bounds in milliseconds: 1 ms .. 60 s, roughly log-spaced (the
# 1-2.5-5 decade pattern Prometheus examples use). Covers CPU-mesh decode
# iterations (~10-100 ms) through real checkpoint stalls (seconds).
DEFAULT_MS_BOUNDS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)


class FixedHistogram:
    """Counts of observations per fixed upper bound (+ overflow).

    ``bounds`` are inclusive upper edges (``le`` semantics); observations
    above the last bound land in the implicit +Inf bucket. Negative
    observations clamp into the first bucket (latencies cannot be
    negative; a clock glitch must not crash telemetry).
    """

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BOUNDS):
        bs = [float(b) for b in bounds]
        if not bs or any(b1 <= b0 for b0, b1 in zip(bs, bs[1:])):
            raise ValueError(
                f"bounds must be non-empty and strictly increasing: {bounds}")
        self.bounds = tuple(bs)
        self.counts = [0] * (len(bs) + 1)  # [..., +Inf]
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    # -- derived -------------------------------------------------------------
    def cumulative(self) -> list[int]:
        """Cumulative counts per bound + the +Inf total (Prometheus
        ``le`` bucket values)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile in the bounds' unit; 0.0 when
        empty. ``q`` in [0, 1]. Within a bucket the mass is assumed
        uniform (the Prometheus ``histogram_quantile`` convention); the
        +Inf bucket reports the last finite bound (no upper edge to
        interpolate toward)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.total == 0:
            return 0.0
        rank = q * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            prev, acc = acc, acc + c
            if acc >= rank and c > 0:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * (rank - prev) / c
        return self.bounds[-1]  # pragma: no cover - rank <= total always

    def merge(self, other: "FixedHistogram") -> None:
        """Add ``other``'s counts in place (cross-host / cross-window
        aggregation); bounds must match exactly."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum += other.sum

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.total, "sum": self.sum}

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "FixedHistogram":
        h = FixedHistogram(d["bounds"])
        counts = [int(c) for c in d["counts"]]
        if len(counts) != len(h.counts):
            raise ValueError(
                f"counts length {len(counts)} != bounds+1 "
                f"{len(h.counts)}")
        h.counts = counts
        h.total = int(d["count"])
        h.sum = float(d["sum"])
        return h
