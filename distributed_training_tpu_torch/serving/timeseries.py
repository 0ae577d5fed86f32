"""Telemetry time-series: a fixed-capacity, fixed-cadence sample ring.

The port of ``distributed_training_tpu/serving/timeseries.py``, unchanged (host Python).

The serving plane's existing instruments answer "what is happening right
now" (the live exporter scrapes `Engine.stats()`), "where did this
request's time go" (the latency ledger), and "what happened inside one
iteration" (traces). None of them can answer "what changed over the
last N iterations" — the question every SLO burn-rate alert and every
post-incident review starts from. This module is that history: the
engine appends one flat sample of its host-side counters and gauges at
a fixed **iteration-count** cadence (``ServeConfig.sample_every``), and
the ring answers windowed delta / rate / mean / quantile queries over
the retained tail.

Design constraints, in order:

- **Iteration cadence, never wall time.** Sampling at "every K
  iterations" makes the sample sequence — and therefore every alert
  decision derived from deterministic counters — a pure function of the
  (virtual-dt) schedule: two ``serve_bench --virtual-dt`` runs of the
  same scenario produce bitwise-identical sample indices and counter
  columns. A wall-clock cadence would make even the *number* of samples
  run-dependent. (Wall-derived columns — ledger ms totals, histogram
  bucket counts over wall latencies — ride along for operators but are
  not what the deterministic alert drill gates on.)
- **O(1) append, no allocation growth.** One list assignment per
  sample; the schema (field order) is pinned by the first append and
  every later sample is flattened into a plain ``list[float]``.
- **Bounded memory** (the flight recorder's contract): the ring holds
  ``capacity`` rows of ``len(fields)`` floats — with the engine's
  ~100-field sample and the default ``capacity=1024`` that is under a
  megabyte of host memory regardless of run length. Nothing in this
  module ever touches a device or the filesystem.

Windowed quantiles come from **histogram snapshot deltas**: the engine
samples each ``FixedHistogram``'s cumulative ``le`` bucket counts as
ordinary counter columns, so "p95 TTFT over the last W samples" is the
bucket-interpolated quantile of ``counts[t] - counts[t-W]`` — exactly
the Prometheus ``histogram_quantile(rate(...))`` idiom, computed from
the same fixed bounds.
"""

from __future__ import annotations

from typing import Any, Sequence

from distributed_training_tpu_torch.observability.histogram import FixedHistogram

FORMAT_VERSION = 1

# How many newest samples a flight dump / incident bundle / scrape
# carries: covers the default slow alert window (60 samples) with
# margin while keeping dumps a quick read. The full retained ring is
# available via TelemetryRing.to_dict(last_n=None).
TIMESERIES_DUMP_SAMPLES = 64


def hist_fields(prefix: str, bounds: Sequence[float]) -> list[str]:
    """Column names for one histogram's cumulative bucket counts:
    ``<prefix>_le_00 .. _le_<n-1>`` (one per finite bound) plus
    ``<prefix>_le_inf`` — the order :meth:`FixedHistogram.cumulative`
    emits."""
    names = [f"{prefix}_le_{i:02d}" for i in range(len(bounds))]
    names.append(f"{prefix}_le_inf")
    return names


class TelemetryRing:
    """Fixed-capacity ring of flat float samples with windowed queries.

    ``record_sample`` is the ONLY mutator, called by the engine thread
    at the iteration-cadence boundary; every other method is a read
    (the ``/timeseries`` scrape path and the alert engine run on
    reads + one engine-thread evaluation — the scrape-safety rule
    treats ``record_sample`` as telemetry mutation).
    """

    def __init__(self, capacity: int, sample_every: int):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self._fields: tuple[str, ...] | None = None
        self._index: dict[str, int] = {}
        self._rows: list[list[float] | None] = [None] * self.capacity
        self._head = 0   # next write slot
        self._count = 0  # samples ever recorded

    # -- append (engine thread only) -----------------------------------------
    def record_sample(self, sample: dict[str, float]) -> None:
        """Append one sample. The first call pins the schema; later
        calls must carry the same keys (the engine builds every sample
        from one code path, so a mismatch is a programming error)."""
        if self._fields is None:
            self._fields = tuple(sample.keys())
            self._index = {k: i for i, k in enumerate(self._fields)}
        elif len(sample) != len(self._fields):
            raise ValueError(
                f"sample schema changed: {len(sample)} fields, "
                f"expected {len(self._fields)}")
        self._rows[self._head] = [float(sample[k]) for k in self._fields]
        self._head = (self._head + 1) % self.capacity
        self._count += 1

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        return min(self._count, self.capacity)

    @property
    def fields(self) -> tuple[str, ...]:
        return self._fields or ()

    @property
    def samples_recorded_total(self) -> int:
        return self._count

    def _row(self, back: int) -> list[float]:
        """Row ``back`` samples before the newest (0 = newest). ``back``
        must be < len(self)."""
        return self._rows[(self._head - 1 - back) % self.capacity]

    def value(self, field: str, back: int = 0) -> float:
        """``field`` of the sample ``back`` positions before the newest."""
        return self._row(back)[self._index[field]]

    def window(self, field: str, window: int) -> list[float]:
        """The last ``min(window, len)`` values of ``field``, oldest
        first."""
        n = min(int(window), len(self))
        i = self._index[field]
        return [self._row(back)[i] for back in range(n - 1, -1, -1)]

    def delta(self, field: str, window: int) -> float:
        """Counter increase over the last ``window`` samples: newest
        minus the value ``window`` samples earlier (clamped to the
        oldest retained sample). 0.0 with fewer than two samples."""
        n = len(self)
        if n < 2:
            return 0.0
        back = min(int(window), n - 1)
        return self.value(field) - self.value(field, back)

    def rate(self, field: str, window: int,
             denominator: str | None = None) -> float:
        """Windowed rate of a counter: its delta per ``denominator``
        delta (e.g. shed requests per submitted request), or per sample
        when no denominator is given. A non-positive denominator delta
        yields 0.0 — no events to take a fraction of."""
        num = self.delta(field, window)
        if denominator is None:
            back = min(int(window), max(len(self) - 1, 1))
            return num / back
        den = self.delta(denominator, window)
        return num / den if den > 0 else 0.0

    def mean(self, field: str, window: int) -> float:
        """Mean of a gauge over the last ``window`` samples (clamped);
        0.0 when empty."""
        xs = self.window(field, window)
        return sum(xs) / len(xs) if xs else 0.0

    def window_quantile(self, prefix: str, bounds: Sequence[float],
                        q: float, window: int) -> float:
        """Bucket-interpolated quantile of the observations that landed
        in the last ``window`` samples, from the cumulative histogram
        columns ``hist_fields(prefix, bounds)``. 0.0 when the window saw
        no observations (an empty window cannot burn an SLO)."""
        names = hist_fields(prefix, bounds)
        cum = [self.delta(f, window) for f in names]
        hist = FixedHistogram(bounds)
        prev = 0.0
        for i, c in enumerate(cum):
            hist.counts[i] = max(int(round(c - prev)), 0)
            prev = c
        hist.total = sum(hist.counts)
        return hist.quantile(q) if hist.total else 0.0

    def to_dict(self, last_n: int | None = None) -> dict[str, Any]:
        """JSON view for dumps and the ``/timeseries`` endpoint: the
        schema, cadence, bound, and the newest ``last_n`` samples
        (oldest first; all retained samples when None). Read-only — a
        scrape copies, it never mutates."""
        n = len(self) if last_n is None else min(int(last_n), len(self))
        return {
            "format_version": FORMAT_VERSION,
            "capacity": self.capacity,
            "sample_every": self.sample_every,
            "samples_recorded_total": self._count,
            "fields": list(self.fields),
            "samples": [list(self._row(back))
                        for back in range(n - 1, -1, -1)],
        }
