"""TrainObservability: the one object both trainers drive.

The port of ``distributed_training_tpu/observability/hooks.py``. It
threads the flight instruments (MFU accounting, the flight recorder,
device-memory telemetry, anomaly detection, the cross-rank straggler
view) through a trainer loop with two touch points:

- :meth:`on_step` after every step *dispatch*: one ``perf_counter()``
  ring write. No device interaction, so the hot loop gains no sync.
- :meth:`on_flush` at every meter flush: MFU from the flush-to-flush wall
  interval (a flush is a real host fetch, so the interval brackets the
  device's time), allocator memory counters, the recorder, the
  cross-rank exchange (over gloo, ``aggregate.py``; summarised only when
  a dump reads it) and the anomaly detector over values the meter
  already fetched.

Anomaly trigger (once per run): dump the flight recorder, save the
offending batch (npz), start an ``anomaly_trace_steps``-step
``torch.profiler`` trace (``utils/profiling.trace``), and after that
window skip or raise per ``anomaly_action``. The raise is deferred to the
end of the window so the trace holds anomalous steps; every rank defers
alike (the detector's inputs are the same on every rank).

Two pieces of JAX's forensics read XLA and have no counterpart here, and
the dump says so in its ``notes``: the step's HLO text (``hooks.py``'s
``_save_hlo``) and the compiled-program count (``xla_compiles``, from the
XLA sanitizer).

It also owns the run's span trace (``observability/trace.py``), written on
:meth:`close` and on a crash, and, on rank 0 with ``metrics_port`` set,
the live exporter (``observability/exporter.py``), whose scrapes read
:meth:`scrape_snapshot`: host values only, never the card.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import numpy as np

from distributed_training_tpu_torch.observability import aggregate as aggregate_lib
from distributed_training_tpu_torch.observability.anomaly import (
    AnomalyDetector,
    AnomalyError,
)
from distributed_training_tpu_torch.observability.flight_recorder import FlightRecorder
from distributed_training_tpu_torch.observability.flops import device_peak_flops
from distributed_training_tpu_torch.observability.flops import mfu as _mfu
from distributed_training_tpu_torch.observability.memory import device_memory_metrics
from distributed_training_tpu_torch.utils.profiling import trace as profiler_trace

# What a port dump leaves out of JAX's, and why.
NOTES = ("no step HLO: the port's step is eager PyTorch, with no lowered "
         "program to dump",
         "no xla_compiles: the port compiles no XLA programs")


class TrainObservability:
    """Flight instruments for one training run (see module docstring)."""

    def __init__(self, cfg, *, step_flops: float | None = None,
                 n_devices: int = 1, clock=None, is_master: bool = True,
                 printer: Callable[[str], None] = print,
                 dump_dir: str | None = None,
                 extra_provider: Callable[[], dict] | None = None,
                 trace=None, trace_path: str | None = None,
                 num_processes: int = 1, device=None):
        """``cfg`` is a :class:`~distributed_training_tpu_torch.config.
        ObservabilityConfig`; ``step_flops`` the model FLOPs of one
        optimizer step (None → no MFU); ``clock`` the trainer's WallClock
        for goodput; ``dump_dir`` overrides ``cfg.dump_dir``;
        ``extra_provider`` supplies extra dump sections (the trainers'
        resilience counters). ``trace``/``trace_path``: the run's
        ``TraceSession`` and its file, written by :meth:`close` and the
        crash path. ``num_processes`` > 1 drives the cross-rank
        exchange at each flush: every rank must construct this object (it
        opens the gloo group) and flush at the same steps. ``device``:
        the card whose allocator the memory telemetry reads."""
        self.cfg = cfg
        self.extra_provider = extra_provider
        self.dump_dir = dump_dir or cfg.dump_dir or "./flight"
        self.is_master = is_master
        self.printer = printer
        self.clock = clock
        self.device = device
        self.trace, self.trace_path = trace, trace_path
        self._trace_saved = False
        # The run's coarse phase for /healthz (the clock's open phase wins).
        self.phase = "init"
        self.num_processes = int(num_processes)
        # The last flush's exchange: the [ranks, payload] matrix, or (one
        # process) this rank's payload parts, packed when read.
        self._gathered = None
        self.n_devices = n_devices
        self.step_flops = step_flops if cfg.mfu else None
        self.peak_flops = cfg.peak_flops if cfg.peak_flops else device_peak_flops()
        self.recorder = FlightRecorder(cfg.ring_size) if cfg.flight_recorder else None
        self.detector = (AnomalyDetector(spike_factor=cfg.grad_norm_spike_factor)
                         if cfg.anomaly_detection else None)
        self._group = (aggregate_lib.host_group()
                       if self.recorder is not None and cfg.straggler_attribution
                       and self.num_processes > 1 else None)
        self._rate_anchor: tuple[int, float] | None = None  # (step, t)
        self._trace_left = 0
        self._trace_cm = None
        self._pending_raise: AnomalyError | None = None
        self._fired = False
        self._crash_dumped = False
        # The live exporter, on rank 0 only, bound here so that a port in
        # use fails the run's start rather than its first scrape.
        self.exporter = None
        if cfg.metrics_port is not None and is_master:
            from distributed_training_tpu_torch.observability.exporter import (
                MetricsExporter,
            )

            self.exporter = MetricsExporter(
                self.scrape_snapshot, port=cfg.metrics_port, host=cfg.metrics_host,
                phase_provider=self._live_phase).start()
            self.printer(f"[observability] live metrics: {self.exporter.url('')} "
                         f"(/metrics /healthz /vars)")

    def _live_phase(self) -> str:
        """The /healthz phase: the clock's open phase, else the run's."""
        if self.clock is not None:
            ph = self.clock.current_phase
            if ph:
                return ph
        return self.phase

    def on_epoch(self) -> None:
        """Epoch boundary: the eval/ckpt/reshuffle pause before the next
        step is no straggler step and no part of the next flush's FLOPs
        rate."""
        if self.recorder is not None:
            self.recorder.mark_gap()
        self._rate_anchor = None
        self.phase = "train"

    # -- hot path ------------------------------------------------------------
    def on_step(self, step: int) -> None:
        """Record one step dispatch; drives the post-anomaly trace window."""
        t = time.perf_counter()
        if self._rate_anchor is None:
            # Anchored at the first step, not at construction, so model
            # building is not billed to the first flush's rate.
            self._rate_anchor = (step - 1, t)
        if self.recorder is not None:
            self.recorder.record_step(step, t)
        if self._trace_left > 0:
            self._trace_left -= 1
            if self._trace_left == 0:
                self._stop_trace()
                if self._pending_raise is not None:
                    err, self._pending_raise = self._pending_raise, None
                    raise err

    # -- flush boundary ------------------------------------------------------
    def on_flush(self, flushed: dict[str, Any], *, batch=None) -> dict[str, float]:
        """Augment a flushed metrics dict; returns the extra metrics for the
        sinks (mfu / model_flops_per_sec / memory). May raise
        :class:`AnomalyError` (``anomaly_action='raise'`` with
        ``anomaly_trace_steps=0``); with a trace window the raise is
        deferred to :meth:`on_step` / :meth:`close`."""
        extras: dict[str, float] = {}
        step = int(flushed.get("step", 0))
        now = time.perf_counter()
        if self.step_flops and self._rate_anchor is not None:
            a_step, a_t = self._rate_anchor
            if step > a_step and now > a_t:
                fps = self.step_flops * (step - a_step) / (now - a_t)
                extras["model_flops_per_sec"] = fps
                u = _mfu(fps, self.n_devices, self.peak_flops)
                if u is not None:
                    extras["mfu"] = u
        self._rate_anchor = (step, now)
        if self.cfg.memory_telemetry:
            extras.update(device_memory_metrics(
                None if self.device is None else [self.device]))
        if self.recorder is not None:
            self.recorder.record_flush(step, {**flushed, **extras})
            if self.cfg.straggler_attribution:
                # Every rank is at this step (the meter's interval is
                # deterministic). The payloads are exchanged here and
                # summarised only when read (host_summary), so dumps stay
                # collective-free and a flush pays no summary; one process
                # keeps its parts as host lists until then.
                window = self.cfg.straggler_window
                parts = aggregate_lib.payload_parts(self.recorder, self.clock, window)
                self._gathered = parts if self.num_processes <= 1 else (
                    aggregate_lib.gather_payloads(aggregate_lib.payload_array(parts, window),
                                                  self.num_processes, group=self._group))
        if self.detector is not None and not self._fired:
            reasons = self.detector.check(flushed)
            if reasons:
                self._trigger(step, reasons, batch=batch)
        return extras

    @property
    def host_summary(self) -> dict | None:
        """The cross-rank straggler summary of the last flush's exchange
        (``aggregate.summarize_hosts``), or None before one."""
        window = self.cfg.straggler_window
        if self._gathered is None:
            return None
        if isinstance(self._gathered, tuple):  # one process
            return aggregate_lib.summarize_hosts(
                aggregate_lib.payload_array(self._gathered, window)[None, :], window)
        return aggregate_lib.summarize_hosts(self._gathered, window)

    # -- anomaly trigger -----------------------------------------------------
    def _trigger(self, step: int, reasons: list[str], *, batch) -> None:
        self._fired = True  # one forensic capture per run
        if self.recorder is not None:
            self.recorder.record_anomaly(step, reasons)
        self.printer(f"[observability] ANOMALY at step {step}: " + "; ".join(reasons))
        tag = f"anomaly_step{step}"
        if self.is_master:
            self.dump(os.path.join(self.dump_dir, f"{tag}_flight.json"),
                      reason="anomaly: " + "; ".join(reasons))
            self._save_batch(batch, tag)
        err = AnomalyError(
            f"training anomaly at step {step}: {'; '.join(reasons)} "
            f"(forensics in {self.dump_dir})")
        if self.cfg.anomaly_trace_steps > 0:
            self._start_trace(os.path.join(self.dump_dir, f"{tag}_trace"))
            self._trace_left = self.cfg.anomaly_trace_steps
            if self.cfg.anomaly_action == "raise":
                self._pending_raise = err  # raised after the trace window
        elif self.cfg.anomaly_action == "raise":
            raise err

    def _save_batch(self, batch, tag: str) -> None:
        """The offending batch as an npz: the one deliberate device → host
        copy here, paid only on anomaly."""
        if batch is None:
            return
        try:
            arrays = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
                      for k, v in batch.items()}
            os.makedirs(self.dump_dir, exist_ok=True)
            np.savez(os.path.join(self.dump_dir, f"{tag}_batch.npz"), **arrays)
        except Exception as e:  # forensics must not mask the anomaly
            self.printer(f"[observability] batch save failed: {e}")

    def _start_trace(self, trace_dir: str) -> None:
        """A ``torch.profiler`` trace of the next steps into ``trace_dir``
        (every rank writes its own ``trace_<pid>.json``)."""
        cm = profiler_trace(trace_dir)
        try:
            cm.__enter__()
        except Exception as e:  # e.g. a profile_dir trace already running
            self.printer(f"[observability] trace capture unavailable: {e}")
            return
        self._trace_cm = cm
        self.printer(f"[observability] capturing {self.cfg.anomaly_trace_steps}-step "
                     f"profiler trace to {trace_dir}")

    def _stop_trace(self) -> None:
        cm, self._trace_cm = self._trace_cm, None
        if cm is None:
            return
        try:
            cm.__exit__(None, None, None)
        except Exception as e:  # pragma: no cover - profiler quirk
            self.printer(f"[observability] trace stop failed: {e}")

    # -- dumps / lifecycle ---------------------------------------------------
    def _dump_sections(self) -> tuple[dict | None, dict]:
        """``(phase_totals, extra)``: lifetime clock totals, the trainers'
        extra sections, the flush-cached cross-rank summary and the notes
        on what a port dump leaves out. Host values only."""
        totals = self.clock.snapshot() if self.clock is not None else None
        # Dicts merge with ``|=``, never ``.update``: the lint resolves a
        # method call by its name alone, and ``update`` is the optimizer's.
        extra: dict = {}
        if self.extra_provider is not None:
            try:
                extra |= self.extra_provider()
            except Exception as e:  # forensics must not mask the dump
                self.printer(f"[observability] extra dump section failed: {e}")
        if self._gathered is not None:
            extra["hosts"] = self.host_summary
        extra["notes"] = list(NOTES)
        return totals, extra

    def scrape_snapshot(self) -> dict:
        """What a ``/metrics`` or ``/vars`` scrape serves: :meth:`dump`'s
        record, never written. With the recorder off, the goodput and the
        extra sections alone."""
        totals, extra = self._dump_sections()
        if self.recorder is not None:
            return self.recorder.snapshot(reason="scrape", phase_totals=totals,
                                          extra=extra)
        snap: dict = {"reason": "scrape", "steps_recorded_total": 0}
        if totals:
            snap["wall_clock"] = FlightRecorder.goodput(totals)
        snap |= extra
        return snap

    def save_trace(self) -> str | None:
        """Write the span trace to ``trace_path`` once; returns the path,
        or None with tracing off."""
        if self.trace is None or self.trace_path is None:
            return None
        if not self._trace_saved:
            self.trace.save(self.trace_path)
            # Set only after the write: a failed crash-path save leaves
            # close() to try again.
            self._trace_saved = True
            self.printer(f"[observability] trace: {self.trace_path} "
                         f"({len(self.trace)} events)")
        return self.trace_path

    def dump(self, path: str | None = None, reason: str = "on-demand") -> str | None:
        """Write the flight record to ``path`` (default
        ``dump_dir/flight.json``); returns the path, or None when the
        recorder is off."""
        if self.recorder is None:
            return None
        if path is None:
            path = os.path.join(self.dump_dir, "flight.json")
        totals, extra = self._dump_sections()
        self.recorder.dump(path, reason=reason, phase_totals=totals, extra=extra)
        return path

    def on_crash(self) -> None:
        """Crash-path dump; swallows its own errors (the original
        exception must surface, not a forensics failure)."""
        if self._crash_dumped or self.recorder is None or not self.is_master:
            return
        self._crash_dumped = True
        try:
            path = self.dump(os.path.join(self.dump_dir, "flight_crash.json"),
                             reason="crash")
            self.printer(f"[observability] crash flight record: {path}")
        except Exception as e:
            self.printer(f"[observability] crash dump failed: {e}")
        try:
            self.save_trace()  # the timeline up to the crash
        except Exception as e:
            self.printer(f"[observability] crash trace save failed: {e}")

    def close(self, raise_pending: bool = True) -> None:
        """Idempotent teardown: stop the live exporter and a dangling
        anomaly trace; write the span trace; surface a deferred raise whose
        trace window the run's end cut short."""
        self.phase = "done"
        if self.exporter is not None:
            self.exporter.close()
        self._trace_left = 0
        self._stop_trace()
        try:
            self.save_trace()
        except Exception as e:  # teardown must not mask the run's outcome
            self.printer(f"[observability] trace save failed: {e}")
        if raise_pending and self._pending_raise is not None:
            err, self._pending_raise = self._pending_raise, None
            raise err
        self._pending_raise = None
