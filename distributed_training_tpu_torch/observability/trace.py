"""Span-level event tracing, exported as Chrome/Perfetto trace JSON.

The port of ``distributed_training_tpu/observability/trace.py``. The
flight recorder says how fast on average; this module says what each
component did when: a timeline of the step loop, the checkpoint writer
and the chaos injections, which Perfetto and chrome://tracing open.

- :class:`TraceSession` buffers events in host memory (a bounded list of
  small dicts; nothing here touches the device) and exports the Chrome
  ``trace_event`` JSON object format, the same file as JAX's, so either
  package's ``trace_report`` reads the other's traces.
- **Tracks** are (pid, tid) lanes: pid is the rank, tid a named lane
  ("train", "ckpt-writer", "chaos"), emitted as ``M`` metadata events.
- **Spans** are complete events (``ph: "X"``, ``ts`` and ``dur``): a crash
  mid-span loses that span and never unbalances the file.
- **Instant events** (``ph: "i"``) mark point faults; **counter samples**
  (``ph: "C"``) plot series.

Spans read the host's clock only and never synchronise the card. PyTorch
returns from a kernel launch before the card runs it, so a span around a
train step times the step's dispatch, as JAX's spans around an
asynchronously dispatched step do; the card's time lands where the host
next waits for it (the meter's flush).

Off by default: every integration point holds ``trace: TraceSession |
None``, and with None no span runs. When on, a span costs two
``perf_counter`` reads and one list append under a lock. Timestamps are
``time.perf_counter()`` seconds, the flight recorder's clock; the file's
``ts`` are microseconds after the session's start.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any

# One JSON object per file (not the bare-array variant): it carries
# displayTimeUnit and metadata beside the events.
TRACE_FORMAT = "chrome-trace-events"


class TraceSession:
    """In-memory span and event buffer for one process.

    >>> tr = TraceSession(pid=0, process_name="rank 0 train")
    >>> with tr.span("step", track="train", step=12):
    ...     ...
    >>> tr.instant("chaos.slow_step", track="train", step=12)
    >>> tr.counter("queue_depth", 3, track="engine")
    >>> tr.save("trace.json")

    Thread-safe: the checkpoint writer and the loaders' threads append
    beside the step loop (one lock around the buffer). At ``max_events``
    new events are dropped and counted (``dropped_events`` in the file):
    a trace must not exhaust the host it describes.
    """

    def __init__(self, *, pid: int = 0, process_name: str | None = None,
                 max_events: int = 500_000):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.pid = int(pid)
        self.process_name = process_name or f"process {pid}"
        self.max_events = int(max_events)
        self._t0 = time.perf_counter()
        self._wall_t0 = time.time()
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._tracks: dict[str, int] = {}
        self._dropped = 0

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        """The session's clock (``perf_counter`` seconds)."""
        return time.perf_counter()

    def _ts(self, t: float) -> float:
        """``perf_counter`` seconds → Chrome µs after the session's start."""
        return (t - self._t0) * 1e6

    # -- tracks --------------------------------------------------------------
    def track(self, name: str) -> int:
        """The tid of ``name`` (registered on first use)."""
        with self._lock:
            tid = self._tracks.get(name)
            if tid is None:
                tid = len(self._tracks)
                self._tracks[name] = tid
            return tid

    # -- emission ------------------------------------------------------------
    def _append(self, ev: dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(ev)

    def complete(self, name: str, t_start: float, t_end: float, *,
                 track: str = "main", **attrs: Any) -> None:
        """One complete span between two ``perf_counter`` readings (for a
        span whose start predates the point that emits it)."""
        ev: dict[str, Any] = {
            "name": name, "ph": "X", "ts": self._ts(t_start),
            "dur": max((t_end - t_start) * 1e6, 0.0),
            "pid": self.pid, "tid": self.track(track),
        }
        if attrs:
            ev["args"] = attrs
        self._append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, track: str = "main", **attrs: Any):
        """One complete span around the body."""
        t_start = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t_start, time.perf_counter(),
                          track=track, **attrs)

    def instant(self, name: str, *, track: str = "main",
                t: float | None = None, **attrs: Any) -> None:
        ev: dict[str, Any] = {
            "name": name, "ph": "i",
            "ts": self._ts(time.perf_counter() if t is None else t),
            "pid": self.pid, "tid": self.track(track), "s": "t",
        }
        if attrs:
            ev["args"] = attrs
        self._append(ev)

    def counter(self, name: str, value: float, *, track: str = "counters",
                t: float | None = None) -> None:
        self._append({
            "name": name, "ph": "C",
            "ts": self._ts(time.perf_counter() if t is None else t),
            "pid": self.pid, "tid": self.track(track),
            "args": {name: float(value)},
        })

    # -- export --------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_json(self) -> dict[str, Any]:
        """The Chrome trace object, events sorted by ``ts`` (so every (pid,
        tid) lane is in time order)."""
        with self._lock:
            events = sorted(self._events, key=lambda e: e["ts"])
            tracks = dict(self._tracks)
            dropped = self._dropped
        meta: list[dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "ts": 0.0, "args": {"name": self.process_name},
        }]
        for name, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": self.pid,
                "tid": tid, "ts": 0.0, "args": {"name": name},
            })
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "format": TRACE_FORMAT,
                "wall_time_origin": self._wall_t0,
                "dropped_events": dropped,
            },
        }

    def save(self, path: str) -> str:
        """Write the trace to ``path`` (directories created; a temporary
        name and an atomic rename, so a crash mid-write leaves no torn
        file); returns ``path``. The temporary name is the calling
        thread's own: a front door's handler threads checkpoint one trace
        at once, and a shared name would let one rename another's file
        away."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_json(), fh, allow_nan=False)  # graftlint: disable=scrape-safety -- json.dump serializes to a file handle; it mutates no recorder (the rule's name list means telemetry dump hooks)
        os.replace(tmp, path)
        return path

    def checkpoint(self, path: str) -> str:
        """:meth:`save` under the name JAX's request handlers call it by."""
        return self.save(path)


def session_for_run(cfg, *, default_dir: str, component: str = "train",
                    rank: int = 0, world: int = 1
                    ) -> tuple["TraceSession | None", str | None]:
    """``(session, output_path)`` for a ``config.TraceConfig``, or ``(None,
    None)`` when it is off. The pid is the rank; one rank writes
    ``trace.json``, several write ``trace_p<rank>.json`` each (JAX names
    them by process index); ``cfg.dir`` None resolves to
    ``<default_dir>/trace``."""
    if not cfg.enabled:
        return None, None
    session = TraceSession(pid=rank, process_name=f"host {rank} {component}",
                           max_events=cfg.max_events)
    d = cfg.dir or os.path.join(default_dir, "trace")
    fname = "trace.json" if world == 1 else f"trace_p{rank}.json"
    return session, os.path.join(d, fname)


def session_for_cli(enabled: bool, trace_dir: str, component: str
                    ) -> tuple["TraceSession | None", str | None]:
    """``(session, output_path)`` for a CLI's ``--trace``/``--trace-dir``:
    a ``TraceConfig``'s validation and ``max_events``, the file
    ``<trace_dir>/<component>_trace.json``."""
    if not enabled:
        return None, None
    from distributed_training_tpu_torch.config import TraceConfig

    cfg = TraceConfig(enabled=True, dir=trace_dir)
    session = TraceSession(process_name=component, max_events=cfg.max_events)
    return session, os.path.join(cfg.dir, f"{component}_trace.json")


def fleet_session(component: str, trace_dir: str | None, *,
                  max_events: int | None = None
                  ) -> tuple["TraceSession | None", str | None]:
    """``(session, output_path)`` for one participant of a fleet (a
    ``serve_net`` replica or the router's front door), or ``(None, None)``
    when ``trace_dir`` is empty.

    As JAX's: the session's pid is the process's real ``os.getpid()``, so a
    replica killed and its successor land on two lanes, and the file is
    ``<trace_dir>/<component>_pid<pid>_trace.json``, so a restart never
    overwrites the dead process's file. ``tools/fleet_trace.py`` aligns
    the files by each session's ``wall_time_origin`` and the door's and
    replica's ``hop.send``/``hop.recv`` instants.
    """
    if not trace_dir:
        return None, None
    from distributed_training_tpu_torch.config import TraceConfig

    cfg = TraceConfig(enabled=True, dir=trace_dir,
                      **({} if max_events is None else {"max_events": max_events}))
    pid = os.getpid()
    session = TraceSession(pid=pid, process_name=f"{component} pid {pid}",
                           max_events=cfg.max_events)
    return session, os.path.join(cfg.dir, f"{component}_pid{pid}_trace.json")


def load_trace(path: str) -> dict[str, Any]:
    """Load and check a trace file (:meth:`TraceSession.save`'s, or any
    Chrome trace object); raises ``ValueError`` naming the first malformed
    event."""
    with open(path) as fh:
        obj = json.load(fh)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace object "
                         "(missing 'traceEvents')")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' is not a list")
    for i, ev in enumerate(events):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(
                    f"event {i} missing required key {key!r}: {ev}")
    return obj
