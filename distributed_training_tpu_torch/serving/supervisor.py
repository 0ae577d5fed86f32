"""Replica supervision: restart-with-journal fleet fault tolerance.

The port of ``distributed_training_tpu/serving/supervisor.py``, unchanged
(it holds subprocess handles and speaks HTTP; no engine, no device).

The round-22 front door made the engine a multi-replica service; this
module adds the layer every production fleet assumes (vLLM/DistServe
deployments run under systemd/k8s equivalents): something that OWNS
the replica processes, notices when one dies or wedges, and brings it
back — with its ``--journal-dir``, so the round-17 recovery replay
runs before the port reopens and the replica rejoins the fleet with
every accepted request intact.

Detection is two-channel:

- **death** — ``proc.poll()`` (the waitpid channel) catches a SIGKILL
  or crash immediately; a run of consecutive failed ``/healthz``
  probes catches a process that is technically alive but no longer
  accepting connections.
- **wedge** — a replica whose HTTP plane answers but whose serve loop
  stopped advancing (deadlocked engine thread, hung dispatch). The
  frontend exports a per-pass ``serve_loop_heartbeat`` epoch on
  ``/healthz``; a reachable replica whose heartbeat is FROZEN for
  ``wedge_timeout_s`` is force-killed (SIGKILL — a wedged process
  ignores SIGTERM by definition) and restarted.

Restarts are bounded (``max_restarts`` per replica — a crash-looping
replica eventually stays down and the router's circuit breaker keeps
traffic off it) with bounded exponential backoff between consecutive
restarts of the SAME replica. Counters are deterministic functions of
the fault schedule: one injected SIGKILL is exactly one death, one
restart — the CI failover drill pins them bitwise across kill cycles.

The supervisor never touches an Engine, a device, or a trie: it holds
subprocess handles and talks HTTP. ``spawn_fn(index)`` returns a
handle exposing ``proc`` (a Popen), ``url``, ``name`` and ``stop()``;
the handle's constructor must block until the replica printed its
port line — which the serve_net replica prints only AFTER
``engine.recover()`` returned, so "recovery replays before the port
reopens" holds by construction.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable

# Consecutive failed /healthz probes on an ALIVE process before it is
# declared unreachable and force-restarted (one flaky probe must not
# bounce a healthy replica).
PROBE_FAILURE_THRESHOLD = 3


class ReplicaSupervisor:
    """Owns ``count`` replica processes spawned via ``spawn_fn``.

    >>> sup = ReplicaSupervisor(lambda i: ReplicaProc(i, args), 2)
    >>> sup.start()          # spawns all replicas, starts the monitor
    >>> sup.kill(0)          # chaos: SIGKILL; the monitor restarts it
    >>> sup.stop()           # stops monitoring AND the replicas

    ``on_restart(index, handle)`` runs after every successful restart
    (the serve_net wiring points the router's ``HttpReplica.url`` at
    the replacement port there). ``wedge_timeout_s=None`` disables the
    wedge detector.
    """

    def __init__(self, spawn_fn: Callable[[int], Any], count: int, *,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 max_restarts: int = 5,
                 backoff_base_s: float = 0.25,
                 backoff_max_s: float = 5.0,
                 wedge_timeout_s: float | None = None,
                 on_restart: Callable[[int, Any], None] | None = None,
                 trace=None):
        if count < 1:
            raise ValueError("supervisor needs at least one replica")
        # Optional TraceSession: death/wedge detections and restart
        # completions land as instants on the supervisor's own lane of
        # the door-process trace, so the merged fleet timeline shows
        # the supervision cause between a victim's last span and its
        # successor's first. None (default) keeps the monitor span-free.
        self.trace = trace
        self._spawn_fn = spawn_fn
        self._count = int(count)
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self.max_restarts = int(max_restarts)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._wedge_timeout_s = (None if wedge_timeout_s is None
                                 else float(wedge_timeout_s))
        self._on_restart = on_restart
        self.handles: list[Any] = []
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._monitor, name="replica-supervisor", daemon=True)
        # Deterministic fault accounting (the CI drill pins these
        # bitwise across independent kill cycles).
        self.replica_restarts = 0
        self.restarts_by_replica = [0] * self._count
        self.deaths_detected = 0
        self.wedged_kills = 0
        self.kills_injected = 0
        self.gave_up = [False] * self._count
        # Probe bookkeeping (per replica): consecutive failures, last
        # observed heartbeat epoch + when it last ADVANCED.
        self._probe_failures = [0] * self._count
        self._beat = [-1] * self._count
        self._beat_t = [0.0] * self._count

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        """Spawn every replica (sequential, index order — deterministic
        port/journal assignment) and start the monitor thread."""
        if self.handles:
            return self
        self.handles = [self._spawn_fn(i) for i in range(self._count)]
        now = time.monotonic()
        for i in range(self._count):
            self._beat_t[i] = now
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop monitoring, then stop the replicas (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        for h in self.handles:
            try:
                h.stop()
            except Exception:
                pass  # already dead is fine — that's the business here

    # -- chaos ---------------------------------------------------------------
    def kill(self, index: int) -> None:
        """SIGKILL a replica (the drill's fault injection handle). The
        monitor detects the death and restarts it like any crash."""
        with self._lock:
            self.kills_injected += 1
        self.handles[index].proc.kill()

    # -- observability -------------------------------------------------------
    def supervisor_snapshot(self) -> dict[str, Any]:
        """Read-only counter view (host ints under one lock) — merged
        into the serve_net SLA row and the drill's bitwise gate."""
        with self._lock:
            return {
                "replica_restarts": self.replica_restarts,
                "restarts_by_replica": list(self.restarts_by_replica),
                "deaths_detected": self.deaths_detected,
                "wedged_kills": self.wedged_kills,
                "kills_injected": self.kills_injected,
                "gave_up": list(self.gave_up),
            }

    # -- monitor thread ------------------------------------------------------
    def _monitor(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            for i in range(self._count):
                if self.gave_up[i]:
                    continue
                if self.handles[i].proc.poll() is not None:
                    with self._lock:
                        self.deaths_detected += 1
                    if self.trace is not None:
                        self.trace.instant(
                            "replica.death", track="supervisor",
                            replica=i,
                            pid=int(self.handles[i].proc.pid))
                    self._restart(i)
                    continue
                self._probe(i)
            time.sleep(self._probe_interval_s)

    def _probe(self, i: int) -> None:
        """One /healthz probe: liveness + the wedge detector's
        heartbeat-advance check."""
        h = self.handles[i]
        try:
            with urllib.request.urlopen(
                    h.url.rstrip("/") + "/healthz",
                    timeout=self._probe_timeout_s) as resp:
                payload = json.loads(resp.read())
        except Exception:
            self._probe_failures[i] += 1
            if self._probe_failures[i] >= PROBE_FAILURE_THRESHOLD:
                # Alive but unreachable: force the waitpid channel.
                with self._lock:
                    self.deaths_detected += 1
                h.proc.kill()
                h.proc.wait()
                self._restart(i)
            return
        self._probe_failures[i] = 0
        beat = int(payload.get("serve_loop_heartbeat", -1))
        now = time.monotonic()
        if beat != self._beat[i]:
            self._beat[i] = beat
            self._beat_t[i] = now
        elif (self._wedge_timeout_s is not None
              and now - self._beat_t[i] > self._wedge_timeout_s):
            # Reachable, answering, NOT progressing: wedged. SIGKILL
            # (a wedged serve loop won't run atexit anyway) + restart.
            with self._lock:
                self.wedged_kills += 1
            if self.trace is not None:
                self.trace.instant("replica.wedged", track="supervisor",
                                   replica=i, pid=int(h.proc.pid),
                                   frozen_beat=beat)
            h.proc.kill()
            h.proc.wait()
            self._restart(i)

    def _restart(self, i: int) -> None:
        """Restart replica ``i`` with bounded exponential backoff. The
        spawn blocks until the replacement printed its port line —
        i.e. until journal recovery replayed — so the router never
        reaches a half-recovered replica."""
        n = self.restarts_by_replica[i]
        if n >= self.max_restarts:
            with self._lock:
                self.gave_up[i] = True
            return
        if n > 0:
            time.sleep(min(self._backoff_base_s * (2 ** (n - 1)),
                           self._backoff_max_s))
        try:
            self.handles[i].stop()   # reap + release the old handle
        except Exception:
            pass
        handle = self._spawn_fn(i)
        self.handles[i] = handle
        with self._lock:
            self.restarts_by_replica[i] += 1
            self.replica_restarts += 1
        if self.trace is not None:
            self.trace.instant("replica.restarted", track="supervisor",
                               replica=i, pid=int(handle.proc.pid),
                               restarts=self.restarts_by_replica[i])
        self._probe_failures[i] = 0
        self._beat[i] = -1
        self._beat_t[i] = time.monotonic()
        if self._on_restart is not None:
            self._on_restart(i, handle)
