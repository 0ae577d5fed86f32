"""Network front door, router half: cache-aware multi-replica routing.

The port of ``distributed_training_tpu/serving/router.py``, unchanged: the
front door's process holds no engine and never initialises CUDA.

Puts N engine replicas (separate processes on one host, each one a
:class:`~distributed_training_tpu_torch.serving.frontend.ServingFrontend` —
the engines themselves are unchanged) behind a single HTTP front door.
Each ``POST /generate`` is routed to the replica whose radix prefix
trie holds the request's longest resident prefix (SGLang-style
cache-aware routing: the replica answers a cheap read-only
``POST /probe``), falling back to the least ledger ``queue_wait`` p95
when no replica holds any of the prompt. The policy is deterministic:
ties break to the lowest replica index, so the same probe answers
always produce the same route.

Counters (``router_snapshot``, scraped at ``GET /metrics`` and
``/router/stats`` and merged into the serve_net SLA row):
``router_requests_routed`` / ``router_prefix_routed`` /
``router_fallback_routed`` plus per-replica routed/error counts — the
bench_compare zero-drift gate holds them at 0 on single-engine rows.

**Zero-downtime rolling deploys** ride the existing drain + hot-swap
machinery, one replica at a time: take it out of rotation → ``POST
/admin/drain`` (admission closes; accepted work finishes) → wait for
phase ``drained`` → ``POST /admin/deploy`` (the replica's serve loop
arms + applies the swap at the empty-engine boundary) → ``POST
/admin/reopen`` → back into rotation. Requests never see the draining
replica (it leaves rotation first), so a mid-load deploy completes
with zero failed and zero duplicated requests — the CI chaos drill.

Scrape-safety: the front door's handler threads route, proxy bytes,
and read counters — they never touch an engine, a device, or a trie
(the graftlint scrape-safety rule covers these handlers and the
``router_snapshot`` provider).
"""

from __future__ import annotations

import contextlib
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from distributed_training_tpu_torch.serving.httpbody import (
    NoBodyLength,
    read_body,
)
from distributed_training_tpu_torch.serving.ledger import (
    CAUSE_FAILOVER_RESUME,
    CAUSE_RELAY,
    CAUSE_RETRY_BACKOFF,
    CAUSE_ROUTE,
    FLEET_CAUSES,
    FLEET_SKEW_SLACK_MS,
    LatencyLedger,
)

# Phases a request must never be routed to: admission is closed (or
# not open yet). "overloaded" stays routable — shedding is the
# replica's own tier-aware decision.
UNROUTABLE_PHASES = {"draining", "drained", "recovering"}

# Numeric encoding of the per-replica breaker state for the Prometheus
# gauge (text expositions carry numbers; the JSON snapshots keep the
# string). Ordered healthy → tripped so an alert threshold reads
# naturally (``state >= 2`` == open).
BREAKER_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}

# Cap on the door's slowest-proxied-requests view (``fleet_ledger_top``
# in ``fleet_snapshot``) — the fleet twin of the replica telemetry's
# ledger_top.
FLEET_TOP_N = 8


class HttpReplica:
    """One replica endpoint (a ServingFrontend, usually in another
    process). Thin stdlib-urllib client: probe, generate (streaming
    passthrough), admin, healthz."""

    def __init__(self, url: str, *, name: str | None = None,
                 timeout_s: float = 30.0):
        self.url = url.rstrip("/")
        self.name = name or self.url
        self.timeout_s = float(timeout_s)

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.url + path,
            data=json.dumps(payload, allow_nan=False).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def probe(self, prompt: list[int] | None) -> dict:
        """The routing probe: resident-prefix tokens + queue-wait
        fallback signal + phase (Engine.probe_snapshot over HTTP)."""
        return self._post("/probe", {"prompt": prompt})

    def generate_raw(self, body: bytes,
                     headers: dict[str, str] | None = None):
        """Open a streaming /generate against this replica; returns the
        live HTTPResponse (SSE bytes relay through unparsed). ``headers``
        adds request headers on top of the JSON content type — the door
        injects ``X-Graft-Trace``/``X-Graft-Hop`` here so the replica's
        spans carry the fleet trace id."""
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs |= headers
        req = urllib.request.Request(
            self.url + "/generate", data=body, headers=hdrs)
        return urllib.request.urlopen(req, timeout=self.timeout_s)

    def admin(self, cmd: str) -> dict:
        return self._post(f"/admin/{cmd}", {})

    def healthz(self) -> dict:
        with urllib.request.urlopen(self.url + "/healthz",
                                    timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    # Read-only scrape helpers (the /fleet/* fan-out): plain GETs, no
    # admin verb, no POST — a federated scrape can never perturb the
    # replica it reads (the graftlint scrape-safety rule additionally
    # pins that a scrape error never trips the breaker).
    def scrape_text(self, path: str) -> str:
        with urllib.request.urlopen(self.url + path,
                                    timeout=self.timeout_s) as resp:
            return resp.read().decode("utf-8", "replace")

    def scrape_json(self, path: str) -> dict:
        with urllib.request.urlopen(self.url + path,
                                    timeout=self.timeout_s) as resp:
            return json.loads(resp.read())


class Router:
    """Deterministic cache-aware routing policy over N replicas.

    ``policy``: ``"prefix"`` (the default — longest resident prefix,
    least-queue-wait fallback) or ``"round_robin"`` (the CI drill's
    baseline: prefix-blind rotation over in-rotation replicas).
    """

    def __init__(self, replicas: list, *, policy: str = "prefix",
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0,
                 trace=None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in ("prefix", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r} "
                             f"(have: prefix, round_robin)")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        self.replicas = list(replicas)
        self.policy = policy
        # Optional TraceSession (observability/trace.py): breaker-skip
        # decisions land as instants on the router pid's trace so a
        # failover request's merged timeline shows WHY the dead replica
        # was never re-probed. None (the default) keeps every route
        # pass span-free.
        self.trace = trace
        self._lock = threading.Lock()
        self._in_rotation = [True] * len(self.replicas)
        self._rr_next = 0
        self.requests_routed = 0
        self.prefix_routed = 0
        self.fallback_routed = 0
        self.routed_by_replica = [0] * len(self.replicas)
        self.errors_by_replica = [0] * len(self.replicas)
        self.retries = 0
        self.deploys_completed = 0
        self.deploy_errors = 0
        # Per-replica circuit breaker: closed → open after
        # ``breaker_threshold`` CONSECUTIVE connection/5xx failures →
        # (cooldown elapses) half_open, ONE trial → closed on success,
        # straight back to open on failure. An open replica is skipped
        # before its probe, so a dead process costs the route pass
        # nothing — no probe timeout, no burned fallback slot.
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._brk_state = ["closed"] * len(self.replicas)
        self._brk_failures = [0] * len(self.replicas)
        self._brk_opened_t = [0.0] * len(self.replicas)
        self.breaker_opens = 0
        self.breaker_closes = 0
        self.breaker_reopens = 0   # half-open trial failed
        self.breaker_opens_by_replica = [0] * len(self.replicas)
        self.failover_resumes = 0  # mid-stream relays re-issued

    # -- rotation ------------------------------------------------------------
    def set_rotation(self, index: int, in_rotation: bool) -> None:
        with self._lock:
            self._in_rotation[index] = bool(in_rotation)

    def in_rotation(self) -> list[int]:
        with self._lock:
            return [i for i, ok in enumerate(self._in_rotation) if ok]

    # -- circuit breaker -----------------------------------------------------
    def _brk_open_locked(self, index: int) -> None:
        self._brk_state[index] = "open"
        self._brk_opened_t[index] = time.monotonic()
        self._brk_failures[index] = 0

    def note_replica_failure(self, index: int) -> None:
        """One connection/5xx failure against a replica (probe,
        connect, or a relay dying mid-stream). Consecutive failures
        open the breaker; a half-open trial failure re-opens it
        immediately (the single trial is spent)."""
        with self._lock:
            state = self._brk_state[index]
            if state == "half_open":
                self.breaker_reopens += 1
                self._brk_open_locked(index)
                return
            if state == "open":
                return  # already open; the cooldown clock keeps running
            self._brk_failures[index] += 1
            if self._brk_failures[index] >= self.breaker_threshold:
                self.breaker_opens += 1
                self.breaker_opens_by_replica[index] += 1
                self._brk_open_locked(index)

    def note_replica_success(self, index: int) -> None:
        """A completed interaction closes the breaker (the half-open
        trial succeeding is the canonical path) and resets the
        consecutive-failure count."""
        with self._lock:
            if self._brk_state[index] != "closed":
                self.breaker_closes += 1
                self._brk_state[index] = "closed"
            self._brk_failures[index] = 0

    def breaker_state(self, index: int) -> str:
        with self._lock:
            return self._brk_state[index]

    def note_failover_resume(self) -> None:
        """One mid-stream relay death turned into a resume re-issue
        (counted once per client request, not per retry)."""
        with self._lock:
            self.failover_resumes += 1

    def _brk_admit(self, candidates: list[int],
                   trace_id: str | None = None) -> tuple[list[int],
                                                         set[int]]:
        """Breaker gate for one route pass: open replicas whose
        cooldown has not elapsed are dropped WITHOUT a probe; expired
        ones transition to half_open and are admitted as trials (the
        caller orders them last). Returns (admitted, half_open set).
        Skipped replicas land as ``breaker_skip`` instants on the
        router trace (when tracing) so the merged fleet timeline shows
        the probe-free drop."""
        now = time.monotonic()
        admitted: list[int] = []
        trials: set[int] = set()
        skipped: list[int] = []
        with self._lock:
            for i in candidates:
                state = self._brk_state[i]
                if state == "open":
                    if now - self._brk_opened_t[i] < \
                            self.breaker_cooldown_s:
                        skipped.append(i)
                        continue
                    self._brk_state[i] = state = "half_open"
                if state == "half_open":
                    trials.add(i)
                admitted.append(i)
        if self.trace is not None:
            for i in skipped:
                self.trace.instant("breaker_skip", track="breaker_skip",
                                   trace=trace_id,
                                   replica=self.replicas[i].name)
        return admitted, trials

    # -- policy --------------------------------------------------------------
    def route(self, prompt: list[int] | None,
              trace_id: str | None = None) -> list[tuple[int, bool]]:
        """``(replica_index, by_prefix)`` pairs to try, best first —
        ``by_prefix`` marks candidates whose trie holds part of the
        prompt (so the winner's counter attribution is decided here,
        not by a second probe). Probes every in-rotation replica whose
        breaker admits it (open → skipped probe-free; half-open →
        probed, ordered last as the single trial); unreachable or
        unroutable (draining/recovering) ones are skipped.
        Deterministic: ties break to the lowest index. ``trace_id``
        tags the breaker-skip instants when the router is tracing."""
        candidates, trials = self._brk_admit(self.in_rotation(),
                                             trace_id=trace_id)
        if self.policy == "round_robin":
            if not candidates:
                return []
            solid = [i for i in candidates if i not in trials]
            if not solid:
                return [(i, False) for i in candidates]
            with self._lock:
                self._rr_next += 1
                k = self._rr_next % len(solid)
            return ([(i, False) for i in solid[k:] + solid[:k]]
                    + [(i, False) for i in candidates if i in trials])
        probes: list[tuple[int, dict]] = []
        for i in candidates:
            try:
                snap = self.replicas[i].probe(prompt)
            except (urllib.error.URLError, OSError, ValueError):
                with self._lock:
                    self.errors_by_replica[i] += 1
                self.note_replica_failure(i)
                continue
            if snap.get("phase") in UNROUTABLE_PHASES \
                    or snap.get("draining"):
                continue
            probes.append((i, snap))
        # Longest resident prefix wins outright; with no residency
        # anywhere, least queue-wait (then least occupancy, then lowest
        # index — all deterministic). Half-open trials sort strictly
        # after every closed-breaker candidate regardless of their
        # probe signals: a recovering replica gets ONE chance, never
        # priority.
        probes.sort(key=lambda p: (
            p[0] in trials,
            -int(p[1].get("hit_tokens", 0)),
            float(p[1].get("queue_wait_p95_ms", 0.0)),
            int(p[1].get("queue_depth", 0))
            + int(p[1].get("active_slots", 0)),
            p[0]))
        return [(i, int(s.get("hit_tokens", 0)) > 0) for i, s in probes]

    def note_routed(self, index: int, *, by_prefix: bool,
                    retried: bool = False) -> None:
        with self._lock:
            self.requests_routed += 1
            self.routed_by_replica[index] += 1
            if self.policy == "prefix":
                if by_prefix:
                    self.prefix_routed += 1
                else:
                    self.fallback_routed += 1
            if retried:
                self.retries += 1

    # -- observability -------------------------------------------------------
    def router_snapshot(self) -> dict[str, Any]:
        """Read-only counter view (scrape-safe: host ints under one
        lock) — the /router/stats payload, the front door's /metrics
        families, and the serve_net SLA-row merge all read this."""
        with self._lock:
            return {
                "policy": self.policy,
                "router_requests_routed": self.requests_routed,
                "router_prefix_routed": self.prefix_routed,
                "router_fallback_routed": self.fallback_routed,
                "router_retries": self.retries,
                "router_deploys_completed": self.deploys_completed,
                "router_deploy_errors": self.deploy_errors,
                # Fleet fault tolerance: deterministic breaker
                # transitions (opens/closes are schedule-driven under
                # seeded chaos; reopens count spent half-open trials)
                # and mid-stream failover re-issues.
                "router_breaker_opens": self.breaker_opens,
                "router_breaker_closes": self.breaker_closes,
                "router_breaker_reopens": self.breaker_reopens,
                "router_failover_resumes": self.failover_resumes,
                "replicas": [
                    {"name": self.replicas[i].name,
                     "in_rotation": self._in_rotation[i],
                     "requests_routed": self.routed_by_replica[i],
                     "probe_errors": self.errors_by_replica[i],
                     "breaker_state": self._brk_state[i],
                     "breaker_opens": self.breaker_opens_by_replica[i]}
                    for i in range(len(self.replicas))],
            }

    # -- rolling deploy ------------------------------------------------------
    def rolling_deploy(self, *, poll_s: float = 0.05,
                       timeout_s: float = 120.0) -> dict[str, Any]:
        """Drain → deploy → reopen each replica in turn (zero-downtime:
        the replica leaves rotation before its admission closes, so no
        request is ever routed into a drain). Returns a per-replica
        report; raises TimeoutError when a replica wedges mid-phase."""
        report = []
        for i, rep in enumerate(self.replicas):
            self.set_rotation(i, False)
            try:
                epoch0 = int(rep.healthz().get("weights_epoch", -1))
                rep.admin("drain")
                self._wait(rep, lambda h: h.get("phase") == "drained",
                           poll_s, timeout_s,
                           what=f"{rep.name}: drain")
                rep.admin("deploy")
                self._wait(rep,
                           lambda h: int(h.get("weights_epoch", -1))
                           > epoch0,
                           poll_s, timeout_s,
                           what=f"{rep.name}: deploy")
                rep.admin("reopen")
                self._wait(rep,
                           lambda h: h.get("phase") not in
                           UNROUTABLE_PHASES,
                           poll_s, timeout_s,
                           what=f"{rep.name}: reopen")
            except Exception:
                with self._lock:
                    self.deploy_errors += 1
                raise
            finally:
                # Back into rotation even on failure: a wedged deploy
                # must not silently halve capacity forever.
                self.set_rotation(i, True)
            with self._lock:
                self.deploys_completed += 1
            report.append({"replica": rep.name, "from_epoch": epoch0,
                           "to_epoch": int(
                               rep.healthz().get("weights_epoch", -1))})
        return {"deployed": report}

    @staticmethod
    def _wait(rep, pred, poll_s: float, timeout_s: float,
              what: str) -> None:
        t0 = time.monotonic()
        while True:
            try:
                if pred(rep.healthz()):
                    return
            except (urllib.error.URLError, OSError, ValueError):
                pass  # replica mid-restart: keep polling to timeout
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(
                    f"rolling deploy wedged waiting for {what} "
                    f"(> {timeout_s:.0f}s)")
            time.sleep(poll_s)


class RouterFrontDoor:
    """The router's own HTTP server: routes + proxies ``POST
    /generate`` byte-for-byte (SSE streams relay through live), serves
    the router counters, and exposes the rolling-deploy trigger.

    - ``POST /generate`` — route (probe fan-out) then proxy to the
      chosen replica; a replica that refuses (503 / connection error)
      falls through to the next candidate, so a drain race never fails
      a request. 502 only when every replica refused.
    - ``GET /router/stats`` — :meth:`Router.router_snapshot` JSON.
    - ``GET /metrics`` — the router counters in Prometheus text (plus
      the per-replica breaker gauges and the fleet-ledger counters).
    - ``GET /healthz`` — aggregate: front-door status + each replica's
      /healthz under its name.
    - ``GET /fleet/metrics`` — federated scrape: the door's own
      families + supervisor gauges + every reachable replica's
      ``/metrics`` exposition relabeled with ``replica="<name>"``.
      Breaker-open or unreachable replicas are NOT probed/blocked on —
      they surface as ``fleet_replica_stale{replica=...} 1``.
    - ``GET /fleet/vars`` — the JSON twin: door + supervisor snapshots
      + each replica's ``/vars`` (``{"stale": true}`` when skipped).
    - ``GET /fleet/replicas`` — one row per replica: rotation, breaker
      state, routing counters, supervisor restart counts.
    - ``POST /admin/rolling_deploy`` — start a background rolling
      deploy; poll ``/router/stats`` (``router_deploys_completed``)
      for completion.

    Every proxied request carries a fleet trace id (client-supplied
    ``X-Graft-Trace`` or minted ``req-<seq>`` from the door's own
    deterministic request sequence — NEVER wall clock), propagated to
    the replica as a request header, echoed back to the client as a
    response header, and stamped on the door's ``route``/``relay``/
    ``retry_backoff``/``failover_resume`` spans so
    ``tools/fleet_trace.py`` can merge the per-process files into one
    timeline. The door also keeps its own conserved
    :class:`~distributed_training_tpu_torch.serving.ledger.LatencyLedger`
    per request and joins the replica's ledger from the ``done`` frame
    — the cross-hop conservation audit behind the
    ``fleet_ledger_*`` counters (zero-tolerance CI gate).
    """

    def __init__(self, router: Router, *, port: int = 0,
                 host: str = "127.0.0.1",
                 route_wait_s: float = 10.0,
                 failover_wait_s: float = 60.0,
                 chaos_hook=None, trace=None,
                 trace_path: str | None = None,
                 supervisor_snapshot=None):
        self.router = router
        self._route_wait_s = float(route_wait_s)
        self._failover_wait_s = float(failover_wait_s)
        # Fleet tracing: one TraceSession for the door process
        # (observability/trace.fleet_session). The router shares it
        # unless it was given its own — one wiring point for the CLIs.
        self._trace = trace
        self._trace_path = trace_path
        if trace is not None and router.trace is None:
            router.trace = trace
        # ``supervisor_snapshot``: zero-arg callable returning the
        # ReplicaSupervisor counter view, merged into /fleet/* when the
        # deployment runs under supervision (serve_net wires it).
        self._supervisor_snapshot = supervisor_snapshot
        # Fleet ledger accounting (see _fleet_account): conserved
        # router-side intervals per proxied request, joined with the
        # replica ledger from the done frame and audited zero-tolerance.
        self._fleet_lock = threading.Lock()
        self.fleet_ledger_requests = 0
        self.fleet_ledger_conservation_violations = 0
        self.fleet_ledger_violation_last = ""
        self.fleet_replica_ledger_joined = 0
        self.fleet_replica_ledger_absent = 0
        self._fleet_cause_ms = {c: 0.0 for c in FLEET_CAUSES}
        self._fleet_top: list[dict] = []
        # Chaos injection (tools/serve_net.py drills):
        # ``chaos_hook(request_seq, tokens_relayed, replica_index)``
        # fires after every relayed frame — the kill-replica-at-
        # request-N drill SIGKILLs the serving replica mid-stream from
        # exactly this callback.
        self._chaos_hook = chaos_hook
        self._seq_lock = threading.Lock()
        self._gen_seq = 0
        self._deploy_thread: threading.Thread | None = None
        self.proxy_errors = 0
        front = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args: Any) -> None:
                pass

            def do_GET(self) -> None:
                front._handle_get(self)

            def do_POST(self) -> None:
                front._handle_post(self)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = self._server.server_address[0]
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="router-front-door", daemon=True)
        self._started = False
        self._closed = False

    def start(self) -> "RouterFrontDoor":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the front door down (idempotent). Named ``stop`` for
        the same lint-call-graph reason as ``ServingFrontend.stop``."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            self._server.shutdown()
            self._thread.join(timeout=5.0)
        self._server.server_close()
        self._trace_checkpoint()

    def _trace_checkpoint(self) -> None:
        """Persist the door trace (atomic replace). The door is never a
        chaos target, so — unlike the replica frontend's per-stream
        checkpoints — one save at stop() suffices; the CLIs save again
        at exit for belt-and-braces."""
        if self._trace is not None and self._trace_path:
            self._trace.checkpoint(self._trace_path)

    def url(self, path: str = "/generate") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # -- handlers ------------------------------------------------------------
    def _handle_get(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0]
        snap = self.router.router_snapshot()
        if path == "/router/stats":
            self._send(req, 200, "application/json",
                       json.dumps(snap, allow_nan=False) + "\n")
        elif path == "/metrics":
            self._send(req, 200, "text/plain; version=0.0.4; "
                       "charset=utf-8",
                       "\n".join(self._metrics_lines(snap)) + "\n")
        elif path == "/fleet/metrics":
            self._send(req, 200, "text/plain; version=0.0.4; "
                       "charset=utf-8", self._fleet_metrics_text(snap))
        elif path == "/fleet/vars":
            self._send(req, 200, "application/json",
                       json.dumps(self._fleet_vars(snap),
                                  allow_nan=False) + "\n")
        elif path == "/fleet/replicas":
            self._send(req, 200, "application/json",
                       json.dumps(self._fleet_replicas(snap),
                                  allow_nan=False) + "\n")
        elif path == "/healthz":
            payload = {"status": "ok", "policy": self.router.policy,
                       "replicas": {}}
            for rep in self.router.replicas:
                try:
                    payload["replicas"][rep.name] = rep.healthz()
                except (urllib.error.URLError, OSError, ValueError) as e:
                    payload["replicas"][rep.name] = {
                        "status": "unreachable",
                        "error": str(e)}
            self._send(req, 200, "application/json",
                       json.dumps(payload, allow_nan=False) + "\n")
        else:
            self._send(req, 404, "application/json", json.dumps(
                {"error": "not found",
                 "endpoints": ["/generate", "/router/stats", "/metrics",
                               "/healthz", "/fleet/metrics",
                               "/fleet/vars", "/fleet/replicas",
                               "/admin/rolling_deploy"]}) + "\n")

    # -- federated telemetry plane -------------------------------------------
    def fleet_snapshot(self) -> dict[str, Any]:
        """Read-only fleet-ledger counter view (host ints/floats under
        one lock) — the door's half of the /fleet/* surface and the
        serve_net SLA-row merge. A snapshot PROVIDER under the
        graftlint scrape-safety rule: it must never trip a breaker,
        kill a replica, or drive an engine."""
        with self._fleet_lock:
            return {
                "fleet_ledger_requests": self.fleet_ledger_requests,
                "fleet_ledger_conservation_violations":
                    self.fleet_ledger_conservation_violations,
                "fleet_ledger_violation_last":
                    self.fleet_ledger_violation_last,
                "fleet_replica_ledger_joined":
                    self.fleet_replica_ledger_joined,
                "fleet_replica_ledger_absent":
                    self.fleet_replica_ledger_absent,
                "fleet_cause_ms": dict(self._fleet_cause_ms),
                "fleet_ledger_top": [dict(e) for e in self._fleet_top],
            }

    def _metrics_lines(self, snap: dict) -> list[str]:
        """The door's own /metrics families: router counters, per-
        replica routing + breaker gauges, fleet-ledger counters."""
        lines: list[str] = []
        for k, v in snap.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f"# TYPE {k} counter")
                lines.append(f"{k} {v}")
        lines.append("# TYPE router_replica_requests_routed counter")
        lines.append("# TYPE router_replica_probe_errors counter")
        lines.append("# TYPE router_replica_breaker_state gauge")
        lines.append("# TYPE router_replica_breaker_opens counter")
        for r in snap["replicas"]:
            tag = f'{{replica="{r["name"]}"}}'
            lines.append(
                f"router_replica_requests_routed{tag} "
                f"{r['requests_routed']}")
            lines.append(f"router_replica_probe_errors{tag} "
                         f"{r['probe_errors']}")
            lines.append(
                f"router_replica_breaker_state{tag} "
                f"{BREAKER_STATE_CODES.get(r['breaker_state'], -1)}")
            lines.append(f"router_replica_breaker_opens{tag} "
                         f"{r['breaker_opens']}")
        fleet = self.fleet_snapshot()
        for k, v in fleet.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f"# TYPE {k} counter")
                lines.append(f"{k} {v}")
        lines.append("# TYPE fleet_ledger_cause_ms_total counter")
        for cause, ms in sorted(fleet["fleet_cause_ms"].items()):
            lines.append(
                f'fleet_ledger_cause_ms_total{{cause="{cause}"}} {ms:g}')
        return lines

    def _fleet_scrape(self, path: str) -> dict[str, Any]:
        """Fan one read-only GET out to every replica. Breaker-open
        replicas are NOT contacted — a federated scrape must never
        block on (or re-probe) a replica the proxy path already
        declared dead; they come back as ``{"stale": True}``, the
        deterministic staleness marker. Scrape errors also mark stale —
        and deliberately do NOT call ``note_replica_failure``: a scrape
        observes the fleet, it never trips a breaker (lint-enforced
        from the do_GET roots)."""
        out: dict[str, Any] = {}
        for i, rep in enumerate(self.router.replicas):
            if self.router.breaker_state(i) == "open":
                out[rep.name] = {"stale": True, "reason": "breaker_open"}
                continue
            try:
                out[rep.name] = {"stale": False,
                                 "body": rep.scrape_text(path)}
            except (urllib.error.URLError, OSError, ValueError) as e:
                out[rep.name] = {"stale": True,
                                 "reason": f"unreachable: {e}"}
        return out

    def _fleet_metrics_text(self, snap: dict) -> str:
        """The federated exposition: door families + supervisor gauges
        + every reachable replica's /metrics relabeled with
        ``replica="<name>"`` (TYPE/HELP once per family), + the
        per-replica staleness marker."""
        from distributed_training_tpu_torch.observability.prometheus import (
            merge_labeled_expositions,
        )

        lines = self._metrics_lines(snap)
        sup = (self._supervisor_snapshot()
               if self._supervisor_snapshot is not None else None)
        if sup:
            for k in ("replica_restarts", "deaths_detected",
                      "wedged_kills", "kills_injected"):
                if k in sup:
                    lines.append(f"# TYPE supervisor_{k} counter")
                    lines.append(f"supervisor_{k} {sup[k]}")
        scraped = self._fleet_scrape("/metrics")
        lines.append("# TYPE fleet_replica_stale gauge")
        for name in sorted(scraped):
            stale = 1 if scraped[name]["stale"] else 0
            lines.append(f'fleet_replica_stale{{replica="{name}"}} '
                         f"{stale}")
        lines.extend(merge_labeled_expositions(
            [(f'replica="{name}"', entry["body"])
             for name, entry in sorted(scraped.items())
             if not entry["stale"]]))
        return "\n".join(lines) + "\n"

    def _fleet_vars(self, snap: dict) -> dict[str, Any]:
        """The JSON twin of /fleet/metrics: one document holding the
        door's router + fleet-ledger snapshots, the supervisor counter
        view, and each replica's /vars (stale marker when skipped)."""
        replicas: dict[str, Any] = {}
        for name, entry in self._fleet_scrape("/vars").items():
            if entry["stale"]:
                replicas[name] = {"stale": True,
                                  "reason": entry["reason"]}
            else:
                try:
                    replicas[name] = json.loads(entry["body"])
                except ValueError:
                    replicas[name] = {"stale": True,
                                      "reason": "unparseable /vars"}
        return {
            "router": snap,
            "fleet": self.fleet_snapshot(),
            "supervisor": (self._supervisor_snapshot()
                           if self._supervisor_snapshot is not None
                           else None),
            "replicas": replicas,
        }

    def _fleet_replicas(self, snap: dict) -> dict[str, Any]:
        """One row per replica: the router's rotation/breaker/routing
        view joined with the supervisor's restart accounting."""
        sup = (self._supervisor_snapshot()
               if self._supervisor_snapshot is not None else None)
        rows = []
        for i, r in enumerate(snap["replicas"]):
            row = dict(r)
            row["breaker_state_code"] = BREAKER_STATE_CODES.get(
                r["breaker_state"], -1)
            if sup is not None:
                restarts = sup.get("restarts_by_replica", [])
                gave_up = sup.get("gave_up", [])
                row["restarts"] = (restarts[i]
                                   if i < len(restarts) else None)
                row["gave_up"] = (gave_up[i]
                                  if i < len(gave_up) else None)
            rows.append(row)
        return {"replicas": rows}

    def _handle_post(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0]
        if path == "/admin/rolling_deploy":
            if self._deploy_thread is not None \
                    and self._deploy_thread.is_alive():
                self._send(req, 409, "application/json",
                           json.dumps({"error": "rolling deploy already "
                                       "in progress"}) + "\n")
                return
            self._deploy_thread = threading.Thread(
                target=self._run_deploy, name="rolling-deploy",
                daemon=True)
            self._deploy_thread.start()
            self._send(req, 202, "application/json",
                       json.dumps({"started": True}) + "\n")
            return
        if path != "/generate":
            self._send(req, 404, "application/json",
                       json.dumps({"error": "not found"}) + "\n")
            return
        try:
            raw = read_body(req.headers, req.rfile)
            body = json.loads(raw or b"{}")
            prompt = body.get("prompt")
            if prompt is None and body.get("text") is not None:
                prompt = [b for b in str(body["text"]).encode("utf-8")]
        except NoBodyLength:
            # 411 ONLY here: neither Content-Length nor chunked
            # framing (same contract as the replica frontend).
            self._send(req, 411, "application/json", json.dumps(
                {"error": "Content-Length or Transfer-Encoding: "
                          "chunked required"}) + "\n")
            return
        except (ValueError, OSError) as e:
            self._send(req, 400, "application/json",
                       json.dumps({"error": f"bad body: {e}"}) + "\n")
            return
        self._proxy_generate(req, raw, body, prompt)

    def _proxy_generate(self, req: BaseHTTPRequestHandler, raw: bytes,
                        body: dict, prompt) -> None:
        """Route, relay, and fail over. Candidate replicas are tried
        best-first; a refusal (503/conn error — e.g. a drain racing
        the probe) falls through to the next. The rotation can be
        momentarily empty mid-deploy, so an empty route re-polls
        briefly before giving up. A relay that dies MID-STREAM (the
        replica was SIGKILLed under it) re-issues against the next
        healthy replica with a resume cursor — the client keeps one
        socket and one seamless stream.

        Fleet observability rides the same loop: the request's trace
        id (client ``X-Graft-Trace`` or the minted ``req-<seq>`` —
        deterministic, the door's own request sequence, never wall
        clock) tags every door span and travels to each replica as a
        request header, with a monotonically increasing ``X-Graft-Hop``
        so the merge tool pairs each door-side ``hop.send`` with the
        replica-side ``hop.recv``. In parallel the door stamps its own
        conserved :class:`LatencyLedger` — ``route``, ``relay``
        (which CONTAINS the replica's lifetime), ``retry_backoff``,
        ``failover_resume`` — audited cross-hop in _fleet_account."""
        with self._seq_lock:
            self._gen_seq += 1
            seq = self._gen_seq
        client_trace = req.headers.get("X-Graft-Trace")
        tid = client_trace if client_trace else f"req-{seq:06d}"
        # Mutable relay state, shared across failover attempts: the
        # client headers go out once, the delivered-token cursor and
        # upstream uid survive a dead upstream. ``trace`` rides along
        # so _relay can echo the id on the client response headers and
        # capture the replica ledger off the terminal done frame.
        state = {"seq": seq, "uid": None, "delivered": 0,
                 "headers_sent": False, "done": False,
                 "client_gone": False, "trace": tid, "ledger": None}
        t0 = time.perf_counter()
        led = LatencyLedger(t0)
        trace = self._trace
        attempt = 0
        hops = 0
        resumed = False
        while True:
            r0 = time.perf_counter()
            order = self.router.route(prompt, trace_id=tid)
            r1 = time.perf_counter()
            # Post-death route passes bill to failover_resume — the
            # tail the dead replica's SIGKILL added to this request.
            cause = CAUSE_FAILOVER_RESUME if resumed else CAUSE_ROUTE
            led.stamp(cause, r1)
            if trace is not None:
                trace.complete(cause, r0, r1, track=cause, trace=tid,
                               seq=seq, candidates=len(order))
            for idx, by_prefix in order:
                rep = self.router.replicas[idx]
                send_raw = raw
                if resumed:
                    resume_body = dict(body)
                    resume_body["resume"] = {
                        "uid": state["uid"],
                        "delivered": state["delivered"]}
                    send_raw = json.dumps(
                        resume_body, allow_nan=False).encode()
                hops += 1
                h0 = time.perf_counter()
                if trace is not None:
                    # One half of the hop handshake: the replica stamps
                    # the matching ``hop.recv`` with the SAME
                    # (trace, hop) args — tools/fleet_trace.py pairs
                    # them to bound cross-file clock offsets.
                    trace.instant("hop.send", track="relay", t=h0,
                                  trace=tid, hop=hops, replica=rep.name,
                                  resume=resumed)
                try:
                    resp = rep.generate_raw(send_raw, headers={
                        "X-Graft-Trace": tid, "X-Graft-Hop": str(hops)})
                except urllib.error.HTTPError as e:
                    if e.code in (503, 429):
                        attempt += 1
                        continue  # draining/shedding: try the next
                    if e.code >= 500:
                        self.router.note_replica_failure(idx)
                    self.proxy_errors += 1
                    if state["headers_sent"]:
                        return  # mid-stream: nothing more we can send
                    self._send(req, e.code, "application/json",
                               e.read().decode("utf-8", "replace")
                               or json.dumps({"error": str(e)}) + "\n")
                    return
                except (urllib.error.URLError, OSError):
                    self.router.note_replica_failure(idx)
                    attempt += 1
                    continue
                self.router.note_routed(idx, by_prefix=by_prefix,
                                        retried=attempt > 0)
                state["replica"] = idx
                upstream_died = self._relay(req, resp, state)
                rel1 = time.perf_counter()
                # The relay span opens at h0 (the connect): the replica
                # admits the request while generate_raw blocks on the
                # response headers, so "relay CONTAINS the replica's
                # lifetime" holds and the cross-hop slack check in
                # _fleet_account is one-sided.
                led.stamp(CAUSE_RELAY, rel1)
                if trace is not None:
                    trace.complete("relay", h0, rel1, track="relay",
                                   trace=tid, hop=hops,
                                   replica=rep.name,
                                   died=bool(upstream_died))
                if state["client_gone"]:
                    return  # the replica's cancel/ack gate handles it
                if not upstream_died:
                    self.router.note_replica_success(idx)
                    led.seal(CAUSE_RELAY)
                    self._fleet_account(led, state)
                    return
                # Upstream died mid-stream: penalize its breaker and
                # re-issue with the resume cursor. The route pass is
                # re-run fresh — the dead replica's breaker is open
                # now, so it is skipped without burning anything.
                self.router.note_replica_failure(idx)
                if not resumed:
                    resumed = True
                    self.router.note_failover_resume()
                    if trace is not None:
                        trace.instant("failover_resume",
                                      track="failover_resume",
                                      trace=tid, replica=rep.name,
                                      delivered=state["delivered"])
                break  # back to the outer loop for a fresh route
            wait = (self._failover_wait_s if resumed
                    else self._route_wait_s)
            if time.perf_counter() - t0 > wait:
                self.proxy_errors += 1
                if not state["headers_sent"]:
                    self._send(req, 502, "application/json", json.dumps(
                        {"error": "no replica accepted the request"})
                        + "\n")
                return
            b0 = time.perf_counter()
            time.sleep(0.02)
            b1 = time.perf_counter()
            led.stamp(CAUSE_RETRY_BACKOFF, b1)
            if trace is not None:
                trace.complete("retry_backoff", b0, b1,
                               track="retry", trace=tid, seq=seq)

    def _fleet_account(self, led: LatencyLedger, state: dict) -> None:
        """The cross-hop conservation audit, run once per COMPLETED
        proxied request: the door's own intervals must tile the client
        wall time exactly (LatencyLedger.violations — EPSILON-exact by
        the telescoping-cursor construction), and the replica ledger
        joined from the done frame must fit inside the relay span(s)
        up to FLEET_SKEW_SLACK_MS (both are perf_counter DURATIONS on
        one host; the slack covers scheduling between the door's
        connect and the replica's admission stamp). Requests
        redelivered verbatim from a journal carry ``ledger: null`` —
        the replica-side check is skipped, total conservation still
        applies. Zero-tolerance: any violation bumps the CI-gated
        counter."""
        problems = led.violations()
        rep_led = state.get("ledger")
        if isinstance(rep_led, dict):
            relay_ms = led.total_s(CAUSE_RELAY) * 1e3
            rep_ms = float(rep_led.get("lifetime_ms", 0.0))
            if rep_ms > relay_ms + FLEET_SKEW_SLACK_MS:
                problems.append(
                    f"replica lifetime {rep_ms:.3f}ms exceeds relay "
                    f"total {relay_ms:.3f}ms + "
                    f"{FLEET_SKEW_SLACK_MS:.0f}ms slack")
            if not rep_led.get("conserved", True):
                problems.append("replica-side ledger not conserved")
        totals = led.totals_ms()
        entry = {
            "trace_id": state["trace"], "seq": state["seq"],
            "uid": state["uid"], "lifetime_ms": led.lifetime_ms,
            "causes_ms": totals,
            "replica_lifetime_ms": (rep_led.get("lifetime_ms")
                                    if isinstance(rep_led, dict)
                                    else None),
            "conserved": not problems,
        }
        with self._fleet_lock:
            self.fleet_ledger_requests += 1
            if isinstance(rep_led, dict):
                self.fleet_replica_ledger_joined += 1
            else:
                self.fleet_replica_ledger_absent += 1
            if problems:
                self.fleet_ledger_conservation_violations += 1
                self.fleet_ledger_violation_last = problems[0]
            for cause, ms in totals.items():
                self._fleet_cause_ms[cause] = \
                    self._fleet_cause_ms.get(cause, 0.0) + ms
            self._fleet_top.append(entry)
            self._fleet_top.sort(
                key=lambda e: (-e["lifetime_ms"], str(e["trace_id"])))
            del self._fleet_top[FLEET_TOP_N:]
        if self._trace is not None:
            self._trace.instant("fleet.audit", track="route",
                                trace=state["trace"],
                                conserved=not problems)

    def _relay(self, req: BaseHTTPRequestHandler, resp,
               state: dict) -> bool:
        """Relay one upstream response into the client socket,
        SSE-frame-aligned. Forwards only COMPLETE frames (a failover
        must splice at a frame boundary or the client's SSE parse
        breaks), tracks the resume cursor (upstream uid + tokens
        delivered + terminal ``done``), and fires the chaos hook after
        every forwarded frame. Returns True iff the upstream died
        before its stream finished (the failover trigger); client
        hangups set ``state['client_gone']`` instead.
        ``contextlib.closing`` releases the upstream socket on every
        exit path."""
        with contextlib.closing(resp):
            ctype = resp.headers.get("Content-Type", "application/json")
            streaming = ctype.startswith("text/event-stream")
            try:
                if not state["headers_sent"]:
                    req.send_response(resp.status)
                    req.send_header("Content-Type", ctype)
                    if state.get("trace") is not None:
                        # The fleet trace id the door minted (or passed
                        # through), echoed so the client can join its
                        # own logs to the merged timeline.
                        req.send_header("X-Graft-Trace",
                                        str(state["trace"]))
                    clen = resp.headers.get("Content-Length")
                    if clen is not None and not streaming:
                        req.send_header("Content-Length", clen)
                    else:
                        req.send_header("Connection", "close")
                    req.end_headers()
                    state["headers_sent"] = True
            except (BrokenPipeError, ConnectionResetError):
                state["client_gone"] = True
                return False
            if not streaming:
                # Unary JSON (stream=false or an error body): plain
                # byte relay, no resume framing to track.
                try:
                    while True:
                        chunk = resp.read1(65536)
                        if not chunk:
                            break
                        req.wfile.write(chunk)
                except (BrokenPipeError, ConnectionResetError):
                    state["client_gone"] = True
                except OSError:
                    return True
                return False
            buf = b""
            while True:
                try:
                    chunk = resp.read1(65536)
                except (OSError, http.client.HTTPException):
                    return not state["done"]
                if not chunk:
                    return not state["done"]
                buf += chunk
                while True:
                    cut = buf.find(b"\n\n")
                    if cut < 0:
                        break
                    frame, buf = buf[:cut + 2], buf[cut + 2:]
                    event, payload = _parse_sse_frame(frame)
                    if event == "tokens":
                        if state["uid"] is None:
                            state["uid"] = payload.get("uid")
                        state["delivered"] += len(
                            payload.get("tokens", ()))
                    elif event == "done":
                        if state["uid"] is None:
                            state["uid"] = payload.get("uid")
                        state["done"] = True
                        # The replica's conserved interval detail rides
                        # the terminal frame (null when the result was
                        # journal-redelivered) — _fleet_account joins
                        # it with the door's own ledger.
                        state["ledger"] = payload.get("ledger")
                    try:
                        req.wfile.write(frame)
                    except (BrokenPipeError, ConnectionResetError):
                        state["client_gone"] = True
                        return False
                    if self._chaos_hook is not None:
                        self._chaos_hook(state["seq"],
                                         state["delivered"],
                                         state.get("replica"))

    def _run_deploy(self) -> None:
        try:
            self.router.rolling_deploy()
        except Exception:
            pass  # counted in router.deploy_errors; surfaced on /stats

    @staticmethod
    def _send(req: BaseHTTPRequestHandler, code: int, ctype: str,
              body: str) -> None:
        data = body.encode("utf-8")
        try:
            req.send_response(code)
            req.send_header("Content-Type", ctype)
            req.send_header("Content-Length", str(len(data)))
            req.end_headers()
            req.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass


def _parse_sse_frame(frame: bytes) -> tuple[str | None, dict]:
    """Parse ONE complete SSE frame ("event: NAME\\ndata: {...}\\n\\n")
    into (event, payload). Unparseable frames (comments, keepalives)
    come back as (None, {}) and relay through untouched."""
    event, data = None, []
    for line in frame.decode("utf-8", "replace").split("\n"):
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            data.append(line[len("data: "):])
    if event is None or not data:
        return None, {}
    try:
        return event, json.loads("\n".join(data))
    except ValueError:
        return None, {}


# -- SSE client helpers (traffic.py client mode + tests) ---------------------
def sse_events(resp):
    """Parse a live SSE byte stream into ``(event, payload)`` pairs —
    the client half of the frontend's framing (event: NAME / data: one
    JSON object / blank line)."""
    event, data = None, []
    for raw in resp:
        line = raw.decode("utf-8").rstrip("\n")
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            data.append(line[len("data: "):])
        elif not line and (event is not None or data):
            yield event, json.loads("\n".join(data))
            event, data = None, []


def generate_over_http(url: str, payload: dict, *,
                       timeout_s: float = 60.0,
                       trace_id: str | None = None,
                       on_first_token=None) -> dict:
    """One streamed /generate round-trip: POST, consume the SSE stream,
    return the terminal ``done`` payload with the streamed-token
    concatenation under ``streamed_tokens`` (the bitwise pin compares
    both against the batch engine's output). ``trace_id`` rides out as
    ``X-Graft-Trace``; whatever the server echoed back on its response
    header comes back under ``trace_header`` — the client half of the
    trace round-trip check (tools/traffic.py client mode).
    ``on_first_token()`` is called once, when the first ``tokens``
    event arrives (the client's time to first token)."""
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["X-Graft-Trace"] = trace_id
    req = urllib.request.Request(
        url, data=json.dumps(payload, allow_nan=False).encode(),
        headers=headers)
    streamed: list[int] = []
    done: dict | None = None
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        trace_header = resp.headers.get("X-Graft-Trace")
        ctype = resp.headers.get("Content-Type", "")
        if not ctype.startswith("text/event-stream"):
            done = json.loads(resp.read())
        else:
            for event, data in sse_events(resp):
                if event == "tokens":
                    if on_first_token is not None and not streamed:
                        on_first_token()
                    streamed.extend(data["tokens"])
                elif event == "done":
                    done = data
    if done is None:
        raise RuntimeError(f"stream from {url} ended without a "
                           f"'done' event")
    done["streamed_tokens"] = streamed
    done["trace_header"] = trace_header
    return done
