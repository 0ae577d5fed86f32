"""Network front door, replica half: the SSE streaming HTTP frontend.

The port of ``distributed_training_tpu/serving/frontend.py``, unchanged
(host Python): the serve-loop thread is the only one that launches work
on the card.

Turns one :class:`~distributed_training_tpu_torch.serving.engine.Engine` into
a network service on stdlib ``http.server`` only — the round-11
exporter's pattern (``observability/exporter.py``), under the same
scrape-safety contract: **handler threads never touch device state and
never drive the engine**. Handlers submit (thread-safe, journal-backed),
buffer, and write sockets; one dedicated serve-loop thread owns every
``Engine.step`` and every staged weight swap.

Endpoints:

- ``POST /generate`` — submit one request (JSON body) and stream its
  completion back as Server-Sent Events, one ``tokens`` event per
  engine iteration that landed tokens (riding the per-iteration token
  landing via :meth:`Engine.set_token_listener`) and a final ``done``
  event carrying the finish record. Body fields: ``prompt`` (token id
  list) or ``text`` (utf-8 byte tokens, the serve.py CLI convention),
  ``max_new_tokens``, ``priority`` (SLO tier), ``tenant``,
  ``deadline_ms``, ``stream`` (false = one JSON response at finish).
- ``POST /probe`` — the router's cache-aware routing probe
  (:meth:`Engine.probe_snapshot`): resident-prefix coverage for a
  prompt + the queue-wait fallback signal. Read-only by construction
  (the graftlint scrape-safety rule roots it).
- ``POST /admin/drain`` / ``/admin/deploy`` / ``/admin/reopen`` — the
  rolling-deploy surface (serving/router.py drives it): close
  admission, stage+apply a weight swap at the drained boundary (on the
  serve-loop thread — handlers never quantize or dispatch), reopen.
- ``GET /healthz /metrics /vars /timeseries /alerts`` — delegated to
  the round-11 :class:`MetricsExporter` logic verbatim, so the network
  front door and the bare exporter serve byte-compatible telemetry.

**Exactly-once delivery.** With a journal, a completion is acked
(:meth:`RequestJournal.ack` — the client cursor) only AFTER its final
event was fully written to the socket. A client that disconnects
mid-stream is never acked: the finish record stays journaled and a
recovery redelivers it, exactly once per ack. This is the round-17
cursor contract extended over the network.

**Determinism.** Tokens are a pure function of ``(seed, uid,
position)`` and uids are assigned in submission order, so a sequential
client replaying a seeded workload over HTTP receives completions
bitwise identical to the batch CLI driving the same engine directly —
the pin in tests/test_torch_frontend.py.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

import numpy as np

from distributed_training_tpu_torch.inference.sampler import CacheBudgetError
from distributed_training_tpu_torch.observability.exporter import MetricsExporter
from distributed_training_tpu_torch.resilience.errors import (
    DrainingError,
    QueueFullError,
)
from distributed_training_tpu_torch.serving.httpbody import (
    NoBodyLength,
    read_body,
)

# One SSE frame: "event: <name>\ndata: <one JSON object>\n\n".
SSE_CONTENT_TYPE = "text/event-stream; charset=utf-8"


class _Stream:
    """Per-request delivery buffer between the engine thread (producer,
    via the token listener) and one handler thread (consumer). Tokens
    are append-only host ints; ``fin`` is set exactly once, last."""

    __slots__ = ("tokens", "fin")

    def __init__(self):
        self.tokens: list[int] = []
        self.fin = None


class ServingFrontend:
    """One engine behind one streaming HTTP server.

    >>> fe = ServingFrontend(engine, port=0).start()
    >>> # POST http://host:port/generate ... ; fe.stop()

    The frontend owns two daemon threads: the ThreadingHTTPServer's
    acceptor (one handler thread per connection) and the serve loop —
    the ONLY thread that calls ``engine.step``/``arm_swap``. ``port=0``
    binds an ephemeral port (tests); the resolved port is :attr:`port`.

    ``deploy_fn`` (optional) runs on the serve-loop thread when
    ``POST /admin/deploy`` lands and must arm the next weights
    (default: re-arm the engine's current tree at ``epoch + 1`` — the
    rolling-deploy chaos drill's no-op redeploy). ``exporter`` supplies
    the telemetry delegate; None builds a non-listening one from the
    engine's standard providers (attach_engine wiring).
    """

    def __init__(self, engine, *, port: int = 0, host: str = "127.0.0.1",
                 exporter: MetricsExporter | None = None,
                 deploy_fn: Callable[[], None] | None = None,
                 poll_s: float = 0.005,
                 trace=None, trace_path: str | None = None):
        self._engine = engine
        self._deploy_fn = deploy_fn
        self._poll_s = float(poll_s)
        # Fleet tracing (docs/OBSERVABILITY.md "Fleet tracing"): this
        # replica's own TraceSession + output path. The frontend stamps
        # the hop handshake (``hop.recv`` on the "hop" track, paired
        # with the door's ``hop.send`` by (trace, hop) args) and
        # CHECKPOINTS the file around delivery: once before the first
        # byte of every stream leaves the socket, once after the
        # terminal frame. The pre-first-byte save is the crash
        # contract — a SIGKILL that lands mid-stream necessarily lands
        # after some frame was relayed, so the victim's admission spans
        # (queued/prefill/first_token) are already durable and the
        # merged fleet timeline renders the dead incarnation's head.
        self._trace = trace
        self._trace_path = trace_path
        self._cond = threading.Condition()
        self._streams: dict[int, _Stream] = {}
        self._commands: list[str] = []
        self._closed = False
        self.requests_served = 0    # completions fully delivered
        self.requests_failed = 0    # submit rejections + client hangups
        self.requests_resumed = 0   # mid-stream failover re-attaches
        # Serve-loop liveness epoch: bumped once per loop pass and
        # exported on /healthz. A replica whose process answers HTTP
        # but whose engine thread is stuck (deadlock, hung dispatch)
        # keeps a FROZEN heartbeat — the supervisor's wedged-replica
        # detector watches exactly this.
        self._heartbeat = 0
        if exporter is None:
            # Delegation-only exporter: bound to an ephemeral port but
            # never started — only its _handle logic runs, on THIS
            # server's handler threads, so /metrics via the front door
            # is byte-compatible with a bare exporter scrape.
            exporter = MetricsExporter(
                engine.flight_snapshot, port=0, host=host,
                phase_provider=lambda: engine.phase,
                health_provider=self._health,
                timeseries_provider=engine.timeseries_snapshot,
                alerts_provider=engine.alerts_snapshot)
            self._owns_exporter = True
        else:
            self._owns_exporter = False
        self._exporter = exporter
        engine.set_token_listener(self._tokens_landed)
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # One line per request would turn stderr into an access log.
            def log_message(self, *args: Any) -> None:
                pass

            def do_GET(self) -> None:
                frontend._exporter._handle(self)

            def do_POST(self) -> None:
                frontend._handle_post(self)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = self._server.server_address[0]
        self.port = int(self._server.server_address[1])
        self._http_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="frontend-http", daemon=True)
        self._loop_thread = threading.Thread(
            target=self._serve_loop, name="frontend-loop", daemon=True)
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingFrontend":
        if not self._started:
            self._started = True
            self._http_thread.start()
            self._loop_thread.start()
        return self

    def stop(self) -> None:
        """Stop serving (idempotent): shut the HTTP server, stop the
        serve loop, release the port. The engine is left as-is — the
        caller owns drain/journal shutdown. (Named ``stop``, not
        ``close``, so the lint call graph never aliases it with the
        latency ledger's per-request ``close`` on the engine's hot
        path.)"""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._server.shutdown()
        self._http_thread.join(timeout=5.0)
        self._loop_thread.join(timeout=5.0)
        self._server.server_close()
        self._engine.set_token_listener(None)
        if self._owns_exporter:
            self._exporter.close()
        self._trace_checkpoint()

    def _trace_checkpoint(self) -> None:
        """Persist the trace file (atomic replace) when tracing is on.
        Handler-thread disk IO by design — the journal's writer thread
        owns hot-loop-adjacent IO, but delivery checkpoints ride the
        handler that just wrote the socket, never Engine.step."""
        if self._trace is not None and self._trace_path:
            self._trace.checkpoint(self._trace_path)

    def url(self, path: str = "/generate") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def _health(self) -> dict:
        """/healthz payload: the engine's health extras plus this
        frontend's serve-loop liveness epoch (the supervisor's
        wedged-replica signal) and delivery counters. Read-only."""
        h = self._engine.health()
        h["serve_loop_heartbeat"] = int(self._heartbeat)
        h["requests_resumed"] = int(self.requests_resumed)
        return h

    # -- engine thread -------------------------------------------------------
    def _serve_loop(self) -> None:
        """The single engine-driving thread: drain admin commands, step
        while there is work, latch drain completion, park briefly when
        idle (a submit wakes it)."""
        engine = self._engine
        while True:
            self._heartbeat += 1
            with self._cond:
                if self._closed:
                    return
                cmds, self._commands = self._commands, []
            for cmd in cmds:
                if cmd == "deploy":
                    if self._deploy_fn is not None:
                        self._deploy_fn()
                    else:
                        engine.arm_swap(engine.params,
                                        epoch=engine.weights_epoch + 1)
                    # Apply at this (possibly empty) boundary: step()
                    # runs the swap barrier even with nothing seated.
                    engine.step()
                elif isinstance(cmd, tuple) and cmd[0] == "attach":
                    # Mid-stream failover re-attach: stream_attach is
                    # engine-thread-only (it aligns the listener
                    # cursor), so the handler parks a box here and the
                    # loop answers it. Registering the stream and
                    # seeding it with the already-landed tokens happens
                    # under the SAME lock the listener publishes under,
                    # so no token can fall between seed and listener.
                    _, uid, st, box = cmd
                    landed = engine.stream_attach(uid)
                    with self._cond:
                        if landed is not None:
                            st.tokens.extend(landed)
                            self._streams[uid] = st
                        box["attached"] = landed is not None
                        self._cond.notify_all()
            if not engine.idle:
                engine.step()
                continue
            if engine.draining:
                engine.poll_drained()
            with self._cond:
                if self._closed:
                    return
                if not self._commands:
                    self._cond.wait(timeout=self._poll_s)

    def _tokens_landed(self, uid: int, new_tokens: list, fin) -> None:
        """Engine-thread token listener (set via set_token_listener):
        buffer and wake waiters — never blocks, never touches sockets.
        Completions without a registered stream (direct submits, e.g. a
        warm-up) are simply not buffered."""
        with self._cond:
            st = self._streams.get(uid)
            if st is not None:
                st.tokens.extend(new_tokens)
                if fin is not None:
                    st.fin = fin
                self._cond.notify_all()

    # -- handler threads -----------------------------------------------------
    def _handle_post(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0]
        try:
            raw = read_body(req.headers, req.rfile)
            body = json.loads(raw or b"{}")
        except NoBodyLength:
            # 411 ONLY here: the request declared neither
            # Content-Length nor chunked framing (ROADMAP item 2c).
            self._send_json(req, 411, {
                "error": "Content-Length or Transfer-Encoding: "
                         "chunked required"})
            return
        except (ValueError, OSError) as e:
            self._send_json(req, 400, {"error": f"bad request body: {e}"})
            return
        if path == "/generate":
            self._handle_generate(req, body)
        elif path == "/probe":
            try:
                snap = self._engine.probe_snapshot(body.get("prompt"))
            except Exception as e:  # a bad probe must not kill the server
                self._send_json(req, 500, {
                    "error": f"probe failed: {type(e).__name__}: {e}"})
                return
            self._send_json(req, 200, snap)
        elif path == "/admin/drain":
            self._engine.close_admission()
            with self._cond:
                self._cond.notify_all()
            self._send_json(req, 200, {"draining": True,
                                       "phase": self._engine.phase})
        elif path == "/admin/deploy":
            with self._cond:
                self._commands.append("deploy")
                self._cond.notify_all()
            self._send_json(req, 202, {
                "queued": True,
                "weights_epoch": int(self._engine.weights_epoch)})
        elif path == "/admin/reopen":
            self._engine.reopen()
            self._send_json(req, 200, {"draining": False,
                                       "phase": self._engine.phase})
        elif path == "/admin/check_balanced":
            # Read-only page-leak audit; meaningful at the drained
            # steady state only (callers poll /probe for idle first —
            # the serve_net chaos drills gate on this after a
            # disconnect-cancel leg).
            try:
                self._engine.check_balanced()
            except AssertionError as e:
                self._send_json(req, 200, {"balanced": False,
                                           "error": str(e)})
                return
            self._send_json(req, 200, {"balanced": True})
        else:
            self._send_json(req, 404, {
                "error": "not found",
                "endpoints": ["/generate", "/probe", "/admin/drain",
                              "/admin/deploy", "/admin/reopen",
                              "/admin/check_balanced"]})

    def _handle_generate(self, req: BaseHTTPRequestHandler,
                         body: dict) -> None:
        # Fleet tracing: the door (or any client) propagates its trace
        # id + per-request hop counter; absent headers mean a direct
        # client and the queue self-mints uid-<uid>. Either way the id
        # is echoed back (response header + done frame) so the caller
        # correlates without parsing logs.
        trace_hdr = req.headers.get("X-Graft-Trace")
        try:
            hop = int(req.headers.get("X-Graft-Hop", 0))
        except ValueError:
            hop = 0
        resume = body.get("resume")
        if resume is not None:
            try:
                uid = int(resume["uid"])
                delivered = int(resume.get("delivered", 0))
            except (KeyError, TypeError, ValueError) as e:
                self._send_json(req, 400, {
                    "error": f"bad resume cursor: {e}"})
                return
            if self._handle_resume(req, body, uid, delivered,
                                   trace_hdr=trace_hdr, hop=hop):
                return
            # Unknown uid here (another replica's stream, or journaled
            # state already compacted): fall through to a fresh submit
            # with the delivered head suppressed — greedy decoding makes
            # the regenerated stream bitwise the original, so the
            # client's concatenation is seamless.
        try:
            prompt = self._parse_prompt(body)
        except ValueError as e:
            self._send_json(req, 400, {"error": str(e)})
            return
        stream = bool(body.get("stream", True))
        mnt = body.get("max_new_tokens")
        try:
            # Register the stream in the SAME lock section as the
            # submit: the engine thread publishes under this lock, so
            # no token landed between admission and registration can be
            # lost.
            with self._cond:
                r = self._engine.submit(
                    prompt, max_new_tokens=None if mnt is None
                    else int(mnt),
                    priority=int(body.get("priority",
                                          body.get("tier", 0))),
                    tenant=str(body.get("tenant", "default")),
                    deadline_ms=body.get("deadline_ms"),
                    trace_id=trace_hdr)
                st = self._streams[r.uid] = _Stream()
                self._cond.notify_all()
        except (DrainingError, QueueFullError) as e:
            self.requests_failed += 1
            self._send_json(req, 503, {"error": str(e),
                                       "kind": type(e).__name__})
            return
        except (CacheBudgetError, ValueError) as e:
            self.requests_failed += 1
            self._send_json(req, 400, {"error": str(e),
                                       "kind": type(e).__name__})
            return
        tid = r.trace_id
        if self._trace is not None:
            # One side of the hop handshake: the door stamped hop.send
            # on ITS trace with the same (trace, hop) args; the merge
            # tool pairs the two instants to bound clock skew.
            self._trace.instant("hop.recv", track="hop", trace=tid,
                               hop=hop, uid=int(r.uid))
        skip = (int(resume.get("delivered", 0))
                if resume is not None else 0)
        try:
            if stream:
                delivered = self._stream_response(req, r.uid, st,
                                                  skip=skip,
                                                  trace_id=tid)
            else:
                delivered = self._unary_response(req, r.uid, st,
                                                 trace_id=tid)
        finally:
            with self._cond:
                self._streams.pop(r.uid, None)
        if not delivered and st.fin is None and not self._closed:
            # The client hung up while the engine was still decoding:
            # cancel instead of finishing tokens nobody will read. The
            # engine evicts at its next step boundary; the serve loop
            # is already awake (the request keeps it non-idle).
            self._engine.cancel(r.uid)
        if delivered:
            # Exactly-once cursor: the result is durably delivered, so
            # a future recovery must not redeliver it. Ack strictly
            # AFTER the last byte was written — a hangup above never
            # reaches here, and the journaled finish redelivers.
            if self._engine.journal is not None:
                self._engine.journal.ack([r.uid])
            self.requests_served += 1
        else:
            self.requests_failed += 1

    def _handle_resume(self, req: BaseHTTPRequestHandler, body: dict,
                       uid: int, delivered: int,
                       trace_hdr: str | None = None,
                       hop: int = 0) -> bool:
        """Mid-stream failover resume for a uid THIS replica owns.

        Returns True when the resume was answered here — from the
        journal's finished-unacked record (the replica died after the
        last token but before the client took delivery) or by
        re-attaching to the still-running/recovered sequence. False →
        the uid is unknown here and the caller falls back to a fresh
        submit with the delivered head suppressed."""
        tid = trace_hdr if trace_hdr is not None else f"uid-{uid}"
        if self._trace is not None:
            self._trace.instant("hop.recv", track="hop", trace=tid,
                               hop=hop, uid=int(uid), resume=True)
        if self._try_journal_tail(req, uid, delivered, trace_id=tid):
            return True
        # Re-attach to a live sequence: stream_attach must run on the
        # serve-loop (engine) thread, so park an attach command and
        # wait for its verdict.
        st = _Stream()
        box: dict = {}
        with self._cond:
            self._commands.append(("attach", uid, st, box))
            self._cond.notify_all()
            while "attached" not in box:
                if self._closed:
                    self._send_json(req, 503, {"error": "shutting down"})
                    return True
                self._cond.wait(timeout=0.1)
        if not box["attached"]:
            # Lost the race with the finish sweep: the sequence may
            # have completed between the journal check and the attach.
            return self._try_journal_tail(req, uid, delivered,
                                          trace_id=tid)
        try:
            ok = self._stream_response(req, uid, st, skip=delivered,
                                       trace_id=tid)
        finally:
            with self._cond:
                self._streams.pop(uid, None)
        if ok:
            if self._engine.journal is not None:
                self._engine.journal.ack([uid])
            self.requests_served += 1
            self.requests_resumed += 1
        else:
            if st.fin is None and not self._closed:
                self._engine.cancel(uid)
            self.requests_failed += 1
        return True

    def _try_journal_tail(self, req: BaseHTTPRequestHandler, uid: int,
                          delivered: int,
                          trace_id: str | None = None) -> bool:
        """Serve a finished-unacked journal record's undelivered tail
        as a normal SSE stream; ack only after the last byte (the
        exactly-once cursor, unchanged). False when the journal holds
        no finished record for ``uid``."""
        journal = self._engine.journal
        if journal is None:
            return False
        snap = journal.live_snapshot(uid)
        if snap is None or not snap.finished:
            return False
        tokens = (snap.finish_tokens if snap.finish_tokens is not None
                  else snap.tokens)
        payload = {
            "uid": int(uid),
            "finish_reason": str(snap.finish_reason),
            "tokens": [int(t) for t in tokens],
            "prompt_len": len(snap.prompt),
            "priority": int(snap.priority),
            "tenant": str(snap.tenant),
            # Redelivered verbatim from the journal: the wall detail
            # died with the process that served it, so no ledger —
            # the door's fleet audit skips the replica-lifetime check
            # for this request (router-side conservation still holds).
            "trace_id": (trace_id if trace_id is not None
                         else f"uid-{uid}"),
            "ledger": None,
        }
        try:
            req.send_response(200)
            req.send_header("Content-Type", SSE_CONTENT_TYPE)
            req.send_header("Cache-Control", "no-store")
            req.send_header("X-Graft-Trace", payload["trace_id"])
            req.send_header("Connection", "close")
            req.end_headers()
            tail = payload["tokens"][delivered:]
            if tail:
                req.wfile.write(_sse_event("tokens", {
                    "uid": int(uid), "tokens": tail}))
            req.wfile.write(_sse_event("done", payload))
        except (BrokenPipeError, ConnectionResetError):
            self.requests_failed += 1
            return True  # handled: not acked, a later resume retries
        journal.ack([uid])
        self.requests_served += 1
        self.requests_resumed += 1
        self._trace_checkpoint()
        return True

    def _await(self, st: _Stream, sent: int) -> tuple[list[int], Any]:
        """Block until ``st`` holds tokens past ``sent`` (or its finish
        record); returns the new batch + fin (fin only once all tokens
        were consumed)."""
        with self._cond:
            while len(st.tokens) <= sent and st.fin is None:
                if self._closed:
                    return [], None
                self._cond.wait(timeout=0.1)
            batch = st.tokens[sent:]
            fin = st.fin if len(st.tokens) == sent + len(batch) else None
        return batch, fin

    def _stream_response(self, req: BaseHTTPRequestHandler, uid: int,
                         st: _Stream, *, skip: int = 0,
                         trace_id: str | None = None) -> bool:
        """SSE delivery: one ``tokens`` event per landed batch, one
        terminal ``done`` event. ``skip`` suppresses the first N tokens
        (a failover resume: the client already holds them from the dead
        relay — the ``done`` payload still carries the FULL array, so
        ``streamed == done`` holds for head + tail concatenation).
        Returns True iff every byte reached the socket (the ack gate)."""
        try:
            req.send_response(200)
            req.send_header("Content-Type", SSE_CONTENT_TYPE)
            req.send_header("Cache-Control", "no-store")
            if trace_id is not None:
                req.send_header("X-Graft-Trace", trace_id)
            req.send_header("Connection", "close")
            req.end_headers()
            sent = 0
            fin = None
            checkpointed = False
            while fin is None:
                batch, fin = self._await(st, sent)
                if not batch and fin is None:
                    return False  # frontend closing mid-stream
                sent += len(batch)
                if skip:
                    drop = min(skip, len(batch))
                    batch = batch[drop:]
                    skip -= drop
                if batch:
                    if not checkpointed:
                        # Durable-before-first-byte (see __init__): the
                        # admission spans for this stream are on disk
                        # before any frame a chaos kill could key on.
                        self._trace_checkpoint()
                        checkpointed = True
                    req.wfile.write(_sse_event("tokens", {
                        "uid": uid, "tokens": batch}))
            req.wfile.write(_sse_event("done", _fin_payload(fin)))
        except (BrokenPipeError, ConnectionResetError):
            return False  # client hung up: not acked, journal redelivers
        self._trace_checkpoint()
        return True

    def _unary_response(self, req: BaseHTTPRequestHandler, uid: int,
                        st: _Stream,
                        trace_id: str | None = None) -> bool:
        sent = 0
        while True:
            batch, fin = self._await(st, sent)
            if not batch and fin is None:
                return False
            sent += len(batch)
            if fin is not None:
                ok = self._send_json(
                    req, 200, _fin_payload(fin),
                    headers=(None if trace_id is None
                             else {"X-Graft-Trace": trace_id}))
                self._trace_checkpoint()
                return ok

    @staticmethod
    def _parse_prompt(body: dict) -> np.ndarray:
        if body.get("prompt") is not None:
            return np.asarray(body["prompt"], np.int32)
        if body.get("text") is not None:
            # Byte-level tokens — the gpt/torch_cuda/serve.py convention.
            return np.frombuffer(str(body["text"]).encode("utf-8"),
                                 np.uint8).astype(np.int32)
        raise ValueError("body needs 'prompt' (token id list) or "
                         "'text' (utf-8 string)")

    @staticmethod
    def _send_json(req: BaseHTTPRequestHandler, code: int,
                   payload: dict,
                   headers: dict[str, str] | None = None) -> bool:
        data = (json.dumps(payload, allow_nan=False) + "\n").encode()
        try:
            req.send_response(code)
            req.send_header("Content-Type", "application/json")
            req.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                req.send_header(k, v)
            req.end_headers()
            req.wfile.write(data)
            return True
        except (BrokenPipeError, ConnectionResetError):
            return False


def _sse_event(name: str, payload: dict) -> bytes:
    return (f"event: {name}\ndata: "
            f"{json.dumps(payload, allow_nan=False)}\n\n").encode()


def _fin_payload(fin) -> dict:
    """The terminal event body: the FinishedRequest's client-facing
    fields (host ints by contract — fin.tokens is the completion's
    int32 array)."""
    # graftlint: disable=hot-path-transfer -- fin.tokens is the host int32 completion array by contract; no device value involved
    return {
        "uid": int(fin.uid),
        "finish_reason": str(fin.finish_reason),
        "tokens": [int(t) for t in fin.tokens],
        "prompt_len": int(fin.prompt.size),
        "priority": int(fin.priority),
        "tenant": str(fin.tenant),
        "trace_id": fin.trace_id,
        # Wall-clock detail for the fleet ledger audit on the router
        # door: the replica's conserved interval list, pre-joined so the
        # door never needs a second round trip.  None when the record
        # was journal-redelivered (the live ledger died with the
        # serving process) — the door skips the replica-lifetime check.
        "ledger": (None if fin.ledger is None else {
            "lifetime_ms": fin.ledger.lifetime_ms,
            "causes_ms": fin.ledger.totals_ms(),
            "conserved": not fin.ledger.violations(ttft_ms=fin.ttft_ms),
        }),
    }
