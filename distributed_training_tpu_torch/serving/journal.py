"""Write-ahead request journal: crash-durable serving state.

The port of ``distributed_training_tpu/serving/journal.py``, unchanged
(host Python: bytes, segments and the durable state machine).

The training plane survives a ``kill -9`` bitwise (verified
checkpoints + chaos resume), but an engine process dying used to lose
every request it had accepted. This module closes that gap with the
same discipline ``resilience/verify.py`` applies to checkpoints —
commit-ordered, checksummed, torn-tail-tolerant artifacts — applied to
the *request* plane:

- **Admission is durable.** ``log_admit`` appends (and, per the fsync
  policy, syncs) the request's full admission record — uid, prompt
  tokens, budget, SLO tier, tenant, wall-anchored arrival and deadline
  clocks — on the producer thread, BEFORE ``submit`` returns. A request
  the journal never saw was never accepted.
- **Progress is asynchronous.** Emitted-token batches, preemptions and
  finish records are *enqueued* from the engine's iteration tail and
  persisted by a background writer thread — the decode loop never
  writes, flushes or fsyncs (pinned by the graftlint hot-path rule).
  Tokens past the last durable flush are NOT lost: recovery re-seats
  the sequence through the preempt-and-requeue resume path and the same
  ``fold_in(rng, position)`` stream recomputes them bitwise.
- **Replay is idempotent.** Token records carry their absolute emitted
  base, admits deduplicate by uid, finishes overwrite — so overlapping
  segments (a compaction interrupted between writing the new segment
  and deleting the old) and repeated recoveries converge to the same
  state. Delivery is exactly-once via the client cursor: ``ack(uid)``
  records that the *consumer* durably took a finished result, and only
  finished-AND-acked requests stop being redelivered (and become
  eligible for compaction).
- **Torn tails never crash.** Each record is length-prefixed and
  crc32-framed; recovery truncates a segment at the first bad record,
  quarantines the severed bytes to ``<segment>.corrupt`` (forensics
  kept, scans stop tripping on them — the ``quarantine_checkpoint``
  idiom), and continues. A machine that died mid-append loses at most
  the torn record, which the resume path recomputes.
- **Growth is bounded.** When the active segment exceeds
  ``segment_bytes`` the journal rotates: the live state (unfinished
  requests, finished-but-unacked results, notes) is compacted into the
  head of a fresh segment — written tmp-then-rename, the COMMITTED
  idiom — and the old segments are deleted. Finished-and-acked
  requests vanish entirely, so a long run's journal footprint tracks
  its *in-flight* state, not its history.

Record framing: ``<u32 payload_len><u32 crc32(payload)><payload>``,
payload = compact JSON. Record kinds: ``cfg`` (RNG/sampling
fingerprint — replaying into a differently-seeded engine would NOT
reproduce the journaled streams, so recovery refuses), ``a`` admit
(``s:1`` marks a compaction snapshot, which *replaces* prior state for
that uid), ``t`` token batch (absolute base + first/last wall stamps),
``p`` preempt, ``f`` finish (reason + full final tokens — authoritative
over token batches), ``d`` delivered (the client cursor), ``n`` note
(small app-level progress dicts, e.g. the bench's submission cursor;
last write per key wins).

Wall-clock anchors (the one deliberate ``time.time`` consumer outside
observability): ``perf_counter`` timestamps die with the process, so
deadline clocks are journaled as (arrival wall time, offsets) and
recovery maps them back into the new process's ``perf_counter``
timeline — downtime keeps billing against TTFT/total deadlines, which
is exactly what "the clock keeps running" must mean across a restart.

The radix prefix cache (``serving/prefix_cache.py``) is deliberately
NOT journaled: the trie indexes in-memory KV pages that die with the
process, and reuse is performance-only — a hit changes which pages a
block table aliases, never a token. Recovery therefore COLD-STARTS the
trie (its fingerprint knobs are absent from ``cfg`` for the same
lane-independence reason as the paging/batch knobs) and replay
repopulates it as recovered requests re-prefill and finish; redelivered
results stay bitwise either way.

``Engine.recover()`` (serving/engine.py) owns the replay semantics;
this module owns bytes, segments and the durable state machine.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Iterable

from distributed_training_tpu_torch.resilience.errors import JournalCorruptError

_FRAME = struct.Struct("<II")
_SEGMENT_PREFIX = "wal-"
_SEGMENT_SUFFIX = ".log"
# A length prefix beyond this is framing garbage, not a record: no
# single journal record (admit with a full prompt, finish with a full
# completion) comes within orders of magnitude of it, and bailing here
# keeps a corrupt length from driving a giant allocation.
_MAX_RECORD_BYTES = 1 << 26


def _wall_of(perf_t: float) -> float:
    """Map a live ``perf_counter`` timestamp onto the wall clock so it
    survives the process (recovery maps it back; see module docstring).
    """
    # graftlint: disable=determinism -- the journal's one deliberate wall-clock read: perf_counter timestamps die with the process, and deadline clocks must keep running across restarts
    return time.time() - (time.perf_counter() - perf_t)


def perf_of(wall_t: float) -> float:
    """The inverse map at recovery: a journaled wall timestamp placed
    on the NEW process's ``perf_counter`` timeline. Downtime lands
    where it belongs — between the journaled instant and now — so
    deadline arithmetic (``now >= deadline_t``) keeps working unchanged.
    """
    # graftlint: disable=determinism -- recovery's wall-clock read, paired with _wall_of above
    return time.perf_counter() - (time.time() - wall_t)


@dataclasses.dataclass
class JournaledRequest:
    """One request's durable state — the journal's live mirror entry
    AND the recovery result (the same struct round-trips)."""

    uid: int
    prompt: list
    max_new_tokens: int
    priority: int = 0
    tenant: str = "default"
    arrival_wall: float = 0.0
    ttft_rel_s: float | None = None    # deadline offsets from arrival
    deadline_rel_s: float | None = None
    tokens: list = dataclasses.field(default_factory=list)
    preempts: int = 0
    first_wall: float | None = None    # first emitted token, wall clock
    last_wall: float | None = None     # newest journaled token
    finish_reason: str | None = None
    finish_tokens: list | None = None  # authoritative final stream
    ttft_ms: float | None = None
    tpot_ms: float | None = None
    delivered: bool = False            # client cursor (ack)

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass
class RecoveredState:
    """What :meth:`RequestJournal.recover` reconstructed from disk."""

    requests: dict  # uid -> JournaledRequest (finished+acked dropped)
    notes: dict
    max_uid: int          # highest uid EVER journaled; -1 when none
    segments_read: int
    records_replayed: int
    torn_bytes: int       # quarantined tail bytes (0 = clean shutdown)


class RequestJournal:
    """Append-only write-ahead log of one engine's request plane.

    >>> j = RequestJournal("/data/journal", fingerprint={"seed": 0})
    >>> state = j.recover()          # REQUIRED before any append
    >>> j.log_admit(req)             # sync, producer thread
    >>> j.note_tokens(seq)           # enqueue-only, engine iteration
    >>> j.ack(fin.uid)               # client cursor after consumption

    ``fsync`` policy: ``"none"`` (OS page cache only — survives
    ``kill -9``, not power loss), ``"batch"`` (one fsync per writer
    flush — the default), ``"always"`` (fsync after every record).

    Thread model: ``_lock`` guards the pending queue, the live mirror
    and the counters (every enqueue path is lock-then-append, cheap
    enough for the iteration tail); ``_io_lock`` serializes disk writes
    (writer thread, sync admits, rotation, recovery). Disk I/O is never
    performed while ``_lock`` is held, so the engine's enqueues never
    wait on the filesystem.
    """

    def __init__(self, path: str, *, fsync: str = "batch",
                 segment_bytes: int = 1 << 20,
                 fingerprint: dict | None = None,
                 flush_interval_s: float = 0.01,
                 trace=None):
        if fsync not in ("none", "batch", "always"):
            raise ValueError(
                f"fsync policy must be none|batch|always, got {fsync!r}")
        if segment_bytes < 4096:
            raise ValueError(
                f"segment_bytes must be >= 4096, got {segment_bytes}")
        self.path = path
        self.fsync = fsync
        self.segment_bytes = int(segment_bytes)
        self.fingerprint = dict(fingerprint or {})
        # Timeline visibility (observability/trace.py; None = off): the
        # background writer draws per-batch write/fsync spans and a
        # journal-queue-depth counter on a 'journal-writer' track, so
        # the writer thread stops being invisible in Perfetto. Spans
        # are emitted AFTER the io lock is released — the trace
        # session's own lock must never nest inside journal locks.
        self.trace = trace
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._pending: list[dict] = []
        self._live: dict[int, JournaledRequest] = {}
        self._notes: dict[str, Any] = {}
        self._max_uid = -1
        self._recovered = False
        self._crashed = False
        self._shut = False
        self._seen_fp: dict | None = None
        # Raw-fd writes (os.open/os.write): the records are already
        # batched into one blob per flush, so buffered file objects add
        # nothing — and a second buffering layer between "persisted"
        # and the disk is exactly what a durability log must not have.
        self._fd: int | None = None
        self._seg_index = 0
        self._seg_bytes = 0
        # Rotation floor: the size of the last compaction's snapshot.
        # Rotating again before the segment has grown well past it
        # would rewrite the whole live state per flush (O(state) every
        # persist when in-flight work alone exceeds segment_bytes);
        # requiring 2x the floor keeps compaction amortized O(1) per
        # appended byte no matter how deep the queue gets.
        self._compact_floor = 0
        # Durability counters (engine.stats() surfaces them; the
        # exporter's /healthz carries them for the recovery drill).
        self.records_written = 0
        self.fsyncs = 0
        self.bytes_written = 0
        self.segments_rotated = 0
        self.write_errors = 0
        self._warned_write = False
        self._stop = threading.Event()
        self._writer = threading.Thread(
            target=self._writer_loop, name="request-journal",
            args=(flush_interval_s,), daemon=True)

    # -- segment plumbing ----------------------------------------------------
    def _segment_name(self, index: int) -> str:
        return f"{_SEGMENT_PREFIX}{index:08d}{_SEGMENT_SUFFIX}"

    def _segment_files(self) -> list[tuple[int, str]]:
        if not os.path.isdir(self.path):
            return []
        out = []
        for name in os.listdir(self.path):
            if (name.startswith(_SEGMENT_PREFIX)
                    and name.endswith(_SEGMENT_SUFFIX)):
                try:
                    idx = int(name[len(_SEGMENT_PREFIX):
                                   -len(_SEGMENT_SUFFIX)])
                except ValueError:
                    continue
                out.append((idx, os.path.join(self.path, name)))
        return sorted(out)

    @staticmethod
    def _encode(payload: dict) -> bytes:
        data = json.dumps(payload, separators=(",", ":"),
                          allow_nan=False).encode("utf-8")
        return _FRAME.pack(len(data), zlib.crc32(data)) + data

    def _read_segment(self, path: str) -> list[dict]:
        """Decode one segment; a torn tail (short frame, bad length,
        crc mismatch, unparsable payload) truncates the segment at the
        last good record and quarantines the severed bytes — never a
        crash, and never a re-trip on the next recovery."""
        with open(path, "rb") as fh:
            data = fh.read()
        records: list[dict] = []
        off = 0
        while off + _FRAME.size <= len(data):
            ln, crc = _FRAME.unpack_from(data, off)
            end = off + _FRAME.size + ln
            if ln > _MAX_RECORD_BYTES or end > len(data):
                break
            payload = data[off + _FRAME.size:end]
            if zlib.crc32(payload) != crc:
                break
            try:
                records.append(json.loads(payload))
            except (ValueError, UnicodeDecodeError):
                break
            off = end
        if off < len(data):
            dst = path + ".corrupt"
            n = 0
            while os.path.exists(dst):
                n += 1
                dst = f"{path}.corrupt{n}"
            with open(dst, "wb") as fh:
                fh.write(data[off:])
            with open(path, "r+b") as fh:
                fh.truncate(off)
            self._torn_bytes += len(data) - off
        return records

    # -- record application (recovery AND the live mirror share it) ----------
    def _apply(self, rec: dict) -> None:
        k = rec.get("k")
        if k == "cfg":
            # Last cfg record wins: a weight hot-swap journals an
            # updated fingerprint (new weights_epoch) mid-log, and the
            # LATEST one is what the journaled tail was produced under
            # — recover() validates against it after the full replay.
            self._seen_fp = rec.get("fp", {})
        elif k == "a":
            uid = int(rec["u"])
            self._max_uid = max(self._max_uid, uid)
            entry = JournaledRequest(
                uid=uid, prompt=list(rec["p"]),
                max_new_tokens=int(rec["m"]),
                priority=int(rec.get("pr", 0)),
                tenant=str(rec.get("t", "default")),
                arrival_wall=float(rec["w"]),
                ttft_rel_s=rec.get("td"), deadline_rel_s=rec.get("dd"),
                preempts=int(rec.get("pe", 0)))
            if rec.get("s"):
                self._live[uid] = entry  # compaction snapshot: replace
            else:
                self._live.setdefault(uid, entry)
        elif k == "t":
            entry = self._live.get(int(rec["u"]))
            if entry is None:
                return
            base = int(rec["b"])
            have = len(entry.tokens)
            if base <= have:
                entry.tokens.extend(rec["x"][have - base:])
            if rec.get("fw") is not None and entry.first_wall is None:
                entry.first_wall = float(rec["fw"])
            if rec.get("lw") is not None:
                entry.last_wall = float(rec["lw"])
        elif k == "p":
            entry = self._live.get(int(rec["u"]))
            if entry is not None:
                # Absolute count, like token bases: a 'p' record racing
                # a rotation appears in BOTH the snapshot admit (as
                # ``pe``) and the new segment — max() keeps double
                # replay a state no-op.
                entry.preempts = max(entry.preempts,
                                     int(rec.get("n",
                                                 entry.preempts + 1)))
        elif k == "f":
            entry = self._live.get(int(rec["u"]))
            if entry is None:
                return
            entry.finish_reason = str(rec["r"])
            entry.finish_tokens = list(rec["x"])
            entry.ttft_ms = rec.get("ttft")
            entry.tpot_ms = rec.get("tpot")
        elif k == "d":
            uid = int(rec["u"])
            entry = self._live.get(uid)
            if entry is not None:
                entry.delivered = True
                if entry.finished:
                    # Finished + acked: nothing left to redeliver or
                    # compact — drop the mirror entry (memory stays
                    # bounded by in-flight work, not run history).
                    del self._live[uid]
        elif k == "n":
            d = rec.get("d", {})
            self._max_uid = max(self._max_uid,
                                int(d.pop("_journal_max_uid", -1)))
            self._notes |= d
        # Unknown kinds are skipped: a newer writer's extra record types
        # must not brick an older reader's recovery.

    # -- recovery ------------------------------------------------------------
    def recover(self) -> RecoveredState:
        """Replay every segment into the live mirror, compact the
        result into a fresh segment, and open the journal for appends.

        MUST be called (once) before any append — appending to a
        directory whose prior state was never read would let the next
        compaction silently drop it. Idempotent in effect: recovering
        the same directory twice yields the same state (token bases and
        uid-keyed admits make replay idempotent), and the compaction
        performed here already bounds what the next recovery reads.
        """
        with self._io_lock:
            os.makedirs(self.path, exist_ok=True)
            self._torn_bytes = 0
            replayed = 0
            segments = self._segment_files()
            # A rotation interrupted before its atomic rename leaves a
            # .tmp the replay must ignore (its content is duplicated by
            # the still-present old segments) — clean it up.
            for name in os.listdir(self.path):
                if name.endswith(".tmp"):
                    os.remove(os.path.join(self.path, name))
            with self._lock:
                self._live.clear()
                self._notes.clear()
                self._max_uid = -1
                self._seen_fp = None
            for _, seg in segments:
                for rec in self._read_segment(seg):
                    self._apply(rec)
                    replayed += 1
            if (self.fingerprint and self._seen_fp is not None
                    and self._seen_fp != self.fingerprint):
                raise JournalCorruptError(
                    f"journal at {self.path} was last written by an "
                    f"engine with a different RNG/sampling/weights "
                    f"fingerprint ({self._seen_fp} != "
                    f"{self.fingerprint}); replaying it here would NOT "
                    f"reproduce the journaled token streams. Point "
                    f"--journal-dir at a fresh directory or restart "
                    f"with the original serving config and weights",
                    path=self.path, reason="fingerprint")
            state = RecoveredState(
                requests={uid: e for uid, e in sorted(self._live.items())
                          if not (e.finished and e.delivered)},
                notes=dict(self._notes),
                max_uid=self._max_uid,
                segments_read=len(segments),
                records_replayed=replayed,
                torn_bytes=self._torn_bytes)
            # Compact what survived into a fresh segment and drop the
            # replayed ones: recovery both bounds the next recovery and
            # proves the rotation path on every restart.
            next_index = (segments[-1][0] + 1) if segments else 0
            self._write_compacted(next_index,
                                  [seg for _, seg in segments])
            self._recovered = True
        if not self._writer.is_alive() and not self._stop.is_set():
            self._writer.start()
        return state

    def _snapshot_payloads(self) -> list[dict]:
        """The compacted restatement of the live state (caller holds
        ``_lock``): fingerprint, notes + uid high-water, then one
        admit(+tokens)(+finish) group per surviving request."""
        payloads: list[dict] = [{"k": "cfg", "fp": self.fingerprint}]
        notes = dict(self._notes)
        notes["_journal_max_uid"] = self._max_uid
        payloads.append({"k": "n", "d": notes})
        for uid, e in sorted(self._live.items()):
            if e.finished and e.delivered:
                continue
            admit = {"k": "a", "s": 1, "u": uid, "p": e.prompt,
                     "m": e.max_new_tokens, "pr": e.priority,
                     "t": e.tenant, "w": e.arrival_wall,
                     "pe": e.preempts}
            if e.ttft_rel_s is not None:
                admit["td"] = e.ttft_rel_s
            if e.deadline_rel_s is not None:
                admit["dd"] = e.deadline_rel_s
            payloads.append(admit)
            if e.tokens:
                payloads.append({"k": "t", "u": uid, "b": 0,
                                 "x": list(e.tokens),
                                 "fw": e.first_wall, "lw": e.last_wall})
            if e.finished:
                # finished+delivered entries were dropped at ack (and
                # skipped above), so a snapshot never carries an acked
                # result — the cursor state IS the entry's absence.
                payloads.append({"k": "f", "u": uid,
                                 "r": e.finish_reason,
                                 "x": list(e.finish_tokens or []),
                                 "ttft": e.ttft_ms, "tpot": e.tpot_ms})
        return payloads

    def _write_compacted(self, index: int, old_paths: list[str]) -> None:
        """Write the live state as segment ``index`` (tmp + atomic
        rename — the COMMITTED idiom: a crash mid-write leaves the old
        segments authoritative), then delete the old segments. Caller
        holds ``_io_lock``."""
        with self._lock:
            payloads = self._snapshot_payloads()
        blob = b"".join(self._encode(p) for p in payloads)
        final = os.path.join(self.path, self._segment_name(index))
        tmp = final + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, blob)
            if self.fsync != "none":
                os.fsync(fd)
                self.fsyncs += 1
        finally:
            os.close(fd)
        os.replace(tmp, final)
        for old in old_paths:
            if os.path.abspath(old) != os.path.abspath(final):
                os.remove(old)
        if self._fd is not None:
            os.close(self._fd)
        self._fd = os.open(final, os.O_WRONLY | os.O_APPEND)
        self._seg_index = index
        self._seg_bytes = len(blob)
        self._compact_floor = len(blob)
        self.records_written += len(payloads)
        self.bytes_written += len(blob)

    # -- append paths --------------------------------------------------------
    def _require_open(self) -> None:
        if self._crashed:
            raise JournalCorruptError(
                "journal was crashed (crash()); no further appends",
                path=self.path, reason="crashed")
        if self._shut:
            # A silently-dropped append would break the "accepted ⇒
            # durable" contract without a trace — refuse loudly, like
            # the crashed/unrecovered states.
            raise JournalCorruptError(
                "journal was shut down (shutdown()); no further "
                "appends — an admission recorded nowhere would be "
                "silently lost at the next crash",
                path=self.path, reason="closed")
        if not self._recovered:
            raise JournalCorruptError(
                f"journal at {self.path} has not been recovered: call "
                f"recover() before appending, or prior state would be "
                f"silently dropped at the next compaction",
                path=self.path, reason="unrecovered")

    def log_admit(self, req) -> None:
        """Durably journal one accepted request (producer thread; the
        sync write IS the acceptance contract — persisted before
        ``submit`` returns to the caller)."""
        self._require_open()
        arrival_wall = _wall_of(req.arrival_t)
        rec = {"k": "a", "u": int(req.uid),
               "p": [int(t) for t in req.prompt],
               "m": int(req.max_new_tokens),
               "pr": int(req.priority), "t": str(req.tenant),
               "w": arrival_wall}
        if req.ttft_deadline_t is not None:
            rec["td"] = req.ttft_deadline_t - req.arrival_t
        if req.deadline_t is not None:
            rec["dd"] = req.deadline_t - req.arrival_t
        with self._lock:
            self._pending.append(rec)
            self._apply(rec)
        self.persist()

    def note_tokens(self, seq) -> None:
        """Enqueue the sequence's not-yet-journaled emitted tokens
        (engine iteration tail; NEVER writes — the writer thread
        persists). Wall stamps for the first/last token ride along so
        deadline attribution survives a restart."""
        self._require_open()
        with self._lock:
            entry = self._live.get(seq.request.uid)
            if entry is None:
                return  # admitted before this journal attached
            have = len(entry.tokens)
            n = len(seq.tokens)
            if n <= have:
                return
            rec = {"k": "t", "u": seq.request.uid, "b": have,
                   "x": [int(t) for t in seq.tokens[have:]]}
            if have == 0 and seq.first_token_t is not None:
                rec["fw"] = _wall_of(seq.first_token_t)
            if seq.last_token_t is not None:
                rec["lw"] = _wall_of(seq.last_token_t)
            self._pending.append(rec)
            self._apply(rec)

    def note_preempt(self, seq) -> None:
        """Journal a lossless preemption (tokens synced first, so the
        requeued prefix is reconstructible from the journal alone).
        The record carries the ABSOLUTE post-preemption count so replay
        stays idempotent even when the record straddles a rotation."""
        self.note_tokens(seq)
        with self._lock:
            entry = self._live.get(seq.request.uid)
            if entry is None:
                return
            rec = {"k": "p", "u": seq.request.uid,
                   "n": entry.preempts + 1}
            self._pending.append(rec)
            self._apply(rec)

    def note_finish(self, fin) -> None:
        """Journal a completion: reason + the FULL final token stream
        (authoritative over any token batches still in flight)."""
        self._require_open()
        rec = {"k": "f", "u": int(fin.uid), "r": fin.finish_reason,
               "x": [int(t) for t in fin.tokens],
               "ttft": fin.ttft_ms, "tpot": fin.tpot_ms}
        with self._lock:
            self._pending.append(rec)
            self._apply(rec)

    def live_snapshot(self, uid: int) -> JournaledRequest | None:
        """A point-in-time COPY of one live-mirror entry (any thread).

        The mid-stream failover read: a resume request asks "is this
        uid finished-unacked (serve the tail from here) or still in
        flight (re-attach to the engine)?" The copy detaches the
        mutable ``tokens``/``finish_tokens`` lists so the caller can
        stream from it while the engine keeps appending. None when the
        uid was never admitted here or is finished AND acked (deleted
        from the mirror at ack)."""
        with self._lock:
            entry = self._live.get(int(uid))
            if entry is None:
                return None
            snap = dataclasses.replace(
                entry, tokens=list(entry.tokens),
                finish_tokens=(list(entry.finish_tokens)
                               if entry.finish_tokens is not None
                               else None))
        return snap

    def ack(self, uids: int | Iterable[int]) -> None:
        """The client cursor: the consumer durably took these finished
        results — they stop being redelivered and compaction may drop
        them. Synchronous (client thread)."""
        self._require_open()
        if isinstance(uids, int):
            uids = (uids,)
        with self._lock:
            for uid in uids:
                rec = {"k": "d", "u": int(uid)}
                self._pending.append(rec)
                self._apply(rec)
        self.persist()

    def log_note(self, d: dict, *, flush: bool = True) -> None:
        """Journal a small app-level progress note (last write per key
        wins; the CLIs use it as their submission cursor).
        ``flush=False`` only enqueues — right when the next append on
        the SAME thread will persist anyway (the CLI cursor precedes
        its admit in one ordered batch, so "admit durable ⇒ cursor
        durable" holds without paying a second fsync per request)."""
        self._require_open()
        rec = {"k": "n", "d": dict(d)}
        with self._lock:
            self._pending.append(rec)
            self._apply(rec)
        if flush:
            self.persist()

    def update_fingerprint(self, **kw) -> None:
        """Record a mid-run fingerprint change (the engine journals the
        new ``weights_epoch`` at every hot-swap barrier): the tail of
        the log was produced under these values, and recovery validates
        against the LAST cfg record — so a restart serving different
        weights than the journal's tail is refused typed instead of
        silently mixing weight generations into 'recovered' outputs.
        Enqueue-only (the barrier runs on the decode thread)."""
        with self._lock:
            self.fingerprint.update(kw)
            if not self._recovered or self._crashed or self._shut:
                return  # pre-recovery arm: the compaction head carries it
            rec = {"k": "cfg", "fp": dict(self.fingerprint)}
            self._pending.append(rec)
            self._apply(rec)

    # -- persistence ---------------------------------------------------------
    def persist(self) -> None:
        """Drain the pending queue to the active segment and apply the
        fsync policy; rotate (compact) when the segment is over budget.
        Runs on the writer thread, the sync append paths, and the chaos
        kill hook — NEVER on the engine's decode loop."""
        with self._io_lock:
            if self._fd is None:
                return  # crashed or never recovered
            # Span bookkeeping starts AFTER the io lock lands: a sync
            # append racing the writer thread must not bill the other
            # flusher's fsyncs or its own lock wait to this batch.
            t0 = time.perf_counter()
            wrote = 0
            fsyncs0 = self.fsyncs
            rotated = False
            with self._lock:
                batch, self._pending = self._pending, []
            try:
                if batch:
                    if self.fsync == "always":
                        for payload in batch:
                            blob = self._encode(payload)
                            os.write(self._fd, blob)
                            os.fsync(self._fd)
                            self.fsyncs += 1
                            wrote += len(blob)
                    else:
                        blob = b"".join(self._encode(p) for p in batch)
                        os.write(self._fd, blob)
                        wrote = len(blob)
                        if self.fsync == "batch":
                            os.fsync(self._fd)
                            self.fsyncs += 1
                    self.records_written += len(batch)
                    self.bytes_written += wrote
                    self._seg_bytes += wrote
                if self._seg_bytes >= max(self.segment_bytes,
                                          2 * self._compact_floor):
                    self.segments_rotated += 1
                    rotated = True
                    self._write_compacted(
                        self._seg_index + 1,
                        [p for _, p in self._segment_files()])
            except OSError:
                # Transient disk fault (ENOSPC, EIO): NOTHING is lost —
                # the whole batch goes back to the queue head for the
                # next flush, and replay idempotence (uid-keyed admits,
                # absolute token bases/preempt counts, finish
                # overwrite) makes any half-written prefix harmless.
                # Callers on the sync paths see the error; the writer
                # loop retries.
                with self._lock:
                    self._pending = batch + self._pending
                self.write_errors += 1
                raise
        # Trace spans outside the io lock (see __init__): one complete
        # write(+fsync) span per non-empty flush, plus the queue-depth
        # counter (records drained this batch). Empty writer ticks draw
        # nothing — the track shows work, not the 100 Hz poll.
        if self.trace is not None and (batch or rotated):
            self.trace.complete(
                "journal.write", t0, time.perf_counter(),
                track="journal-writer", records=len(batch), bytes=wrote,
                fsyncs=self.fsyncs - fsyncs0, rotated=rotated)
            self.trace.counter("journal_queue_depth", len(batch),
                               track="journal-writer")

    def _writer_loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.persist()
            except OSError as e:
                # The writer must SURVIVE a transient disk fault —
                # persist() already re-queued the batch, so the next
                # tick retries; dying here would silently end
                # durability for the rest of the process.
                if not self._warned_write:
                    self._warned_write = True
                    import warnings

                    warnings.warn(
                        f"request journal write failed ({e}); records "
                        f"are retained in memory and retried every "
                        f"flush tick (write_errors counts the "
                        f"failures)", stacklevel=2)
        try:
            self.persist()
        except OSError:
            pass  # final best-effort flush; crash() paths land here

    def shutdown(self) -> None:
        """Flush everything and stop the writer (idempotent). A shut
        journal's directory recovers to exactly the state at shutdown.
        (Named ``shutdown`` rather than ``close``: the linter's
        over-approximate call resolution would bind every ``.close()``
        in serving/ — including the journal's own file handle — to a
        method of that name, manufacturing a lock self-cycle.)"""
        self._stop.set()
        if self._writer.is_alive():
            self._writer.join(timeout=5.0)
        if not self._crashed:
            self.persist()
        with self._io_lock:
            self._shut = True
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def pause(self) -> None:
        """Test/chaos hook: stop the background writer (one final flush
        included). Records enqueued AFTER this stay in memory until an
        explicit :meth:`persist` — or are dropped by :meth:`crash` —
        which is the deterministic way to stage a "tokens past the last
        durable flush" tail for the recovery drills."""
        self._stop.set()
        if self._writer.is_alive():
            self._writer.join(timeout=5.0)

    def crash(self) -> None:
        """Chaos/test hook: die like ``kill -9`` — stop the writer and
        DROP every unpersisted record. What recovery then sees is
        exactly what a hard kill would have left durable."""
        self._stop.set()
        if self._writer.is_alive():
            self._writer.join(timeout=5.0)
        with self._io_lock:
            self._crashed = True
            with self._lock:
                self._pending.clear()
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
