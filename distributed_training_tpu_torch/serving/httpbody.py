"""HTTP request-body framing shared by the serving HTTP planes.

The port of ``distributed_training_tpu/serving/httpbody.py``, unchanged.

The stdlib ``BaseHTTPRequestHandler`` parses headers but leaves the
body on ``rfile`` — and reads exactly what ``Content-Length`` promises,
which silently truncates a chunked (``Transfer-Encoding: chunked``)
POST to zero bytes. Both the replica frontend (serving/frontend.py)
and the router front door (serving/router.py) accept streaming
clients, so both need the same discipline (ROADMAP item 2c):

- ``Content-Length: N`` → read exactly N bytes;
- ``Transfer-Encoding: chunked`` → decode the chunked framing
  (hex-size line, data, CRLF, 0-terminator, optional trailers);
- neither → the request length is unknowable; the handler answers
  ``411 Length Required`` — the ONLY case that earns a 411.

Malformed chunked framing raises :class:`ValueError`; callers map it
to a 400 like any other bad body.
"""

from __future__ import annotations

# Per-read and total budgets: the serving plane's JSON bodies are tiny
# (a prompt plus knobs); a chunked client claiming gigabytes is a
# malformed or hostile request, not a workload.
MAX_BODY_BYTES = 8 << 20
_MAX_LINE = 1024


class NoBodyLength(Exception):
    """Neither Content-Length nor chunked framing was present."""


def read_body(headers, rfile, *, max_bytes: int = MAX_BODY_BYTES) -> bytes:
    """Read one request body from ``rfile`` per ``headers`` framing.

    Returns the raw bytes (possibly ``b""``). Raises
    :class:`NoBodyLength` when the request declares no framing at all
    (the 411 case) and :class:`ValueError` on malformed framing or a
    body over ``max_bytes``.
    """
    te = (headers.get("Transfer-Encoding") or "").lower()
    if "chunked" in te:
        return _read_chunked(rfile, max_bytes)
    cl = headers.get("Content-Length")
    if cl is None:
        raise NoBodyLength()
    try:
        length = int(cl)
    except ValueError as e:
        raise ValueError(f"bad Content-Length: {cl!r}") from e
    if length < 0 or length > max_bytes:
        raise ValueError(f"Content-Length {length} out of range")
    return rfile.read(length) if length else b""


def _read_chunked(rfile, max_bytes: int) -> bytes:
    """Decode RFC 9112 §7.1 chunked framing from ``rfile``."""
    parts: list[bytes] = []
    total = 0
    while True:
        line = rfile.readline(_MAX_LINE + 1)
        if not line.endswith(b"\n") or len(line) > _MAX_LINE:
            raise ValueError("chunk-size line missing or oversized")
        # Chunk extensions (";name=value") are legal; ignore them.
        size_token = line.strip().split(b";", 1)[0]
        try:
            size = int(size_token, 16)
        except ValueError as e:
            raise ValueError(f"bad chunk size {size_token!r}") from e
        if size == 0:
            break
        total += size
        if total > max_bytes:
            raise ValueError(f"chunked body exceeds {max_bytes} bytes")
        data = rfile.read(size)
        if len(data) != size:
            raise ValueError("chunk shorter than its declared size")
        parts.append(data)
        if rfile.read(2) != b"\r\n":
            raise ValueError("chunk data not CRLF-terminated")
    # Trailer section: header lines until the terminating blank line.
    while True:
        line = rfile.readline(_MAX_LINE + 1)
        if not line.endswith(b"\n") or len(line) > _MAX_LINE:
            raise ValueError("trailer line missing or oversized")
        if line in (b"\r\n", b"\n"):
            return b"".join(parts)
