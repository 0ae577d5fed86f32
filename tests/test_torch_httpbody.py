"""``serving/httpbody.py``'s ``read_body`` against the JAX package's on the
same framings: Content-Length, chunked (extensions, trailers), malformed
framing, bodies over the limit and no length at all. Each case gives the
same bytes, or the same exception type and message, in both."""

import io

import pytest

from distributed_training_tpu.serving import httpbody as jax_httpbody
from distributed_training_tpu_torch.serving import httpbody

BODY = b'{"prompt": [1, 2, 3], "max_new_tokens": 4}'

CASES = {
    "content_length": ({"Content-Length": str(len(BODY))}, BODY, None),
    "content_length_zero": ({"Content-Length": "0"}, b"", None),
    "content_length_bad": ({"Content-Length": "ten"}, BODY, None),
    "content_length_negative": ({"Content-Length": "-1"}, BODY, None),
    "content_length_over_limit": ({"Content-Length": "65"}, b"x" * 65, 64),
    "chunked": ({"Transfer-Encoding": "chunked"},
                b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n", None),
    "chunked_extension_and_trailer": (
        {"Transfer-Encoding": "gzip, Chunked"},
        b"3;name=v\r\nabc\r\n0\r\nX-Trailer: 1\r\n\r\n", None),
    "chunked_bad_size": ({"Transfer-Encoding": "chunked"}, b"zz\r\nabc\r\n0\r\n\r\n", None),
    "chunked_short_chunk": ({"Transfer-Encoding": "chunked"}, b"9\r\nabc", None),
    "chunked_no_crlf": ({"Transfer-Encoding": "chunked"}, b"3\r\nabcXY0\r\n\r\n", None),
    "chunked_no_terminator": ({"Transfer-Encoding": "chunked"}, b"3\r\nabc\r\n", None),
    "chunked_over_limit": ({"Transfer-Encoding": "chunked"},
                           b"40\r\n" + b"y" * 64 + b"\r\n1\r\nz\r\n0\r\n\r\n", 64),
    "chunked_oversized_line": ({"Transfer-Encoding": "chunked"}, b"1" * 2000 + b"\r\n", None),
    "no_length": ({}, BODY, None),
}


def _read(mod, headers, raw, limit):
    kw = {} if limit is None else {"max_bytes": limit}
    try:
        return ("ok", mod.read_body(headers, io.BytesIO(raw), **kw))
    except mod.NoBodyLength:
        return ("NoBodyLength", None)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", list(CASES))
def test_read_body_matches_jax(case):
    headers, raw, limit = CASES[case]
    got = _read(httpbody, headers, raw, limit)
    assert got == _read(jax_httpbody, headers, raw, limit)
    if case.startswith("chunked") and got[0] == "ok":
        assert got[1] in (b"hello world", b"abc")
    if case == "no_length":
        assert got == ("NoBodyLength", None)
