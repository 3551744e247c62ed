"""The port's HTTP/1.1, multipart and RFC 6455 shell (``server/http.py``,
``server/multipart.py``, ``server/websocket.py``), on the CPU, and the
G.711-in-WAV repair of ``ops/audio.py:read_wav``.

HTTP: requests written byte by byte on a real socket to a small echo app:
request and query parsing, repeated headers, chunked request bodies,
``Expect: 100-continue``, keep-alive with two requests on one connection,
``Connection: close`` and HTTP/1.0, HEAD, 404/405/413 through the error
middleware, malformed requests, and a chunked ``StreamResponse``. The body
is read only when the handler asks: a middleware's 401 reads none of it
(no ``100 Continue``, the connection closed after the reply), a stalled
body gets 408, and the middleware checks the key of a non-WebSocket route
that carries an ``Upgrade`` header.

Multipart: the edge cases of ``parse_form`` (quoted boundaries, CRLF inside
file bytes, repeated names, a file part without a content type, charsets,
transfer encodings), a gzip or deflate part that inflates past the limit
(413 with a small allocation) and a hypothesis round trip of random forms.

WebSocket: frames fed to ``WebSocketResponse`` through an in-memory stream
(masking, fragmentation with a ping inside, close codes, the size limit,
UTF-8, protocol faults), hypothesis round trips of random messages cut
into random fragments, a ``receive(timeout=)`` that expires while a frame
is half sent (the stream stays intact), one handshake on a real socket, and
the subprotocol answered as aiohttp answers it.

G.711: ``read_wav`` of A-law and mu-law WAVs equals the JAX package's, and
``convert_to_wav`` of them too; ingest passes non-WAV bytes through
without ffmpeg and takes the ffmpeg branch when the binary is there.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import os
import struct
import tracemalloc
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from open_speech_tpu.audio import ingest as JI
from open_speech_tpu.ops import audio as JA
from open_speech_tpu_torch.audio import ingest as TI
from open_speech_tpu_torch.ops import audio as TA
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.server import http as H
from open_speech_tpu_torch.server import multipart as MP
from open_speech_tpu_torch.server import websocket as W
from open_speech_tpu_torch.server.errors import error_middleware
from open_speech_tpu_torch.server.http import (
    Application,
    HTTPError,
    StreamResponse,
    json_response,
    parse_header_value,
    serve_app,
)
from open_speech_tpu_torch.server.middleware import security_middleware

# ── HTTP over a real socket ────────────────────────────────────────────


async def _echo(request):
    body = await request.read()
    return json_response({
        "method": request.method, "path": request.path, "query": request.query,
        "match": request.match_info, "body": body.decode("latin-1"),
        "x_a": request.headers.get("x-a"), "ctype": request.content_type,
    })


async def _streamed(request):
    resp = StreamResponse(headers={"Content-Type": "text/plain"})
    await resp.prepare(request)
    for part in (b"one ", b"two ", b"three"):
        await resp.write(part)
    await resp.write_eof()
    return resp


def _app(max_size: int = 1024) -> Application:
    app = Application(middlewares=[error_middleware], client_max_size=max_size)
    app.router.add_get("/echo/{name}", _echo)
    app.router.add_post("/echo/{name}", _echo)
    app.router.add_get("/stream", _streamed)
    return app


@contextlib.asynccontextmanager
async def _connection(app: Application):
    server = await serve_app(app, "127.0.0.1", 0)
    reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
    try:
        yield reader, writer
    finally:
        writer.close()
        await server.close()


async def _response(reader: asyncio.StreamReader) -> tuple[int, dict, bytes]:
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {k.lower(): v.strip() for k, _, v in (line.partition(":") for line in lines[1:] if line)}
    if headers.get("transfer-encoding") == "chunked":
        body = b""
        while True:
            size = int((await reader.readuntil(b"\r\n"))[:-2], 16)
            body += (await reader.readexactly(size + 2))[:-2]
            if size == 0:
                return status, headers, body
    return status, headers, await reader.readexactly(int(headers.get("content-length", 0)))


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


def test_request_parsing_and_keep_alive():
    """Two requests on one connection: the path and match info decoded,
    the query's first values, repeated headers joined, the body; then
    ``Connection: close`` ends the connection after its response."""
    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(b"GET /echo/a%20b?x=1&x=2&y=&z=%C3%A9 HTTP/1.1\r\nHost: h\r\n"
                         b"X-A: 1\r\nx-a: 2\r\n\r\n")
            status, headers, body = await _response(reader)
            first = json.loads(body)
            writer.write(b"POST /echo/n HTTP/1.1\r\nContent-Length: 5\r\nContent-Type: Text/Plain; charset=utf-8"
                         b"\r\nConnection: close\r\n\r\nhello")
            second = await _response(reader)
            assert await reader.read() == b""  # closed by the server
            return status, headers, first, second

    status, headers, first, (status2, headers2, body2) = _run(main())
    assert status == 200 and headers["content-type"] == "application/json; charset=utf-8"
    assert first == {"method": "GET", "path": "/echo/a b", "query": {"x": "1", "y": "", "z": "é"},
                     "match": {"name": "a b"}, "body": "", "x_a": "1, 2", "ctype": ""}
    assert status2 == 200 and headers2["connection"] == "close"
    assert json.loads(body2)["body"] == "hello" and json.loads(body2)["ctype"] == "text/plain"


def test_chunked_request_body_with_extensions_and_trailers():
    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(b"POST /echo/c HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
                         b"5;ext=1\r\nhello\r\n1\r\n \r\nA\r\n0123456789\r\n0\r\nX-T: 1\r\n\r\n")
            return await _response(reader)

    status, _, body = _run(main())
    assert status == 200 and json.loads(body)["body"] == "hello 0123456789"


def test_expect_100_continue_is_answered_before_the_body():
    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(b"POST /echo/e HTTP/1.1\r\nContent-Length: 3\r\nExpect: 100-continue\r\n\r\n")
            interim = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
            writer.write(b"abc")
            return interim, await _response(reader)

    interim, (status, _, body) = _run(main())
    assert interim == b"HTTP/1.1 100 Continue\r\n\r\n"
    assert status == 200 and json.loads(body)["body"] == "abc"


def test_http10_closes_and_head_sends_no_body():
    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(b"HEAD /echo/h HTTP/1.0\r\n\r\n")
            head = await reader.read()  # HTTP/1.0 without keep-alive: closed after it
            return head

    head = _run(main())
    text = head.decode("latin-1")
    assert text.startswith("HTTP/1.1 200 OK\r\n") and text.endswith("\r\n\r\n")
    length = int(next(line.split(":")[1] for line in text.split("\r\n")
                      if line.lower().startswith("content-length")))
    assert length > 0  # the GET body's length, no body


@pytest.mark.parametrize("request_bytes,status,message", [
    (b"GET /nope HTTP/1.1\r\n\r\n", 404, "Not Found"),
    (b"DELETE /echo/x HTTP/1.1\r\n\r\n", 405, "Method Not Allowed"),
    (b"POST /echo/x HTTP/1.1\r\nContent-Length: 2000\r\n\r\n" + b"x" * 2000, 413,
     "Request Entity Too Large"),
], ids=["404", "405", "413"])
def test_errors_go_through_the_error_middleware(request_bytes, status, message):
    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(request_bytes)
            return await _response(reader)

    got, headers, body = _run(main())
    assert got == status and headers["content-type"] == "application/json; charset=utf-8"
    assert json.loads(body) == {"error": {"message": message, "code": "http_error"}}
    assert headers["access-control-allow-origin"] == "*"


@pytest.mark.parametrize("request_bytes", [
    b"GET /echo/x\r\n\r\n",
    b"GET /echo/x HTTP/1.1\r\nBad Header\r\n\r\n",
    b"GET /echo/x HTTP/1.1\r\nX: " + b"y" * 9000 + b"\r\n\r\n",
    b"POST /echo/x HTTP/1.1\r\nContent-Length: 2\r\nTransfer-Encoding: chunked\r\n\r\n",
    b"POST /echo/x HTTP/1.1\r\nContent-Length: -1\r\n\r\n",
    b"POST /echo/x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
], ids=["no-version", "header-no-colon", "line-too-long", "te-and-cl", "bad-length", "bad-chunk"])
def test_malformed_requests_get_400_and_close(request_bytes):
    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(request_bytes)
            return await asyncio.wait_for(reader.read(), 10)

    reply = _run(main())
    assert reply.startswith(b"HTTP/1.1 400 Bad Request\r\n")


def test_stream_response_is_chunked():
    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(b"GET /stream HTTP/1.1\r\n\r\n")
            return await _response(reader)

    status, headers, body = _run(main())
    assert status == 200 and headers["transfer-encoding"] == "chunked"
    assert headers["content-type"] == "text/plain" and body == b"one two three"


def test_header_values_and_route_patterns():
    assert parse_header_value('Multipart/Form-Data; Boundary="a;b=c"; x=1') == (
        "multipart/form-data", {"boundary": "a;b=c", "x": "1"})
    assert parse_header_value("form-data; name=f; filename*=UTF-8''%C3%A9.wav")[1] == {
        "name": "f", "filename": "é.wav"}
    app = _app()
    handler, match = app.router.resolve("HEAD", "/echo/q")
    assert handler is _echo and match == {"name": "q"}


async def _refuse(request, handler):
    """A middleware that answers 401 before the handler reads the body."""
    if request.headers.get("x-refuse"):
        return json_response({"error": {"message": "no"}}, status=401)
    return await handler(request)


@pytest.mark.parametrize("expect", [False, True], ids=["plain", "expect-100"])
def test_a_refusal_reads_no_body_and_closes(expect):
    """A 401 from a middleware goes out before any of a 1 GiB body is read:
    no ``100 Continue`` is sent, the reply closes the connection, and the
    bytes the client already sent are dropped while it reads the reply."""
    async def main():
        app = _app()
        app.middlewares.insert(1, _refuse)
        async with _connection(app) as (reader, writer):
            writer.write(b"POST /echo/r HTTP/1.1\r\nX-Refuse: 1\r\nContent-Length: 1073741824\r\n"
                         + (b"Expect: 100-continue\r\n\r\n" if expect else b"\r\n" + b"x" * 100_000))
            reply = await _response(reader)
            writer.close()
            return reply

    status, headers, body = _run(main())
    assert status == 401 and headers["connection"] == "close"
    assert json.loads(body) == {"error": {"message": "no"}}


def test_a_stalled_body_gets_408(monkeypatch):
    monkeypatch.setattr(H, "BODY_TIMEOUT", 0.2)

    async def main():
        async with _connection(_app()) as (reader, writer):
            writer.write(b"POST /echo/s HTTP/1.1\r\nContent-Length: 10\r\n\r\nabc")
            reply = await _response(reader)
            return reply, await asyncio.wait_for(reader.read(), 10)

    (status, headers, body), rest = _run(main())
    assert status == 408 and headers["connection"] == "close" and rest == b""
    assert json.loads(body) == {"error": {"message": "Request Timeout", "code": "http_error"}}


def test_an_upgrade_header_does_not_skip_the_key_check(monkeypatch):
    """Only the WebSocket routes check their own key; a POST that carries
    ``Upgrade: websocket`` still meets the middleware's."""
    monkeypatch.setattr(torch_settings, "os_api_key", "sk-test")

    async def main():
        app = Application(middlewares=[error_middleware, security_middleware])
        app.router.add_post("/echo/{name}", _echo)
        replies = []
        for head in (b"Upgrade: websocket\r\nConnection: Upgrade", b"Authorization: Bearer sk-test"):
            async with _connection(app) as (reader, writer):
                writer.write(b"POST /echo/u HTTP/1.1\r\n" + head + b"\r\nContent-Length: 2\r\n\r\nhi")
                replies.append(await _response(reader))
        return replies

    (status, _, body), (status2, _, body2) = _run(main())
    assert status == 401 and "Invalid or missing API key" in json.loads(body)["error"]["message"]
    assert status2 == 200 and json.loads(body2)["body"] == "hi"


# ── multipart ──────────────────────────────────────────────────────────


def _multipart(parts, boundary="XyZ") -> bytes:
    out = b""
    for headers, content in parts:
        out += b"--" + boundary.encode() + b"\r\n"
        out += b"".join(f"{k}: {v}\r\n".encode() for k, v in headers) + b"\r\n" + content + b"\r\n"
    return out + b"--" + boundary.encode() + b"--\r\n"


def test_multipart_edge_cases():
    payload = b"RIFF\r\n-XyZ\r\n--Xy\r\n\r\nend\r\n"  # near misses of the delimiter
    body = b"preamble\r\n" + _multipart([
        ([("Content-Disposition", 'form-data; name="file"; filename="a b.wav"'),
          ("Content-Type", "audio/wav")], payload),
        ([("Content-Disposition", 'form-data; name="model"')], b"first"),
        ([("Content-Disposition", 'form-data; name="model"')], b"second"),
        ([("Content-Disposition", "form-data; name=blob; filename=x.bin")], b"\x00\x01"),
        ([("Content-Disposition", 'form-data; name="text"'),
          ("Content-Type", "text/plain; charset=latin-1")], "é".encode("latin-1")),
        ([("Content-Disposition", 'form-data; name="raw"'), ("Content-Type", "application/json")], b"{}"),
        ([("Content-Disposition", 'form-data; name="empty"; filename=""')], b"v"),
        ([("Content-Disposition", 'form-data; name="b64"; filename="b.bin"'),
          ("Content-Transfer-Encoding", "base64")], base64.b64encode(b"\r\n\xff")),
    ])
    form, size = MP.parse_form(body, 'multipart/form-data; boundary="XyZ"')
    assert form == {
        "file": (payload, "a b.wav", "audio/wav"),
        "model": "second",  # a repeated name keeps its last value
        "blob": (b"\x00\x01", "x.bin", "application/octet-stream"),
        "text": "é",
        "raw": b"{}",
        "empty": "v",  # an empty filename is an ordinary field
        "b64": (b"\r\n\xff", "b.bin", "application/octet-stream"),
    }
    assert size == len(payload) + 5 + 6 + 2 + 1 + 2 + 1 + 3
    assert MP.parse_form(b"--XyZ--\r\n", "multipart/form-data; boundary=XyZ") == ({}, 0)


@pytest.mark.parametrize("body,ctype", [
    (b"--XyZ\r\nContent-Disposition: form-data\r\n\r\nx\r\n--XyZ--", "multipart/form-data; boundary=XyZ"),
    (b"--XyZ\r\nContent-Disposition: form-data; name=a\r\n\r\nx", "multipart/form-data; boundary=XyZ"),
    (b"no boundary here", "multipart/form-data; boundary=XyZ"),
    (b"--XyZ--", "multipart/form-data"),
], ids=["no-name", "not-closed", "no-opening", "no-boundary-param"])
def test_multipart_faults_raise_value_error(body, ctype):
    with pytest.raises(ValueError):
        MP.parse_form(body, ctype)


def test_urlencoded_form():
    assert MP.parse_urlencoded(b"model=a&model=b&x=%20y&z=\r\n") == {"model": "b", "x": " y", "z": ""}


_names = st.text(st.characters(min_codepoint=0x21, max_codepoint=0x7E, blacklist_characters='"\\;'),
                 min_size=1, max_size=8)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(_names, st.binary(max_size=300), st.one_of(st.none(), _names),
                          st.one_of(st.none(), st.sampled_from(["audio/wav", "application/octet-stream"]))),
                min_size=1, max_size=5))
def test_multipart_round_trip(fields):
    """Random file and text parts, CRLF and boundary-like bytes included:
    each name's last part comes back as it went in."""
    boundary = "bNd" + os.urandom(8).hex()
    parts, want = [], {}
    for name, data, filename, ctype in fields:
        headers = [("Content-Disposition", f'form-data; name="{name}"'
                    + (f'; filename="{filename}"' if filename else ""))]
        if filename:
            if ctype:
                headers.append(("Content-Type", ctype))
            want[name] = (data, filename, ctype or "application/octet-stream")
        else:
            headers.append(("Content-Type", "application/octet-stream"))
            want[name] = data
        parts.append((headers, data))
    form, size = MP.parse_form(_multipart(parts, boundary), f"multipart/form-data; boundary={boundary}")
    assert form == want
    assert size == sum(len(d) for _, d, _, _ in fields)


def _zeros_compressed(n_mib: int, wbits: int) -> bytes:
    c = zlib.compressobj(9, zlib.DEFLATED, wbits)
    block = bytes(1 << 20)
    return b"".join(c.compress(block) for _ in range(n_mib)) + c.flush()


@pytest.mark.parametrize("encoding,wbits", [("gzip", 16 + zlib.MAX_WBITS), ("deflate", -zlib.MAX_WBITS)])
def test_a_compressed_part_past_the_limit_is_413_with_a_small_allocation(encoding, wbits):
    """256 MiB of zeros in a ~256 KiB part: inflating stops one byte past
    the 1 MiB left of the limit, and peak memory stays near that."""
    bomb = _zeros_compressed(256, wbits)
    body = _multipart([
        ([("Content-Disposition", 'form-data; name="model"')], b"m"),
        ([("Content-Disposition", 'form-data; name="file"; filename="a.wav"'),
          ("Content-Encoding", encoding)], bomb),
    ])
    ctype = "multipart/form-data; boundary=XyZ"
    tracemalloc.start()
    try:
        with pytest.raises(HTTPError) as e:
            MP.parse_form(body, ctype, max_size=1 << 20)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert e.value.status == 413 and peak < 8 << 20
    small = _zeros_compressed(1, wbits)  # exactly 1 MiB: within a limit of 1 MiB + 1
    form, size = MP.parse_form(body.replace(bomb, small), ctype, max_size=(1 << 20) + 1)
    assert form["file"] == (bytes(1 << 20), "a.wav", "application/octet-stream") and size == (1 << 20) + 1
    with pytest.raises(HTTPError):
        MP.parse_form(body.replace(bomb, small), ctype, max_size=1 << 20)


def test_a_compressed_upload_past_the_limit_is_413_over_the_socket():
    async def main():
        async with _connection(_form_app()) as (reader, writer):
            body = _multipart([([("Content-Disposition", 'form-data; name="file"; filename="a"'),
                                 ("Content-Encoding", "gzip")], _zeros_compressed(64, 16 + zlib.MAX_WBITS))])
            writer.write(b"POST /form HTTP/1.1\r\nContent-Type: multipart/form-data; boundary=XyZ\r\n"
                         + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            return await _response(reader)

    status, _, body = _run(main())
    assert status == 413 and json.loads(body) == {
        "error": {"message": "Request Entity Too Large", "code": "http_error"}}


def _form_app() -> Application:
    async def form(request):
        got = await request.post()
        return json_response({k: v if isinstance(v, str) else len(v[0]) for k, v in got.items()})

    app = Application(middlewares=[error_middleware], client_max_size=1 << 20)
    app.router.add_post("/form", form)
    return app


# ── WebSocket frames ───────────────────────────────────────────────────


class _Writer:
    """A StreamWriter stand-in that keeps what was written."""

    def __init__(self) -> None:
        self.data = bytearray()
        self.closed = False
        self.transport = None

    def write(self, data: bytes) -> None:
        self.data += data

    async def drain(self) -> None:
        pass

    def is_closing(self) -> bool:
        return self.closed

    def close(self) -> None:
        self.closed = True


def _frames(data: bytes) -> list[tuple[bool, int, bytes]]:
    """Parse the server's (unmasked) frames."""
    out, pos = [], 0
    while pos < len(data):
        b0, b1 = data[pos], data[pos + 1]
        n, pos = b1 & 0x7F, pos + 2
        if n == 126:
            (n,), pos = struct.unpack("!H", data[pos:pos + 2]), pos + 2
        elif n == 127:
            (n,), pos = struct.unpack("!Q", data[pos:pos + 8]), pos + 8
        assert not b1 & 0x80, "server frames are not masked"
        out.append((bool(b0 & 0x80), b0 & 0x0F, bytes(data[pos:pos + n])))
        pos += n
    return out


def _client(opcode: int, payload: bytes, *, fin: bool = True, masked: bool = True) -> bytes:
    return W.encode_frame(opcode, payload, fin=fin, mask=os.urandom(4) if masked else None)


def _session(wire: bytes, *, max_msg_size: int = W.MAX_MSG_SIZE, close_reply: bool = True):
    """Messages the socket yields for client bytes ``wire`` (then a client
    close frame when ``close_reply``), and the server's frames."""
    async def main():
        reader = asyncio.StreamReader()
        reader.feed_data(wire + (_client(W.OP_CLOSE, struct.pack("!H", 1000)) if close_reply else b""))
        reader.feed_eof()
        ws = W.WebSocketResponse(max_msg_size=max_msg_size, timeout=2)
        ws._reader, ws._writer = reader, _Writer()
        messages = [m async for m in ws]
        return messages, _frames(ws._writer.data), ws

    return asyncio.run(asyncio.wait_for(main(), 30))


def test_accept_key_of_rfc_6455():
    assert W.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_fragmented_text_with_a_ping_inside():
    wire = (_client(W.OP_TEXT, "hé".encode()[:2], fin=False) + _client(W.OP_PING, b"p")
            + _client(W.OP_CONT, "hé".encode()[2:] + b"llo", fin=False) + _client(W.OP_CONT, b"!")
            + _client(W.OP_BINARY, b"\x00\xff"))
    messages, frames, ws = _session(wire)
    assert [(m.type, m.data) for m in messages] == [
        (W.MsgType.TEXT, "héllo!"), (W.MsgType.BINARY, b"\x00\xff"), (W.MsgType.CLOSE, 1000)]
    assert frames == [(True, W.OP_PONG, b"p"), (True, W.OP_CLOSE, struct.pack("!H", 1000))]
    assert ws.closed and ws._writer.closed


@pytest.mark.parametrize("wire,code", [
    (_client(W.OP_TEXT, b"hi", masked=False), 1002),
    (_client(W.OP_CONT, b"x"), 1002),
    (_client(W.OP_TEXT, b"a", fin=False) + _client(W.OP_TEXT, b"b"), 1002),
    (_client(W.OP_PING, b"p", fin=False), 1002),
    (_client(W.OP_PING, b"p" * 126), 1002),
    (_client(0x3, b"x"), 1002),
    (bytes([0xC1]) + _client(W.OP_TEXT, b"x")[1:], 1002),  # RSV1 set
    (_client(W.OP_TEXT, b"\xff\xfe"), 1007),
    (_client(W.OP_BINARY, b"x" * 2000), 1009),
    (_client(W.OP_BINARY, b"x" * 600, fin=False) + _client(W.OP_CONT, b"x" * 600), 1009),
], ids=["unmasked", "orphan-continuation", "interleaved", "fragmented-control", "long-control",
        "reserved-opcode", "rsv-bit", "bad-utf8", "oversize", "oversize-fragments"])
def test_protocol_faults_close_with_their_code(wire, code):
    messages, frames, _ = _session(wire, max_msg_size=1024)
    assert [(m.type, m.data) for m in messages] == [(W.MsgType.CLOSE, code)]
    assert frames == [(True, W.OP_CLOSE, struct.pack("!H", code))]  # empty reason, as aiohttp


@pytest.mark.parametrize("payload,code,reply", [
    (struct.pack("!H", 4000) + b"bye", 4000, 1000),
    (b"", 1005, 1000),
    (b"\x03", 1002, 1002),
    (struct.pack("!H", 999), 1002, 1002),
    (struct.pack("!H", 1000) + b"\xff", 1007, 1007),
], ids=["private-code", "no-code", "one-byte", "invalid-code", "bad-reason"])
def test_client_close_is_answered(payload, code, reply):
    messages, frames, ws = _session(_client(W.OP_CLOSE, payload), close_reply=False)
    assert [(m.type, m.data) for m in messages] == [(W.MsgType.CLOSE, code)]
    assert frames == [(True, W.OP_CLOSE, struct.pack("!H", reply))]
    assert ws.close_code == code


def test_server_close_sends_code_and_reason_and_waits_for_the_reply():
    async def main():
        reader = asyncio.StreamReader()
        reader.feed_data(_client(W.OP_TEXT, b"late") + _client(W.OP_CLOSE, struct.pack("!H", 1008)))
        ws = W.WebSocketResponse(timeout=2)
        ws._reader, ws._writer = reader, _Writer()
        assert await ws.close(code=1008, message=b"Origin not allowed")
        assert not await ws.close()
        with pytest.raises(ConnectionResetError):
            await ws.send_str("x")
        return _frames(ws._writer.data), reader.at_eof() or not reader._buffer

    frames, drained = asyncio.run(main())
    assert frames == [(True, W.OP_CLOSE, struct.pack("!H", 1008) + b"Origin not allowed")]
    assert drained  # the text frame and the client's close were read


def test_abrupt_disconnect_yields_close_1006():
    messages, _, _ = _session(_client(W.OP_TEXT, b"x")[:3], close_reply=False)
    assert [(m.type, m.data) for m in messages] == [(W.MsgType.CLOSE, 1006)]


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.booleans(), st.binary(max_size=70000), st.lists(st.integers(0, 70000), max_size=3)),
                min_size=1, max_size=3))
def test_message_round_trip(messages):
    """Random text/binary messages cut into random fragments (lengths across
    the 7-, 16- and 64-bit forms) with random masks come back whole; the
    server's own frames parse back to what it sent."""
    wire, want = b"", []
    for is_text, data, cuts in messages:
        data = data.decode("latin-1").encode("utf-8") if is_text else data
        bounds = sorted({0, len(data), *(c for c in cuts if c < len(data))})
        pieces = [data[a:b] for a, b in zip(bounds, bounds[1:])] or [b""]
        for i, piece in enumerate(pieces):
            op = (W.OP_TEXT if is_text else W.OP_BINARY) if i == 0 else W.OP_CONT
            wire += _client(op, piece, fin=i == len(pieces) - 1)
        want.append((W.MsgType.TEXT, data.decode("utf-8")) if is_text else (W.MsgType.BINARY, data))
    got, _, _ = _session(wire)
    assert [(m.type, m.data) for m in got] == want + [(W.MsgType.CLOSE, 1000)]
    for _, data, _ in messages:
        assert _frames(W.encode_frame(W.OP_BINARY, data)) == [(True, W.OP_BINARY, data)]


def test_handshake_on_a_real_socket():
    """A raw client: 101 with the accept key, an echoed masked message, the
    close handshake; a request that is not a handshake gets 400."""
    async def echo(request):
        ws = W.WebSocketResponse()
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == W.MsgType.TEXT:
                await ws.send_str(msg.data.upper())
        return ws

    async def main():
        app = Application(middlewares=[error_middleware])
        app.router.add_get("/ws", echo)
        async with _connection(app) as (reader, writer):
            writer.write(b"GET /ws HTTP/1.1\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                         b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\nSec-WebSocket-Version: 13\r\n\r\n")
            head = await reader.readuntil(b"\r\n\r\n")
            writer.write(_client(W.OP_TEXT, b"abc") + _client(W.OP_CLOSE, struct.pack("!H", 1000)))
            frames = _frames(await asyncio.wait_for(reader.read(), 10))
        async with _connection(app) as (reader, writer):
            writer.write(b"GET /ws HTTP/1.1\r\nUpgrade: websocket\r\n\r\n")
            refused = await _response(reader)
        return head, frames, refused

    head, frames, (status, _, body) = _run(main())
    assert head.startswith(b"HTTP/1.1 101 Switching Protocols\r\n")
    assert b"Sec-WebSocket-Accept: s3pPLMBiTxaQ9kYGzzhZRbK+xOo=\r\n" in head
    assert frames == [(True, W.OP_TEXT, b"ABC"), (True, W.OP_CLOSE, struct.pack("!H", 1000))]
    assert status == 400 and json.loads(body)["error"]["message"] == "Bad Request"


def test_receive_timeout_mid_frame_keeps_the_stream_intact():
    """A timeout while a frame is half sent raises ``asyncio.TimeoutError``
    (as aiohttp's ``receive(timeout=)``); the rest of that frame and the
    next message are then read intact, and ``close`` takes over a read
    still in progress."""
    async def main():
        reader = asyncio.StreamReader()
        ws = W.WebSocketResponse(timeout=2)
        ws._reader, ws._writer = reader, _Writer()
        first = _client(W.OP_TEXT, b"x" * 300)
        with pytest.raises(asyncio.TimeoutError):
            await ws.receive(timeout=0.05)  # nothing sent yet
        reader.feed_data(first[:5])
        with pytest.raises(asyncio.TimeoutError):
            await ws.receive(timeout=0.05)  # the header and one mask byte
        reader.feed_data(first[5:150])
        with pytest.raises(asyncio.TimeoutError):
            await ws.receive(timeout=0.05)  # half the payload
        reader.feed_data(first[150:] + _client(W.OP_BINARY, b"\x01\x02", fin=False))
        got = [await ws.receive(timeout=1)]
        with pytest.raises(asyncio.TimeoutError):
            await ws.receive(timeout=0.05)  # a fragment of the next message
        reader.feed_data(_client(W.OP_CONT, b"\x03"))
        got.append(await ws.receive(timeout=1))
        late = _client(W.OP_TEXT, b"late")
        reader.feed_data(late[:4])
        with pytest.raises(asyncio.TimeoutError):
            await ws.receive(timeout=0.05)
        closing = asyncio.ensure_future(ws.close(code=4008, message=b"Session idle timeout"))
        await asyncio.sleep(0.05)
        reader.feed_data(late[4:] + _client(W.OP_CLOSE, struct.pack("!H", 4008)))
        assert await asyncio.wait_for(closing, 2)
        return got, _frames(ws._writer.data), ws

    got, frames, ws = asyncio.run(asyncio.wait_for(main(), 30))
    assert [(m.type, m.data) for m in got] == [(W.MsgType.TEXT, "x" * 300), (W.MsgType.BINARY, b"\x01\x02\x03")]
    assert frames == [(True, W.OP_CLOSE, struct.pack("!H", 4008) + b"Session idle timeout")]
    assert ws.closed and ws._writer.closed and ws._pending is None


@pytest.mark.parametrize("offered,answered", [
    ("realtime", "realtime"),
    ("chat, realtime", "realtime"),
    ("realtime,other", "realtime"),
    ("other", None),
    (None, None),
], ids=["offered", "second-offered", "first-of-two", "unoffered", "none-offered"])
def test_subprotocol_is_answered_as_aiohttp_answers_it(offered, answered):
    """The first offered subprotocol that the server lists is named in the
    101; none is named when the client offers none the server lists."""
    async def handler(request):
        ws = W.WebSocketResponse(protocols=("realtime",))
        await ws.prepare(request)
        await ws.send_str(str(ws.ws_protocol))
        async for _ in ws:
            pass
        return ws

    async def main():
        app = Application(middlewares=[error_middleware])
        app.router.add_get("/ws", handler)
        async with _connection(app) as (reader, writer):
            proto = b"" if offered is None else b"Sec-WebSocket-Protocol: " + offered.encode() + b"\r\n"
            writer.write(b"GET /ws HTTP/1.1\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                         b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\nSec-WebSocket-Version: 13\r\n"
                         + proto + b"\r\n")
            head = await reader.readuntil(b"\r\n\r\n")
            writer.write(_client(W.OP_CLOSE, struct.pack("!H", 1000)))
            return head, _frames(await asyncio.wait_for(reader.read(), 10))

    head, frames = _run(main())
    assert head.startswith(b"HTTP/1.1 101 Switching Protocols\r\n")
    named = [line for line in head.split(b"\r\n") if line.lower().startswith(b"sec-websocket-protocol:")]
    assert named == ([] if answered is None else [b"Sec-WebSocket-Protocol: " + answered.encode()])
    assert frames[0] == (True, W.OP_TEXT, str(answered).encode())


# ── G.711 inside WAV, ingest ───────────────────────────────────────────


def _g711_wav(codes: bytes, tag: int, rate: int = 8000) -> bytes:
    fmt = struct.pack("<HHIIHH", tag, 1, rate, rate, 1, 8)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(codes)) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(codes)) + codes)


@pytest.mark.parametrize("tag", [6, 7], ids=["alaw", "mulaw"])
def test_read_wav_decodes_g711_as_jax_does(tag):
    rng = np.random.default_rng(tag)
    pcm = (8000 * np.sin(np.arange(8000) / 9.0) + rng.normal(0, 300, 8000)).astype(np.int16)
    codes = (JA.alaw_encode if tag == 6 else JA.ulaw_encode)(pcm).tobytes()
    wav = _g711_wav(codes, tag)
    want, want_rate = JA.read_wav(wav)
    got, rate = TA.read_wav(wav)
    assert rate == want_rate == 8000
    np.testing.assert_array_equal(got, want)
    jw, tw = JI.convert_to_wav(wav), TI.convert_to_wav(wav, device="cpu")
    assert tw[:44] == jw[:44]  # 16 kHz mono 16-bit, the same length
    diff = np.frombuffer(tw[44:], "<i2").astype(int) - np.frombuffer(jw[44:], "<i2").astype(int)
    assert np.abs(diff).max() <= 1


def test_ingest_without_ffmpeg_passes_bytes_through(monkeypatch):
    monkeypatch.setattr(JI, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(TI, "ffmpeg_available", lambda: False)
    for data in (b"ID3\x03 an mp3", b"", b"RIFF\x00\x00\x00\x00WAVE"):
        assert TI.convert_to_wav(data, device="cpu") == JI.convert_to_wav(data) == data


def test_ingest_ffmpeg_branch(monkeypatch):
    """With ffmpeg present, non-WAV bytes are decoded by it to 16 kHz f32le
    (the subprocess replaced by a stand-in that checks its arguments)."""
    audio = (0.3 * np.sin(np.arange(1600) / 5.0)).astype("<f4")
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw["input"]))
        return type("Proc", (), {"stdout": audio.tobytes()})()

    for module in (JI, TI):
        monkeypatch.setattr(module, "ffmpeg_available", lambda: True)
        monkeypatch.setattr(module.subprocess, "run", run)
    got, want = TI.convert_to_wav(b"OggS...", device="cpu"), JI.convert_to_wav(b"OggS...")
    assert got == want and TA.read_wav(got)[1] == 16000
    assert calls[0] == calls[1] and calls[0][0][:3] == ["ffmpeg", "-i", "pipe:0"]
