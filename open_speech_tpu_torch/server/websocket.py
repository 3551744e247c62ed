"""The server side of RFC 6455 on the connection of ``server/http.py``.

``WebSocketResponse`` plays the part of aiohttp's: ``prepare`` answers the
handshake (101 with ``Sec-WebSocket-Accept``; a request that is not a
WebSocket handshake raises 400), ``async for msg in ws`` yields
``Message(MsgType.BINARY | TEXT, data)`` for each whole message and then
one ``Message(MsgType.CLOSE, code)``, and ``send_str``, ``send_bytes`` and
``close(code=, message=)`` send. Pings are answered with pongs; fragmented
messages are joined; a message over ``max_msg_size`` (aiohttp's 4 MiB)
closes with 1009, a text message that is not UTF-8 with 1007, and an
unmasked client frame or any other protocol fault with 1002, each with an
empty reason as aiohttp sends them. A client's close is answered with
1000, as aiohttp answers it. ``close`` waits up to ``timeout`` for the
client's close frame, reading and dropping what arrives before it.

``receive(timeout=)`` raises ``asyncio.TimeoutError`` when no whole message
arrived in time, as aiohttp's does, and leaves the socket usable: the read
in progress goes on, and the next ``receive`` (or ``close``) takes what it
reads, so a frame half read at the timeout is not lost. ``protocols=``
lists the subprotocols the server speaks: the handshake answers the first
one the client offers that is listed, and names none otherwise.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import enum
import hashlib
import struct
from dataclasses import dataclass

from open_speech_tpu_torch.server.http import HTTPError, Request

_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_MSG_SIZE = 4 * 1024 * 1024  # aiohttp's default max_msg_size

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

# close codes a peer may send (RFC 6455 7.4.1; 1004-1006 and 1015 are never
# sent on the wire), plus the registered and private ranges
_VALID_CLOSE = {1000, 1001, 1002, 1003, 1007, 1008, 1009, 1010, 1011, 1012, 1013, 1014}


class MsgType(enum.Enum):
    BINARY = "binary"
    TEXT = "text"
    CLOSE = "close"


@dataclass
class Message:
    """One client message: audio bytes (BINARY), JSON text (TEXT), or CLOSE
    (``data`` is the close code)."""

    type: MsgType
    data: bytes | str | int | None = None


class _Fault(Exception):
    """A protocol fault: close with ``code``; ``skip`` payload bytes of the
    frame in progress are still on the wire."""

    def __init__(self, code: int, skip: int = 0) -> None:
        super().__init__(code)
        self.code, self.skip = code, skip


def accept_key(key: str) -> str:
    return base64.b64encode(hashlib.sha1(key.encode("ascii") + _GUID).digest()).decode("ascii")


def unmask(data: bytes, mask: bytes) -> bytes:
    if not data:
        return data
    n = len(data)
    key = int.from_bytes((mask * (n // 4 + 1))[:n], "big")
    return (int.from_bytes(data, "big") ^ key).to_bytes(n, "big")


def encode_frame(opcode: int, payload: bytes, *, fin: bool = True, mask: bytes | None = None) -> bytes:
    """One frame; servers send unmasked, clients pass a 4-byte ``mask``."""
    n = len(payload)
    head = bytearray([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask is not None else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask is not None:
        return bytes(head) + mask + unmask(payload, mask)
    return bytes(head) + payload


def _check_handshake(request: Request) -> str:
    h = request.headers
    if request.method != "GET":
        raise HTTPError(405, {"Allow": "GET"})
    if "websocket" not in h.get("upgrade", "").lower():
        raise HTTPError(400)
    if "upgrade" not in h.get("connection", "").lower():
        raise HTTPError(400)
    if h.get("sec-websocket-version", "") not in ("13", "8", "7"):
        raise HTTPError(400)
    key = h.get("sec-websocket-key", "")
    try:
        if len(base64.b64decode(key, validate=True)) != 16:
            raise HTTPError(400)
    except binascii.Error as e:
        raise HTTPError(400) from e
    return key


def _choose_protocol(request: Request, protocols: tuple[str, ...]) -> str | None:
    """The first subprotocol the client offers that the server lists."""
    offered = request.headers.get("sec-websocket-protocol", "")
    for proto in (p.strip() for p in offered.split(",")):
        if proto and proto in protocols:
            return proto
    return None


class WebSocketResponse:
    def __init__(self, *, max_msg_size: int = MAX_MSG_SIZE, timeout: float = 10.0,
                 protocols: tuple[str, ...] = ()) -> None:
        self.max_msg_size, self.timeout = max_msg_size, timeout
        self.protocols = tuple(protocols)
        self.ws_protocol: str | None = None
        self._pending: asyncio.Task | None = None  # a receive cut by its timeout
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._closing = False  # our close frame went out
        self._closed = False
        self.close_code: int | None = None
        self._send_lock = asyncio.Lock()

    @property
    def closed(self) -> bool:
        return self._closing or self._closed

    async def prepare(self, request: Request) -> None:
        key = _check_handshake(request)
        self.ws_protocol = _choose_protocol(request, self.protocols)
        self._reader, self._writer = request._reader, request._writer
        request.started, request.upgraded = True, self
        proto = b"" if self.ws_protocol is None else (
            b"Sec-WebSocket-Protocol: " + self.ws_protocol.encode("ascii") + b"\r\n")
        self._writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\nConnection: upgrade\r\n"
            b"Sec-WebSocket-Accept: " + accept_key(key).encode("ascii") + b"\r\n" + proto + b"\r\n")
        await self._writer.drain()

    # ── sending ───────────────────────────────────────────────────────

    async def _send(self, opcode: int, payload: bytes) -> None:
        async with self._send_lock:
            if self._writer.is_closing():
                raise ConnectionResetError("Cannot write to closing transport")
            self._writer.write(encode_frame(opcode, payload))
            await self._writer.drain()

    async def send_str(self, data: str) -> None:
        if self.closed:
            raise ConnectionResetError("Cannot write to closing transport")
        await self._send(OP_TEXT, data.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        if self.closed:
            raise ConnectionResetError("Cannot write to closing transport")
        await self._send(OP_BINARY, bytes(data))

    async def close(self, *, code: int = 1000, message: bytes = b"") -> bool:
        """Send a close frame and wait for the client's; False if already closed."""
        if self.closed:
            return False
        await self._close_and_drain(code, message)
        return True

    async def _close_and_drain(self, code: int, message: bytes = b"", skip: int = 0) -> None:
        self._closing = True
        self.close_code = code
        try:
            await self._send(OP_CLOSE, struct.pack("!H", code) + message)
            await asyncio.wait_for(self._drain(skip), self.timeout)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError):
            pass
        finally:
            self._closed = True
            self._writer.close()

    async def _drain(self, skip: int) -> None:
        """Read and drop frames until the client's close frame; a receive
        cut by its timeout finishes its message first."""
        pending, self._pending = self._pending, None
        if pending is not None and pending is not asyncio.current_task():
            if (await pending).type == MsgType.CLOSE:
                return
        while True:
            while skip:
                skip -= len(await self._reader.readexactly(min(skip, 1 << 16)))
            try:
                _, opcode, _ = await self._read_frame(0)
            except _Fault as e:
                skip = e.skip
                continue
            if opcode == OP_CLOSE:
                return

    async def finish(self) -> None:
        """End the connection once the handler returned: close with 1000
        unless closed already."""
        if not self.closed:
            await self._close_and_drain(1000)
        elif not self._closed:
            self._closed = True
            self._writer.close()

    # ── receiving ─────────────────────────────────────────────────────

    async def _read_frame(self, size: int) -> tuple[bool, int, bytes]:
        """(fin, opcode, unmasked payload); ``size`` is the length of the
        message so far, for the size limit."""
        b0, b1 = await self._reader.readexactly(2)
        fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", await self._reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self._reader.readexactly(8))
        rest = n + (4 if masked else 0)
        if b0 & 0x70 or not masked:
            raise _Fault(1002, rest)
        if opcode >= 0x8 and (not fin or n > 125):
            raise _Fault(1002, rest)
        if opcode < 0x8 and size + n > self.max_msg_size:
            raise _Fault(1009, rest)
        mask = await self._reader.readexactly(4)
        return fin, opcode, unmask(await self._reader.readexactly(n), mask)

    async def receive(self, timeout: float | None = None) -> Message:
        """The next whole message; ``asyncio.TimeoutError`` if none arrived
        within ``timeout`` seconds (the read goes on for the next call)."""
        if self._pending is None:
            if self.closed:
                return Message(MsgType.CLOSE, self.close_code)
            self._pending = asyncio.ensure_future(self._receive())
        pending = self._pending
        try:
            return await asyncio.wait_for(asyncio.shield(pending), timeout)
        finally:
            if pending.done() and self._pending is pending:
                self._pending = None

    async def _receive(self) -> Message:
        if self.closed:
            return Message(MsgType.CLOSE, self.close_code)
        parts: list[bytes] = []
        kind, size = None, 0
        try:
            while True:
                fin, opcode, payload = await self._read_frame(size)
                if opcode == OP_PING:
                    await self._send(OP_PONG, payload)
                    continue
                if opcode == OP_PONG:
                    continue
                if opcode == OP_CLOSE:
                    return await self._on_close(payload)
                if opcode == OP_CONT:
                    if kind is None:
                        raise _Fault(1002)
                elif opcode in (OP_TEXT, OP_BINARY):
                    if kind is not None:
                        raise _Fault(1002)
                    kind = opcode
                else:
                    raise _Fault(1002)
                parts.append(payload)
                size += len(payload)
                if fin:
                    break
        except _Fault as e:
            await self._close_and_drain(e.code, skip=e.skip)
            return Message(MsgType.CLOSE, e.code)
        except (ConnectionError, asyncio.IncompleteReadError):
            self._closed, self.close_code = True, 1006
            self._writer.close()
            return Message(MsgType.CLOSE, 1006)
        data = b"".join(parts)
        if kind == OP_BINARY:
            return Message(MsgType.BINARY, data)
        try:
            return Message(MsgType.TEXT, data.decode("utf-8"))
        except UnicodeDecodeError:
            await self._close_and_drain(1007)
            return Message(MsgType.CLOSE, 1007)

    async def _on_close(self, payload: bytes) -> Message:
        code = 1005  # no status code in the frame
        if len(payload) == 1:
            code = 1002
        elif len(payload) >= 2:
            (code,) = struct.unpack("!H", payload[:2])
            try:
                payload[2:].decode("utf-8")
            except UnicodeDecodeError:
                code = 1007
            if code not in _VALID_CLOSE and not 3000 <= code <= 4999 and code != 1007:
                code = 1002
        reply = code if code in (1002, 1007) else 1000
        if self._closing:  # the reply to our own close frame
            self._closed = True
            self._writer.close()
            return Message(MsgType.CLOSE, code)
        self.close_code = code
        self._closing = True
        try:
            await self._send(OP_CLOSE, struct.pack("!H", reply))
        except ConnectionError:
            pass
        self._closed = True
        self._writer.close()
        return Message(MsgType.CLOSE, code)

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        if self.closed:
            raise StopAsyncIteration
        return await self.receive()
