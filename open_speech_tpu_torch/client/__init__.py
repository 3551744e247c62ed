"""Python SDK for the Open Speech server, on the standard library alone.

Counterpart of ``open_speech_tpu/client/__init__.py``, with the same public
surface: sync/async ``transcribe``/``speak``, WS ``stream_transcribe`` with
a sender thread/task and reconnect-and-replay of the in-flight chunk, and
sync/async Realtime sessions with callback dispatch. Where the JAX client
uses httpx and websockets, this one speaks HTTP/1.1 through ``http.client``
(multipart bodies built here) and RFC 6455 over a plain or TLS socket
(``_WebSocket``; the async API runs it in worker threads),
framing with the server's own ``encode_frame``. It imports neither torch
nor anything that needs a card, so it runs on any machine with Python.

``ssl_verify=False`` turns certificate checks off for the sockets as well
as for REST (the server's default TLS certificate is self-signed).
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import http.client
import json
import logging
import os
import socket
import ssl
import struct
import threading
import time
import uuid
from collections.abc import AsyncIterator, Callable, Iterator
from typing import Any
from urllib.parse import urlencode, urlsplit

from open_speech_tpu_torch.server.websocket import (
    OP_BINARY,
    OP_CLOSE,
    OP_CONT,
    OP_PING,
    OP_PONG,
    OP_TEXT,
    accept_key,
    encode_frame,
    unmask,
)

logger = logging.getLogger(__name__)

CLOSE_TIMEOUT = 5.0  # seconds a close waits for the server's close frame
MAX_HEAD = 64 * 1024  # bytes of a handshake response's head


class HTTPStatusError(RuntimeError):
    """A REST call answered with a status outside 2xx (httpx's
    ``raise_for_status``)."""

    def __init__(self, status: int, reason: str, url: str, body: bytes) -> None:
        super().__init__(f"HTTP {status} {reason} for {url}: {body[:200]!r}")
        self.status, self.body = status, body


class ConnectionClosed(Exception):
    """The socket is closed: ``code`` is the close code the server sent
    (1005 without one, 1006 when the connection dropped)."""

    def __init__(self, code: int = 1006, reason: str = "") -> None:
        super().__init__(f"websocket closed: {code} {reason}".strip())
        self.code, self.reason = code, reason


class InvalidHandshake(ConnectionError):
    """The server refused the WebSocket upgrade; ``status`` is its HTTP status."""

    def __init__(self, message: str, status: int | None = None) -> None:
        super().__init__(message)
        self.status = status


def _ssl_context(verify: bool) -> ssl.SSLContext:
    ctx = ssl.create_default_context()
    if not verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _multipart(fields: dict[str, str], files: dict[str, tuple[str, bytes, str]]) -> tuple[bytes, str]:
    """(body, content type) of multipart/form-data: ``fields`` as text parts,
    ``files`` as {name: (filename, bytes, content type)}."""
    boundary = uuid.uuid4().hex
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    for name, (filename, data, ctype) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                     f'filename="{filename}"\r\nContent-Type: {ctype}\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


# ── WebSocket: the client side of RFC 6455 ───────────────────────────────


def _handshake(url: str, headers: dict[str, str] | None, subprotocols: list[str] | None):
    """(host, port, tls, request bytes, key) of the upgrade request for a
    ws:// or wss:// ``url``."""
    parts = urlsplit(url)
    if parts.scheme not in ("ws", "wss") or not parts.hostname:
        raise ValueError(f"not a ws:// or wss:// URL: {url!r}")
    tls = parts.scheme == "wss"
    port = parts.port or (443 if tls else 80)
    host = parts.hostname if ":" not in parts.hostname else f"[{parts.hostname}]"
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    lines = [f"GET {target} HTTP/1.1", f"Host: {host}" + ("" if parts.port is None else f":{port}"),
             "Upgrade: websocket", "Connection: Upgrade", f"Sec-WebSocket-Key: {key}",
             "Sec-WebSocket-Version: 13"]
    if subprotocols:
        lines.append("Sec-WebSocket-Protocol: " + ", ".join(subprotocols))
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    return parts.hostname, port, tls, ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"), key


def _accepted(head: bytes, key: str, subprotocols: list[str] | None) -> str | None:
    """Checks the server's answer to the upgrade; returns its subprotocol."""
    lines = head.decode("latin-1").split("\r\n")
    status = lines[0].split(" ", 2)
    code = int(status[1]) if len(status) > 1 and status[1].isdigit() else None
    if code != 101:
        raise InvalidHandshake(f"server rejected WebSocket connection: {lines[0]}", code)
    fields = {}
    for line in lines[1:]:
        name, _, value = line.partition(":")
        fields[name.strip().lower()] = value.strip()
    if fields.get("sec-websocket-accept") != accept_key(key):
        raise InvalidHandshake("server answered with a wrong Sec-WebSocket-Accept", code)
    chosen = fields.get("sec-websocket-protocol") or None
    if chosen is not None and chosen not in (subprotocols or []):
        raise InvalidHandshake(f"server chose subprotocol {chosen!r}, which was not offered", code)
    return chosen


def _close_payload(payload: bytes) -> tuple[int, str]:
    if len(payload) < 2:
        return 1005, ""
    return struct.unpack("!H", payload[:2])[0], payload[2:].decode("utf-8", "replace")


def _frame_head(head: bytes) -> tuple[bool, int, bool, int]:
    """(fin, opcode, masked, length or 126/127) of a frame's first two bytes."""
    return bool(head[0] & 0x80), head[0] & 0x0F, bool(head[1] & 0x80), head[1] & 0x7F


def _message(kind: int | None, parts: list[bytes]) -> str | bytes:
    data = b"".join(parts)
    return data.decode("utf-8") if kind == OP_TEXT else data


class _WebSocket:
    """A blocking client socket. ``recv`` returns str (text) or bytes
    (binary) and raises ``ConnectionClosed`` once the connection closed;
    ``send`` may run on another thread than ``recv``; pings are answered."""

    def __init__(self, sock: socket.socket, buffered: bytes, subprotocol: str | None) -> None:
        self._sock = sock
        self._buf = bytearray(buffered)
        self.subprotocol = subprotocol
        self._send_lock = threading.Lock()
        self._read_lock = threading.Lock()
        self._close_sent = False
        self._closed = threading.Event()  # the server's close frame arrived, or the socket died
        self.close_code: int | None = None

    def __enter__(self) -> _WebSocket:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(max(65536, n - len(self._buf)))
            if not chunk:
                raise ConnectionError("socket closed")
            self._buf += chunk
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def _frame(self) -> tuple[bool, int, bytes]:
        fin, opcode, masked, n = _frame_head(self._exactly(2))
        if n == 126:
            (n,) = struct.unpack("!H", self._exactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", self._exactly(8))
        mask = self._exactly(4) if masked else None
        payload = self._exactly(n)
        return fin, opcode, unmask(payload, mask) if mask else payload

    def _write(self, opcode: int, payload: bytes) -> None:
        with self._send_lock:
            if self._close_sent or self._closed.is_set():
                raise ConnectionClosed(self.close_code or 1006)
            if opcode == OP_CLOSE:
                self._close_sent = True
            try:
                self._sock.sendall(encode_frame(opcode, payload, mask=os.urandom(4)))
            except OSError as e:
                self._dropped()
                raise ConnectionClosed(1006) from e

    def _dropped(self) -> None:
        if self.close_code is None:
            self.close_code = 1006
        self._closed.set()

    def _on_close(self, payload: bytes) -> ConnectionClosed:
        code, reason = _close_payload(payload)
        with contextlib.suppress(ConnectionClosed):
            self._write(OP_CLOSE, payload[:2])  # the reply, unless ours went out first
        self.close_code = code
        self._closed.set()
        return ConnectionClosed(code, reason)

    def send(self, data: str | bytes) -> None:
        if isinstance(data, str):
            self._write(OP_TEXT, data.encode("utf-8"))
        else:
            self._write(OP_BINARY, bytes(data))

    def recv(self) -> str | bytes:
        with self._read_lock:
            if self._closed.is_set():
                raise ConnectionClosed(self.close_code or 1006)
            kind, parts = None, []
            try:
                while True:
                    fin, opcode, payload = self._frame()
                    if opcode == OP_PING:
                        with contextlib.suppress(ConnectionClosed):
                            self._write(OP_PONG, payload)
                        continue
                    if opcode == OP_PONG:
                        continue
                    if opcode == OP_CLOSE:
                        raise self._on_close(payload)
                    if opcode != OP_CONT:
                        kind, parts = opcode, []
                    parts.append(payload)
                    if fin:
                        return _message(kind, parts)
            except (OSError, ConnectionError) as e:
                self._dropped()
                raise ConnectionClosed(1006) from e

    def close(self, code: int = 1000) -> None:
        """Send a close frame, wait up to ``CLOSE_TIMEOUT`` for the server's,
        and close the socket."""
        with contextlib.suppress(ConnectionClosed):
            self._write(OP_CLOSE, struct.pack("!H", code))
        if self._read_lock.acquire(timeout=CLOSE_TIMEOUT):
            try:
                self._sock.settimeout(CLOSE_TIMEOUT)
                while not self._closed.is_set():
                    fin, opcode, payload = self._frame()
                    if opcode == OP_CLOSE:
                        self._on_close(payload)
            except (OSError, ConnectionError):
                self._dropped()
            finally:
                self._read_lock.release()
        else:  # a reader holds the socket; it sees the server's close frame
            self._closed.wait(CLOSE_TIMEOUT)
        self._dropped()
        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)  # wakes a reader still blocked in recv
        self._sock.close()


def _connect(url: str, headers: dict[str, str] | None = None,
             subprotocols: list[str] | None = None, ssl_verify: bool = True,
             timeout: float = 30.0) -> _WebSocket:
    host, port, tls, request, key = _handshake(url, headers, subprotocols)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        if tls:
            sock = _ssl_context(ssl_verify).wrap_socket(sock, server_hostname=host)
        sock.sendall(request)
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk or len(buf) > MAX_HEAD:
                raise InvalidHandshake("connection closed during the WebSocket handshake")
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        protocol = _accepted(head, key, subprotocols)
        sock.settimeout(None)
        return _WebSocket(sock, rest, protocol)
    except BaseException:
        sock.close()
        raise


class _AsyncWebSocket:
    """The async form of ``_WebSocket``: each blocking call runs in a worker
    thread (``asyncio.to_thread``), as the async REST calls do; ``async
    for`` yields messages until the connection closes."""

    def __init__(self, ws: _WebSocket) -> None:
        self._ws = ws
        self.subprotocol = ws.subprotocol

    async def __aenter__(self) -> _AsyncWebSocket:
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def __aiter__(self) -> _AsyncWebSocket:
        return self

    async def __anext__(self) -> str | bytes:
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None

    async def send(self, data: str | bytes) -> None:
        await asyncio.to_thread(self._ws.send, data)

    async def recv(self) -> str | bytes:
        return await asyncio.to_thread(self._ws.recv)

    async def close(self, code: int = 1000) -> None:
        await asyncio.to_thread(self._ws.close, code)


async def _async_connect(url: str, headers: dict[str, str] | None = None,
                         subprotocols: list[str] | None = None,
                         ssl_verify: bool = True) -> _AsyncWebSocket:
    return _AsyncWebSocket(await asyncio.to_thread(_connect, url, headers, subprotocols, ssl_verify))


# ── the SDK ──────────────────────────────────────────────────────────────


class _ReplaySender:
    """Pumps audio chunks into a WS; replays the in-flight chunk on retry.

    Distinguishes *source* failures (the caller's iterator raised — terminal,
    surfaced to the caller after the final events) from *network* failures
    (ws.send raised — retried with the in-flight chunk replayed). Each pump
    attempt gets its own stop event so an abandoned thread from a previous
    connection can never clobber the live attempt's state (writes are gated
    on its own event, and the live thread owns the shared iterator)."""

    def __init__(self, audio_stream: Iterator[bytes]):
        self._source = iter(audio_stream)
        self._attempt_stop = threading.Event()
        self.pending: bytes | None = None
        self.exhausted = False
        self.error: Exception | None = None
        self.source_error: Exception | None = None

    def pump(self, ws) -> None:
        stop = self._attempt_stop
        try:
            if self.pending is not None:
                ws.send(self.pending)
                self.pending = None
            while not stop.is_set():
                try:
                    chunk = next(self._source)
                except StopIteration:
                    break
                except Exception as exc:  # the caller's iterator died
                    if not stop.is_set():
                        self.source_error = exc
                    break
                if stop.is_set():
                    return
                self.pending = chunk
                ws.send(chunk)
                self.pending = None
            if stop.is_set():
                return
            # a dead source still flushes what was delivered: the server
            # finalizes on "stop" and sends session.end
            self.exhausted = True
            ws.send(json.dumps({"type": "stop"}))
        except Exception as exc:  # network failure: the attempt is retried
            if not stop.is_set():
                self.error = exc

    def stop(self) -> None:
        self._attempt_stop.set()

    def finished_clean(self) -> bool:
        return self.exhausted and self.pending is None

    def reset_for_retry(self) -> None:
        # abandon the previous attempt (its thread holds the old event and
        # stops touching shared state) and arm a fresh one
        self._attempt_stop.set()
        self._attempt_stop = threading.Event()
        self.error = None


class OpenSpeechClient:
    def __init__(
        self,
        base_url: str = "http://localhost:8100",
        api_key: str | None = None,
        ssl_verify: bool = True,
    ):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.ssl_verify = ssl_verify

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self.api_key}"} if self.api_key else {}

    def _ws_url(self, path: str) -> str:
        for http_scheme, ws_scheme in (("https://", "wss://"), ("http://", "ws://")):
            if self.base_url.startswith(http_scheme):
                return ws_scheme + self.base_url[len(http_scheme) :] + path
        return self.base_url + path

    def _post(self, path: str, body: bytes, content_type: str, timeout: float = 60) -> bytes:
        """POST ``body`` to base_url + path; the response body, or
        ``HTTPStatusError`` for a status outside 2xx."""
        url = self.base_url + path
        parts = urlsplit(url)
        if parts.scheme == "https":
            conn = http.client.HTTPSConnection(parts.hostname, parts.port, timeout=timeout,
                                               context=_ssl_context(self.ssl_verify))
        else:
            conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout)
        try:
            conn.request("POST", parts.path + (f"?{parts.query}" if parts.query else ""), body=body,
                         headers={**self._headers(), "Content-Type": content_type})
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        if not 200 <= resp.status < 300:
            raise HTTPStatusError(resp.status, resp.reason, url, data)
        return data

    # ── batch STT / TTS ───────────────────────────────────────────────

    def transcribe(self, audio: bytes, model: str = "") -> dict:
        body, ctype = _multipart({"model": model} if model else {},
                                 {"file": ("audio.wav", audio, "audio/wav")})
        return json.loads(self._post("/v1/audio/transcriptions", body, ctype))

    def speak(
        self,
        text: str,
        voice: str = "alloy",
        speed: float = 1.0,
        model: str = "kokoro",
        response_format: str = "mp3",
    ) -> bytes:
        body = {"model": model, "input": text, "voice": voice, "speed": speed,
                "response_format": response_format}
        return self._post("/v1/audio/speech", json.dumps(body).encode(), "application/json")

    async def async_transcribe(self, audio: bytes, model: str = "") -> dict:
        return await asyncio.to_thread(self.transcribe, audio, model)

    async def async_speak(
        self,
        text: str,
        voice: str = "alloy",
        speed: float = 1.0,
        model: str = "kokoro",
        response_format: str = "mp3",
    ) -> bytes:
        return await asyncio.to_thread(self.speak, text, voice, speed, model, response_format)

    # ── streaming STT ─────────────────────────────────────────────────

    def _stream_url(self, model: str, sample_rate: int, vad: bool) -> str:
        params = {"sample_rate": sample_rate, "vad": "true" if vad else "false"}
        if model:
            params = {"model": model, **params}
        # model ids are user input — '&', '#', spaces must not split params
        return f"{self._ws_url('/v1/audio/stream')}?{urlencode(params)}"

    def stream_transcribe(
        self,
        audio_stream: Iterator[bytes],
        model: str = "",
        sample_rate: int = 16000,
        vad: bool = True,
        reconnect_attempts: int = 2,
    ) -> Iterator[dict[str, Any]]:
        """Sync streaming: background sender thread; yields server events.

        On disconnect, reconnects (up to ``reconnect_attempts``) and replays
        the chunk that was in flight.
        """
        ws_url = self._stream_url(model, sample_rate, vad)
        sender = _ReplaySender(audio_stream)

        for attempt in range(reconnect_attempts + 2):
            if attempt > reconnect_attempts:
                raise RuntimeError(
                    "stream_transcribe disconnected and reconnection limit reached"
                )
            if attempt:
                time.sleep(min(0.2 * attempt, 1.0))

            session_ended = False
            with _connect(ws_url, self._headers(), ssl_verify=self.ssl_verify) as ws:
                thread = threading.Thread(
                    target=sender.pump, args=(ws,), daemon=True
                )
                thread.start()
                try:
                    while True:
                        raw = ws.recv()
                        if isinstance(raw, bytes):
                            continue
                        event = json.loads(raw)
                        yield event
                        if event.get("type") == "session.end":
                            session_ended = True
                            sender.stop()
                            break
                except ConnectionClosed:
                    sender.stop()
                finally:
                    thread.join(timeout=1.0)

            if sender.source_error is not None:
                # the caller's iterator raised: surface it (the server was
                # asked to flush, and its final events were yielded above)
                raise sender.source_error
            if session_ended or sender.finished_clean():
                # server closed the session (clean stop OR server-side
                # abort like model_load_failed) — reconnect-and-replay
                # against an identical failure would just duplicate events
                return
            if sender.error and sender.exhausted:
                raise sender.error
            # resuming requires sole ownership of the shared source
            # iterator; a pump thread parked inside next() can't be resumed
            deadline = time.time() + 5.0
            while thread.is_alive() and time.time() < deadline:
                thread.join(timeout=0.25)
            if thread.is_alive():
                raise RuntimeError(
                    "stream_transcribe cannot reconnect: the audio source "
                    "is blocked mid-read"
                )
            sender.reset_for_retry()

    async def async_stream_transcribe(
        self,
        audio_stream: AsyncIterator[bytes] | Iterator[bytes],
        model: str = "",
        sample_rate: int = 16000,
        vad: bool = True,
        reconnect_attempts: int = 2,
    ) -> AsyncIterator[dict[str, Any]]:
        ws_url = self._stream_url(model, sample_rate, vad)
        state = {"pending": None, "done": False, "error": None,
                 "source_error": None}

        chunks_gen = None

        async def _chunks():
            if hasattr(audio_stream, "__aiter__"):
                async for chunk in audio_stream:  # type: ignore[union-attr]
                    yield chunk
            else:
                for chunk in audio_stream:  # type: ignore[not-an-iterable]
                    yield chunk

        async def _pump(ws) -> None:
            try:
                if state["pending"] is not None:
                    await ws.send(state["pending"])
                    state["pending"] = None
                while True:
                    try:
                        chunk = await anext(chunks_gen)
                    except StopAsyncIteration:
                        break
                    except Exception as exc:  # the caller's iterator died
                        state["source_error"] = exc
                        break
                    state["pending"] = chunk
                    await ws.send(chunk)
                    state["pending"] = None
                # a dead source still flushes what was delivered
                state["done"] = True
                await ws.send(json.dumps({"type": "stop"}))
            except Exception as exc:  # network failure: the attempt is retried
                state["error"] = exc

        for attempt in range(reconnect_attempts + 2):
            if attempt > reconnect_attempts:
                raise RuntimeError(
                    "async_stream_transcribe disconnected and reconnection "
                    "limit reached"
                )
            if attempt:
                await asyncio.sleep(min(0.2 * attempt, 1.0))
            if chunks_gen is None:
                chunks_gen = _chunks()
            session_ended = False
            async with await _async_connect(ws_url, self._headers(),
                                            ssl_verify=self.ssl_verify) as ws:
                pump_task = asyncio.create_task(_pump(ws))
                try:
                    async for raw in ws:
                        if isinstance(raw, bytes):
                            continue
                        event = json.loads(raw)
                        yield event
                        if event.get("type") == "session.end":
                            session_ended = True
                            break
                finally:
                    if not pump_task.done():
                        with contextlib.suppress(BaseException):
                            await asyncio.wait_for(pump_task, timeout=0.5)
                    if not pump_task.done():
                        pump_task.cancel()
                        with contextlib.suppress(BaseException):
                            await pump_task

                if state["source_error"] is not None:
                    # surface the caller's iterator failure (final events
                    # for the delivered audio were yielded above)
                    raise state["source_error"]
                if session_ended or (
                    state["done"] and state["pending"] is None
                ):
                    # server closed the session (clean stop OR server-side
                    # abort) — reconnecting would duplicate events
                    return
                if state["error"] and state["done"]:
                    raise state["error"]
                state["error"] = None

    # ── realtime sessions ─────────────────────────────────────────────

    def realtime_session(self, model: str = "") -> "RealtimeSession":
        return RealtimeSession(self, model=model)

    async def async_realtime_session(self, model: str = "") -> "AsyncRealtimeSession":
        sess = AsyncRealtimeSession(self, model=model)
        await sess.connect()
        return sess


def _route_event(evt: dict, transcript_cbs, audio_cbs, vad_cbs):
    et = evt.get("type", "")
    if "transcription" in et or et == "conversation.item.created":
        return transcript_cbs
    if et.startswith("response.audio"):
        return audio_cbs
    if "speech_" in et:
        return vad_cbs
    return []


def _realtime_url(client: OpenSpeechClient, model: str) -> str:
    suffix = f"/v1/realtime?{urlencode({'model': model})}" if model else "/v1/realtime"
    return client._ws_url(suffix)


class RealtimeSession:
    """Sync realtime session: background receiver thread + callbacks."""

    def __init__(self, client: OpenSpeechClient, model: str = ""):
        self.client = client
        self.model = model
        self._ws: _WebSocket | None = None
        self._receiver: threading.Thread | None = None
        self._running = False
        self._transcript_callbacks: list[Callable[[dict], None]] = []
        self._audio_callbacks: list[Callable[[dict], None]] = []
        self._vad_callbacks: list[Callable[[dict], None]] = []
        self._connect()

    def _connect(self) -> None:
        self._ws = _connect(_realtime_url(self.client, self.model), self.client._headers(),
                            subprotocols=["realtime"], ssl_verify=self.client.ssl_verify)
        self._running = True
        self._receiver = threading.Thread(target=self._recv_loop, daemon=True)
        self._receiver.start()

    def _recv_loop(self) -> None:
        while self._running and self._ws is not None:
            try:
                raw = self._ws.recv()
            except Exception:  # noqa: BLE001 - socket closed/dropped
                break
            if isinstance(raw, bytes):
                continue
            try:
                evt = json.loads(raw)
            except ValueError:
                logger.warning("realtime: dropping malformed frame")
                continue
            for cb in _route_event(
                evt,
                self._transcript_callbacks,
                self._audio_callbacks,
                self._vad_callbacks,
            ):
                # a broken user callback must not kill event dispatch
                # for the rest of the session
                try:
                    cb(evt)
                except Exception:  # noqa: BLE001
                    logger.exception("realtime callback raised")

    def _send(self, payload: dict) -> None:
        if self._ws is None:
            raise RuntimeError("Realtime session is closed")
        self._ws.send(json.dumps(payload))

    def send_audio(self, chunk: bytes) -> None:
        self._send(
            {
                "type": "input_audio_buffer.append",
                "audio": base64.b64encode(chunk).decode("ascii"),
            }
        )

    def commit(self) -> None:
        self._send({"type": "input_audio_buffer.commit"})

    def create_response(self, text: str, voice: str = "alloy") -> None:
        self._send(
            {
                "type": "response.create",
                "response": {
                    "instructions": text,
                    "voice": voice,
                    "modalities": ["audio", "text"],
                },
            }
        )

    def on_transcript(self, callback: Callable[[dict], None]) -> None:
        self._transcript_callbacks.append(callback)

    def on_audio(self, callback: Callable[[dict], None]) -> None:
        self._audio_callbacks.append(callback)

    def on_vad(self, callback: Callable[[dict], None]) -> None:
        self._vad_callbacks.append(callback)

    def close(self) -> None:
        self._running = False
        if self._ws is not None:
            try:
                self._ws.close()
            finally:
                self._ws = None
        if self._receiver is not None:
            self._receiver.join(timeout=1.0)


class AsyncRealtimeSession:
    """Async realtime session: receiver task + (a)sync callbacks."""

    def __init__(self, client: OpenSpeechClient, model: str = ""):
        self.client = client
        self.model = model
        self._ws: _AsyncWebSocket | None = None
        self._receiver_task: asyncio.Task | None = None
        self._transcript_callbacks: list[Callable[[dict], Any]] = []
        self._audio_callbacks: list[Callable[[dict], Any]] = []
        self._vad_callbacks: list[Callable[[dict], Any]] = []

    async def connect(self) -> None:
        self._ws = await _async_connect(
            _realtime_url(self.client, self.model), self.client._headers(),
            subprotocols=["realtime"], ssl_verify=self.client.ssl_verify)
        self._receiver_task = asyncio.create_task(self._recv_loop())

    async def _recv_loop(self) -> None:
        if self._ws is None:
            raise RuntimeError("Realtime session is not connected")
        async for raw in self._ws:
            if isinstance(raw, bytes):
                continue
            try:
                evt = json.loads(raw)
            except ValueError:
                logger.warning("realtime: dropping malformed frame")
                continue
            for cb in _route_event(
                evt,
                self._transcript_callbacks,
                self._audio_callbacks,
                self._vad_callbacks,
            ):
                # a broken user callback must not kill the receiver task
                try:
                    ret = cb(evt)
                    if asyncio.iscoroutine(ret):
                        await ret
                except Exception:  # noqa: BLE001
                    logger.exception("realtime callback raised")

    async def _send(self, payload: dict) -> None:
        if self._ws is None:
            raise RuntimeError("Realtime session is closed")
        await self._ws.send(json.dumps(payload))

    async def send_audio(self, chunk: bytes) -> None:
        await self._send(
            {
                "type": "input_audio_buffer.append",
                "audio": base64.b64encode(chunk).decode("ascii"),
            }
        )

    async def commit(self) -> None:
        await self._send({"type": "input_audio_buffer.commit"})

    async def create_response(self, text: str, voice: str = "alloy") -> None:
        await self._send(
            {
                "type": "response.create",
                "response": {
                    "instructions": text,
                    "voice": voice,
                    "modalities": ["audio", "text"],
                },
            }
        )

    def on_transcript(self, callback: Callable[[dict], Any]) -> None:
        self._transcript_callbacks.append(callback)

    def on_audio(self, callback: Callable[[dict], Any]) -> None:
        self._audio_callbacks.append(callback)

    def on_vad(self, callback: Callable[[dict], Any]) -> None:
        self._vad_callbacks.append(callback)

    async def close(self) -> None:
        if self._receiver_task:
            self._receiver_task.cancel()
            with contextlib.suppress(BaseException):
                await self._receiver_task
        if self._ws is not None:
            await self._ws.close()
            self._ws = None
