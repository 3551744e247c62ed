"""HTTP/1.1 on asyncio streams: the part of aiohttp that the server uses.

The JAX package serves its app with aiohttp; the card's machine has no
aiohttp, so the port serves the same routes on ``asyncio.start_server``:

- requests: the request line and headers (each line at most
  ``MAX_LINE`` bytes, at most ``MAX_HEADERS`` fields), ``Content-Length``
  and chunked bodies, ``Expect: 100-continue`` (answered before the body is
  read), keep-alive (HTTP/1.1 unless ``Connection: close``; HTTP/1.0 only
  with ``Connection: keep-alive``) and the query string;
- ``Request`` with ``method``, ``path`` (percent-decoded), ``query`` (the
  first value of each name), ``headers`` (case-insensitive),
  ``match_info``, ``transport`` and ``remote``; ``read``/``post``/``json``
  answer 413 past the app's ``client_max_size`` as aiohttp does;
- ``Response``, ``json_response`` and a chunked ``StreamResponse``
  (``prepare``/``write``/``write_eof``);
- a router with aiohttp's ``{name}`` and ``{name:regex}`` patterns, where
  a ``GET`` route also answers ``HEAD``; an unknown path raises 404 and a
  known path with another method 405 inside the middleware chain, so the
  app's error middleware renders them; ``add_static`` serves a directory's
  files with aiohttp's refusals (a path that resolves outside it, through
  ``..``, an encoded ``..`` or a symlink, is 404; a directory is 403);
- ``Application`` (middlewares ``mw(request, handler)``, startup and
  cleanup hooks, item storage) and ``run_app``, which serves until SIGINT
  or SIGTERM, lets requests in flight finish, then runs the cleanup hooks.

The body is read only when the handler asks for it, so the middlewares'
401 and 429 cost no upload: ``read`` stops at ``client_max_size`` (a
``Content-Length`` past it is refused unread), ``Expect: 100-continue`` is
answered at the first read, and each read of the socket waits at most
``BODY_TIMEOUT`` (then 408). A response that goes out before its request's
body was read closes the connection; the server drops what the client
still sends for up to ``LINGER_TIMEOUT`` first, so that the client can
read that response (aiohttp's lingering close).
"""

from __future__ import annotations

import asyncio
import email.utils
import json
import logging
import mimetypes
import re
import signal
import ssl
from collections.abc import Awaitable, Callable, Iterator, MutableMapping
from http import HTTPStatus
from pathlib import Path
from urllib.parse import parse_qsl, unquote

from open_speech_tpu_torch import __version__

logger = logging.getLogger(__name__)

MAX_LINE = 8190  # aiohttp's max_line_size and max_field_size
MAX_HEADERS = 128
KEEPALIVE_TIMEOUT = 75.0  # aiohttp's keepalive_timeout
BODY_TIMEOUT = 60.0  # the longest wait for the next bytes of a body
LINGER_TIMEOUT = 10.0  # aiohttp's lingering_time
SHUTDOWN_TIMEOUT = 60.0  # requests in flight get this long at shutdown
FORM_FRAMING = 1 << 16  # multipart delimiters and part headers allowed past the limit
_PIECE = 1 << 16
_BODY_METHODS = frozenset({"POST", "PUT", "PATCH", "TRACE", "DELETE"})  # aiohttp's POST_METHODS
SERVER = f"Python open-speech-torch/{__version__}"
_TOKEN = re.compile(rb"[!#$%&'*+\-.^_`|~0-9A-Za-z]+")

Handler = Callable[["Request"], Awaitable["Response | StreamResponse"]]


class HTTPError(Exception):
    """An HTTP error raised by the router or a body reader (the role of
    aiohttp's ``web.HTTPException``); ``reason`` is the status phrase."""

    def __init__(self, status: int, headers: dict[str, str] | None = None) -> None:
        self.status = status
        self.reason = HTTPStatus(status).phrase
        self.headers = dict(headers or {})
        super().__init__(f"{status} {self.reason}")


class _BadRequest(Exception):
    """A request that cannot be parsed: answered 400 and the connection closed."""


class Headers(MutableMapping):
    """Case-insensitive header map that keeps the first spelling of a name."""

    def __init__(self, items=()) -> None:
        self._d: dict[str, tuple[str, str]] = {}
        pairs = items.items() if hasattr(items, "items") else items
        for name, value in pairs:
            self[name] = value

    def __getitem__(self, name: str) -> str:
        return self._d[name.lower()][1]

    def __setitem__(self, name: str, value) -> None:
        key = name.lower()
        self._d[key] = (self._d[key][0] if key in self._d else name, str(value))

    def __delitem__(self, name: str) -> None:
        del self._d[name.lower()]

    def __iter__(self) -> Iterator[str]:
        return (name for name, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)


def parse_header_value(value: str) -> tuple[str, dict[str, str]]:
    """``type/sub; a=1; b="x;y"`` -> ("type/sub", {"a": "1", "b": "x;y"}):
    the first item lower-cased, parameter names lower-cased, quoted strings
    unquoted (backslash escapes kept literal), ``name*`` (RFC 5987) decoded."""
    parts, buf, quoted, i = [], [], False, 0
    while i < len(value):
        c = value[i]
        if quoted and c == "\\" and i + 1 < len(value):
            buf.append(value[i + 1])
            i += 2
            continue
        if c == '"':
            quoted = not quoted
        elif c == ";" and not quoted:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    parts.append("".join(buf))
    params: dict[str, str] = {}
    for item in parts[1:]:
        name, eq, val = item.partition("=")
        name = name.strip().lower()
        if not eq or not name:
            continue
        val = val.strip()
        if name.endswith("*"):
            charset, _, rest = val.partition("'")
            _, _, encoded = rest.partition("'")
            params[name[:-1]] = unquote(encoded, encoding=charset or "utf-8")
        else:
            params.setdefault(name, val)
    return parts[0].strip().lower(), params


class _Body:
    """A request's body, read from the connection on demand. A fault in
    the framing raises 400 and marks the connection ``broken``."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 headers: Headers, expect_continue: bool) -> None:
        self._reader, self._writer = reader, writer
        self.continue_owed = expect_continue  # 100 Continue, sent at the first read
        self.broken = False
        coding = headers.get("transfer-encoding", "")
        length = headers.get("content-length")
        if coding:
            if length is not None:
                raise _BadRequest("both Transfer-Encoding and Content-Length")
            if coding.split(",")[-1].strip().lower() != "chunked":
                raise _BadRequest(f"unsupported Transfer-Encoding {coding!r}")
        elif length is not None and not length.isdigit():
            raise _BadRequest(f"bad Content-Length {length!r}")
        self.chunked = bool(coding)
        self.left = 0 if coding else int(length or 0)  # bytes left in the body or chunk
        self.done = not coding and self.left == 0

    async def _get(self, aw):
        try:
            return await asyncio.wait_for(aw, BODY_TIMEOUT)
        except asyncio.TimeoutError:
            self.broken = True
            raise HTTPError(408) from None

    def _fault(self, message: str) -> HTTPError:
        self.broken = True
        logger.info("bad request body: %s", message)
        return HTTPError(400)

    async def _piece(self) -> bytes:
        """The next bytes of the body (b"" at its end)."""
        if self.done:
            return b""
        if self.continue_owed:
            self.continue_owed = False
            self._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await self._writer.drain()
        if self.chunked and self.left == 0:
            line = await self._get(self._reader.readuntil(b"\r\n"))
            size_field = line[:-2].split(b";")[0].strip()
            if not size_field or not re.fullmatch(rb"[0-9A-Fa-f]+", size_field):
                raise self._fault(f"bad chunk size {line[:40]!r}")
            self.left = int(size_field, 16)
            if self.left == 0:
                while True:  # trailer fields, then the empty line
                    line = await self._get(self._reader.readuntil(b"\r\n"))
                    if line == b"\r\n":
                        break
                    if len(line) > MAX_LINE:
                        raise self._fault("trailer line too long")
                self.done = True
                return b""
        data = await self._get(self._reader.readexactly(min(self.left, _PIECE)))
        self.left -= len(data)
        if self.left == 0:
            if not self.chunked:
                self.done = True
            elif await self._get(self._reader.readexactly(2)) != b"\r\n":
                raise self._fault("chunk not followed by CRLF")
        return data

    async def read(self, limit: int) -> bytes:
        """The whole body; 413 once it reaches ``limit`` bytes (0: no limit)."""
        if limit and not self.chunked and self.left >= limit:
            raise HTTPError(413)
        body = bytearray()
        while piece := await self._piece():
            body += piece
            if limit and len(body) >= limit:
                raise HTTPError(413)
        return bytes(body)


class Request:
    """One parsed request; its body is read by ``read``, ``post`` or ``json``."""

    def __init__(self, *, method: str, target: str, headers: Headers, body: _Body,
                 app: "Application", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        raw_path, _, query = target.partition("?")
        self.method, self.headers, self.app = method, headers, app
        self.path = unquote(raw_path)
        self.query: dict[str, str] = {}
        for name, value in parse_qsl(query, keep_blank_values=True):
            self.query.setdefault(name, value)
        self._body, self._read = body, None
        self.match_info: dict[str, str] = {}
        self._reader, self._writer = reader, writer
        self.started = False  # a response's head went out: no other response follows
        self.upgraded = None  # the WebSocketResponse that took the connection

    @property
    def transport(self) -> asyncio.Transport | None:
        return self._writer.transport

    @property
    def remote(self) -> str | None:
        peer = self._writer.get_extra_info("peername")
        return peer[0] if isinstance(peer, tuple) else peer

    @property
    def can_read_body(self) -> bool:
        """Whether the request has a body left to read (aiohttp's name)."""
        return not self._body.done

    @property
    def content_type(self) -> str:
        return parse_header_value(self.headers.get("content-type", ""))[0]

    @property
    def charset(self) -> str | None:
        return parse_header_value(self.headers.get("content-type", ""))[1].get("charset")

    async def _read_up_to(self, limit: int) -> bytes:
        if self._read is None:
            self._read = await self._body.read(limit)
        return self._read

    async def read(self) -> bytes:
        return await self._read_up_to(self.app.client_max_size)

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self):
        return json.loads(await self.text())

    async def post(self) -> dict:
        """The form of a POST: ``{name: str | (bytes, filename, content
        type)}``, the last value of a repeated name (see ``multipart.py``),
        parsed on an executor thread."""
        from open_speech_tpu_torch.server.multipart import parse_form, parse_urlencoded

        if self.method not in _BODY_METHODS:
            return {}
        loop = asyncio.get_running_loop()
        max_size = self.app.client_max_size
        if self.content_type == "multipart/form-data":
            # aiohttp counts a form's decoded parts against the limit, not its framing
            raw = await self._read_up_to(max_size + FORM_FRAMING if max_size else 0)
            form, _ = await loop.run_in_executor(
                None, parse_form, raw, self.headers.get("content-type", ""), max_size)
            return form
        if self.content_type in ("", "application/x-www-form-urlencoded"):
            return await loop.run_in_executor(
                None, parse_urlencoded, await self.read(), self.charset or "utf-8")
        return {}


def _head(status: int, headers: Headers, *, close: bool) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    lines += [f"{name}: {value}" for name, value in headers.items()]
    if "date" not in headers:
        lines.append(f"Date: {email.utils.formatdate(usegmt=True)}")
    if "server" not in headers:
        lines.append(f"Server: {SERVER}")
    if close:
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A whole response. ``text`` is sent as UTF-8 with ``; charset=utf-8``
    on its content type (``text/plain`` unless given), as aiohttp does."""

    def __init__(self, body: bytes | None = None, *, status: int = 200, text: str | None = None,
                 content_type: str | None = None, headers=None) -> None:
        self.status = status
        self.headers = Headers(headers or {})
        if text is not None:
            body = text.encode("utf-8")
            content_type = f"{content_type or 'text/plain'}; charset=utf-8"
        elif body is not None and content_type is None:
            content_type = "application/octet-stream"
        if content_type is not None and "content-type" not in self.headers:
            self.headers["Content-Type"] = content_type
        self.body = body or b""

    def encode(self, *, head_only: bool, close: bool) -> bytes:
        headers = Headers(self.headers.items())
        if self.status >= 200 and self.status not in (204, 304):
            headers["Content-Length"] = len(self.body)
        return _head(self.status, headers, close=close) + (b"" if head_only else self.body)


def json_response(data, *, status: int = 200, headers=None) -> Response:
    return Response(text=json.dumps(data), status=status, content_type="application/json",
                    headers=headers)


class StreamResponse:
    """A response written as it is produced, in chunked transfer coding.
    Nothing is sent before ``prepare``."""

    def __init__(self, *, status: int = 200, headers=None) -> None:
        self.status = status
        self.headers = Headers(headers or {})
        self._writer: asyncio.StreamWriter | None = None
        self._eof = False

    async def prepare(self, request: Request) -> None:
        if self._writer is not None:
            return
        self.headers["Transfer-Encoding"] = "chunked"
        self._writer = request._writer
        request.started = True
        await self._send(_head(self.status, self.headers, close=not request._body.done))

    async def _send(self, data: bytes) -> None:
        if self._writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        self._writer.write(data)
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if self._writer is None:
            raise RuntimeError("write before prepare")
        if data:
            await self._send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if self._writer is None:
            raise RuntimeError("write_eof before prepare")
        if not self._eof:
            self._eof = True
            await self._send(b"0\r\n\r\n")


# ── routing ─────────────────────────────────────────────────────────────

_PARAM = re.compile(r"\{(\w+)(?::([^{}]+))?\}")


def _compile(pattern: str) -> re.Pattern:
    """aiohttp's patterns: ``{name}`` is one segment, ``{name:regex}`` the regex."""
    out, pos = [], 0
    for m in _PARAM.finditer(pattern):
        out.append(re.escape(pattern[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>{m.group(2) or '[^{}/]+'})")
        pos = m.end()
    out.append(re.escape(pattern[pos:]))
    return re.compile("".join(out))


class Router:
    def __init__(self) -> None:
        self._routes: list[tuple[str, re.Pattern, Handler, str]] = []

    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append((method.upper(), _compile(pattern), handler, pattern))

    def add_get(self, pattern: str, handler: Handler) -> None:
        self.add_route("GET", pattern, handler)
        self.add_route("HEAD", pattern, handler)

    def add_post(self, pattern: str, handler: Handler) -> None:
        self.add_route("POST", pattern, handler)

    def add_put(self, pattern: str, handler: Handler) -> None:
        self.add_route("PUT", pattern, handler)

    def add_delete(self, pattern: str, handler: Handler) -> None:
        self.add_route("DELETE", pattern, handler)

    def add_static(self, prefix: str, directory: str | Path) -> None:
        """``GET``/``HEAD`` ``prefix/<filename>``: the files under
        ``directory``, refused as aiohttp's ``add_static`` refuses them."""
        root = Path(directory).resolve()
        prefix = prefix.rstrip("/")

        async def handler(request: Request) -> Response:
            return await asyncio.get_running_loop().run_in_executor(
                None, _static_file, root, request.match_info.get("filename") or "")

        regex = re.compile(re.escape(prefix) + r"(?:/(?P<filename>.*))?")
        for method in ("GET", "HEAD"):
            self._routes.append((method, regex, handler, prefix))

    def routes(self) -> list[tuple[str, str]]:
        """(method, pattern) of every route, in the order they were added."""
        return [(method, pattern) for method, _, _, pattern in self._routes]

    def resolve(self, method: str, path: str) -> tuple[Handler, dict[str, str]]:
        allowed: set[str] = set()
        for route_method, regex, handler, _ in self._routes:
            m = regex.fullmatch(path)
            if m is None:
                continue
            if route_method == method:
                return handler, m.groupdict()
            allowed.add(route_method)
        if allowed:
            raise HTTPError(405, {"Allow": ",".join(sorted(allowed))})
        raise HTTPError(404)


def _static_file(root: Path, filename: str) -> Response:
    """aiohttp's static lookup with symlinks not followed out: the path
    resolved (``..``, encoded or not, and symlinks included) must lie under
    ``root``, else 404; a directory is 403; a file that is not there is
    aiohttp's empty 404. The content type is guessed from the name."""
    try:
        path = root.joinpath(filename).resolve()
        path.relative_to(root)
    except (ValueError, RuntimeError):  # outside the root, a NUL byte, a symlink loop
        raise HTTPError(404)
    try:
        if path.is_dir():
            raise HTTPError(403)
        body = path.read_bytes()
    except PermissionError:
        raise HTTPError(403)
    except OSError:
        return Response(status=404, body=b"", content_type="application/octet-stream")
    return Response(body=body, content_type=mimetypes.guess_type(path.name)[0] or "application/octet-stream")


class Application:
    """Routes, middlewares (outermost first), lifecycle hooks and items."""

    def __init__(self, *, middlewares=(), client_max_size: int = 1024 ** 2) -> None:
        self.router = Router()
        self.middlewares = list(middlewares)
        self.client_max_size = client_max_size
        self.on_startup: list[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[["Application"], Awaitable[None]]] = []
        self._items: dict[str, object] = {}

    def __getitem__(self, key: str):
        return self._items[key]

    def __setitem__(self, key: str, value) -> None:
        self._items[key] = value

    def get(self, key: str, default=None):
        return self._items.get(key, default)

    async def startup(self) -> None:
        for hook in self.on_startup:
            await hook(self)

    async def cleanup(self) -> None:
        for hook in self.on_cleanup:
            await hook(self)

    async def handle(self, request: Request):
        async def dispatch(req: Request):
            handler, req.match_info = self.router.resolve(req.method, req.path)
            return await handler(req)

        handler = dispatch
        for mw in reversed(self.middlewares):
            handler = (lambda m, inner: lambda req: m(req, inner))(mw, handler)
        return await handler(request)


# ── the connection ──────────────────────────────────────────────────────


class _Connection:
    def __init__(self, app: Application, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.app, self.reader, self.writer = app, reader, writer
        self.busy = False  # a request is being read or answered

    async def serve(self) -> None:
        try:
            while await self._one():
                pass
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError, ssl.SSLError):
            pass
        except _BadRequest as e:
            await self._reply_bad(str(e))
        finally:
            self.writer.close()

    async def _reply_bad(self, message: str) -> None:
        resp = Response(text=f"400, message: {message}", status=400)
        try:
            self.writer.write(resp.encode(head_only=False, close=True))
            await self.writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    async def _read_head(self) -> tuple[str, str, tuple[int, int], Headers] | None:
        try:
            raw = await asyncio.wait_for(self.reader.readuntil(b"\r\n\r\n"), KEEPALIVE_TIMEOUT)
        except asyncio.IncompleteReadError as e:
            if e.partial.strip():
                raise _BadRequest("incomplete request head") from e
            return None  # the client closed between requests
        except asyncio.LimitOverrunError as e:
            raise _BadRequest("request head too large") from e
        self.busy = True
        lines = raw[:-4].split(b"\r\n")
        while lines and not lines[0]:  # stray CRLF before a request line
            lines.pop(0)
        if not lines or any(len(line) > MAX_LINE for line in lines):
            raise _BadRequest(f"Got more than {MAX_LINE} bytes when reading a line")
        parts = lines[0].split(b" ")
        if len(parts) != 3 or not _TOKEN.fullmatch(parts[0]):
            raise _BadRequest(f"bad request line {lines[0][:80]!r}")
        method, target, proto = parts
        m = re.fullmatch(rb"HTTP/(\d)\.(\d)", proto)
        if m is None or not (target.startswith(b"/") or target == b"*"):
            raise _BadRequest(f"bad request line {lines[0][:80]!r}")
        if len(lines) - 1 > MAX_HEADERS:
            raise _BadRequest("too many headers")
        headers = Headers()
        for line in lines[1:]:
            name, colon, value = line.partition(b":")
            if not colon or not _TOKEN.fullmatch(name):
                raise _BadRequest(f"bad header line {line[:80]!r}")
            key, text = name.decode("ascii"), value.strip(b" \t").decode("latin-1")
            headers[key] = f"{headers[key]}, {text}" if key in headers else text
        return (method.decode("ascii"), target.decode("latin-1"),
                (int(m.group(1)), int(m.group(2))), headers)

    async def _linger(self) -> None:
        """Drop what the client still sends, until it closes or
        ``LINGER_TIMEOUT`` passes, so that closing with unread bytes does
        not reset the connection before the client read its response."""
        loop = asyncio.get_running_loop()
        end = loop.time() + LINGER_TIMEOUT
        while (left := end - loop.time()) > 0:
            if not await asyncio.wait_for(self.reader.read(_PIECE), left):
                return

    async def _one(self) -> bool:
        """Serve one request; whether the connection stays open."""
        self.busy = False
        head = await self._read_head()
        if head is None:
            return False
        method, target, version, headers = head
        expect = headers.get("expect", "").lower()
        if expect and expect != "100-continue":
            self.writer.write(Response(status=417).encode(head_only=False, close=True))
            await self.writer.drain()
            return False
        body = _Body(self.reader, self.writer, headers, bool(expect) and version >= (1, 1))
        request = Request(method=method, target=target, headers=headers, body=body,
                          app=self.app, reader=self.reader, writer=self.writer)
        try:
            resp = await self.app.handle(request)
        except Exception:  # noqa: BLE001 — a fault past the app's error middleware
            logger.exception("Unhandled error on %s %s", method, request.path)
            resp = Response(text="500 Internal Server Error", status=500)
        if request.upgraded is not None:
            await request.upgraded.finish()
            return False
        conn = headers.get("connection", "").lower()
        keep_alive = ("close" not in conn) if version >= (1, 1) else ("keep-alive" in conn)
        keep_alive = keep_alive and body.done
        if isinstance(resp, StreamResponse):
            if self.writer.is_closing():
                return False
            await resp.prepare(request)
            await resp.write_eof()
        elif request.started or self.writer.is_closing():
            return False  # a stream broke off: nothing more can be said on it
        else:
            self.writer.write(resp.encode(head_only=method == "HEAD", close=not keep_alive))
            await self.writer.drain()
        if not body.done and not body.broken and not body.continue_owed:
            self.busy = False
            await self._linger()
        return keep_alive


class Server:
    """A listening socket serving ``app``; ``close`` lets requests in flight
    finish (up to ``SHUTDOWN_TIMEOUT``), then ends every connection."""

    def __init__(self, app: Application) -> None:
        self.app = app
        self._server: asyncio.base_events.Server | None = None
        self._conns: dict[asyncio.Task, _Connection] = {}

    async def start(self, host: str, port: int, ssl_context: ssl.SSLContext | None = None) -> None:
        self._server = await asyncio.start_server(
            self._accept, host, port, ssl=ssl_context, limit=1 << 16)

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _Connection(self.app, reader, writer)
        task = asyncio.current_task()
        self._conns[task] = conn
        try:
            await conn.serve()
        finally:
            self._conns.pop(task, None)

    async def close(self) -> None:
        self._server.close()
        deadline = asyncio.get_running_loop().time() + SHUTDOWN_TIMEOUT
        while any(c.busy for c in self._conns.values()):
            if asyncio.get_running_loop().time() > deadline:
                break
            await asyncio.sleep(0.05)
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()


async def serve_app(app: Application, host: str, port: int,
                    ssl_context: ssl.SSLContext | None = None) -> Server:
    """Run the startup hooks and start listening."""
    await app.startup()
    server = Server(app)
    await server.start(host, port, ssl_context)
    return server


def run_app(app: Application, *, host: str, port: int,
            ssl_context: ssl.SSLContext | None = None) -> None:
    """Serve until SIGINT or SIGTERM, then close and run the cleanup hooks."""

    async def main() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        server = await serve_app(app, host, port, ssl_context)
        scheme = "https" if ssl_context is not None else "http"
        print(f"======== Running on {scheme}://{host}:{server.port} ========\n"
              "(Press CTRL+C to quit)", flush=True)
        try:
            await stop.wait()
        finally:
            await server.close()
            await app.cleanup()

    asyncio.run(main())
