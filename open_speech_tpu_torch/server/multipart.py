"""Form bodies: ``multipart/form-data`` and urlencoded forms.

``parse_form`` gives what the JAX app's ``_read_multipart`` builds from
aiohttp's ``request.post()`` (``open_speech_tpu/server/app.py``):
``{name: value}`` where a part with a (non-empty) filename becomes
``(bytes, filename, content type)`` (``application/octet-stream`` when the
part names none), a part without a filename becomes text when it has no
content type or a ``text/*`` one (decoded with its charset, UTF-8 unless
given) and bytes otherwise, and a repeated name keeps its last value (the
dict is built from the MultiDict's items in order). ``Content-Transfer-
Encoding`` (base64, quoted-printable) and ``Content-Encoding`` (gzip,
deflate) are undone, as aiohttp's ``field.decode`` does. The decoded
parts' bytes are what aiohttp checks against ``client_max_size``:
``parse_form`` raises 413 once they pass ``max_size``, and never inflates
a compressed part past what is left of it.
"""

from __future__ import annotations

import base64
import binascii
import quopri
import zlib
from urllib.parse import parse_qsl

from open_speech_tpu_torch.server.http import HTTPError, parse_header_value

FormValue = str | bytes | tuple[bytes, str, str]


def parse_urlencoded(data: bytes, charset: str = "utf-8") -> dict[str, str]:
    form: dict[str, str] = {}
    if data:
        for name, value in parse_qsl(data.rstrip().decode(charset), keep_blank_values=True,
                                     encoding=charset):
            form[name] = value
    return form


def _part_headers(block: bytes) -> dict[str, str]:
    headers: dict[str, str] = {}
    for line in block.split(b"\r\n"):
        if not line:
            continue
        name, colon, value = line.partition(b":")
        if not colon:
            raise ValueError(f"Invalid multipart header line {line[:80]!r}")
        headers[name.strip().decode("latin-1").lower()] = value.strip().decode("utf-8", "replace")
    return headers


def _inflate(data: bytes, wbits: int, budget: int | None) -> bytes:
    """``data`` decompressed; 413 past ``budget`` bytes (None: no bound)."""
    d = zlib.decompressobj(wbits)
    out = d.decompress(data, 0 if budget is None else budget + 1)
    if budget is not None and (len(out) > budget or d.unconsumed_tail):
        raise HTTPError(413)
    return out + d.flush()


def _decode(data: bytes, headers: dict[str, str], budget: int | None) -> bytes:
    cte = headers.get("content-transfer-encoding", "").lower()
    if cte == "base64":
        try:
            data = base64.b64decode(data)
        except binascii.Error as e:
            raise ValueError(f"Invalid base64 part: {e}") from e
    elif cte == "quoted-printable":
        data = quopri.decodestring(data)
    elif cte not in ("", "binary", "8bit", "7bit"):
        raise RuntimeError(f"unknown content transfer encoding: {cte}")
    encoding = headers.get("content-encoding", "").lower()
    if encoding == "gzip":
        data = _inflate(data, 16 + zlib.MAX_WBITS, budget)
    elif encoding == "deflate":
        data = _inflate(data, -zlib.MAX_WBITS, budget)
    elif encoding not in ("", "identity"):
        raise RuntimeError(f"unknown content encoding: {encoding}")
    return data


def _iter_parts(body: bytes, boundary: str):
    """Yield (headers, raw content) of each part of a multipart body."""
    delim = b"--" + boundary.encode("latin-1")
    start = body.find(delim)
    if start < 0 or (start > 0 and body[start - 2 : start] != b"\r\n"):
        raise ValueError("Multipart body has no opening boundary")
    pos = start + len(delim)
    while True:
        if body[pos : pos + 2] == b"--":
            return  # the closing delimiter; anything after it is epilogue
        eol = body.find(b"\r\n", pos)
        if eol < 0 or body[pos:eol].strip(b" \t"):
            raise ValueError("Invalid multipart boundary line")
        pos = eol + 2
        if body[pos : pos + 2] == b"\r\n":  # a part without headers
            headers, content_at = {}, pos + 2
        else:
            end = body.find(b"\r\n\r\n", pos)
            if end < 0:
                raise ValueError("Multipart part headers are not terminated")
            headers, content_at = _part_headers(body[pos:end]), end + 4
        stop = body.find(b"\r\n" + delim, content_at)
        if stop < 0:
            raise ValueError("Multipart body is not closed")
        yield headers, body[content_at:stop]
        pos = stop + 2 + len(delim)


def parse_form(body: bytes, content_type: str,
               max_size: int = 0) -> tuple[dict[str, FormValue], int]:
    """(form, decoded size) of a ``multipart/form-data`` body; 413 once the
    decoded size passes ``max_size`` (0: no limit)."""
    boundary = parse_header_value(content_type)[1].get("boundary")
    if not boundary:
        raise ValueError(f"Multipart body without a boundary: {content_type!r}")
    form: dict[str, FormValue] = {}
    size = 0
    for headers, raw in _iter_parts(body, boundary):
        _, disposition = parse_header_value(headers.get("content-disposition", ""))
        name = disposition.get("name")
        if name is None:
            raise ValueError("Multipart field missing name.")
        part_type = headers.get("content-type")
        data = _decode(raw, headers, max_size - size if max_size else None)
        size += len(data)
        if 0 < max_size < size:
            raise HTTPError(413)
        filename = disposition.get("filename")
        if filename:
            form[name] = (data, filename, part_type or "application/octet-stream")
        elif part_type is None or part_type.lower().startswith("text/"):
            charset = parse_header_value(part_type or "")[1].get("charset", "utf-8")
            form[name] = data.decode(charset)
        else:
            form[name] = data
    return form, size
