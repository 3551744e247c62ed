"""Minimal Wyoming wire protocol (https://github.com/rhasspy/wyoming).

The reference imports the ``wyoming`` package; it isn't installed here, so
the wire format is implemented directly: each event is one JSON line
``{"type": ..., "data": {...}, "payload_length": N|null}`` followed by an
optional data-json line and N payload bytes.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field


@dataclass
class Event:
    type: str
    data: dict = field(default_factory=dict)
    payload: bytes = b""


async def read_event(reader: asyncio.StreamReader) -> Event | None:
    try:
        line = await reader.readline()
    except (ConnectionResetError, asyncio.IncompleteReadError):
        return None
    if not line:
        return None
    try:
        header = json.loads(line)
    except json.JSONDecodeError:
        return None
    event_type = header.get("type", "")
    data = header.get("data") or {}
    data_length = header.get("data_length")
    payload_length = header.get("payload_length")
    if data_length:
        data_bytes = await reader.readexactly(data_length)
        try:
            data = {**data, **json.loads(data_bytes)}
        except json.JSONDecodeError:
            pass
    payload = b""
    if payload_length:
        payload = await reader.readexactly(payload_length)
    return Event(type=event_type, data=data, payload=payload)


async def write_event(writer: asyncio.StreamWriter, event: Event) -> None:
    header = {
        "type": event.type,
        "data": event.data,
        "payload_length": len(event.payload) if event.payload else None,
    }
    writer.write(json.dumps(header).encode("utf-8") + b"\n")
    if event.payload:
        writer.write(event.payload)
    await writer.drain()
