"""OpenAI Realtime API server-event constructors.

Event shapes follow https://platform.openai.com/docs/api-reference/realtime
(same wire format the reference emits, src/realtime/events.py). All events
share the ``event_id`` + ``type`` envelope; ids use the evt_/item_/resp_
prefixes.
"""

from __future__ import annotations

import uuid
from typing import Any


def _ident(prefix: str, n: int) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:n]}"


def _event_id() -> str:
    return _ident("evt", 24)


def _item_id() -> str:
    return _ident("item", 20)


def _response_id() -> str:
    return _ident("resp", 20)


def _evt(event_type: str, **fields: Any) -> dict[str, Any]:
    return {"event_id": _event_id(), "type": event_type, **fields}


def session_created(session: dict[str, Any]) -> dict[str, Any]:
    return _evt("session.created", session=session)


def session_updated(session: dict[str, Any]) -> dict[str, Any]:
    return _evt("session.updated", session=session)


def error(
    message: str,
    error_type: str = "invalid_request_error",
    code: str | None = None,
    event_id: str | None = None,
) -> dict[str, Any]:
    body: dict[str, Any] = {"type": error_type, "message": message}
    if code:
        body["code"] = code
    if event_id:
        body["event_id"] = event_id
    return _evt("error", error=body)


def input_audio_buffer_speech_started(audio_start_ms: int, item_id: str) -> dict:
    return _evt(
        "input_audio_buffer.speech_started",
        audio_start_ms=audio_start_ms,
        item_id=item_id,
    )


def input_audio_buffer_speech_stopped(audio_end_ms: int, item_id: str) -> dict:
    return _evt(
        "input_audio_buffer.speech_stopped",
        audio_end_ms=audio_end_ms,
        item_id=item_id,
    )


def input_audio_buffer_committed(
    item_id: str, previous_item_id: str | None = None
) -> dict:
    return _evt(
        "input_audio_buffer.committed",
        previous_item_id=previous_item_id,
        item_id=item_id,
    )


def input_audio_buffer_cleared() -> dict:
    return _evt("input_audio_buffer.cleared")


def conversation_item_created(item: dict[str, Any]) -> dict:
    return _evt("conversation.item.created", previous_item_id=None, item=item)


def conversation_item_input_audio_transcription_completed(
    item_id: str, content_index: int, transcript: str
) -> dict:
    return _evt(
        "conversation.item.input_audio_transcription.completed",
        item_id=item_id,
        content_index=content_index,
        transcript=transcript,
    )


def response_created(response: dict[str, Any]) -> dict:
    return _evt("response.created", response=response)


def response_audio_delta(
    response_id: str, item_id: str, output_index: int, content_index: int, delta: str
) -> dict:
    return _evt(
        "response.audio.delta",
        response_id=response_id,
        item_id=item_id,
        output_index=output_index,
        content_index=content_index,
        delta=delta,
    )


def response_audio_done(
    response_id: str, item_id: str, output_index: int, content_index: int
) -> dict:
    return _evt(
        "response.audio.done",
        response_id=response_id,
        item_id=item_id,
        output_index=output_index,
        content_index=content_index,
    )


def response_done(response: dict[str, Any]) -> dict:
    return _evt("response.done", response=response)
