"""OpenAI Realtime API over the port's WebSocket shell.

Counterpart of ``open_speech_tpu/server/realtime/server.py``: audio only
(STT in, TTS out, no LLM), with the same events in the same order.
Protocol flow:

    session.update            -> rebuild VAD/input buffer, session.updated
    input_audio_buffer.append -> base64 decode -> format decode -> VAD events
                                 (auto-commit when server VAD sees turn end)
    input_audio_buffer.commit -> WAV wrap -> STT (greedy latency path)
    response.create           -> TTS -> base64 audio deltas (~3 KB each)
    response.cancel           -> drop the in-flight response's deltas

The STT router is the caller's (``realtime_endpoint(ws, stt_router,
tts_router)``), as the streaming session's is; the JAX module reads its
module router. The VAD runs on ``get_vad_model``'s device (``OS_VAD_DEVICE``,
else the STT device). A cancelled response also stops its synthesis before
the next chunk; the JAX producer synthesizes to the end in the background.
Inference runs on a small thread pool; the event loop only shuffles JSON.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import json
import logging
import threading
import time
from typing import Any

import numpy as np

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.vad.silero import SileroVAD, get_vad_model
from open_speech_tpu_torch.ops.audio import float_to_pcm16, pcm16_to_float, pcm16_to_wav
from open_speech_tpu_torch.runtime.batcher_pool import transcribe_pcm_batched
from open_speech_tpu_torch.server.realtime import events
from open_speech_tpu_torch.server.realtime.audio_buffer import (
    InputAudioBuffer,
    decode_audio_to_pcm16,
    encode_pcm16_to_format,
)
from open_speech_tpu_torch.server.realtime.session import SessionConfig
from open_speech_tpu_torch.server.websocket import MsgType
from open_speech_tpu_torch.tts.backends.base import backend_sample_rate

logger = logging.getLogger(__name__)

_executor = concurrent.futures.ThreadPoolExecutor(
    max_workers=4, thread_name_prefix="realtime"
)

_MIN_COMMIT_BYTES = 1600  # 50 ms @ 16 kHz pcm16 — shorter commits are noise
_DELTA_BYTES = 3000  # ~4 KB of base64 per response.audio.delta


# ── blocking inference (thread pool) ────────────────────────────────────


def _run_stt(stt_router, audio_pcm16: bytes, model: str) -> dict[str, Any]:
    """Transcribe one committed turn. Greedy, no fallback sweep — this is
    the latency path."""
    return stt_router.transcribe(
        audio=pcm16_to_wav(audio_pcm16, 16000),
        model=model,
        language=None,
        response_format="json",
        temperature=0.0,
        beam_size=1,
        fallback=False,
    )


def _tts_chunk_producer(tts_router, text, model, voice, loop, queue, stop) -> None:
    """Run the TTS generator on the pool, handing chunks to the event loop
    as they are produced; ``stop`` (a ``threading.Event``) ends the
    synthesis before its next chunk."""
    chunks = tts_router.synthesize(text=text, model=model, voice=voice, speed=1.0)
    try:
        for c in chunks:
            loop.call_soon_threadsafe(queue.put_nowait, np.asarray(c, np.float32))
            if stop.is_set():
                break
        loop.call_soon_threadsafe(queue.put_nowait, None)
    except Exception as e:  # noqa: BLE001 — handed to the response task
        loop.call_soon_threadsafe(queue.put_nowait, e)
    finally:
        close = getattr(chunks, "close", None)
        if close is not None:
            close()


def _pick_response_text(response_data: dict[str, Any]) -> str:
    """instructions wins; otherwise the first input_text content item."""
    text = response_data.get("instructions", "")
    if text:
        return text
    for item in response_data.get("input", []):
        for c in item.get("content", []):
            if c.get("type") == "input_text" and c.get("text"):
                return c["text"]
    return ""


# ── session ─────────────────────────────────────────────────────────────


class RealtimeSession:
    def __init__(self, websocket, stt_router, tts_router, model: str = ""):
        self.ws = websocket
        self.stt_router = stt_router
        self.tts_router = tts_router
        self.config = SessionConfig(model=model or settings.stt_model)
        self.audio_buffer: InputAudioBuffer | None = None
        self._last_item_id: str | None = None
        self._pending_item_id: str | None = None
        self._cancelled_responses: set[str] = set()
        self._current_response_id: str | None = None
        self._current_stop: threading.Event | None = None
        self._last_commit_at = time.monotonic()
        # auto-detect pinning (mirrors streaming._maybe_pin_language)
        self._detected_language: str | None = None
        self._lang_probe_failed = False

    async def initialize(self) -> None:
        await self._make_input_buffer()
        await self._send(events.session_created(self.config.to_dict()))

    async def _send(self, event: dict[str, Any]) -> None:
        try:
            await self.ws.send_str(json.dumps(event))
        except Exception:  # noqa: BLE001
            pass  # connection may be closed

    def _stt_device(self):
        """The device the session's STT model runs on: the VAD's default."""
        backend = self.stt_router.get_backend(self.config.model or settings.stt_model)
        return getattr(backend, "device", None) or settings.stt_device

    async def _make_input_buffer(self) -> None:
        vad = None
        if self.config.vad_enabled:
            try:
                vad_model = await asyncio.get_running_loop().run_in_executor(
                    None, get_vad_model, self._stt_device()
                )
                vad = SileroVAD(
                    vad_model.session,
                    threshold=self.config.turn_detection.threshold,
                )
            except Exception:  # noqa: BLE001
                logger.warning("Failed to load VAD model, disabling server VAD")
        td = self.config.turn_detection
        self.audio_buffer = InputAudioBuffer(
            vad=vad,
            threshold=td.threshold if td else 0.5,
            silence_duration_ms=td.silence_duration_ms if td else 500,
            max_buffer_bytes=settings.os_realtime_max_buffer_mb * 1024 * 1024,
        )

    # dispatch

    async def handle_event(self, data: dict[str, Any]) -> None:
        event_type = data.get("type", "")
        handler = _CLIENT_HANDLERS.get(event_type)
        if handler is None:
            await self._send(
                events.error(
                    f"Unknown event type: {event_type}",
                    code="unknown_event",
                    event_id=data.get("event_id"),
                )
            )
            return
        try:
            await handler(self, data)
        except Exception as e:  # noqa: BLE001
            logger.exception("Error handling event %s", event_type)
            await self._send(
                events.error(
                    str(e), code="internal_error", event_id=data.get("event_id")
                )
            )

    # session.update

    async def _on_session_update(self, data: dict[str, Any]) -> None:
        self.config.update_from(data)
        await self._make_input_buffer()
        await self._send(events.session_updated(self.config.to_dict()))

    # input_audio_buffer.*

    async def _on_append(self, data: dict[str, Any]) -> None:
        idle = time.monotonic() - self._last_commit_at
        if idle > settings.os_realtime_idle_timeout_s:
            await self._send(
                events.error(
                    "Session idle timeout waiting for commit", code="idle_timeout"
                )
            )
            await self.ws.close(code=4008, message=b"Session idle timeout")
            return

        audio_b64 = data.get("audio", "")
        if not audio_b64:
            return
        try:
            raw = base64.b64decode(audio_b64)
        except Exception:  # noqa: BLE001
            await self._send(
                events.error("Invalid base64 audio data", code="invalid_audio")
            )
            return
        try:
            pcm16 = decode_audio_to_pcm16(
                raw, self.config.input_audio_format, target_rate=16000
            )
        except Exception as e:  # noqa: BLE001
            await self._send(events.error(str(e), code="invalid_audio"))
            return
        try:
            vad_events = self.audio_buffer.append(pcm16)
        except BufferError as e:
            if self.audio_buffer:
                self.audio_buffer.clear()
            await self._send(events.error(str(e), code="buffer_overflow"))
            return

        for evt in vad_events:
            if evt["type"] == "speech_started":
                # one item id spans the whole turn: speech_started,
                # speech_stopped, and the committed conversation item all
                # carry it (OpenAI Realtime semantics)
                self._pending_item_id = events._item_id()
                await self._send(
                    events.input_audio_buffer_speech_started(
                        evt["audio_start_ms"], self._pending_item_id
                    )
                )
            elif evt["type"] == "speech_stopped":
                await self._send(
                    events.input_audio_buffer_speech_stopped(
                        evt["audio_end_ms"],
                        self._pending_item_id or events._item_id(),
                    )
                )
                await self._finalize_turn()

    async def _on_commit(self, data: dict[str, Any]) -> None:
        await self._finalize_turn()

    async def _on_clear(self, data: dict[str, Any]) -> None:
        if self.audio_buffer:
            self.audio_buffer.clear()
        await self._send(events.input_audio_buffer_cleared())

    async def _finalize_turn(self) -> None:
        """Commit the buffer and run STT; emit item + transcription events."""
        if self.audio_buffer is None:
            return
        audio_data = self.audio_buffer.commit()
        self._last_commit_at = time.monotonic()
        if not audio_data or len(audio_data) < _MIN_COMMIT_BYTES:
            return

        # reuse the turn's pending id (minted at speech_started) so the
        # committed item correlates with the VAD events that announced it
        item_id = self._pending_item_id or events._item_id()
        self._pending_item_id = None
        self._last_item_id = item_id
        await self._send(events.input_audio_buffer_committed(item_id, None))
        await self._send(
            events.conversation_item_created(
                {
                    "id": item_id,
                    "object": "realtime.item",
                    "type": "message",
                    "role": "user",
                    "content": [{"type": "input_audio", "transcript": None}],
                }
            )
        )

        loop = asyncio.get_running_loop()
        model = self.config.model or settings.stt_model
        # input_audio_transcription.language pins the language. The
        # batcher's slot pool shares one prompt per (model, language), so
        # only language-pinned sessions ride it; unpinned commits keep the
        # executor path's per-commit auto-detect.
        lang = (
            (self.config.input_audio_transcription or {}).get("language")
            or self._detected_language
        )
        if (
            settings.os_batcher_enabled
            and not lang
            and not self._lang_probe_failed
            and len(audio_data) >= 2 * 16000  # >=1 s: stable detection
        ):
            # detect once, then pin: later commits of this session ride
            # the shared batcher like explicitly-pinned ones (backends
            # without detect support fail the probe once and stay on the
            # executor path)
            def _probe() -> str:
                backend = self.stt_router.get_backend(model)
                code = backend.detect_language_pcm(
                    model, pcm16_to_float(audio_data)
                )
                if not isinstance(code, str) or not code:
                    raise TypeError("backend returned no language code")
                return code

            try:
                lang = await loop.run_in_executor(_executor, _probe)
                self._detected_language = lang
                logger.info("Pinned detected language %r for session", lang)
            except Exception:  # noqa: BLE001 — per-commit auto-detect
                self._lang_probe_failed = True
        try:
            if settings.os_batcher_enabled and lang:
                # realtime commits share the continuous batcher's slot pool
                # with streaming sessions
                result = await self._transcribe_batched(audio_data, model, lang)
            else:
                result = await loop.run_in_executor(
                    _executor, _run_stt, self.stt_router, audio_data, model
                )
        except Exception as e:  # noqa: BLE001
            logger.exception("Transcription failed in realtime session")
            await self._send(events.error(str(e), code="transcription_error"))
            return

        transcript = (
            result.get("text", "") if isinstance(result, dict) else str(result)
        )
        await self._send(
            events.conversation_item_input_audio_transcription_completed(
                item_id, 0, transcript
            )
        )

    async def _transcribe_batched(
        self, audio_pcm16: bytes, model: str, language: str
    ) -> dict:
        """One committed turn through the shared slot-pool batcher."""
        return await transcribe_pcm_batched(
            self.stt_router.get_backend(model), model, language,
            pcm16_to_float(audio_pcm16),
        )

    # response.*

    async def _on_response_create(self, data: dict[str, Any]) -> None:
        response_data = data.get("response", {})
        modalities = response_data.get("modalities", ["audio", "text"])
        if modalities == ["text"]:
            await self._send(
                events.error(
                    "Open Speech does not support text-only responses. "
                    "We handle audio I/O only.",
                    code="unsupported_modality",
                )
            )
            return

        text_to_speak = _pick_response_text(response_data)
        if not text_to_speak:
            await self._send(
                events.error(
                    "No text provided for TTS. Include 'instructions' or "
                    "input text content.",
                    code="missing_input",
                )
            )
            return

        resp_id = events._response_id()
        self._current_response_id = resp_id
        stop = self._current_stop = threading.Event()
        item_id = events._item_id()
        response_obj = {
            "id": resp_id,
            "object": "realtime.response",
            "status": "in_progress",
            "output": [],
        }
        await self._send(events.response_created(response_obj))

        loop = asyncio.get_running_loop()
        # config.model is the *STT* model; TTS falls back to the
        # configured TTS default
        tts_model = response_data.get("model") or settings.tts_model
        backend = self.tts_router.get_backend(tts_model)
        native_rate = backend_sample_rate(backend, tts_model)
        out_format = self.config.output_audio_format
        # stream deltas as vocoder blocks complete: first audio leaves in
        # ~one block rather than after the full utterance
        queue: asyncio.Queue = asyncio.Queue()
        producer = loop.run_in_executor(
            _executor, _tts_chunk_producer,
            self.tts_router, text_to_speak, tts_model, self.config.voice,
            loop, queue, stop,
        )
        cancelled_early = False
        try:
            while True:
                item = await queue.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                if resp_id in self._cancelled_responses:
                    # stop consuming NOW: response.done(cancelled) must
                    # not wait for the producer
                    cancelled_early = True
                    break
                audio_data = encode_pcm16_to_format(
                    float_to_pcm16(item), native_rate, out_format
                )
                await self._stream_audio_deltas(resp_id, item_id, audio_data)
        except Exception as e:  # noqa: BLE001
            logger.exception("TTS synthesis failed in realtime session")
            await self._send(events.error(str(e), code="tts_error"))
            response_obj["status"] = "failed"
            await self._send(events.response_done(response_obj))
            self._current_response_id = None
            return
        finally:
            stop.set()  # a cancel or a failure ends the synthesis at its next chunk
            if cancelled_early:
                # detach: swallow any late producer error instead of
                # blocking the cancel acknowledgement on the chunk in flight
                producer.add_done_callback(
                    lambda f: f.cancelled() or f.exception()
                )
            else:
                await asyncio.wait([producer])

        if resp_id in self._cancelled_responses:
            self._cancelled_responses.discard(resp_id)
            # the response lifecycle must still terminate: clients block
            # on response.done regardless of how the response ended
            response_obj["status"] = "cancelled"
            await self._send(events.response_done(response_obj))
            self._current_response_id = None
            return

        self._cancelled_responses.discard(resp_id)
        await self._send(events.response_audio_done(resp_id, item_id, 0, 0))
        response_obj["status"] = "completed"
        response_obj["output"] = [
            {
                "id": item_id,
                "object": "realtime.item",
                "type": "message",
                "role": "assistant",
                "content": [{"type": "audio", "transcript": text_to_speak}],
            }
        ]
        await self._send(events.response_done(response_obj))
        self._current_response_id = None

    async def _stream_audio_deltas(
        self, resp_id: str, item_id: str, audio_data: bytes
    ) -> None:
        for i in range(0, len(audio_data), _DELTA_BYTES):
            if resp_id in self._cancelled_responses:
                break
            delta = base64.b64encode(audio_data[i : i + _DELTA_BYTES]).decode("ascii")
            await self._send(
                events.response_audio_delta(resp_id, item_id, 0, 0, delta)
            )

    async def _on_response_cancel(self, data: dict[str, Any]) -> None:
        if self._current_response_id:
            self._cancelled_responses.add(self._current_response_id)
            self._current_stop.set()


_CLIENT_HANDLERS: dict[str, Any] = {
    "session.update": RealtimeSession._on_session_update,
    "input_audio_buffer.append": RealtimeSession._on_append,
    "input_audio_buffer.commit": RealtimeSession._on_commit,
    "input_audio_buffer.clear": RealtimeSession._on_clear,
    "response.create": RealtimeSession._on_response_create,
    "response.cancel": RealtimeSession._on_response_cancel,
}


def _parse_client_event(raw: str) -> dict[str, Any] | str:
    """Returns the event dict, or an error message string."""
    try:
        data = json.loads(raw)
    except json.JSONDecodeError:
        return "Invalid JSON"
    if not isinstance(data, dict) or "type" not in data:
        return "Event must be a JSON object with a 'type' field"
    return data


async def realtime_endpoint(ws, stt_router, tts_router, model: str = "") -> None:
    """Run a realtime session over an accepted ``WebSocketResponse``."""
    session = RealtimeSession(ws, stt_router, tts_router, model=model)
    await session.initialize()
    response_task: asyncio.Task | None = None
    try:
        while True:
            try:
                msg = await ws.receive(timeout=settings.os_realtime_idle_timeout_s)
            except asyncio.TimeoutError:
                await session._send(
                    events.error("Session idle timeout", code="idle_timeout")
                )
                await ws.close(code=4008, message=b"Session idle timeout")
                break
            if msg.type == MsgType.CLOSE:  # e.g. idle-timeout close inside a handler
                break
            if msg.type != MsgType.TEXT:
                continue
            parsed = _parse_client_event(msg.data)
            if isinstance(parsed, str):
                await session._send(events.error(parsed, code="invalid_event"))
                continue
            if parsed.get("type") == "response.create":
                # run the response concurrently so the receive loop keeps
                # draining frames — otherwise response.cancel can never
                # arrive while deltas stream and barge-in is impossible
                if response_task is not None and not response_task.done():
                    await session._send(
                        events.error(
                            "Conversation already has an active response",
                            code="conversation_already_has_active_response",
                        )
                    )
                    continue
                response_task = asyncio.get_running_loop().create_task(
                    session.handle_event(parsed)
                )
                continue
            await session.handle_event(parsed)
    except Exception:  # noqa: BLE001
        logger.exception("Realtime session crashed")
    finally:
        if response_task is not None and not response_task.done():
            response_task.cancel()
            try:
                await response_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
