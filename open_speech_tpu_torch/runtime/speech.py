"""The body of ``POST /v1/audio/speech`` without HTTP.

``speech_response`` does what the JAX server's ``synthesize_speech`` route
does with a parsed JSON body (``open_speech_tpu/server/app.py``), in its
order and with its status codes and messages: the TTS switch (404), the
request's validation (422), input length and emptiness (400), features
the backend lacks (400), the response format (400), then SSML and the
pronunciation dictionary, then synthesis through the router (or, for a
request with ``voice_design`` or ``reference_audio``, the backend called
directly with the extended arguments its capabilities allow: the design,
the reference audio base64-decoded, or its raw bytes when it does not
decode, and the clone transcript), trim and normalise, and WAV/PCM
encoding (compressed formats through ffmpeg when it is installed). Every
rejection raises ``SpeechError`` with the status and message the JAX
server answers with, so the HTTP shell maps them one to one.

A streamed response is an iterator of encoded bytes that pulls synthesis
lazily: a consumer that stops early stops the synthesis before its next
sentence. Its first chunk is produced before ``speech_response`` returns,
so an error before the first byte is a real error response: 400 for a
``ValueError`` (text the vocab cannot express, an unsupported language),
500 otherwise. For WAV the first chunk is the header.

``effects`` (DSP, ``audio/effects.py``) run on the backend's device, as
the JAX server applies them: a whole body gets them under
``OS_EFFECTS_ENABLED`` (on by default); a streamed response always gets
them, and then synthesizes and post-processes the whole utterance first
(the effects are whole-signal DSP: a global level, a phase-vocoder pitch,
reverb tails) and sends the processed audio as one chunk. Left out, each a
later item of ``ROADMAP.md``: the TTS cache (off by default in the JAX
package) and history.

``timing``, a dict the caller passes, receives what the server's metrics
need: the native ``rate`` and the ``format``, and for a whole body
``first_chunk`` (``time.monotonic()`` at the first synthesized chunk, the
JAX server's time to first audio) and ``audio_seconds``.
"""

from __future__ import annotations

import base64
import time
from functools import lru_cache
from typing import Iterator

import numpy as np

from open_speech_tpu_torch.audio.effects import apply_chain
from open_speech_tpu_torch.audio.encode import CONTENT_TYPES, encode_audio, encode_audio_streaming
from open_speech_tpu_torch.audio.postprocessing import StreamingPostProcessor, process_tts_chunks
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.schemas import TTSSpeechRequest
from open_speech_tpu_torch.text.pronunciation import PronunciationDictionary, parse_ssml
from open_speech_tpu_torch.tts.backends.base import backend_sample_rate
from open_speech_tpu_torch.tts.router import TTSRouter

class SpeechError(Exception):
    """A rejected speech request: the HTTP status, message and error code
    of the JAX server's error envelope."""

    def __init__(self, status: int, message: str, code: str = "http_error") -> None:
        super().__init__(message)
        self.status = status
        self.message = message
        self.code = code


def get_content_type(fmt: str) -> str:
    return CONTENT_TYPES.get(fmt, "application/octet-stream")


@lru_cache(maxsize=4)
def _pronunciation_dict(path: str) -> PronunciationDictionary:
    return PronunciationDictionary(path)


def feature_error(router: TTSRouter, model_id: str, voice_design=None, reference_audio=None) -> str | None:
    """The JAX server's 400 message for a design or clone request that the
    model's backend cannot serve; None when it can."""
    backend = router.get_backend(model_id)
    name = getattr(backend, "name", model_id)
    caps = getattr(backend, "capabilities", {})
    if voice_design and not caps.get("voice_design", False):
        return f"voice_design is not supported by the {name} backend."
    if reference_audio is not None and not caps.get("voice_clone", False):
        return f"Voice cloning is not supported by the {name} backend."
    return None


def _extended_kwargs(backend, req: TTSSpeechRequest, text: str) -> dict:
    """The backend's arguments for a design or clone request, each gated
    by the backend's capabilities as the JAX route gates them."""
    caps = getattr(backend, "capabilities", {})
    kwargs: dict = dict(text=text, voice=req.voice, speed=req.speed, lang_code=req.language)
    if req.voice_design and (caps.get("voice_design") or caps.get("voice_clone")):
        kwargs["voice_design"] = req.voice_design
    if req.reference_audio and caps.get("voice_clone"):
        try:
            kwargs["reference_audio"] = base64.b64decode(req.reference_audio)
        except Exception:  # noqa: BLE001 — as the JAX route: not base64, so the raw bytes
            kwargs["reference_audio"] = req.reference_audio.encode()
    if req.clone_transcript and caps.get("voice_clone"):
        kwargs["clone_transcript"] = req.clone_transcript
    return kwargs


def speech_response(
    router: TTSRouter, body, *, stream: bool = False, timing: dict | None = None
) -> tuple[str, bytes] | tuple[str, Iterator[bytes]]:
    """(content type, audio bytes), or with ``stream`` (content type,
    iterator of encoded chunks)."""
    if not settings.tts_enabled:
        raise SpeechError(404, "TTS is disabled")
    if not isinstance(body, dict):
        raise SpeechError(422, "Body must be a JSON object", "validation_error")
    try:
        req = TTSSpeechRequest.from_body(body)
    except ValueError as e:
        raise SpeechError(422, str(e), "validation_error") from e
    if len(req.input) > settings.tts_max_input_length:
        raise SpeechError(400, f"Input too long. Max: {settings.tts_max_input_length} characters")
    if not req.input.strip():
        raise SpeechError(400, "Input text is empty")
    rejected = feature_error(router, req.model, req.voice_design, req.reference_audio)
    if rejected:
        raise SpeechError(400, rejected)
    if req.response_format not in CONTENT_TYPES:  # the formats the server answers in
        raise SpeechError(400, "Invalid response_format. Must be one of: " + ", ".join(sorted(CONTENT_TYPES)))
    content_type = get_content_type(req.response_format)

    text = req.input
    if req.input_type == "ssml":
        text = parse_ssml(text)
    text = _pronunciation_dict(settings.tts_pronunciation_dict or "").apply(text)
    backend = router.get_backend(req.model)
    rate = backend_sample_rate(backend, req.model)
    timing = {} if timing is None else timing
    timing.update(rate=rate, format=req.response_format)

    def synthesize() -> Iterator[np.ndarray]:
        if req.voice_design or req.reference_audio:
            return backend.synthesize(**_extended_kwargs(backend, req, text))
        return router.synthesize(text=text, model=req.model, voice=req.voice, speed=req.speed,
                                 lang_code=req.language)

    def effects(samples: np.ndarray) -> np.ndarray:
        return apply_chain(samples, rate, req.effects, device=getattr(backend, "device", None))

    if stream:
        return content_type, _stream(synthesize, rate, req.response_format,
                                     effects if req.effects else None)

    def timed() -> Iterator[np.ndarray]:
        for chunk in synthesize():
            timing.setdefault("first_chunk", time.monotonic())
            yield chunk

    try:
        chunks = list(process_tts_chunks(timed(), trim=settings.tts_trim_silence,
                                         normalize=settings.tts_normalize_output))
        samples = np.concatenate(chunks).astype(np.float32, copy=False) if chunks else np.zeros(0, np.float32)
        if settings.os_effects_enabled and req.effects:
            samples = effects(samples)
        timing["audio_seconds"] = len(samples) / rate
        return content_type, encode_audio(samples, rate, req.response_format)
    except Exception as e:  # noqa: BLE001 — every synthesis failure is a 500, as in the JAX server
        raise SpeechError(500, str(e)) from e


def _stream(synthesize, rate: int, fmt: str, effects=None) -> Iterator[bytes]:
    """Produce the first encoded chunk now; the rest as the consumer pulls.
    With ``effects``, the whole post-processed utterance goes through them
    and out as one chunk."""
    pp = StreamingPostProcessor(trim=settings.tts_trim_silence, normalize=settings.tts_normalize_output)

    def processed() -> Iterator[np.ndarray]:
        if effects is not None:
            parts = [p for chunk in synthesize() for p in pp.feed(chunk)] + list(pp.finish())
            if parts:
                yield effects(np.concatenate([np.asarray(p, np.float32) for p in parts]))
            return
        for chunk in synthesize():
            yield from pp.feed(chunk)
        yield from pp.finish()

    encoded = encode_audio_streaming(processed(), rate, fmt)
    try:
        first = next(encoded)
    except StopIteration:
        return (chunk for chunk in ())  # a generator: the caller may close it
    except Exception as e:  # noqa: BLE001 — nothing sent yet: a real error response
        raise SpeechError(400 if isinstance(e, ValueError) else 500, f"TTS failed: {e}") from e
    return _rest(first, encoded)


def _rest(first: bytes, encoded: Iterator[bytes]) -> Iterator[bytes]:
    try:
        yield first
        yield from encoded
    except Exception as e:  # noqa: BLE001 — bytes are out: the shell aborts the transfer
        raise SpeechError(500, f"TTS failed mid-stream: {e}") from e
    finally:
        encoded.close()  # a consumer that left stops the synthesis here
