"""Realtime input buffer + audio format codecs.

Reference behavior (src/realtime/audio_buffer.py): a bounded byte buffer of
PCM16 @ 16 kHz with VAD speech_started/speech_stopped hysteresis; format
codecs for the OpenAI Realtime wire formats (pcm16 @ 24 kHz, G.711 u/a-law
@ 8 kHz). Companding uses the framework's LUTs — no audioop (removed in
Python 3.13).
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

from open_speech_tpu_torch.models.vad.silero import VAD_SAMPLE_RATE, SileroVAD
from open_speech_tpu_torch.ops import audio as codec

logger = logging.getLogger(__name__)

# wire format -> (decoder to pcm16 ints, native rate)
_DECODERS = {
    "pcm16": (lambda data: np.frombuffer(data, dtype="<i2"), 24000),
    "g711_ulaw": (codec.ulaw_decode, 8000),
    "g711_alaw": (codec.alaw_decode, 8000),
}

_ENCODERS = {
    "pcm16": (lambda ints: ints.tobytes(), 24000),
    "g711_ulaw": (lambda ints: codec.ulaw_encode(ints).tobytes(), 8000),
    "g711_alaw": (lambda ints: codec.alaw_encode(ints).tobytes(), 8000),
}


def decode_audio_to_pcm16(data: bytes, fmt: str, target_rate: int = 16000) -> bytes:
    """Wire-format bytes -> PCM16 mono at ``target_rate``."""
    try:
        decoder, native_rate = _DECODERS[fmt]
    except KeyError:
        raise ValueError(f"Unsupported audio format: {fmt}") from None
    pcm = decoder(data)
    if isinstance(pcm, np.ndarray):
        pcm = pcm.tobytes()
    return codec.linear_resample_pcm16(pcm, native_rate, target_rate)


def encode_pcm16_to_format(pcm16_data: bytes, from_rate: int, fmt: str) -> bytes:
    """PCM16 mono at ``from_rate`` -> wire-format bytes."""
    try:
        encoder, native_rate = _ENCODERS[fmt]
    except KeyError:
        raise ValueError(f"Unsupported audio format: {fmt}") from None
    resampled = codec.linear_resample_pcm16(pcm16_data, from_rate, native_rate)
    return encoder(np.frombuffer(resampled, dtype="<i2"))


class InputAudioBuffer:
    """Bounded input buffer with VAD hysteresis (internal PCM16 @ 16 kHz)."""

    def __init__(
        self,
        vad: SileroVAD | None = None,
        threshold: float = 0.5,
        silence_duration_ms: int = 500,
        max_buffer_bytes: int = 50 * 1024 * 1024,
    ):
        self._vad = vad
        self._threshold = threshold
        self._silence_limit_ms = silence_duration_ms
        self._limit = max_buffer_bytes
        self._data = bytearray()
        self._in_speech = False
        self._silence_samples = 0
        self._speech_start_ms = 0
        self._total_samples = 0

    @property
    def in_speech(self) -> bool:
        return self._in_speech

    def clear(self) -> None:
        self._data.clear()
        self._silence_samples = 0

    def get_audio(self) -> bytes:
        return bytes(self._data)

    def commit(self) -> bytes:
        audio = bytes(self._data)
        self.clear()
        return audio

    def append(self, pcm16_16khz: bytes) -> list[dict[str, Any]]:
        """Buffer a chunk; returns speech_started/speech_stopped events."""
        size = len(pcm16_16khz)
        if size > self._limit:
            self.clear()
            raise BufferError(
                f"Audio frame exceeds max buffer size ({self._limit} bytes)"
            )
        if len(self._data) + size > self._limit:
            raise BufferError(
                f"Input audio buffer exceeded max size ({self._limit} bytes)"
            )
        self._data.extend(pcm16_16khz)

        samples = size // 2
        at_ms = (self._total_samples * 1000) // VAD_SAMPLE_RATE
        self._total_samples += samples
        if self._vad is None or samples == 0:
            return []
        return self._run_vad(pcm16_16khz, samples, at_ms)

    def _run_vad(self, chunk: bytes, samples: int, at_ms: int) -> list[dict]:
        probability = self._vad(codec.pcm16_to_float(chunk))
        if probability >= self._threshold:
            self._silence_samples = 0
            if self._in_speech:
                return []
            self._in_speech = True
            self._speech_start_ms = at_ms
            return [{"type": "speech_started", "audio_start_ms": at_ms}]
        if not self._in_speech:
            return []
        self._silence_samples += samples
        silence_ms = (self._silence_samples * 1000) // VAD_SAMPLE_RATE
        if silence_ms < self._silence_limit_ms:
            return []
        self._in_speech = False
        self._silence_samples = 0
        return [{"type": "speech_stopped", "audio_end_ms": at_ms}]
