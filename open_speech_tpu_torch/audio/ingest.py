"""Audio ingest: anything -> 16 kHz mono 16-bit WAV.

Counterpart of ``open_speech_tpu/audio/ingest.py``: WAV input (PCM, float
and G.711 payloads) is decoded natively; other formats are decoded by
ffmpeg when the binary is installed. The audio is resampled to 16 kHz with
the polyphase resampler (``ops/resample.py``) when its rate differs and
re-encoded as mono 16-bit. Bytes that cannot be decoded pass through
unchanged, as the reference does when it cannot convert.
"""

from __future__ import annotations

import logging
import struct
import subprocess

import numpy as np
import torch

from open_speech_tpu_torch.audio.encode import ffmpeg_available
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.ops.resample import resample_array

logger = logging.getLogger(__name__)

TARGET_RATE = 16000


def decode_to_float32(data: bytes) -> tuple[np.ndarray, int] | None:
    """Decode to (float32 mono, rate) natively if WAV, via ffmpeg otherwise."""
    if codec.is_wav(data):
        try:
            return codec.read_wav(data)
        except (ValueError, struct.error):
            # struct.error: header claims more bytes than the body carries
            # (truncated upload) — same passthrough as any other bad WAV
            return None
    if ffmpeg_available():
        try:
            proc = subprocess.run(
                [
                    "ffmpeg", "-i", "pipe:0", "-f", "f32le", "-ac", "1",
                    "-ar", str(TARGET_RATE), "pipe:1",
                ],
                input=data,
                capture_output=True,
                timeout=60,
                check=True,
            )
            audio = np.frombuffer(proc.stdout, dtype="<f4")
            return np.ascontiguousarray(audio), TARGET_RATE
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("ffmpeg decode failed: %s", e)
    return None


def convert_to_wav(
    data: bytes, content_type: str | None = None, device: torch.device | str | None = None
) -> bytes:
    """Any supported input -> 16 kHz mono 16-bit WAV; passthrough on failure.

    Resampling runs on ``device``, ``settings.stt_device`` unless given.
    """
    decoded = decode_to_float32(data)
    if decoded is None:
        return data
    audio, rate = decoded
    audio = resample_array(audio, rate, TARGET_RATE, device)
    return codec.write_wav(audio, TARGET_RATE)
