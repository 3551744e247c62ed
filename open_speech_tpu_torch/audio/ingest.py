"""Audio ingest: WAV input -> 16 kHz mono 16-bit WAV.

Counterpart of ``open_speech_tpu/audio/ingest.py`` for WAV input: the WAV is
decoded natively, resampled to 16 kHz with the polyphase resampler
(``ops/resample.py``) when its rate differs, and re-encoded as mono 16-bit.
Non-WAV bytes pass through unchanged, as the reference does when it cannot
convert (the ffmpeg path is a later slice of the port).
"""

from __future__ import annotations

import struct

import torch

from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.ops.resample import resample_array

TARGET_RATE = 16000


def convert_to_wav(
    data: bytes, content_type: str | None = None, device: torch.device | str | None = None
) -> bytes:
    """WAV input -> 16 kHz mono 16-bit WAV; other bytes pass through.

    Resampling runs on ``device``, ``settings.stt_device`` unless given.
    """
    if not codec.is_wav(data):
        return data
    try:
        audio, rate = codec.read_wav(data)
    except (ValueError, struct.error):
        return data  # malformed WAV: the same passthrough as the reference
    audio = resample_array(audio, rate, TARGET_RATE, device)
    return codec.write_wav(audio, TARGET_RATE)
