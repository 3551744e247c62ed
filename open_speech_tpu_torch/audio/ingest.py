"""Audio ingest: WAV input -> 16 kHz mono 16-bit WAV.

Counterpart of ``open_speech_tpu/audio/ingest.py`` for WAV input. WAV at
16 kHz is re-encoded as mono 16-bit; other rates need the polyphase
resampler (``ops/resample.py``), which a later slice of the port brings,
and raise here. Non-WAV bytes pass through unchanged, as the reference
does when it cannot convert.
"""

from __future__ import annotations

import struct

from open_speech_tpu_torch.ops import audio as codec

TARGET_RATE = 16000


def resample_unported(rate: int) -> NotImplementedError:
    return NotImplementedError(
        f"audio at {rate} Hz needs resampling to {TARGET_RATE} Hz "
        "(ops/resample.py), which the PyTorch port has not brought yet; "
        f"send {TARGET_RATE} Hz audio"
    )


def convert_to_wav(data: bytes, content_type: str | None = None) -> bytes:
    """WAV input -> 16 kHz mono 16-bit WAV; other bytes pass through."""
    if not codec.is_wav(data):
        return data
    try:
        audio, rate = codec.read_wav(data)
    except (ValueError, struct.error):
        return data  # malformed WAV: the same passthrough as the reference
    if rate != TARGET_RATE:
        raise resample_unported(rate)
    return codec.write_wav(audio, TARGET_RATE)
