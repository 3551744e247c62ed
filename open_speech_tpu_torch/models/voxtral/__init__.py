"""Voxtral: Whisper's encoder feeding a grouped-query language model."""

from open_speech_tpu_torch.models.voxtral.model import (  # noqa: F401
    Voxtral,
    VoxtralConfig,
    decode_step,
    encode_audio,
    prefill,
)
