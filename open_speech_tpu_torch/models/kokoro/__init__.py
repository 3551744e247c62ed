"""Kokoro-82M TTS in PyTorch: the model and its weight conversion.
Counterpart of ``open_speech_tpu/models/kokoro``."""

from open_speech_tpu_torch.models.kokoro.model import (
    KModel,
    KokoroConfig,
    encode_utterance,
    init_kokoro_params,
    synthesize_frames,
    vocode,
    vocode_blocks,
    vocode_streaming,
    voice_vector,
)

__all__ = [
    "KModel",
    "KokoroConfig",
    "encode_utterance",
    "init_kokoro_params",
    "synthesize_frames",
    "vocode",
    "vocode_blocks",
    "vocode_streaming",
    "voice_vector",
]
