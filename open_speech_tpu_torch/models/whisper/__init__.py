"""Whisper in PyTorch: encoder/decoder modules, KV-cached decoding, the
seek loop. Counterpart of ``open_speech_tpu/models/whisper``."""

from open_speech_tpu_torch.models.whisper.model import (
    PRESETS,
    Whisper,
    WhisperConfig,
    decode_step,
    decoder_forward,
    encode,
    init_params,
    init_self_kv,
    precompute_cross_kv,
)
from open_speech_tpu_torch.models.whisper.tokenizer import (
    FallbackTokenizer,
    SpecialTokens,
    WhisperTokenizer,
    get_tokenizer,
)

__all__ = [
    "WhisperConfig",
    "Whisper",
    "PRESETS",
    "init_params",
    "encode",
    "decode_step",
    "decoder_forward",
    "precompute_cross_kv",
    "init_self_kv",
    "SpecialTokens",
    "WhisperTokenizer",
    "FallbackTokenizer",
    "get_tokenizer",
]
