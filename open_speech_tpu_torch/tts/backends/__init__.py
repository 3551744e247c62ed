"""TTS engines of the PyTorch/CUDA port: Kokoro, Piper and Pocket. Each module exposes
one backend class that the router's duck-typing scan discovers.
"""

from open_speech_tpu_torch.tts.backends.base import (
    TTSBackend,
    TTSLoadedModelInfo,
    VoiceInfo,
)

__all__ = ["TTSBackend", "TTSLoadedModelInfo", "VoiceInfo"]
