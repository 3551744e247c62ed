"""TTS backend contract (counterpart of ``open_speech_tpu/tts/backends/base.py``).

- ``synthesize`` is a *generator* of float32 chunks at the backend's native
  sample rate: the streaming unit the encode pipeline consumes.
- ``capabilities`` gates per-backend API features (blend/design/clone/...)
  so the request handler can reject unsupported request fields with a 400.
- ``is_available`` lets the router's discovery scan skip backends whose
  optional dependencies are absent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, Protocol, runtime_checkable

import numpy as np

# every capability key the API layer may consult, with its conservative
# default; backends override the ones they actually support
_CAPABILITY_DEFAULTS: tuple[tuple[str, Any], ...] = (
    ("voice_blend", False),
    ("voice_design", False),
    ("voice_clone", False),
    ("streaming", False),
    ("instructions", False),
    ("speakers", []),
    ("languages", ["en"]),
    ("speed_control", True),
    ("ssml", False),
    ("batch", False),
)

DEFAULT_TTS_CAPABILITIES: dict[str, Any] = dict(_CAPABILITY_DEFAULTS)


@dataclass
class VoiceInfo:
    """One selectable voice as surfaced by /v1/audio/voices."""

    id: str
    name: str
    language: str = "en-us"
    gender: str = "unknown"


@dataclass
class TTSLoadedModelInfo:
    """Row in the loaded-TTS-models listing (mirrors the STT shape)."""

    model: str
    backend: str
    device: str
    loaded_at: float
    last_used_at: float | None = None


@runtime_checkable
class TTSBackend(Protocol):
    """Duck type for text-to-speech engines."""

    name: str
    sample_rate: int
    capabilities: dict[str, Any]

    @classmethod
    def is_available(cls) -> bool:
        return True

    # lifecycle — mirrors STTBackend
    def load_model(self, model_id: str) -> None: ...

    def unload_model(self, model_id: str) -> None: ...

    def is_model_loaded(self, model_id: str) -> bool: ...

    def loaded_models(self) -> list[TTSLoadedModelInfo]: ...

    # synthesis
    def synthesize(
        self,
        text: str,
        voice: str,
        speed: float = 1.0,
        lang_code: str | None = None,
    ) -> Iterator[np.ndarray]: ...

    def list_voices(self) -> list[VoiceInfo]: ...


def backend_sample_rate(backend, model_id: str) -> int:
    """Per-voice native rate when the backend distinguishes (piper voices
    ship 16/22.05 kHz variants); class-level rate otherwise."""
    fn = getattr(backend, "get_sample_rate", None)
    if callable(fn):
        try:
            rate = int(fn(model_id))
        except Exception:  # noqa: BLE001 — fall back to the class rate
            rate = 0
        if 4000 <= rate <= 192000:  # guards mocks/garbage (int(Mock())==1)
            return rate
    try:
        rate = int(getattr(backend, "sample_rate", 24000))
    except Exception:  # noqa: BLE001
        return 24000
    return rate if 4000 <= rate <= 192000 else 24000
