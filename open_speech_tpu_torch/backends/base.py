"""STT backend contract.

A copy of ``open_speech_tpu/backends/base.py``: any object the router
serves must satisfy this runtime-checkable protocol. The torch backend is
the port's only implementation; tests may substitute fakes, which is why
this is a Protocol rather than an ABC.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from open_speech_tpu_torch.schemas import LoadedModelInfo


@runtime_checkable
class STTBackend(Protocol):
    """Duck type for speech-to-text engines.

    Lifecycle: ``load_model`` / ``unload_model`` / ``is_model_loaded`` /
    ``loaded_models``. Inference: ``transcribe`` / ``translate``, both
    returning a response dict already shaped for the requested
    ``response_format`` (json / verbose_json / text / srt / vtt).
    """

    name: str

    # ── lifecycle ────────────────────────────────────────────────────
    def load_model(self, model_id: str) -> None: ...

    def unload_model(self, model_id: str) -> None: ...

    def is_model_loaded(self, model_id: str) -> bool: ...

    def loaded_models(self) -> list[LoadedModelInfo]: ...

    # ── inference ────────────────────────────────────────────────────
    def transcribe(
        self,
        audio: bytes,
        model: str,
        language: str | None = None,
        response_format: str = "json",
        temperature: float = 0.0,
        prompt: str | None = None,
    ) -> dict[str, Any]: ...

    def translate(
        self,
        audio: bytes,
        model: str,
        response_format: str = "json",
        temperature: float = 0.0,
        prompt: str | None = None,
    ) -> dict[str, Any]: ...
