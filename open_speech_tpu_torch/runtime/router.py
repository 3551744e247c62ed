"""STT backend router and the REST transcription handlers without HTTP.

Counterpart of ``open_speech_tpu/runtime/router.py``: resolve a model id to
a backend, fan listing calls and the HF-cache calls across registered
backends, pass inference through. The torch whisper backend is registered
under its own name, the reference's ``faster-whisper`` provider name, and
``jax-whisper``: the provider that the model catalog (``registry.py``, a
copy of the JAX package's) and ``ModelManager`` name for every STT id, so
that a load through ``/api/models/{id}/load`` finds its provider.
``_lock`` is the lock the lifecycle's evictions take.

``transcription_response`` / ``translation_response`` do what the JAX
server's ``POST /v1/audio/transcriptions`` and ``/translations`` routes do
with one upload once the multipart form is parsed (``server/app.py``):
ingest and preprocessing (``prepare_upload``), the router call, and the
response shaping (``transcription_body``, ``render_result``). The HTTP
routes (``server/app.py``) call the same pieces, with the JAX routes'
error mapping between them.
"""

from __future__ import annotations

import asyncio
from typing import Any

from open_speech_tpu_torch.audio.ingest import convert_to_wav
from open_speech_tpu_torch.audio.preprocessing import preprocess_stt_audio
from open_speech_tpu_torch.backends.base import STTBackend
from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.schemas import LoadedModelInfo
from open_speech_tpu_torch.text.formatters import format_transcription


class BackendRouter:
    def __init__(self, device: str | None = None, compute_type: str | None = None,
                 backend: STTBackend | None = None) -> None:
        self._lock = asyncio.Lock()
        # ``backend``: one made by the caller (a model group's leader)
        whisper = backend or TorchWhisperBackend(device=device, compute_type=compute_type)
        # every provider name resolves to the same backend instance
        self._backends: dict[str, STTBackend] = {
            "torch-whisper": whisper,
            "faster-whisper": whisper,
            "jax-whisper": whisper,
        }
        self._default_backend: STTBackend = whisper

    def get_backend(self, model_id: str) -> STTBackend:
        return self._default_backend

    def _unique_backends(self):
        seen: set[int] = set()
        for backend in self._backends.values():
            if id(backend) not in seen:
                seen.add(id(backend))
                yield backend

    # ── lifecycle passthrough ─────────────────────────────────────────

    def load_model(self, model_id: str) -> None:
        self.get_backend(model_id).load_model(model_id)

    def unload_model(self, model_id: str) -> None:
        self.get_backend(model_id).unload_model(model_id)

    def is_model_loaded(self, model_id: str) -> bool:
        return self.get_backend(model_id).is_model_loaded(model_id)

    def loaded_models(self) -> list[LoadedModelInfo]:
        out: list[LoadedModelInfo] = []
        for backend in self._unique_backends():
            out.extend(backend.loaded_models())
        return out

    # ── cache passthrough (duck-typed, like the reference) ────────────

    def list_cached_models(self) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        for backend in self._unique_backends():
            lister = getattr(backend, "list_cached_models", None)
            if callable(lister):
                out.extend(lister())
        return out

    def delete_cached_model(self, model_id: str) -> bool:
        deleter = getattr(self.get_backend(model_id), "delete_cached_model", None)
        return bool(deleter(model_id)) if callable(deleter) else False

    def is_model_cached(self, model_id: str) -> bool:
        checker = getattr(self.get_backend(model_id), "is_model_cached", None)
        return bool(checker(model_id)) if callable(checker) else False

    # ── inference passthrough ─────────────────────────────────────────

    def transcribe(self, audio: bytes, model: str, **kwargs: Any) -> dict[str, Any]:
        return self.get_backend(model).transcribe(audio, model, **kwargs)

    def translate(self, audio: bytes, model: str, **kwargs: Any) -> dict[str, Any]:
        return self.get_backend(model).translate(audio, model, **kwargs)


def prepare_upload(
    router: BackendRouter, model: str, audio_bytes: bytes, content_type: str | None
) -> bytes:
    """An upload's ingest and preprocessing, on the device the model runs on."""
    device = getattr(router.get_backend(model), "device", None)
    return preprocess_stt_audio(
        convert_to_wav(audio_bytes, content_type, device),
        normalize=settings.stt_normalize,
        noise_reduce=settings.stt_noise_reduce,
    )


def backend_format(response_format: str) -> str:
    """The format the backend is asked for: srt, vtt and json are rendered
    from verbose_json, as the JAX route does."""
    if response_format in ("srt", "vtt", "json", "verbose_json"):
        return "verbose_json"
    return response_format


def transcription_body(result: dict[str, Any], response_format: str) -> tuple[str | dict[str, Any], str]:
    """(body, content type) of a transcription result, as the JAX route
    renders it: a dict is sent as JSON, a string as text."""
    if response_format == "json" and "text" in result:
        result = {"text": result["text"]}  # OpenAI json shape
    if response_format in ("text", "srt", "vtt"):
        content, content_type = format_transcription(result, response_format)
        return content, content_type.split(";")[0]
    return render_result(result)


def render_result(result: dict[str, Any]) -> tuple[str | dict[str, Any], str]:
    """(body, content type) of a backend result: its text when the backend
    rendered it (text/srt/vtt), else the dict as JSON."""
    if result.get("raw_text"):
        return result["text"], "text/plain"
    return result, "application/json"


def transcription_response(
    router: BackendRouter,
    audio_bytes: bytes,
    *,
    model: str | None = None,
    language: str | None = None,
    prompt: str | None = None,
    response_format: str = "json",
    temperature: float = 0.0,
    content_type: str | None = None,
) -> str | dict[str, Any]:
    """The body of a transcription response: a dict for json/verbose_json,
    the text for text/srt/vtt."""
    if not audio_bytes:
        raise ValueError("Empty audio file")
    model = model or settings.stt_model
    result = router.transcribe(
        audio=prepare_upload(router, model, audio_bytes, content_type),
        model=model,
        language=language,
        response_format=backend_format(response_format),
        temperature=temperature,
        prompt=prompt,
        beam_size=settings.stt_rest_beam_size,
    )
    return transcription_body(result, response_format)[0]


def translation_response(
    router: BackendRouter,
    audio_bytes: bytes,
    *,
    model: str | None = None,
    prompt: str | None = None,
    response_format: str = "json",
    temperature: float = 0.0,
    content_type: str | None = None,
) -> str | dict[str, Any]:
    """The body of a translation response (English text in any format)."""
    if not audio_bytes:
        raise ValueError("Empty audio file")
    model = model or settings.stt_model
    result = router.translate(
        audio=prepare_upload(router, model, audio_bytes, content_type),
        model=model,
        response_format=response_format,
        temperature=temperature,
        prompt=prompt,
    )
    return render_result(result)[0]
