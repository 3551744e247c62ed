"""TTS router: model id -> backend, with discovery of the backends package.

Counterpart of ``open_speech_tpu/tts/router.py``: backends are found by
duck-typing the modules of ``open_speech_tpu_torch.tts.backends`` (Kokoro
and Piper), ``provider/model`` ids resolve by their provider, unknown ids
go to the default backend (Kokoro), plugins can ``register_backend``,
load/unload run under an RLock, single-speaker backends (Piper) receive
the model id as the voice, and voice listings aggregate across backends.

An id that the JAX router resolves to a backend the port does not have yet
(``pocket-tts``) raises a named ``NotImplementedError`` from
``get_backend``: the speech, capability and load routes report it, and no
route answers with the default backend's audio in its place.

Every backend is made for ``device`` (``settings.tts_effective_device``,
the card, when None). A backend module that fails to import, or a backend
that fails to construct or load, raises: nothing is skipped quietly.
"""

from __future__ import annotations

import copy
import importlib
import inspect
import pkgutil
import threading
from typing import Any, Iterator

import numpy as np

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.tts.backends.base import TTSBackend, TTSLoadedModelInfo, VoiceInfo

_BACKEND_ATTRS = ("name", "sample_rate", "synthesize", "load_model")

# backend names of the JAX router that the port has not ported yet
NOT_PORTED = {"pocket-tts": "Pocket TTS is not ported yet: ROADMAP.md module item 1"}


def _discover_backends() -> dict[str, type]:
    import open_speech_tpu_torch.tts.backends as pkg

    found: dict[str, type] = {}
    for _importer, module_name, _is_pkg in pkgutil.iter_modules(pkg.__path__):
        if module_name == "base" or module_name.startswith("_"):
            continue
        qualified = f"{pkg.__name__}.{module_name}"
        module = importlib.import_module(qualified)
        for _name, cls in inspect.getmembers(module, inspect.isclass):
            if (cls is not TTSBackend and cls.__module__ == qualified
                    and all(hasattr(cls, attr) for attr in _BACKEND_ATTRS)):
                found[cls.name] = cls
    return found


class TTSRouter:
    def __init__(self, device: str | None = None) -> None:
        self._device = device if device is not None else settings.tts_effective_device
        self._lock = threading.RLock()
        self._backends: dict[str, TTSBackend] = {
            name: cls(device=self._device)
            for name, cls in _discover_backends().items()
            if cls.is_available()
        }
        self._default_backend: TTSBackend | None = self._backends.get("kokoro") or next(
            iter(self._backends.values()), None)

    # ── registration / resolution ─────────────────────────────────────

    def register_backend(self, name: str, backend: TTSBackend) -> None:
        """Plugin hook: add a backend at runtime."""
        with self._lock:
            self._backends[name] = backend
            if self._default_backend is None:
                self._default_backend = backend

    def get_backend(self, model_id: str) -> TTSBackend:
        keys = (model_id, model_id.split("/", 1)[0]) if "/" in model_id else (model_id,)
        for key in keys:
            if key in self._backends:
                return self._backends[key]
            if key in NOT_PORTED:
                raise NotImplementedError(NOT_PORTED[key])
        if self._default_backend is None:
            raise RuntimeError("No TTS backends available")
        return self._default_backend

    def list_backends(self) -> list[str]:
        return list(self._backends)

    def get_capabilities(self, model_id: str) -> dict[str, Any]:
        return copy.deepcopy(getattr(self.get_backend(model_id), "capabilities", {}))

    # ── lifecycle ─────────────────────────────────────────────────────

    def load_model(self, model_id: str) -> None:
        with self._lock:
            self.get_backend(model_id).load_model(model_id)

    def unload_model(self, model_id: str) -> None:
        with self._lock:
            self.get_backend(model_id).unload_model(model_id)

    def is_model_loaded(self, model_id: str) -> bool:
        return self.get_backend(model_id).is_model_loaded(model_id)

    def loaded_models(self) -> list[TTSLoadedModelInfo]:
        out: list[TTSLoadedModelInfo] = []
        for backend in self._backends.values():
            out.extend(backend.loaded_models())
        return out

    # ── synthesis / voices ────────────────────────────────────────────

    def synthesize(
        self,
        text: str,
        model: str,
        voice: str,
        speed: float = 1.0,
        lang_code: str | None = None,
    ) -> Iterator[np.ndarray]:
        backend = self.get_backend(model)
        if getattr(backend, "single_speaker", False):
            voice = model  # a single-speaker backend selects its voice by model id
        return backend.synthesize(text, voice, speed, lang_code)

    def list_voices(self, model: str | None = None) -> list[VoiceInfo]:
        if model and model in self._backends:
            return self._backends[model].list_voices()
        merged: list[VoiceInfo] = []
        for backend in self._backends.values():
            merged.extend(backend.list_voices())
        return merged
