"""Unified model manager over the STT and TTS routers.

Reference semantics preserved (src/model_manager.py): the
available/provider_missing/provider_installed/downloading/downloaded/loaded
state machine, typed lifecycle errors, auto-evicting other same-type models
on load, download implemented as load+unload, artifact deletion restricted
to known cache roots, a merged catalog listing, and TTL/LRU eviction hooks.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Any

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.runtime.registry import get_known_model, get_known_models

logger = logging.getLogger(__name__)

_TTS_ID_HINTS = ("kokoro", "piper/", "piper-", "pocket-tts")


class ModelState(str, Enum):
    AVAILABLE = "available"
    PROVIDER_MISSING = "provider_missing"
    PROVIDER_INSTALLED = "provider_installed"
    DOWNLOADING = "downloading"
    DOWNLOADED = "downloaded"
    LOADED = "loaded"


@dataclass
class ModelLifecycleError(Exception):
    message: str
    code: str
    model_id: str
    provider: str | None = None
    action: str | None = None
    details: dict[str, Any] | None = None

    def to_dict(self) -> dict[str, Any]:
        body = {
            "message": self.message,
            "code": self.code,
            "model": self.model_id,
            "provider": self.provider,
            "action": self.action,
        }
        if self.details:
            body["details"] = self.details
        return body


@dataclass
class ModelInfo:
    id: str
    type: str  # "stt" | "tts"
    provider: str
    device: str | None = None
    state: ModelState = ModelState.AVAILABLE
    size_mb: int | None = None
    loaded_at: float | None = None
    last_used_at: float | None = None
    is_default: bool = False
    description: str | None = None
    source: str | None = None
    model_format: str | None = None
    provider_available: bool = True

    _OPTIONAL = ("description", "source", "model_format")

    def to_dict(self) -> dict[str, Any]:
        body: dict[str, Any] = {
            "id": self.id,
            "type": self.type,
            "provider": self.provider,
            "device": self.device,
            "state": self.state.value,
            "size_mb": self.size_mb,
            "loaded_at": self.loaded_at,
            "last_used_at": self.last_used_at,
            "is_default": self.is_default,
            "provider_available": self.provider_available,
        }
        for key in self._OPTIONAL:
            value = getattr(self, key)
            if value:
                body[key] = value
        return body

    def absorb_catalog(self, row: dict) -> None:
        """Fill metadata gaps from a registry row."""
        if self.size_mb is None and row.get("size_mb"):
            self.size_mb = row["size_mb"]
        for key in self._OPTIONAL:
            if not getattr(self, key) and row.get(key):
                setattr(self, key, row[key])


class ModelManager:
    def __init__(self, stt_router, tts_router) -> None:
        self._stt = stt_router
        self._tts = tts_router

    # ── id resolution ─────────────────────────────────────────────────

    def _resolve_type(self, model_id: str) -> str:
        if model_id in getattr(self._tts, "_backends", {}):
            return "tts"
        if any(model_id.startswith(hint) for hint in _TTS_ID_HINTS):
            return "tts"
        if any(m.model == model_id for m in self._tts.loaded_models()):
            return "tts"
        return "stt"

    def _provider_from_model(self, model_id: str) -> str:
        row = get_known_model(model_id)
        if row:
            return row["provider"]
        for hint, provider in (
            ("piper/", "piper"),
            ("piper-", "piper"),
            ("pocket-tts", "pocket-tts"),
            ("kokoro", "kokoro"),
        ):
            if model_id.startswith(hint):
                return provider
        return "jax-whisper"

    def resolve_provider(self, model_id: str) -> str:
        return self._provider_from_model(model_id)

    def _provider_registered(self, model_type: str, provider: str) -> bool:
        if model_type == "tts":
            return provider in getattr(self._tts, "_backends", {})
        stt_backends = getattr(self._stt, "_backends", None)
        return True if not stt_backends else provider in stt_backends

    def _default_for(self, model_type: str) -> str:
        return settings.tts_model if model_type == "tts" else settings.stt_model

    def _router_for(self, model_type: str):
        return self._tts if model_type == "tts" else self._stt

    # ── lifecycle ─────────────────────────────────────────────────────

    def load(
        self, model_id: str, device: str | None = None, _evict_others: bool = True
    ) -> ModelInfo:
        model_type = self._resolve_type(model_id)
        provider = self._provider_from_model(model_id)

        if not self._provider_registered(model_type, provider):
            raise ModelLifecycleError(
                message=(
                    f"Provider '{provider}' is not installed for model "
                    f"'{model_id}'."
                ),
                code="provider_missing",
                model_id=model_id,
                provider=provider,
                action="load",
            )

        if _evict_others:
            self._evict_same_type(model_type, keep=model_id)

        router = self._router_for(model_type)
        try:
            router.load_model(model_id)
        except ModelLifecycleError:
            raise
        except Exception as exc:  # noqa: BLE001
            raise ModelLifecycleError(
                message=f"Failed to load model '{model_id}': {exc}",
                code="load_failed",
                model_id=model_id,
                provider=provider,
                action="load",
                details={"exception": type(exc).__name__},
            ) from exc

        default_id = self._default_for(model_type)
        for loaded in router.loaded_models():
            if loaded.model == model_id:
                return ModelInfo(
                    id=model_id, type=model_type, provider=loaded.backend,
                    device=loaded.device, state=ModelState.LOADED,
                    loaded_at=loaded.loaded_at,
                    last_used_at=loaded.last_used_at,
                    is_default=(model_id == default_id),
                )
        return ModelInfo(
            id=model_id, type=model_type, provider=provider,
            state=ModelState.LOADED, is_default=(model_id == default_id),
        )

    def _evict_same_type(self, model_type: str, keep: str) -> None:
        """One loaded model per type (reference policy)."""
        for loaded in self.list_loaded():
            if loaded.type != model_type or loaded.id == keep:
                continue
            try:
                self.unload(loaded.id)
                logger.info(
                    "Auto-unloaded %s model %s to load %s",
                    model_type.upper(), loaded.id, keep,
                )
            except Exception as exc:  # noqa: BLE001
                logger.warning(
                    "Failed to auto-unload %s model %s: %s",
                    model_type.upper(), loaded.id, exc,
                )

    def download(self, model_id: str) -> ModelInfo:
        provider = self._provider_from_model(model_id)
        router = self._router_for(self._resolve_type(model_id))
        try:
            was_loaded = router.is_model_loaded(model_id)
        except Exception:  # noqa: BLE001
            was_loaded = False
        self.load(model_id, _evict_others=False)
        if not was_loaded:
            self.unload(model_id)
        info = self.status(model_id)
        info.provider = provider
        return info

    def unload(self, model_id: str) -> None:
        self._router_for(self._resolve_type(model_id)).unload_model(model_id)

    # ── artifact deletion ─────────────────────────────────────────────

    def _hf_cache_roots(self) -> list[Path]:
        candidates = [
            settings.stt_model_dir,
            os.environ.get("HF_HUB_CACHE"),
            os.environ.get("HUGGINGFACE_HUB_CACHE"),
            str(Path.home() / ".cache" / "huggingface" / "hub"),
        ]
        roots: list[Path] = []
        for candidate in candidates:
            if not candidate:
                continue
            path = Path(candidate).expanduser()
            if path not in roots:
                roots.append(path)
        return roots

    @staticmethod
    def _piper_voice_roots() -> list[Path]:
        """Where the piper backend actually caches voices
        (tts/backends/piper_torch.py:_find_voice_file — keep in sync)."""
        roots = []
        env = os.environ.get("OS_PIPER_VOICES_DIR", "")
        if env:
            roots.append(Path(env).expanduser())
        roots += [
            Path.home() / ".cache" / "piper-voices",
            Path.home() / ".local" / "share" / "piper",
        ]
        return roots

    def _candidate_artifact_paths(self, model_id: str, provider: str) -> list[Path]:
        safe_name = f"models--{model_id.replace('/', '--')}"
        paths = [root / safe_name for root in self._hf_cache_roots()]
        if provider == "kokoro":
            paths += [
                root / "models--hexgrad--Kokoro-82M"
                for root in self._hf_cache_roots()
            ]
        elif provider == "piper":
            # voices are FILES <short>.onnx(.json), not HF snapshot dirs
            short = model_id.split("/", 1)[-1].split("#", 1)[0]
            for root in self._piper_voice_roots():
                paths += [root / f"{short}.onnx", root / f"{short}.onnx.json"]
        elif provider == "pocket-tts":
            paths += [
                root / "models--kyutai--pocket-tts"
                for root in self._hf_cache_roots()
            ]
            env = os.environ.get("OS_POCKET_CKPT_PATH", "")
            if env:
                paths.append(Path(env).expanduser())
        return paths

    @staticmethod
    def _safe_remove_dir(path: Path, allowed_roots: list[Path]) -> bool:
        resolved = path.resolve()
        for root in allowed_roots:
            root_resolved = root.resolve()
            if resolved == root_resolved or root_resolved in resolved.parents:
                if resolved.is_dir():
                    shutil.rmtree(resolved)
                    return True
                if resolved.is_file():  # piper voices are single files
                    resolved.unlink()
                    return True
        return False

    def delete_artifacts(self, model_id: str) -> dict[str, Any]:
        provider = self._provider_from_model(model_id)
        try:
            if self.status(model_id).state == ModelState.LOADED:
                self.unload(model_id)
        except Exception:  # noqa: BLE001
            pass

        deleted = False
        if self._resolve_type(model_id) == "stt":
            precise = getattr(self._stt, "delete_cached_model", None)
            if callable(precise):
                try:
                    deleted = bool(precise(model_id))
                except Exception:  # noqa: BLE001
                    deleted = False

        removed: list[str] = []
        allowed = self._hf_cache_roots()
        if provider == "piper":
            allowed = allowed + self._piper_voice_roots()
        for candidate in self._candidate_artifact_paths(model_id, provider):
            try:
                if self._safe_remove_dir(candidate, allowed):
                    removed.append(str(candidate))
                    deleted = True
            except Exception:  # noqa: BLE001
                logger.warning("Failed deleting path %s", candidate, exc_info=True)

        return {
            "status": "deleted" if deleted else "not_found",
            "model": model_id,
            "provider": provider,
            "deleted_paths": removed,
        }

    # ── listings / status ─────────────────────────────────────────────

    def list_loaded(self) -> list[ModelInfo]:
        out: list[ModelInfo] = []
        for model_type, router in (("stt", self._stt), ("tts", self._tts)):
            default_id = self._default_for(model_type)
            for loaded in router.loaded_models():
                out.append(
                    ModelInfo(
                        id=loaded.model, type=model_type,
                        provider=loaded.backend, device=loaded.device,
                        state=ModelState.LOADED, loaded_at=loaded.loaded_at,
                        last_used_at=loaded.last_used_at,
                        is_default=(loaded.model == default_id),
                    )
                )
        return out

    @staticmethod
    def _downloaded_state(is_downloaded: bool) -> ModelState:
        return (
            ModelState.DOWNLOADED
            if is_downloaded
            else ModelState.PROVIDER_INSTALLED
        )

    def _cached_stt_infos(self, known_types: dict[str, str]) -> list[ModelInfo]:
        infos = []
        for cached in self._stt.list_cached_models():
            model_id = cached.get("model") or cached.get("id") or ""
            # off-catalog downloads (custom repo ids) still count: only
            # skip ids the catalog explicitly claims for another type
            if not model_id or known_types.get(model_id, "stt") != "stt":
                continue
            infos.append(
                ModelInfo(
                    id=model_id, type="stt",
                    provider=cached.get(
                        "backend", self._provider_from_model(model_id)
                    ),
                    state=self._downloaded_state(True),
                    size_mb=cached.get("size_mb"),
                    is_default=(model_id == settings.stt_model),
                )
            )
        return infos

    def list_all(self) -> list[ModelInfo]:
        known_rows = get_known_models()
        known_types = {row["id"]: row["type"] for row in known_rows}

        merged: dict[str, ModelInfo] = {m.id: m for m in self.list_loaded()}
        for info in self._cached_stt_infos(known_types):
            merged.setdefault(info.id, info)

        for row in known_rows:
            model_id, provider = row["id"], row["provider"]
            is_tts = row["type"] == "tts"
            registered = self._provider_registered(row["type"], provider)
            existing = merged.get(model_id)
            if existing is None:
                downloaded = is_tts and any(
                    p.exists()
                    for p in self._candidate_artifact_paths(model_id, provider)
                )
                state = (
                    ModelState.PROVIDER_MISSING
                    if is_tts and not registered
                    else self._downloaded_state(downloaded)
                )
                info = ModelInfo(
                    id=model_id, type=row["type"], provider=provider,
                    state=state, size_mb=row.get("size_mb"),
                    is_default=model_id in (settings.stt_model, settings.tts_model),
                    description=row.get("description"),
                    source=row.get("source"),
                    model_format=row.get("model_format"),
                    provider_available=registered,
                )
                merged[model_id] = info
            else:
                existing.absorb_catalog(row)
                if is_tts and not registered:
                    existing.provider_available = False
                    if existing.state != ModelState.LOADED:
                        existing.state = ModelState.PROVIDER_MISSING

        # configured defaults always appear, even off-catalog
        for default_id, model_type in (
            (settings.stt_model, "stt"),
            (settings.tts_model, "tts"),
        ):
            if default_id in merged:
                continue
            provider = self._provider_from_model(default_id)
            registered = self._provider_registered(model_type, provider)
            merged[default_id] = ModelInfo(
                id=default_id, type=model_type, provider=provider,
                state=(
                    ModelState.PROVIDER_MISSING
                    if model_type == "tts" and not registered
                    else self._downloaded_state(False)
                ),
                is_default=True,
                provider_available=registered if model_type == "tts" else True,
            )
        return list(merged.values())

    def status(self, model_id: str) -> ModelInfo:
        for info in self.list_loaded():
            if info.id == model_id:
                return info
        for cached in self._stt.list_cached_models():
            if (cached.get("model") or cached.get("id")) == model_id:
                return ModelInfo(
                    id=model_id, type="stt",
                    provider=cached.get(
                        "backend", self._provider_from_model(model_id)
                    ),
                    state=self._downloaded_state(True),
                    size_mb=cached.get("size_mb"),
                    is_default=(model_id == settings.stt_model),
                )
        model_type = self._resolve_type(model_id)
        provider = self._provider_from_model(model_id)
        registered = True
        downloaded = False
        if model_type == "tts":
            registered = self._provider_registered("tts", provider)
            downloaded = any(
                p.exists()
                for p in self._candidate_artifact_paths(model_id, provider)
            )
        return ModelInfo(
            id=model_id, type=model_type, provider=provider,
            state=(
                ModelState.PROVIDER_MISSING
                if model_type == "tts" and not registered
                else self._downloaded_state(downloaded)
            ),
            is_default=model_id in (settings.stt_model, settings.tts_model),
            provider_available=registered,
        )

    # ── eviction hooks ────────────────────────────────────────────────

    def evict_lru(self) -> None:
        evictable = [m for m in self.list_loaded() if not m.is_default]
        if not evictable:
            return
        oldest = min(evictable, key=lambda m: m.last_used_at or 0)
        logger.info("LRU eviction: unloading %s", oldest.id)
        self.unload(oldest.id)

    def check_ttl(self) -> None:
        ttl = settings.os_model_ttl
        if ttl <= 0:
            return
        now = time.time()
        for info in self.list_loaded():
            if info.is_default:
                continue
            last_used = info.last_used_at or info.loaded_at or now
            idle = now - last_used
            if idle > ttl:
                logger.info(
                    "TTL eviction: unloading %s (idle %.0fs)", info.id, idle
                )
                self.unload(info.id)
