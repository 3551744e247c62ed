"""Named WAV reference store for voice cloning.

Behavior matches the reference's voice library (src/voice_library.py): only
RIFF/WAVE uploads are accepted, names are sanitized to a lowercase slug,
entries are ``<name>.audio.<ext>`` files with ``<name>.meta.json`` sidecars,
and a configurable cap limits how many voices may be stored.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from datetime import datetime, timezone
from pathlib import Path

logger = logging.getLogger(__name__)

_SLUG_STRIP = re.compile(r"[^a-z0-9_]")

_CONTENT_TYPE_EXT = {
    "audio/wav": "wav",
    "audio/x-wav": "wav",
    "audio/mp3": "mp3",
    "audio/mpeg": "mp3",
    "audio/ogg": "ogg",
    "audio/flac": "flac",
}


class VoiceNotFoundError(KeyError):
    """Raised when a named voice entry does not exist."""


def _slug(name: str) -> str:
    slug = _SLUG_STRIP.sub("", name.strip().lower().replace(" ", "_").replace("-", "_"))
    slug = slug[:64]
    if not slug:
        raise ValueError(
            "Voice name must contain at least one alphanumeric character"
        )
    return slug


def _ext_for(content_type: str) -> str:
    return _CONTENT_TYPE_EXT.get(content_type.lower().strip(), "wav")


def _looks_like_wav(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE"


class VoiceLibraryManager:
    def __init__(self, library_path: str | Path, max_count: int = 0) -> None:
        self.library_path = Path(library_path)
        self.max_count = max_count  # 0 = unlimited
        self._lock = threading.RLock()
        with self._lock:
            self.library_path.mkdir(parents=True, exist_ok=True)

    # ── paths ─────────────────────────────────────────────────────────

    def _meta_path(self, slug: str) -> Path:
        return self.library_path / f"{slug}.meta.json"

    def _audio_path(self, slug: str, ext: str) -> Path:
        return self.library_path / f"{slug}.audio.{ext}"

    def _audio_glob(self, slug: str):
        return self.library_path.glob(f"{slug}.audio.*")

    # ── operations ────────────────────────────────────────────────────

    def save(
        self, name: str, audio_bytes: bytes, content_type: str = "audio/wav"
    ) -> dict:
        slug = _slug(name)
        if not audio_bytes:
            raise ValueError("Audio data is empty")
        if not _looks_like_wav(audio_bytes):
            raise ValueError(
                "Reference audio must be WAV format (RIFF/WAVE header "
                "required). Convert MP3/OGG/FLAC to WAV before uploading."
            )
        # only WAV bytes pass the header check above, so the stored
        # extension/metadata reflect the actual format even when the
        # client's claimed content_type disagrees (e.g. audio/mpeg)
        meta = {
            "name": slug,
            "size_bytes": len(audio_bytes),
            "content_type": "audio/wav",
            "created_at": datetime.now(timezone.utc).isoformat(),
        }
        target = self._audio_path(slug, "wav")
        with self._lock:
            self.library_path.mkdir(parents=True, exist_ok=True)
            if self.max_count > 0 and not self._meta_path(slug).exists():
                stored = sum(1 for _ in self.library_path.glob("*.meta.json"))
                if stored >= self.max_count:
                    raise ValueError(
                        f"Voice library is full ({self.max_count} voices "
                        "max). Delete a voice before adding more."
                    )
            for old in self._audio_glob(slug):
                if old != target:
                    old.unlink(missing_ok=True)
            target.write_bytes(audio_bytes)
            self._meta_path(slug).write_text(json.dumps(meta), encoding="utf-8")
        return meta

    def list_voices(self) -> list[dict]:
        entries: list[dict] = []
        with self._lock:
            for meta_path in self.library_path.glob("*.meta.json"):
                try:
                    meta = json.loads(meta_path.read_text(encoding="utf-8"))
                except Exception as exc:  # noqa: BLE001
                    logger.warning(
                        "Voice library: skipping corrupted metadata %s (%s)",
                        meta_path, exc,
                    )
                    continue
                if not isinstance(meta, dict):
                    continue
                ext = _ext_for(meta.get("content_type", "audio/wav"))
                if not self._audio_path(meta.get("name", ""), ext).exists():
                    logger.warning(
                        "Voice library: audio missing for '%s' — skipping",
                        meta.get("name"),
                    )
                    continue
                entries.append(meta)
        entries.sort(key=lambda item: item.get("name", ""))
        return entries

    def get(self, name: str) -> tuple[bytes, dict]:
        slug = _slug(name)
        with self._lock:
            meta_path = self._meta_path(slug)
            if not meta_path.exists():
                raise VoiceNotFoundError(name)
            meta = json.loads(meta_path.read_text(encoding="utf-8"))
            audio_path = self._audio_path(
                slug, _ext_for(meta.get("content_type", "audio/wav"))
            )
            if not audio_path.exists():
                raise VoiceNotFoundError(name)
            return audio_path.read_bytes(), meta

    def delete(self, name: str) -> None:
        slug = _slug(name)
        with self._lock:
            meta_path = self._meta_path(slug)
            audio_files = list(self._audio_glob(slug))
            if not meta_path.exists() and not audio_files:
                raise VoiceNotFoundError(name)
            meta_path.unlink(missing_ok=True)
            for audio_file in audio_files:
                audio_file.unlink(missing_ok=True)

    def exists(self, name: str) -> bool:
        with self._lock:
            return self._meta_path(_slug(name)).exists()
