"""Disk LRU cache for synthesized audio (reference: src/cache/tts_cache.py).

SHA256(text|voice|speed|format|model) keys (:22), mtime-based LRU touch and
size-capped eviction (:56-72), thread-safe.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from pathlib import Path

logger = logging.getLogger(__name__)


class TTSCache:
    def __init__(self, cache_dir: str, max_mb: int = 500, enabled: bool = True) -> None:
        self._dir = Path(cache_dir)
        self.enabled = enabled
        if enabled:
            try:
                self._dir.mkdir(parents=True, exist_ok=True)
            except OSError as e:
                # optional cache: read-only fs, full disk, bad path all
                # degrade to disabled instead of failing server startup
                logger.warning("TTS cache disabled (%s): %s", cache_dir, e)
                self.enabled = False
        self._max_bytes = max_mb * 1024 * 1024
        self._lock = threading.RLock()

    @staticmethod
    def make_key(
        text: str, voice: str, speed: float, output_format: str, model: str
    ) -> str:
        # length-prefixed fields: a '|' inside text/voice must not let two
        # different (text, voice) pairs collide onto one key
        parts = [str(text), str(voice), str(speed), str(output_format), str(model)]
        payload = "|".join(f"{len(p)}:{p}" for p in parts)
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    def _path(self, key: str, output_format: str) -> Path:
        return self._dir / f"{key}.{output_format}"

    def get(self, key: str, output_format: str) -> bytes | None:
        path = self._path(key, output_format)
        with self._lock:
            if not path.exists():
                return None
            data = path.read_bytes()
            path.touch()  # LRU bump
            return data

    def set(self, key: str, output_format: str, data: bytes) -> None:
        with self._lock:
            path = self._path(key, output_format)
            # atomic: a crash mid-write must not leave a truncated file
            # that get() serves forever as a HIT
            tmp = path.with_suffix(path.suffix + ".tmp")
            try:
                tmp.write_bytes(data)
                tmp.replace(path)
            except OSError as e:
                logger.warning("TTS cache write failed: %s", e)
                tmp.unlink(missing_ok=True)

    def cleanup(self) -> int:
        """Evict oldest files until under the size cap; returns bytes freed."""
        if not self.enabled or not self._dir.is_dir():
            return 0
        with self._lock:
            files = [(f, f.stat()) for f in self._dir.iterdir() if f.is_file()]
            total = sum(st.st_size for _f, st in files)
            if total <= self._max_bytes:
                return 0
            files.sort(key=lambda it: it[1].st_mtime)
            freed = 0
            for f, st in files:
                if total - freed <= self._max_bytes:
                    break
                try:
                    f.unlink()
                    freed += st.st_size
                except OSError:  # pragma: no cover
                    pass
            logger.info("TTS cache cleanup freed %d bytes", freed)
            return freed

    # reference-signature convenience (src/main.py:832-845, :867-880)

    def get_for(self, *, text, voice, speed, fmt, model) -> bytes | None:
        if not self.enabled:
            return None
        return self.get(self.make_key(text, voice, speed, fmt, model), fmt)

    def set_for(self, *, text, voice, speed, fmt, model, audio: bytes) -> None:
        if not self.enabled:
            return
        self.set(self.make_key(text, voice, speed, fmt, model), fmt, audio)

    def stats(self) -> dict:
        if not self.enabled or not self._dir.is_dir():
            return {"entries": 0, "bytes": 0, "max_bytes": self._max_bytes}
        files = [f for f in self._dir.iterdir() if f.is_file()]
        return {
            "entries": len(files),
            "bytes": sum(f.stat().st_size for f in files),
            "max_bytes": self._max_bytes,
        }
