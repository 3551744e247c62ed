"""Generation history: auto-logged TTS/STT records with pruning.

Counterpart of ``open_speech_tpu/studio/history.py`` on the app's
``Store``: every synthesis/transcription gets a row; pruning enforces
``max_entries`` (OS_HISTORY_MAX_ENTRIES, newest kept) and ``max_mb`` of
stored audio (OS_HISTORY_MAX_MB, oldest audio-bearing rows dropped first);
deleting a row removes its audio file. The app passes the three settings
when it makes the manager.
"""

from __future__ import annotations

import json
import os
from datetime import datetime, timezone
from pathlib import Path
from uuid import uuid4

from open_speech_tpu_torch.studio.storage import Store

_PREVIEW_CHARS = 180


def _clip_preview(text: str) -> str:
    cleaned = (text or "").strip()
    if len(cleaned) <= _PREVIEW_CHARS:
        return cleaned
    return cleaned[: _PREVIEW_CHARS - 1] + "…"


def _insert(db, columns: dict) -> None:
    names = ", ".join(columns)
    marks = ", ".join("?" * len(columns))
    db.execute(
        f"INSERT INTO history_entries ({names}) VALUES ({marks})",
        tuple(columns.values()),
    )
    db.commit()


class HistoryManager:
    def __init__(self, store: Store, *, max_entries: int, max_mb: int,
                 retain_audio: bool) -> None:
        self._store = store
        self.max_entries = max_entries
        self.max_mb = max_mb
        self.retain_audio = retain_audio

    def log_tts(
        self, model, voice, speed, format, text, output_path, output_bytes,
        streamed=False,
    ) -> str:
        entry_id = str(uuid4())
        keep_audio = not streamed and self.retain_audio
        _insert(
            self._store.connection(),
            {
                "id": entry_id,
                "type": "tts",
                "created_at": datetime.now(timezone.utc).isoformat(),
                "model": model,
                "voice": voice,
                "speed": speed,
                "format": format,
                "text_preview": _clip_preview(text),
                "full_text": text,
                "output_path": output_path if keep_audio else None,
                "output_bytes": None if streamed else output_bytes,
                "streamed": 1 if streamed else 0,
                "meta_json": "{}",
            },
        )
        self.prune()
        return entry_id

    def log_stt(self, model, input_filename, result_text) -> str:
        entry_id = str(uuid4())
        _insert(
            self._store.connection(),
            {
                "id": entry_id,
                "type": "stt",
                "created_at": datetime.now(timezone.utc).isoformat(),
                "model": model,
                "text_preview": _clip_preview(result_text),
                "full_text": result_text,
                "input_filename": input_filename,
                "streamed": 0,
                "meta_json": "{}",
            },
        )
        self.prune()
        return entry_id

    def list_entries(self, type_filter=None, limit=50, offset=0) -> dict:
        db = self._store.connection()
        condition, args = "", []
        if type_filter in {"tts", "stt"}:
            condition = "WHERE type = ?"
            args = [type_filter]
        total = db.execute(
            f"SELECT COUNT(*) FROM history_entries {condition}", args
        ).fetchone()[0]
        rows = db.execute(
            f"SELECT * FROM history_entries {condition} "
            "ORDER BY created_at DESC LIMIT ? OFFSET ?",
            [*args, int(limit), int(offset)],
        ).fetchall()
        items = []
        for row in rows:
            item = dict(row)
            item["streamed"] = bool(item.get("streamed"))
            items.append(item)
        return {
            "items": items, "total": total,
            "limit": int(limit), "offset": int(offset),
        }

    def delete_entry(self, entry_id: str) -> bool:
        db = self._store.connection()
        row = db.execute(
            "SELECT output_path FROM history_entries WHERE id = ?",
            (entry_id,),
        ).fetchone()
        if row is None:
            return False
        db.execute("DELETE FROM history_entries WHERE id = ?", (entry_id,))
        db.commit()
        self._remove_file(row["output_path"])
        return True

    def clear_all(self) -> int:
        db = self._store.connection()
        paths = [
            row["output_path"]
            for row in db.execute(
                "SELECT output_path FROM history_entries "
                "WHERE output_path IS NOT NULL"
            ).fetchall()
        ]
        count = db.execute("SELECT COUNT(*) FROM history_entries").fetchone()[0]
        db.execute("DELETE FROM history_entries")
        db.commit()
        for path in paths:
            self._remove_file(path)
        return count

    def prune(self) -> int:
        removed = self._prune_by_count()
        removed += self._prune_by_audio_bytes()
        return removed

    def _prune_by_count(self) -> int:
        cap = max(0, int(self.max_entries))
        if cap == 0:
            return 0
        overflow = self._store.connection().execute(
            "SELECT id FROM history_entries ORDER BY created_at DESC "
            "LIMIT -1 OFFSET ?",
            (cap,),
        ).fetchall()
        return sum(1 for row in overflow if self.delete_entry(row["id"]))

    def _prune_by_audio_bytes(self) -> int:
        cap_bytes = max(0, int(self.max_mb)) * 1024 * 1024
        if cap_bytes == 0:
            return 0
        # cheap gate first: prune() runs on the event loop after every
        # TTS/STT request, so the common under-cap case must not stat files
        db = self._store.connection()
        recorded = db.execute(
            "SELECT COALESCE(SUM(COALESCE(output_bytes, 0)), 0), "
            "COUNT(*) FILTER (WHERE output_bytes IS NULL) "
            "FROM history_entries WHERE output_path IS NOT NULL"
        ).fetchone()
        if recorded[0] <= cap_bytes and recorded[1] == 0:
            return 0
        # one pass, oldest-first: stat only rows missing a recorded size,
        # delete from the front until the remainder fits the cap
        rows = db.execute(
            "SELECT id, output_path, output_bytes FROM history_entries "
            "WHERE output_path IS NOT NULL ORDER BY created_at ASC"
        ).fetchall()
        sized = [
            (
                row["id"],
                row["output_bytes"]
                if row["output_bytes"] is not None
                else self._file_size(row["output_path"]),
            )
            for row in rows
        ]
        total = sum(size for _eid, size in sized)
        removed = 0
        for entry_id, size in sized:
            if total <= cap_bytes:
                break
            if self.delete_entry(entry_id):
                removed += 1
                total -= size
            else:  # row vanished concurrently; its bytes are gone too
                total -= size
        return removed

    @staticmethod
    def _file_size(path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError:
            return 0

    @staticmethod
    def _remove_file(path: str | None) -> None:
        if not path:
            return
        try:
            target = Path(path)
            if target.is_file():
                target.unlink()
        except OSError:
            pass
