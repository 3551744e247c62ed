"""Voice profile CRUD.

Counterpart of ``open_speech_tpu/studio/profiles.py`` on the app's
``Store``: unique names (ValueError -> 409 at the API), a single default
profile, effects stored as a JSON column.
"""

from __future__ import annotations

import json
import sqlite3
from datetime import datetime, timezone
from uuid import uuid4

from open_speech_tpu_torch.studio.storage import Store

_COLUMNS = (
    "name", "backend", "model", "voice", "speed", "format", "blend",
    "reference_audio_id",
)


def _timestamp() -> str:
    return datetime.now(timezone.utc).isoformat()


def _to_public(row: sqlite3.Row) -> dict:
    record = dict(row)
    record["is_default"] = bool(record.get("is_default"))
    raw_effects = record.pop("effects_json", None)
    record["effects"] = json.loads(raw_effects) if raw_effects else []
    return record


class ProfileManager:
    def __init__(self, store: Store) -> None:
        self._store = store

    def create(
        self, name, backend, model, voice, speed, format, blend,
        reference_audio_id, effects,
    ) -> dict:
        profile_id = str(uuid4())
        now = _timestamp()
        columns = ", ".join(
            ["id", *_COLUMNS, "effects_json", "is_default", "created_at",
             "updated_at"]
        )
        placeholders = ", ".join("?" * (len(_COLUMNS) + 5))
        values = (
            profile_id, name, backend, model, voice, speed, format, blend,
            reference_audio_id, json.dumps(effects or []), 0, now, now,
        )
        db = self._store.connection()
        try:
            db.execute(
                f"INSERT INTO profiles ({columns}) VALUES ({placeholders})",
                values,
            )
            db.commit()
        except sqlite3.IntegrityError as exc:
            raise ValueError("Profile name already exists") from exc
        return self.get(profile_id) or {}

    def list_all(self) -> list[dict]:
        rows = self._store.connection().execute(
            "SELECT * FROM profiles ORDER BY name COLLATE NOCASE ASC"
        ).fetchall()
        return [_to_public(row) for row in rows]

    def get(self, profile_id: str) -> dict | None:
        row = self._store.connection().execute(
            "SELECT * FROM profiles WHERE id = ?", (profile_id,)
        ).fetchone()
        return _to_public(row) if row else None

    def update(self, profile_id: str, **fields) -> dict:
        assignments: list[str] = []
        values: list = []
        for key in (*_COLUMNS, "effects"):
            if key not in fields:
                continue
            if key == "effects":
                assignments.append("effects_json = ?")
                values.append(json.dumps(fields[key] or []))
            else:
                assignments.append(f"{key} = ?")
                values.append(fields[key])
        if not assignments:
            existing = self.get(profile_id)
            if existing is None:
                raise KeyError(profile_id)
            return existing
        assignments.append("updated_at = ?")
        values += [_timestamp(), profile_id]
        db = self._store.connection()
        try:
            cursor = db.execute(
                f"UPDATE profiles SET {', '.join(assignments)} WHERE id = ?",
                tuple(values),
            )
            db.commit()
        except sqlite3.IntegrityError as exc:
            raise ValueError("Profile name already exists") from exc
        if cursor.rowcount == 0:
            raise KeyError(profile_id)
        return self.get(profile_id) or {}

    def delete(self, profile_id: str) -> bool:
        db = self._store.connection()
        cursor = db.execute("DELETE FROM profiles WHERE id = ?", (profile_id,))
        db.commit()
        return cursor.rowcount > 0

    def set_default(self, profile_id: str) -> None:
        db = self._store.connection()
        exists = db.execute(
            "SELECT 1 FROM profiles WHERE id = ?", (profile_id,)
        ).fetchone()
        if exists is None:
            raise KeyError(profile_id)
        db.execute("UPDATE profiles SET is_default = 0")
        db.execute(
            "UPDATE profiles SET is_default = 1, updated_at = ? WHERE id = ?",
            (_timestamp(), profile_id),
        )
        db.commit()

    def get_default(self) -> dict | None:
        row = self._store.connection().execute(
            "SELECT * FROM profiles WHERE is_default = 1 LIMIT 1"
        ).fetchone()
        return _to_public(row) if row else None
