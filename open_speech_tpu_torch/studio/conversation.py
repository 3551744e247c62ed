"""Conversations: their turns, and their renders.

Counterpart of ``open_speech_tpu/studio/conversation.py`` on the app's
``Store``, with its SQL: render = per-turn synth with profile-resolved
voice/model/speed (the app's ``tts_model``/``tts_voice`` where no profile
names them), per-turn effects through the port's ``apply_chain`` on
``device`` (the TTS device), 500 ms silence gaps, turn WAVs and the render
file under ``output_dir/<id>/``, concat; turn reindex on delete. The
synthesis function is injected by the app.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from uuid import uuid4

import numpy as np

from open_speech_tpu_torch.audio.effects import apply_chain
from open_speech_tpu_torch.audio.encode import encode_audio
from open_speech_tpu_torch.ops.audio import write_wav
from open_speech_tpu_torch.studio.storage import Store

SILENCE_MS = 500

# SQL statements, hoisted so the manager methods read as control flow
_SQL_NEW_CONV = (
    "INSERT INTO conversations (id, name, created_at, updated_at,"
    " render_output_path, meta_json) VALUES (?, ?, ?, ?, NULL, ?)"
)
_SQL_TURNS_FOR = (
    "SELECT * FROM conversation_turns WHERE conversation_id = ?"
    " ORDER BY turn_index ASC"
)
_SQL_TOUCH = "UPDATE conversations SET updated_at = ? WHERE id = ?"
_SQL_NEW_TURN = (
    "INSERT INTO conversation_turns (id, conversation_id, turn_index,"
    " speaker, profile_id, text, audio_path, duration_ms,"
    " effects_json, created_at)"
    " VALUES (?, ?, ?, ?, ?, ?, NULL, NULL, ?, ?)"
)


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


class ConversationManager:
    def __init__(self, store: Store, *, output_dir, default_model: str,
                 default_voice: str, device, profile_manager=None,
                 synthesize_fn=None):
        self._store = store
        self.output_dir = Path(output_dir)
        self.default_model = default_model
        self.default_voice = default_voice
        self.device = device  # the turn effects' device
        self.profile_manager = profile_manager
        self.synthesize_fn = synthesize_fn

    def create(self, name: str, turns: list[dict]) -> dict:
        db = self._store.connection()
        cid = str(uuid4())
        now = _now_iso()
        db.execute(_SQL_NEW_CONV, (cid, name, now, now, json.dumps({})))
        for idx, turn in enumerate(turns or []):
            self._insert_turn(
                db, cid, idx,
                turn.get("speaker") or "Speaker",
                turn.get("text") or "",
                turn.get("profile_id"),
                turn.get("effects"),
            )
        db.commit()
        return self.get(cid) or {}

    def list_all(self, limit=50, offset=0) -> dict:
        db = self._store.connection()
        total = db.execute("SELECT COUNT(*) FROM conversations").fetchone()[0]
        rows = db.execute(
            "SELECT * FROM conversations ORDER BY updated_at DESC LIMIT ? OFFSET ?",
            (int(limit), int(offset)),
        ).fetchall()
        return {"items": [dict(r) for r in rows], "total": total}

    def get(self, conversation_id: str) -> dict | None:
        db = self._store.connection()
        row = db.execute(
            "SELECT * FROM conversations WHERE id = ?", (conversation_id,)
        ).fetchone()
        if not row:
            return None
        conv = dict(row)
        turns = db.execute(_SQL_TURNS_FOR, (conversation_id,)).fetchall()
        conv["turns"] = [self._turn_row(r) for r in turns]
        return conv

    def add_turn(
        self, conversation_id: str, speaker: str, text: str,
        profile_id=None, effects=None,
    ) -> dict:
        db = self._store.connection()
        if not db.execute(
            "SELECT id FROM conversations WHERE id = ?", (conversation_id,)
        ).fetchone():
            raise KeyError(conversation_id)
        idx = db.execute(
            "SELECT COALESCE(MAX(turn_index), -1) + 1 FROM conversation_turns"
            " WHERE conversation_id = ?",
            (conversation_id,),
        ).fetchone()[0]
        turn_id = self._insert_turn(
            db, conversation_id, idx, speaker, text, profile_id, effects
        )
        db.execute(_SQL_TOUCH, (_now_iso(), conversation_id))
        db.commit()
        row = db.execute(
            "SELECT * FROM conversation_turns WHERE id = ?", (turn_id,)
        ).fetchone()
        return self._turn_row(row)

    def delete_turn(self, conversation_id: str, turn_id: str) -> bool:
        db = self._store.connection()
        cur = db.execute(
            "DELETE FROM conversation_turns WHERE id = ? AND conversation_id = ?",
            (turn_id, conversation_id),
        )
        if cur.rowcount <= 0:
            return False
        turns = db.execute(
            _SQL_TURNS_FOR.replace("SELECT *", "SELECT id"), (conversation_id,)
        ).fetchall()
        for idx, row in enumerate(turns):
            db.execute(
                "UPDATE conversation_turns SET turn_index = ? WHERE id = ?",
                (idx, row["id"]),
            )
        db.execute(_SQL_TOUCH, (_now_iso(), conversation_id))
        db.commit()
        return True

    def delete(self, conversation_id: str) -> bool:
        db = self._store.connection()
        cur = db.execute(
            "DELETE FROM conversations WHERE id = ?", (conversation_id,)
        )
        db.commit()
        return cur.rowcount > 0

    def _resolve_turn_settings(self, turn: dict) -> tuple[str, str, float]:
        """Profile-resolved (model, voice, speed) with config fallbacks."""
        profile = None
        if self.profile_manager and turn.get("profile_id"):
            profile = self.profile_manager.get(turn["profile_id"])
        profile = profile or {}
        return (
            profile.get("model") or self.default_model,
            profile.get("voice") or self.default_voice,
            float(profile.get("speed") or 1.0),
        )

    def _render_turn(
        self, db, turn: dict, index: int, out_dir: Path,
        sample_rate: int, save_turn_audio: bool,
    ) -> np.ndarray:
        model, voice, speed = self._resolve_turn_settings(turn)
        samples = self._synthesize_turn(
            text=turn["text"], model=model, voice=voice, speed=speed,
            sample_rate=sample_rate,
        )
        if turn.get("effects"):
            samples = apply_chain(samples, sample_rate, turn["effects"],
                                  device=self.device)
        turn_path = None
        if save_turn_audio:
            turn_path = str(out_dir / f"turn_{index}.wav")
            Path(turn_path).write_bytes(write_wav(samples, sample_rate))
        duration_ms = int(1000 * len(samples) / sample_rate) if len(samples) else 0
        db.execute(
            "UPDATE conversation_turns SET audio_path = ?, duration_ms = ?"
            " WHERE id = ?",
            (turn_path, duration_ms, turn["id"]),
        )
        return samples

    def render(
        self, conversation_id: str, format="wav", sample_rate=24000,
        save_turn_audio=True,
    ) -> dict:
        db = self._store.connection()
        if not db.execute(
            "SELECT * FROM conversations WHERE id = ?", (conversation_id,)
        ).fetchone():
            raise KeyError(conversation_id)
        turns = [
            self._turn_row(r)
            for r in db.execute(_SQL_TURNS_FOR, (conversation_id,)).fetchall()
        ]
        if not turns:
            raise ValueError("Conversation has no turns")

        out_dir = self.output_dir / conversation_id
        out_dir.mkdir(parents=True, exist_ok=True)

        gap = np.zeros(int(sample_rate * SILENCE_MS / 1000), np.float32)
        pieces: list[np.ndarray] = []
        for index, turn in enumerate(turns, start=1):
            if pieces:
                pieces.append(gap)  # 500 ms between turns
            pieces.append(
                self._render_turn(
                    db, turn, index, out_dir, sample_rate, save_turn_audio
                )
            )

        merged = (
            np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        )
        out_ext = format.lower()
        output_path = out_dir / f"render.{out_ext}"
        output_path.write_bytes(encode_audio(merged, sample_rate, out_ext))
        db.execute(
            "UPDATE conversations SET render_output_path = ?, updated_at = ?"
            " WHERE id = ?",
            (str(output_path), _now_iso(), conversation_id),
        )
        db.commit()
        return {
            "conversation_id": conversation_id,
            "output_path": str(output_path),
            "download_url": f"/api/conversations/{conversation_id}/audio",
            "duration_ms": (
                int(1000 * len(merged) / sample_rate) if len(merged) else 0
            ),
            "turn_count": len(turns),
        }

    def _synthesize_turn(self, text, model, voice, speed, sample_rate):
        if self.synthesize_fn is None:
            raise RuntimeError("No synthesis function configured")
        audio = self.synthesize_fn(
            text=text, model=model, voice=voice, speed=speed,
            sample_rate=sample_rate,
        )
        return np.asarray(audio, dtype=np.float32)

    def _insert_turn(
        self, db, conversation_id, idx, speaker, text, profile_id=None,
        effects=None,
    ) -> str:
        turn_id = str(uuid4())
        db.execute(
            _SQL_NEW_TURN,
            (
                turn_id, conversation_id, idx, speaker, profile_id, text,
                json.dumps(effects or []), _now_iso(),
            ),
        )
        return turn_id

    @staticmethod
    def _turn_row(row) -> dict:
        data = dict(row)
        effects_json = data.pop("effects_json", None)
        data["effects"] = json.loads(effects_json) if effects_json else []
        return data
