"""Multi-track composer.

Counterpart of ``open_speech_tpu/studio/composer.py`` on the app's
``Store``: mute/solo selection, the data-root path allow-list,
per-track effects (the port's ``apply_chain``), volume and offset, the
polyphase resample to the mix rate (``ops/resample.py:resample_poly``),
sum+clip mix, WAV/MP3 renders persisted in the compositions table. The
effects and the resample run on ``device``, which the app names (its TTS
device); a CUDA device on a host without CUDA raises.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from uuid import uuid4

import numpy as np

import torch

from open_speech_tpu_torch.audio.effects import apply_chain
from open_speech_tpu_torch.audio.encode import encode_audio
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.ops.resample import resample_poly
from open_speech_tpu_torch.studio.storage import Store


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


class MultiTrackComposer:
    def __init__(self, store: Store, *, output_dir, conversations_dir,
                 voice_library_path, device) -> None:
        self._store = store
        self.device = torch.device(device)
        # the configured directories, as the allow-list names them
        self.roots = (Path(conversations_dir), Path(output_dir),
                      Path(voice_library_path))
        self.output_dir = Path(output_dir)
        try:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        except PermissionError:
            self.output_dir = (Path.cwd() / "data" / "composer").resolve()
            self.output_dir.mkdir(parents=True, exist_ok=True)

    # ── rendering ─────────────────────────────────────────────────────

    def _prepare_track(self, track: dict, sample_rate: int) -> tuple[dict, np.ndarray]:
        """Validate, load, apply effects/volume, resample to the mix rate."""
        source_path = self._validate_source_path(track.get("source_path", ""))
        src_rate, samples = self._load_audio(source_path)
        samples = apply_chain(samples, src_rate, track.get("effects") or [],
                              device=self._render_device())
        volume = float(track.get("volume", 1.0))
        samples = (samples * volume).astype(np.float32, copy=False)
        if int(src_rate) != int(sample_rate):
            samples = self._resample(samples, int(src_rate), int(sample_rate))
        meta = {
            "offset_s": float(track.get("offset_s", 0.0)),
            "source_path": str(source_path),
            "volume": volume,
            "muted": bool(track.get("muted", False)),
            "solo": bool(track.get("solo", False)),
            "effects": track.get("effects") or [],
        }
        return meta, samples

    def render(
        self, tracks: list[dict], format: str = "wav",
        sample_rate: int = 24000, name: str | None = None,
    ) -> dict:
        active = self._active_tracks(tracks)
        if not active:
            raise ValueError("No active tracks to render")

        persisted: list[dict] = []
        prepared: list[dict] = []
        for track in active:
            meta, samples = self._prepare_track(track, int(sample_rate))
            persisted.append(meta)
            prepared.append({**meta, "samples": samples})

        mixed = self._mix_prepared(prepared, int(sample_rate))

        composition_id = str(uuid4())
        out_ext = "mp3" if str(format).lower() == "mp3" else "wav"
        output_path = self.output_dir / f"render_{composition_id}.{out_ext}"
        output_path.write_bytes(encode_audio(mixed, int(sample_rate), out_ext))

        rel_output_path = self._relative_to_repo(output_path)
        duration_ms = int(1000 * len(mixed) / int(sample_rate)) if len(mixed) else 0
        self._save_composition(
            composition_id, name, int(sample_rate), rel_output_path,
            persisted, {"format": out_ext, "duration_ms": duration_ms},
        )
        return {
            "composition_id": composition_id,
            "output_path": rel_output_path,
            "download_url": f"/api/composer/render/{composition_id}/audio",
            "duration_ms": duration_ms,
        }

    def list_renders(self, limit: int = 100, offset: int = 0) -> dict:
        db = self._store.connection()
        total = db.execute("SELECT COUNT(*) FROM compositions").fetchone()[0]
        rows = db.execute(
            "SELECT * FROM compositions ORDER BY updated_at DESC LIMIT ? OFFSET ?",
            (int(limit), int(offset)),
        ).fetchall()
        return {
            "items": [self._row_to_render(r) for r in rows],
            "total": total,
            "limit": int(limit),
            "offset": int(offset),
        }

    def get_render(self, composition_id: str) -> dict | None:
        row = self._store.connection().execute(
            "SELECT * FROM compositions WHERE id = ?", (composition_id,)
        ).fetchone()
        return self._row_to_render(row) if row else None

    def delete_render(self, composition_id: str) -> bool:
        db = self._store.connection()
        row = db.execute(
            "SELECT render_output_path FROM compositions WHERE id = ?",
            (composition_id,),
        ).fetchone()
        if not row:
            return False
        output_path = self._resolve_repo_path(row["render_output_path"])
        if output_path.exists():
            output_path.unlink()
        db.execute("DELETE FROM compositions WHERE id = ?", (composition_id,))
        db.commit()
        return True

    # ── track selection / validation ──────────────────────────────────

    @staticmethod
    def _active_tracks(tracks: list[dict]) -> list[dict]:
        non_muted = [t for t in tracks if not bool(t.get("muted", False))]
        if any(bool(t.get("solo", False)) for t in non_muted):
            return [t for t in non_muted if bool(t.get("solo", False))]
        return non_muted

    def _validate_source_path(self, source_path: str) -> Path:
        if not source_path:
            raise ValueError("Track source_path is required")
        resolved = self._resolve_repo_path(Path(source_path))
        if not resolved.exists():
            raise ValueError(f"Track source not found: {source_path}")
        repo_data = self._resolve_repo_path(Path("data"))
        allowed_roots = {
            repo_data,
            *self.roots,
            Path("/home/openspeech/data"),
        }
        if not any(self._is_relative_to(resolved, r) for r in allowed_roots):
            raise PermissionError(
                f"Track source path is outside allowed roots: {source_path}"
            )
        return resolved

    @staticmethod
    def _load_audio(source_path: Path) -> tuple[int, np.ndarray]:
        audio, sr = codec.read_wav(source_path.read_bytes())
        return int(sr), audio

    def _render_device(self) -> torch.device:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: the composer renders on "
                               f"{self.device}")
        return self.device

    def _resample(self, samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(samples, np.float32))
        with torch.inference_mode():
            y = resample_poly(x.to(self._render_device()), dst_rate, src_rate)
            return y.cpu().numpy().astype(np.float32, copy=False)

    @staticmethod
    def _mix_prepared(prepared: list[dict], sample_rate: int) -> np.ndarray:
        def start_of(track: dict) -> int:
            return int(round(max(0.0, track["offset_s"]) * sample_rate))

        placements = [
            (start_of(t), np.asarray(t["samples"], np.float32))
            for t in prepared
        ]
        total = max((s + len(x) for s, x in placements), default=0)
        if total <= 0:
            return np.zeros(0, np.float32)
        mixed = np.zeros(total, np.float32)
        for start, samples in placements:
            mixed[start : start + len(samples)] += samples
        return np.clip(mixed, -1.0, 1.0)

    # ── persistence helpers ───────────────────────────────────────────

    def _save_composition(
        self, composition_id, name, sample_rate, output_path, tracks, meta
    ) -> None:
        db = self._store.connection()
        now = _now_iso()
        db.execute(
            "INSERT INTO compositions (id, name, sample_rate, created_at,"
            " updated_at, render_output_path, tracks_json, meta_json)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
            (
                composition_id, name, sample_rate, now, now, output_path,
                json.dumps(tracks), json.dumps(meta),
            ),
        )
        db.commit()

    @staticmethod
    def _row_to_render(row) -> dict:
        data = dict(row)
        data["tracks"] = json.loads(data.pop("tracks_json") or "[]")
        data["meta"] = json.loads(data.pop("meta_json") or "{}")
        return data

    @staticmethod
    def _relative_to_repo(path: Path) -> str:
        try:
            return str(path.resolve().relative_to(Path.cwd().resolve()))
        except ValueError:
            return str(path)

    @staticmethod
    def _resolve_repo_path(source_path) -> Path:
        p = Path(source_path)
        return p.resolve() if p.is_absolute() else (Path.cwd() / p).resolve()

    @staticmethod
    def _is_relative_to(path: Path, root: Path) -> bool:
        try:
            path.relative_to(root.resolve())
            return True
        except ValueError:
            return False
