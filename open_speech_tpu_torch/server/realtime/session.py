"""Realtime session configuration state.

Covers the subset of OpenAI Realtime ``session.update`` the server honors
(reference behavior: src/realtime/session.py): audio formats, voice, model,
transcription config, and server-VAD turn detection.
"""

from __future__ import annotations

import uuid
from dataclasses import asdict, dataclass, field
from typing import Any

VALID_AUDIO_FORMATS = {"pcm16", "g711_ulaw", "g711_alaw"}

FORMAT_SAMPLE_RATES = {"pcm16": 24000, "g711_ulaw": 8000, "g711_alaw": 8000}


@dataclass
class TurnDetectionConfig:
    type: str = "server_vad"
    threshold: float = 0.5
    prefix_padding_ms: int = 300
    silence_duration_ms: int = 500
    create_response: bool = False  # audio I/O only — no LLM responses

    # field -> coercion applied when a session.update provides it
    _COERCE = {
        "type": str,
        "threshold": float,
        "prefix_padding_ms": int,
        "silence_duration_ms": int,
        "create_response": bool,
    }

    def apply(self, update: dict[str, Any]) -> None:
        for key, cast in self._COERCE.items():
            if key in update:
                setattr(self, key, cast(update[key]))


def _new_session_id() -> str:
    return f"sess_{uuid.uuid4().hex[:24]}"


@dataclass
class SessionConfig:
    id: str = field(default_factory=_new_session_id)
    model: str = ""
    voice: str = "alloy"
    input_audio_format: str = "pcm16"
    output_audio_format: str = "pcm16"
    input_audio_transcription: dict[str, Any] | None = field(
        default_factory=lambda: {"model": "whisper-1"}
    )
    turn_detection: TurnDetectionConfig | None = field(
        default_factory=TurnDetectionConfig
    )

    @property
    def vad_enabled(self) -> bool:
        td = self.turn_detection
        return td is not None and td.type == "server_vad"

    def to_dict(self) -> dict[str, Any]:
        td = self.turn_detection
        return {
            "id": self.id,
            "object": "realtime.session",
            "model": self.model,
            "voice": self.voice,
            "input_audio_format": self.input_audio_format,
            "output_audio_format": self.output_audio_format,
            "input_audio_transcription": self.input_audio_transcription,
            "turn_detection": (
                {k: v for k, v in asdict(td).items()} if td else None
            ),
            "modalities": ["audio", "text"],
        }

    def update_from(self, data: dict[str, Any]) -> None:
        payload = data.get("session", data)

        if payload.get("model"):
            self.model = str(payload["model"])
        if "voice" in payload:
            self.voice = payload["voice"]
        for fmt_field in ("input_audio_format", "output_audio_format"):
            candidate = payload.get(fmt_field)
            if candidate in VALID_AUDIO_FORMATS:
                setattr(self, fmt_field, candidate)
        if "input_audio_transcription" in payload:
            self.input_audio_transcription = payload["input_audio_transcription"]

        if "turn_detection" not in payload:
            return
        td_update = payload["turn_detection"]
        if td_update is None:
            self.turn_detection = None
        else:
            if self.turn_detection is None:
                self.turn_detection = TurnDetectionConfig()
            self.turn_detection.apply(td_update)
