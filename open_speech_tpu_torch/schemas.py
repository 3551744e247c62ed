"""API records of the served path.

Counterpart of ``open_speech_tpu/schemas.py``. The JAX package builds these
with pydantic, which the card's machine does not have; the port uses
dataclasses with the same fields and defaults.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field


@dataclass
class LoadedModelInfo:
    model: str
    backend: str
    device: str
    compute_type: str
    loaded_at: float
    last_used_at: float | None = None
    is_default: bool = False
    ttl_remaining: float | None = None


# ── the server's records (GET /v1/models, /health) ──────────────────


@dataclass
class ModelObject:
    id: str
    object: str = "model"
    created: int = field(default_factory=lambda: int(time.time()))
    owned_by: str = "open-speech"

    def model_dump(self) -> dict:
        return asdict(self)


@dataclass
class ModelListResponse:
    object: str = "list"
    data: list[ModelObject] = field(default_factory=list)

    def model_dump(self) -> dict:
        return asdict(self)


@dataclass
class HealthResponse:
    version: str
    status: str = "ok"
    models_loaded: int = 0

    def model_dump(self) -> dict:
        return {"status": self.status, "version": self.version, "models_loaded": self.models_loaded}


# ── TTS ────────────────────────────────────────────────────────────────

_SPEED_GE, _SPEED_LE = 0.25, 4.0


@dataclass
class TTSSpeechRequest:
    """OpenAI-compatible speech request: the JAX package's fields and
    defaults. ``from_body`` validates a JSON body as pydantic does in lax
    mode and raises ``ValueError`` with pydantic's message, without the
    ``[type=...]`` tail and the documentation link."""

    input: str
    model: str = "kokoro"
    voice: str = "alloy"
    response_format: str = "mp3"
    speed: float = 1.0
    voice_design: str | None = None
    reference_audio: str | None = None  # base64 or URL of reference audio
    language: str | None = None
    clone_transcript: str | None = None
    input_type: str = "text"  # "text" | "ssml"
    effects: list[dict] | None = None

    @classmethod
    def from_body(cls, body: dict) -> "TTSSpeechRequest":
        errors: list[str] = []
        values: dict = {}
        for name in _FIELD_ORDER:  # pydantic reports errors in this order
            if name not in body:
                if name == "input":
                    errors.append("input\n  Field required")
                continue
            value, problems = _check(name, body[name])
            errors += problems
            if not problems:
                values[name] = value
        if errors:
            n = len(errors)
            head = f"{n} validation error{'s' if n > 1 else ''} for {cls.__name__}"
            raise ValueError("\n".join([head, *errors]))
        return cls(**values)


_FIELD_ORDER = ("model", "input", "voice", "response_format", "speed", "voice_design",
                "reference_audio", "language", "clone_transcript", "input_type", "effects")
_OPTIONAL = {"voice_design", "reference_audio", "language", "clone_transcript", "effects"}


def _check(name: str, value) -> tuple[object, list[str]]:
    """(value as the field holds it, ["<loc>\\n  <message>", ...])."""
    if value is None and name in _OPTIONAL:
        return None, []
    if name == "speed":
        speed, message = _lax_float(value)
        if message is None and not speed <= _SPEED_LE:
            message = f"Input should be less than or equal to {_SPEED_LE:g}"
        elif message is None and not speed >= _SPEED_GE:
            message = f"Input should be greater than or equal to {_SPEED_GE:g}"
        return speed, [] if message is None else [f"speed\n  {message}"]
    if name == "effects":
        if not isinstance(value, list):
            return value, ["effects\n  Input should be a valid list"]
        return value, [f"effects.{i}\n  Input should be a valid dictionary"
                       for i, e in enumerate(value) if not isinstance(e, dict)]
    if not isinstance(value, str):
        return value, [f"{name}\n  Input should be a valid string"]
    return value, []


def _lax_float(value) -> tuple[float, str | None]:
    """pydantic's lax float: numbers and bools, and strings that parse."""
    if isinstance(value, (bool, int, float)):
        return float(value), None
    if isinstance(value, str):
        try:
            return float(value), None
        except ValueError:
            return 0.0, "Input should be a valid number, unable to parse string as a number"
    return 0.0, "Input should be a valid number"
