"""Voice spec parsing and blending weights.

Grammar (reference behavior, src/tts/voices.py): a voice is either an
OpenAI alias, a single voice id, or a ``+``-joined blend where each
component may carry a numeric weight in parentheses —
``af_bella(2)+af_sky(1)``. Weights normalize to sum to one.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# OpenAI-compatible voice names resolve to kokoro ids
OPENAI_VOICE_MAP: dict[str, str] = {
    "alloy": "af_heart",
    "echo": "am_adam",
    "fable": "bf_emma",
    "onyx": "am_michael",
    "nova": "af_nova",
    "shimmer": "af_bella",
}

_PART = re.compile(r"^([A-Za-z0-9_]+)(?:\((\d+(?:\.\d+)?)\))?$")


@dataclass
class VoiceComponent:
    voice_id: str
    weight: float = 1.0


@dataclass
class VoiceSpec:
    components: list[VoiceComponent]

    @property
    def is_blend(self) -> bool:
        return len(self.components) > 1

    @property
    def primary_id(self) -> str:
        return self.components[0].voice_id

    def normalized_weights(self) -> list[float]:
        total = sum(c.weight for c in self.components)
        n = len(self.components)
        if total == 0:
            return [1.0 / n] * n
        return [c.weight / total for c in self.components]


def resolve_voice_name(voice: str) -> str:
    """Map an OpenAI alias to its backend voice id (identity otherwise)."""
    return OPENAI_VOICE_MAP.get(voice, voice)


def _parse_component(text: str) -> VoiceComponent:
    match = _PART.match(text.strip())
    if match is None:
        raise ValueError(f"Invalid voice spec component: {text.strip()!r}")
    weight = match.group(2)
    return VoiceComponent(
        voice_id=match.group(1),
        weight=float(weight) if weight else 1.0,
    )


def parse_voice_spec(voice: str) -> VoiceSpec:
    """``'af_bella(2)+af_sky(1)'`` -> weighted VoiceSpec.

    Aliases only resolve for bare single names (a blend of aliases is not a
    thing in the reference either).
    """
    if "+" not in voice and "(" not in voice:
        voice = resolve_voice_name(voice)
    return VoiceSpec(components=[_parse_component(p) for p in voice.split("+")])
