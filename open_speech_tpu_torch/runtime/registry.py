"""Curated model catalog.

Same catalog contents as the reference registry (src/model_registry.py) —
native ``whisper-*`` ids are primary, the reference's CT2-era repo ids stay
listed as aliases so existing configurations resolve. Rows are stored as
compact tuples and expanded to the dict shape the management API serves.
"""

from __future__ import annotations

_STT_DESCRIPTIONS = {
    "tiny": "Fastest, lowest quality",
    "base": "Good balance",
    "small": "Better accuracy",
    "medium": "High accuracy",
    "tiny.en": "English-only tiny model",
    "base.en": "English-only base model",
    "small.en": "English-only small model",
    "medium.en": "English-only medium model",
    "large-v2": "Large-v2, high accuracy",
    "large-v3": "Large-v3, high accuracy",
    "large-v3-turbo": "Large-v3-turbo, near large-v3 accuracy at 3-4x speed",
    "distil-large-v3": "Distil-large-v3, near large-v3 quality at half size",
    "distil-small.en": "Distil small.en, English-only, shallow decoder",
    "distil-medium.en": "Distil medium.en, English-only, shallow decoder",
}

_STT_SIZES = {
    "tiny": 75, "tiny.en": 75, "base": 150, "base.en": 150,
    "small": 500, "small.en": 500, "medium": 1500, "medium.en": 1500,
    "large-v2": 2900, "large-v3": 3000, "large-v3-turbo": 1600,
    "distil-large-v3": 1500, "distil-small.en": 350, "distil-medium.en": 800,
}

# (alias id, preset) — reference CT2 repo ids mapped onto the same models
_STT_ALIASES = (
    ("Systran/faster-whisper-tiny", "tiny"),
    ("Systran/faster-whisper-tiny.en", "tiny.en"),
    ("Systran/faster-whisper-base", "base"),
    ("Systran/faster-whisper-base.en", "base.en"),
    ("Systran/faster-whisper-small", "small"),
    ("Systran/faster-whisper-small.en", "small.en"),
    ("Systran/faster-whisper-medium", "medium"),
    ("Systran/faster-whisper-medium.en", "medium.en"),
    ("Systran/faster-whisper-large-v2", "large-v2"),
    ("Systran/faster-whisper-large-v3", "large-v3"),
    ("deepdml/faster-whisper-large-v3-turbo-ct2", "large-v3-turbo"),
    ("Systran/faster-distil-whisper-small.en", "distil-small.en"),
    ("Systran/faster-distil-whisper-medium.en", "distil-medium.en"),
    ("Systran/faster-distil-whisper-large-v3", "distil-large-v3"),
)

# (short id, size_mb, description) for the piper voice catalog
_PIPER_VOICES = (
    ("en_US-lessac-low", 6, "US English - Lessac, low quality"),
    ("en_US-lessac-medium", 35, "US English - Lessac voice"),
    ("en_US-lessac-high", 75, "US English - Lessac, high quality"),
    ("en_US-amy-medium", 35, "US English - Amy voice"),
    ("en_US-amy-high", 75, "US English - Amy, high quality"),
    ("en_US-arctic-medium", 35, "US English - Arctic voice"),
    ("en_US-bryce-medium", 35, "US English - Bryce voice"),
    ("en_US-danny-low", 6, "US English - Danny, low quality"),
    ("en_US-hfc_female-medium", 35, "US English - HFC female voice"),
    ("en_US-hfc_male-medium", 35, "US English - HFC male voice"),
    ("en_US-joe-medium", 35, "US English - Joe voice"),
    ("en_US-john-medium", 35, "US English - John voice"),
    ("en_US-kathleen-low", 6, "US English - Kathleen, low quality"),
    ("en_US-kusal-medium", 35, "US English - Kusal voice"),
    ("en_US-libritts_r-medium", 35, "US English - LibriTTS-R voice"),
    ("en_US-ljspeech-medium", 35, "US English - LJSpeech voice"),
    ("en_US-ljspeech-high", 75, "US English - LJSpeech, high quality"),
    ("en_US-norman-medium", 35, "US English - Norman voice"),
    ("en_US-ryan-low", 6, "US English - Ryan, low quality"),
    ("en_US-ryan-medium", 35, "US English - Ryan voice"),
    ("en_US-ryan-high", 75, "US English - Ryan, high quality"),
    ("en_GB-alan-low", 6, "British English - Alan, low quality"),
    ("en_GB-alan-medium", 35, "British English - Alan voice"),
    ("en_GB-cori-medium", 35, "British English - Cori voice"),
    ("en_GB-cori-high", 75, "British English - Cori, high quality"),
    ("en_GB-jenny_dioco-medium", 35, "British English - Jenny Dioco voice"),
    ("en_GB-northern_english_male-medium", 35,
     "British English - Northern English male voice"),
    ("en_GB-semaine-medium", 35, "British English - Semaine voice"),
    ("en_GB-southern_english_female-low", 6,
     "British English - Southern English female, low quality"),
    ("en_GB-southern_english_female-medium", 35,
     "British English - Southern English female voice"),
)


def _stt_row(model_id: str, preset: str, source: str) -> dict:
    return {
        "id": model_id,
        "type": "stt",
        "provider": "jax-whisper",
        "source": source,
        "model_format": "jax",
        "size_mb": _STT_SIZES[preset],
        "description": (
            _STT_DESCRIPTIONS[preset]
            if model_id.startswith("whisper-")
            else f"Alias of whisper-{preset}"
        ),
    }


def _build_catalog() -> list[dict]:
    rows: list[dict] = []
    for preset in _STT_DESCRIPTIONS:
        source = "distil-whisper" if preset.startswith("distil") else "openai"
        rows.append(_stt_row(f"whisper-{preset}", preset, source))
    for alias, preset in _STT_ALIASES:
        rows.append(_stt_row(alias, preset, alias.split("/")[0]))
    rows.append(
        {
            "id": "kokoro", "type": "tts", "provider": "kokoro",
            "size_mb": 330, "description": "Fast, 52 voices, voice blending",
        }
    )
    rows.append(
        {
            "id": "pocket-tts", "type": "tts", "provider": "pocket-tts",
            "size_mb": 220,
            "description": (
                "Low-latency streaming TTS with voice cloning and voice design"
            ),
        }
    )
    for short_id, size_mb, description in _PIPER_VOICES:
        rows.append(
            {
                "id": f"piper/{short_id}", "type": "tts", "provider": "piper",
                "size_mb": size_mb, "description": description,
            }
        )
    return rows


KNOWN_MODELS: list[dict] = _build_catalog()

_BY_ID = {row["id"]: row for row in KNOWN_MODELS}


def get_known_models() -> list[dict]:
    return [row.copy() for row in KNOWN_MODELS]


def get_known_model(model_id: str) -> dict | None:
    row = _BY_ID.get(model_id)
    return row.copy() if row else None
