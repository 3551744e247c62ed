"""Settings read from the environment (the subset the served path reads).

Counterpart of ``open_speech_tpu/config.py``: the same field names, the same
upper-case environment variables and the same parsing, for the fields the
REST transcription path reads. ``stt_device`` defaults to ``cuda``.
"""

from __future__ import annotations

import os

_TRUTHY = {"1", "true", "yes", "on", "t", "y"}
_FALSY = {"0", "false", "no", "off", "f", "n", ""}

# field -> default; each is read from the upper-case env var of its name
_DEFAULTS: dict[str, object] = {
    "os_model_ttl": 300,
    "os_precompile_on_load": True,
    "os_stt_precompile_budgets": "224",
    "stt_model": "whisper-large-v3-turbo",
    "stt_rest_beam_size": 5,
    "stt_device": "cuda",
    "stt_compute_type": "bfloat16",
    "stt_model_dir": None,
    "stt_normalize": True,
}

_OPTIONAL_STR = {"stt_model_dir"}


def _parse(raw: str, default):
    """Parse an env string according to the default's type."""
    if isinstance(default, bool):
        low = raw.strip().lower()
        if low in _TRUTHY:
            return True
        if low in _FALSY:
            return False
        raise ValueError(f"invalid boolean: {raw!r}")
    if isinstance(default, int):
        return int(raw.strip())
    if isinstance(default, float):
        return float(raw.strip())
    return raw


class Settings:
    """Flat settings object."""

    def __init__(self, env: dict[str, str] | None = None) -> None:
        env = dict(os.environ if env is None else env)
        # case-insensitive env lookup
        upper = {k.upper(): v for k, v in env.items()}
        for name, default in _DEFAULTS.items():
            raw = upper.get(name.upper())
            if raw is None:
                value = default
            elif name in _OPTIONAL_STR:
                value = raw
            else:
                value = _parse(raw, default)
            setattr(self, name, value)


settings = Settings()

