"""Settings read from the environment (the subset the served path reads).

Counterpart of ``open_speech_tpu/config.py``: the same field names, the same
upper-case environment variables, the same parsing and the same alias
properties, for the fields the REST transcription path (batched long-form
included), the streaming session and the continuous batcher read, and the
device Kokoro's weights are made on. ``stt_device`` defaults to ``cuda``;
``tts_device`` defaults to ``stt_device``.
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
    # streaming sessions (/v1/audio/stream)
    "os_stream_chunk_ms": 100,
    "os_stream_max_connections": 10,
    "stt_vad_enabled": True,
    "stt_vad_threshold": 0.5,
    # interims over the O(n) block-causal incremental encoder
    "os_stream_incremental": True,
    # the continuous slot-pool batcher behind streaming sessions
    "os_batcher_enabled": False,
    "os_batch_max_sessions": 8,
    # decode positions per batcher tick (one host sync per tick)
    "os_batch_steps_per_tick": 4,
    "os_batch_max_tokens": 448,
    # batched long-form REST: chunks of one window, decoded as a batch
    "os_stt_batched_longform": False,
    "os_stt_batch_windows": 16,
    # TTS (Kokoro) runs here; None means the STT device
    "tts_device": None,
}

_OPTIONAL_STR = {"stt_model_dir", "tts_device"}


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

    # ── aliases of the JAX package's Settings ────────────────────────
    stt_stream_chunk_ms = property(lambda self: self.os_stream_chunk_ms)
    stt_stream_max_connections = property(lambda self: self.os_stream_max_connections)
    stt_default_model = property(lambda self: self.stt_model)

    @property
    def tts_effective_device(self) -> str:
        return self.tts_device or self.stt_device


settings = Settings()
