"""Settings read from the environment (the subset the served path reads).

Counterpart of ``open_speech_tpu/config.py``: the same field names, the same
upper-case environment variables, the same parsing and the same alias
properties, for the fields the REST transcription path (batched long-form,
int8 compute and speculative decoding included), the streaming session,
the continuous batcher, Kokoro serving (``POST /v1/audio/speech``'s
body, the backend and the TTS batcher), the HTTP server (``server/``:
binding, TLS, auth, CORS, rate limits, upload size, preloads), the
realtime socket, the Wyoming server, model management and its TTL/LRU
lifecycle, the profiler routes, Pocket's slot-pool batcher, the Studio
(voice library, profiles, history, conversations, composer) and the TTS
cache read. ``os_vad_device``
(``OS_VAD_DEVICE``, which the JAX package reads from the environment
directly) names the VAD's device; its default is the STT device. ``stt_device`` defaults to ``cuda``; ``tts_device`` defaults to
``stt_device``.
"""

from __future__ import annotations

import os

_TRUTHY = {"1", "true", "yes", "on", "t", "y"}
_FALSY = {"0", "false", "no", "off", "f", "n", ""}

# field -> default; each is read from the upper-case env var of its name
_DEFAULTS: dict[str, object] = {
    # the server (python -m open_speech_tpu_torch.server)
    "os_port": 8100,
    "os_host": "0.0.0.0",
    "os_api_key": "",
    "os_auth_required": False,
    "os_cors_origins": "*",
    "os_ws_allowed_origins": "",
    "os_trust_proxy": False,
    "os_max_upload_mb": 100,
    "os_rate_limit": 0,
    "os_rate_limit_burst": 0,
    "os_ssl_enabled": True,
    "os_ssl_certfile": "",
    "os_ssl_keyfile": "",
    # model lifecycle: idle seconds before a non-default model is evicted,
    # and the most STT models kept loaded (0 = no limit)
    "os_model_ttl": 300,
    "os_max_loaded_models": 0,
    "os_precompile_on_load": True,
    # torch.profiler trace output dir for /api/profiler/start|stop
    "os_profile_dir": "/tmp/open-speech-profile",
    "os_stt_precompile_budgets": "224",
    "stt_model": "whisper-large-v3-turbo",
    "stt_rest_beam_size": 5,
    "stt_device": "cuda",
    "stt_compute_type": "bfloat16",
    "stt_model_dir": None,
    "stt_normalize": True,
    "stt_noise_reduce": False,
    "stt_diarize_enabled": False,
    "stt_preload_models": "",
    # streaming sessions (/v1/audio/stream)
    "os_stream_chunk_ms": 100,
    "os_stream_max_connections": 10,
    "stt_vad_enabled": True,
    "stt_vad_threshold": 0.5,
    # Wyoming's speech-segment extraction
    "stt_vad_min_speech_ms": 250,
    "stt_vad_silence_ms": 800,
    # the VAD's device: "default" is the STT device; "cpu" or any torch device
    "os_vad_device": "default",
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
    # the Wyoming TCP server (Home Assistant), started with the app
    "os_wyoming_enabled": False,
    "os_wyoming_host": "127.0.0.1",
    "os_wyoming_port": 10400,
    # the OpenAI Realtime socket, /v1/realtime
    "os_realtime_enabled": True,
    "os_realtime_max_buffer_mb": 50,
    "os_realtime_idle_timeout_s": 120,
    # speculative decoding: the draft model's id ("" = off) and the tokens
    # it proposes per verify pass (batch-1 temperature-0 greedy REST decodes)
    "os_spec_draft_model": "",
    "os_spec_gamma": 4,
    # TTS (Kokoro) runs here; None means the STT device
    "tts_device": None,
    # POST /v1/audio/speech
    "tts_enabled": True,
    "tts_model": "kokoro",
    "tts_voice": "af_heart",
    "tts_max_input_length": 4096,
    "tts_default_format": "mp3",
    "tts_speed": 1.0,
    "tts_trim_silence": True,
    "tts_normalize_output": True,
    "tts_pronunciation_dict": "",
    "tts_preload_models": "",
    # speech effects (DSP) on a whole-body /v1/audio/speech request
    "os_effects_enabled": True,
    # concurrent Kokoro and Piper requests share one batched encode +
    # blockwise vocode; Pocket sessions share the slot-pool batcher
    "os_tts_batcher_enabled": False,
    # rows of the TTS batcher's warmup batch at load: the largest entry
    "os_tts_precompile_buckets": "1,4,16,64",
    # Pocket's slot pool: concurrent sessions per pool group (sizes the
    # card's KV pool, 2*L*slots*H*max_ctx*Dh entries), and the frames each
    # group advances every session (one host sync, one Mimi block)
    "os_pocket_batch_slots": 16,
    "os_pocket_block_frames": 2,
    # the Studio: voice library, SQLite store, history, renders
    "os_voice_library_path": "/home/openspeech/data/voices",
    "os_voice_library_max_count": 100,
    "os_studio_db_path": "/home/openspeech/data/studio.db",
    "os_history_enabled": True,
    "os_history_max_entries": 1000,
    "os_history_retain_audio": True,
    "os_history_max_mb": 2000,
    "os_conversations_dir": "/home/openspeech/data/conversations",
    "os_composer_dir": "/home/openspeech/data/composer",
    # GET /api/voice-presets reads TTS_VOICES_CONFIG from the environment
    # per request, as the JAX app does; the field mirrors it
    "tts_voices_config": "",
    # the disk cache of whole /v1/audio/speech bodies
    "tts_cache_enabled": False,
    "tts_cache_max_mb": 500,
    "tts_cache_dir": "/var/lib/open-speech/cache",
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
    stt_port = property(lambda self: self.os_port)
    stt_host = property(lambda self: self.os_host)
    stt_api_key = property(lambda self: self.os_api_key)
    stt_cors_origins = property(lambda self: self.os_cors_origins)
    stt_trust_proxy = property(lambda self: self.os_trust_proxy)
    stt_ws_allowed_origins = property(lambda self: self.os_ws_allowed_origins)
    stt_max_upload_mb = property(lambda self: self.os_max_upload_mb)
    stt_rate_limit = property(lambda self: self.os_rate_limit)
    stt_rate_limit_burst = property(lambda self: self.os_rate_limit_burst)
    stt_ssl_enabled = property(lambda self: self.os_ssl_enabled)
    stt_ssl_certfile = property(lambda self: self.os_ssl_certfile)
    stt_ssl_keyfile = property(lambda self: self.os_ssl_keyfile)
    stt_model_ttl = property(lambda self: self.os_model_ttl)
    stt_max_loaded_models = property(lambda self: self.os_max_loaded_models)
    stt_stream_chunk_ms = property(lambda self: self.os_stream_chunk_ms)
    stt_stream_max_connections = property(lambda self: self.os_stream_max_connections)
    voice_library_path = property(lambda self: self.os_voice_library_path)
    voice_library_max_count = property(lambda self: self.os_voice_library_max_count)
    stt_default_model = property(lambda self: self.stt_model)
    tts_default_model = property(lambda self: self.tts_model)
    tts_default_voice = property(lambda self: self.tts_voice)
    tts_default_speed = property(lambda self: self.tts_speed)

    @property
    def tts_effective_device(self) -> str:
        return self.tts_device or self.stt_device


settings = Settings()
