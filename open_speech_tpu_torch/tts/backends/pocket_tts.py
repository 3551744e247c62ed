"""Pocket-TTS backend on the card: streaming Mimi-LM TTS with audio-prompt
voice cloning.

Counterpart of ``open_speech_tpu/tts/backends/pocket_tts.py``, with the
same surface: 8 named speakers, the capabilities (streaming, voice clone,
voice design, no speed control), ``pocket/<name>`` voices, and a
generator of float32 chunks at 24 kHz. Voices are audio prompts:

- a named speaker resolves to ``<name>.wav`` under ``OS_POCKET_VOICES_DIR``
  or, without one, to a deterministic synthetic prompt (the JAX backend's
  bytes);
- ``reference_audio`` (clone) is a WAV whose clip is encoded by Mimi and
  teacher-forced into the LM's KV caches;
- ``voice_design`` maps the description to a synthetic prompt.

The warmed prompt states are cached per voice (LRU, 8 entries) and are
never written: a generation works on a copy, and the batcher copies a
state into its pool row. With ``OS_TTS_BATCHER_ENABLED`` concurrent
requests share the slot-pool batcher (``runtime/pocket_batcher.py``).

Weights come from ``OS_POCKET_CKPT_PATH`` or the HF cache
(``kyutai/pocket-tts``); without a checkpoint the model has random weights
from ``torch.Generator`` seed 11 at ``OS_POCKET_PRESET`` (``tiny``, the
default: the test geometry with max_ctx 512; ``base``: the full
``PocketLMConfig()`` + ``MimiConfig()``). Those differ from the JAX
backend's ``jax.random`` weights (``ROADMAP.md``, "By design"). The model
lives on ``settings.tts_effective_device`` unless the caller names a
device.
"""

from __future__ import annotations

import glob
import hashlib
import logging
import os
import time
from dataclasses import replace
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.pocket import (
    MIMI_TEST_TINY,
    TEST_TINY_LM,
    MimiConfig,
    PocketLMConfig,
    PocketTTS,
    PromptState,
)
from open_speech_tpu_torch.models.pocket.model import SAMPLE_RATE
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.tts.backends.base import (
    DEFAULT_TTS_CAPABILITIES,
    TTSLoadedModelInfo,
    VoiceInfo,
)

logger = logging.getLogger(__name__)

# the reference pocket-tts speaker set
SPEAKERS = ["alice", "bob", "carol", "dave", "eve", "frank", "grace", "henry"]

_PROMPT_SECONDS = 0.5  # the synthetic prompt's length
_PROMPT_CACHE_MAX = 8  # warmed KV caches are large: bound the cache
_RANDOM_SEED = 11


def _synthetic_prompt(seed_text: str, sample_rate: int) -> np.ndarray:
    """A deterministic speech-band prompt clip for a name or description
    (a few seeded harmonics under an envelope, normalized): the JAX
    backend's bytes. Distinct seeds give distinct cloned voices."""
    seed = int.from_bytes(hashlib.sha256(seed_text.encode()).digest()[:4], "big")
    rng = np.random.default_rng(seed)
    n = int(_PROMPT_SECONDS * sample_rate)
    t = np.arange(n) / sample_rate
    f0 = 80.0 + 160.0 * rng.random()
    sig = np.zeros(n, np.float32)
    for h in range(1, 6):
        sig += (rng.random() * 0.5 / h) * np.sin(2 * np.pi * f0 * h * t + rng.random() * 6.28).astype(np.float32)
    sig += 0.05 * rng.standard_normal(n).astype(np.float32)
    env = 0.5 - 0.5 * np.cos(2 * np.pi * np.minimum(t / t[-1], 1.0))
    sig *= env.astype(np.float32)
    peak = np.abs(sig).max() or 1.0
    return (0.6 * sig / peak).astype(np.float32)


def preset_configs(preset: str) -> tuple[PocketLMConfig, MimiConfig]:
    """``OS_POCKET_PRESET``'s geometry: ``base`` is the full model; any
    other value the test geometry with enough context for a voice prompt
    and a long sentence (the prompt keeps at most max_ctx // 2)."""
    if preset == "base":
        return PocketLMConfig(), MimiConfig()
    return replace(TEST_TINY_LM, max_ctx=512), MIMI_TEST_TINY


class PocketTTSBackend:
    name = "pocket-tts"
    sample_rate = SAMPLE_RATE
    single_speaker = False
    capabilities: dict[str, Any] = {
        **DEFAULT_TTS_CAPABILITIES,
        "streaming": True,
        "voice_clone": True,
        "voice_design": True,
        "speakers": SPEAKERS,
        "speed_control": False,  # the reference pocket-tts has no speed control
    }

    @classmethod
    def is_available(cls) -> bool:
        return True

    def __init__(self, device: str | torch.device | None = None) -> None:
        # naming the card touches no CUDA state: loading does
        self.device = torch.device(device if device is not None else settings.tts_effective_device)
        self._model: PocketTTS | None = None
        self._loaded_at: float | None = None
        self._last_used: float | None = None
        self._prompt_cache: dict[str, PromptState] = {}  # voice -> warmed state, oldest first

    # ── lifecycle ─────────────────────────────────────────────────────

    @staticmethod
    def _find_checkpoint() -> Path | None:
        """Pocket-tts weights: OS_POCKET_CKPT_PATH, then the HF cache."""
        env = os.environ.get("OS_POCKET_CKPT_PATH", "")
        if env and Path(env).exists():
            return Path(env)
        hub = Path.home() / ".cache" / "huggingface" / "hub"
        hits = sorted(glob.glob(str(hub / "models--kyutai--pocket-tts*/snapshots/*")))
        return Path(hits[0]) if hits else None

    def load_model(self, model_id: str = "pocket-tts") -> None:
        if self._model is not None:
            self._last_used = time.time()
            return
        t0 = time.time()
        ckpt = self._find_checkpoint()
        if ckpt is not None:
            self._model = PocketTTS.from_checkpoint(ckpt, device=self.device)
            logger.info("pocket-tts weights converted from %s", ckpt)
        else:
            lm_cfg, mimi_cfg = preset_configs(os.environ.get("OS_POCKET_PRESET", "tiny"))
            self._model = PocketTTS.random_init(torch.Generator().manual_seed(_RANDOM_SEED), lm_cfg, mimi_cfg,
                                                device=self.device)
            logger.warning("No pocket-tts checkpoint found (OS_POCKET_CKPT_PATH unset); running with random "
                           "weights — audio is not speech")
        self._warmup()
        self._loaded_at = self._last_used = time.time()
        logger.info("pocket-tts ready in %.1fs", time.time() - t0)

    def _warmup(self) -> None:
        """One short unconditioned generation (the text prefill, the LM
        step, the Mimi block decode) and, with the batcher on, one batcher
        session, so the first request does not pay the card's one-time
        set-up. A failure is logged and the model stays loaded."""
        if not settings.os_precompile_on_load:
            return
        try:
            for _ in self._model.generate_stream("hi", max_frames=4):
                pass
            if settings.os_tts_batcher_enabled:
                from open_speech_tpu_torch.runtime.pocket_batcher import get_pocket_batcher

                get_pocket_batcher(self).precompile()
        except Exception:  # noqa: BLE001 — a warmup never blocks the load
            logger.exception("pocket-tts warmup failed")

    def unload_model(self, model_id: str = "pocket-tts") -> None:
        from open_speech_tpu_torch.runtime.pocket_batcher import release_pocket_batcher

        release_pocket_batcher(self)  # the slot pool's KV caches
        self._model = None
        self._loaded_at = None
        self._prompt_cache.clear()

    def is_model_loaded(self, model_id: str = "pocket-tts") -> bool:
        return self._model is not None and model_id in ("pocket-tts", self.name)

    def loaded_models(self) -> list[TTSLoadedModelInfo]:
        if self._model is None:
            return []
        return [TTSLoadedModelInfo(model="pocket-tts", backend=self.name, device=str(self.device),
                                   loaded_at=self._loaded_at or 0.0, last_used_at=self._last_used)]

    def list_voices(self) -> list[VoiceInfo]:
        return [VoiceInfo(id=f"pocket/{s}", name=s.capitalize(), language="en-us") for s in SPEAKERS]

    # ── prompt states (the voices) ────────────────────────────────────

    def _cache_get(self, key: str) -> PromptState | None:
        """An LRU hit moves to the back: hot voices outlive cold ones."""
        state = self._prompt_cache.pop(key, None)
        if state is not None:
            self._prompt_cache[key] = state
        return state

    def _cache_put(self, key: str, state: PromptState) -> None:
        if len(self._prompt_cache) >= _PROMPT_CACHE_MAX:
            self._prompt_cache.pop(next(iter(self._prompt_cache)))  # the least recently used
        self._prompt_cache[key] = state

    def _prompt_pcm_for_name(self, name: str) -> np.ndarray:
        voices_dir = os.environ.get("OS_POCKET_VOICES_DIR", "")
        if voices_dir:
            wav = Path(voices_dir) / f"{name}.wav"
            if wav.is_file():
                return self._load_prompt_wav(wav.read_bytes())
        return _synthetic_prompt(name, self._model.sample_rate)

    def _load_prompt_wav(self, data: bytes) -> np.ndarray:
        """A WAV clip at the model's rate (resampled on the model's device)."""
        from open_speech_tpu_torch.ops.resample import resample_poly

        audio, rate = codec.read_wav(data)
        sr = self._model.sample_rate
        if rate != sr:
            audio = resample_poly(torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device),
                                  sr, rate).cpu().numpy()
        return audio.astype(np.float32)

    def _state(self, key: str, pcm_fn) -> PromptState:
        state = self._cache_get(key)
        if state is None:
            state = self._model.state_for_audio_prompt(pcm_fn())
            self._cache_put(key, state)
        return state

    def _speaker_state(self, voice: str) -> PromptState:
        name = voice.removeprefix("pocket/").lower()
        return self._state(name, lambda: self._prompt_pcm_for_name(name))

    def _clone_state(self, reference_audio: bytes) -> PromptState:
        return self._state("sha:" + hashlib.sha256(reference_audio).hexdigest(),
                           lambda: self._load_prompt_wav(reference_audio))

    def _design_state(self, description: str) -> PromptState:
        return self._state("design:" + description,
                           lambda: _synthetic_prompt(description, self._model.sample_rate))

    # ── synthesis ─────────────────────────────────────────────────────

    def synthesize(
        self,
        text: str,
        voice: str,
        speed: float = 1.0,
        lang_code: str | None = None,
        reference_audio: bytes | None = None,
        clone_transcript: str | None = None,
        voice_design: str | None = None,
    ) -> Iterator[np.ndarray]:
        if self._model is None:
            self.load_model()
        self._last_used = time.time()
        if reference_audio:
            state = self._clone_state(reference_audio)
        elif voice_design:
            state = self._design_state(voice_design)
        else:
            state = self._speaker_state(voice or SPEAKERS[0])
        # clone_transcript is accepted and unused (the audio prompt carries
        # the voice), and speed has no effect, as in the reference
        if settings.os_tts_batcher_enabled:
            from open_speech_tpu_torch.runtime.pocket_batcher import get_pocket_batcher

            yield from (c for c in get_pocket_batcher(self).synthesize(text, state) if c.size)
            return
        for block in self._model.generate_stream(text, state):
            chunk = np.asarray(block, np.float32)
            if chunk.size:
                yield chunk
