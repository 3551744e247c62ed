"""Piper (VITS) TTS backend on the card.

Counterpart of ``open_speech_tpu/tts/backends/piper_jax.py``, with the same
surface: the curated 30-voice registry with per-voice rates and quality
tiers, the model id doubling as the voice (``single_speaker``: the router
passes the model id), ``#speaker`` selectors through a multi-speaker
voice's ``speaker_id_map``, ``length_scale = 1/speed`` with the voice's own
length_scale folded in, and a generator of per-sentence float32 chunks.

Per sentence: G2P -> the voice's phoneme ids, split into pieces of
``max_phonemes`` (an over-long sentence is split, never cut) ->
``synthesize_vits`` with each piece's noise from seed ``si * 9973 + pi``
(or the TTS batcher when ``OS_TTS_BATCHER_ENABLED`` is on), in float32 on
``settings.tts_effective_device`` unless the caller names a device.

A voice converts from ``<voice>.onnx`` (and its ``.onnx.json``) under
``OS_PIPER_VOICES_DIR``, ``~/.cache/piper-voices`` or
``~/.local/share/piper``. A registry voice with no checkpoint runs random
weights from a seed derived from the voice id's sha256, as the JAX backend
does; the weights differ from ``jax.random``'s, so the two packages' random
voices sound different (``ROADMAP.md``, "By design").
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.piper.convert import convert_piper_onnx
from open_speech_tpu_torch.models.piper.model import SAMPLE_RATE, PiperConfig, init_piper_params
from open_speech_tpu_torch.text.g2p import get_g2p, split_sentences
from open_speech_tpu_torch.text.g2p_langs import base_lang
from open_speech_tpu_torch.tts.backends.base import (
    DEFAULT_TTS_CAPABILITIES,
    TTSLoadedModelInfo,
    VoiceInfo,
)

logger = logging.getLogger(__name__)

# voice id -> (sample_rate, quality); ids match the reference registry
PIPER_VOICES: dict[str, dict[str, Any]] = {
    f"piper/{vid}": {"sample_rate": sr, "quality": q}
    for vid, sr, q in [
        ("en_US-lessac-low", 16000, "low"),
        ("en_US-lessac-medium", 22050, "medium"),
        ("en_US-lessac-high", 22050, "high"),
        ("en_US-amy-medium", 22050, "medium"),
        ("en_US-amy-high", 22050, "high"),
        ("en_US-arctic-medium", 22050, "medium"),
        ("en_US-bryce-medium", 22050, "medium"),
        ("en_US-danny-low", 16000, "low"),
        ("en_US-hfc_female-medium", 22050, "medium"),
        ("en_US-hfc_male-medium", 22050, "medium"),
        ("en_US-joe-medium", 22050, "medium"),
        ("en_US-john-medium", 22050, "medium"),
        ("en_US-kathleen-low", 16000, "low"),
        ("en_US-kusal-medium", 22050, "medium"),
        ("en_US-libritts_r-medium", 22050, "medium"),
        ("en_US-ljspeech-medium", 22050, "medium"),
        ("en_US-ljspeech-high", 22050, "high"),
        ("en_US-norman-medium", 22050, "medium"),
        ("en_US-ryan-low", 16000, "low"),
        ("en_US-ryan-medium", 22050, "medium"),
        ("en_US-ryan-high", 22050, "high"),
        ("en_GB-alan-low", 16000, "low"),
        ("en_GB-alan-medium", 22050, "medium"),
        ("en_GB-cori-medium", 22050, "medium"),
        ("en_GB-cori-high", 22050, "high"),
        ("en_GB-jenny_dioco-medium", 22050, "medium"),
        ("en_GB-northern_english_male-medium", 22050, "medium"),
        ("en_GB-semaine-medium", 22050, "medium"),
        ("en_GB-southern_english_female-low", 16000, "low"),
        ("en_GB-southern_english_female-medium", 22050, "medium"),
    ]
}

DEFAULT_VOICE = "piper/en_US-lessac-medium"


class PiperBackend:
    name = "piper"
    sample_rate = SAMPLE_RATE  # nominal; per-voice rates in PIPER_VOICES
    single_speaker = True  # the router passes the model id as the voice
    capabilities: dict[str, Any] = {
        **DEFAULT_TTS_CAPABILITIES,
        "streaming": True,
        "languages": ["en-us", "en-gb"],
    }

    @classmethod
    def is_available(cls) -> bool:
        return True

    def __init__(self, device: str | torch.device | None = None) -> None:
        # naming the card touches no CUDA state: loading does
        self.device = torch.device(device if device is not None else settings.tts_effective_device)
        self._cfg = PiperConfig()
        self._models: dict[str, tuple] = {}  # voice id -> (model, cfg, voice meta)
        self._loaded_at: dict[str, float] = {}
        self._last_used: dict[str, float] = {}
        self._g2p = get_g2p()

    def _canonical(self, model_id: str) -> str:
        if model_id in ("piper", self.name, ""):
            return DEFAULT_VOICE
        if not model_id.startswith("piper/"):
            model_id = "piper/" + model_id.removeprefix("piper-")
        return model_id

    # ── lifecycle ─────────────────────────────────────────────────────

    @staticmethod
    def _find_voice_file(short: str) -> Path | None:
        """A piper ONNX voice on disk: OS_PIPER_VOICES_DIR, then the local
        caches of the piper ecosystem."""
        roots = []
        env = os.environ.get("OS_PIPER_VOICES_DIR", "")
        if env:
            roots.append(Path(env))
        roots += [
            Path.home() / ".cache" / "piper-voices",
            Path.home() / ".local" / "share" / "piper",
        ]
        for root in roots:
            cand = root / f"{short}.onnx"
            if cand.is_file():
                return cand
        return None

    def load_model(self, model_id: str) -> None:
        mid = self._canonical(model_id)
        if mid in self._models:
            self._last_used[mid] = time.time()
            return
        t0 = time.time()
        ckpt = self._find_voice_file(mid.removeprefix("piper/"))
        if mid not in PIPER_VOICES and ckpt is None:
            # registry voices run without weights; other voices (any
            # language) need their ONNX file on disk
            raise ValueError(f"Unknown piper voice: {model_id}")
        if ckpt is not None:
            model, cfg, meta = convert_piper_onnx(
                ckpt, device=self.device,
                max_phonemes=self._cfg.max_phonemes, max_frames=self._cfg.max_frames)
            logger.info("piper voice %s converted from %s", mid, ckpt)
        else:
            seed = int.from_bytes(hashlib.sha256(mid.encode()).digest()[:4], "little")
            cfg, meta = self._cfg, {}
            model = init_piper_params(torch.Generator().manual_seed(seed), cfg, device=self.device)
            logger.warning(
                "piper voice %s running with random weights (no checkpoint under OS_PIPER_VOICES_DIR)", mid)
        self._models[mid] = (model, cfg, meta)
        now = time.time()
        self._loaded_at[mid] = self._last_used[mid] = now
        logger.info("piper voice %s ready in %.1fs", mid, now - t0)

    def unload_model(self, model_id: str) -> None:
        mid = self._canonical(model_id)
        if mid in self._models:
            from open_speech_tpu_torch.runtime.tts_batcher import release_piper_batcher

            release_piper_batcher(self, mid)  # the batcher holds the voice's weights too
        self._models.pop(mid, None)
        self._loaded_at.pop(mid, None)
        self._last_used.pop(mid, None)

    def is_model_loaded(self, model_id: str) -> bool:
        return self._canonical(model_id) in self._models

    def loaded_models(self) -> list[TTSLoadedModelInfo]:
        return [
            TTSLoadedModelInfo(
                model=mid,
                backend=self.name,
                device=str(self.device),
                loaded_at=self._loaded_at.get(mid, 0.0),
                last_used_at=self._last_used.get(mid),
            )
            for mid in self._models
        ]

    # ── voices ────────────────────────────────────────────────────────

    def list_voices(self) -> list[VoiceInfo]:
        out = []
        for vid in PIPER_VOICES:
            short = vid.removeprefix("piper/")
            lang = "en-gb" if short.startswith("en_GB") else "en-us"
            out.append(VoiceInfo(id=vid, name=short, language=lang, gender="unknown"))
        return out

    def get_sample_rate(self, model_id: str) -> int:
        """A voice's native rate: the converted checkpoint's config (from
        its .onnx.json), else the registry's per-voice rate, else 22.05 kHz."""
        mid = self._canonical(model_id.split("#", 1)[0])
        entry = self._models.get(mid)
        if entry is not None and entry[1].sample_rate:
            return int(entry[1].sample_rate)
        return PIPER_VOICES.get(mid, {}).get("sample_rate", SAMPLE_RATE)

    @staticmethod
    def _resolve_speaker(meta: dict, cfg: PiperConfig, selector: str | None) -> int:
        """Speaker selector -> embedding row (multi-speaker voices only)."""
        n = cfg.n_speakers
        if selector is None or n <= 1:
            return 0
        id_map = meta.get("speaker_id_map") or {}
        if selector in id_map:
            return int(id_map[selector]) % n
        try:
            return int(selector) % n
        except ValueError:
            raise ValueError(f"Unknown speaker '{selector}'; known: {sorted(id_map) or list(range(n))}")

    # ── synthesis ─────────────────────────────────────────────────────

    def synthesize(
        self,
        text: str,
        voice: str,
        speed: float = 1.0,
        lang_code: str | None = None,
    ) -> Iterator[np.ndarray]:
        # a multi-speaker voice selects its speaker after '#':
        # "piper/<voice>#<speaker name or id>"
        speaker_sel = None
        if "#" in voice:
            voice, speaker_sel = voice.split("#", 1)
        mid = self._canonical(voice)
        if mid not in self._models:
            self.load_model(mid)
        self._last_used[mid] = time.time()
        model, cfg, meta = self._models[mid]
        speaker_id = self._resolve_speaker(meta, cfg, speaker_sel)
        short = mid.removeprefix("piper/")
        lang = lang_code or base_lang(short)
        if not self._g2p.supports_language(lang):
            raise ValueError(
                f"language_not_supported: piper voice '{short}' needs {lang} "
                "G2P (install espeak-ng for full language coverage)"
            )
        speed = speed if speed and speed > 0 else 1.0
        # piper multiplies durations by the voice's length_scale; speed
        # divides them: fold the voice's own rate in
        speed_eff = speed / float(meta.get("length_scale") or 1.0)
        from open_speech_tpu_torch.runtime.tts_batcher import _piper_rows, get_piper_batcher

        for si, sentence in enumerate(split_sentences(text) or [text]):
            ids = self._g2p.to_ids(sentence, id_map=meta.get("phoneme_id_map"), voice=lang)
            for pi in range(0, max(len(ids), 1), cfg.max_phonemes):
                piece = ids[pi : pi + cfg.max_phonemes]
                seed = si * 9973 + pi
                if settings.os_tts_batcher_enabled:
                    # concurrent requests share one batched pass; per-row
                    # seeded noise keeps a row's audio independent of its peers
                    yield from (c for c in get_piper_batcher(self, mid).synthesize(
                        piece, speaker_id, speed_eff, seed) if c.size)
                    continue
                phonemes = torch.zeros((1, cfg.max_phonemes), dtype=torch.int64)
                phonemes[0, : len(piece)] = torch.tensor(piece, dtype=torch.int64)
                audio, n_frames = _piper_rows(
                    model, cfg, phonemes, torch.tensor([len(piece)]), torch.tensor([speaker_id]),
                    torch.tensor([speed_eff], dtype=torch.float32), [seed])
                chunk = audio[0, : int(n_frames[0]) * cfg.samples_per_frame].cpu().numpy()
                if chunk.size:
                    yield chunk

