"""Kokoro TTS backend on the card.

Counterpart of ``open_speech_tpu/tts/backends/kokoro_backend.py``, with the
same surface: the 52-voice registry, the language taken from the voice
id's prefix, voice blends as weighted sums of style vectors, a generator of
per-sentence audio blocks, and a warmup synthesis at load. Per sentence:
G2P -> checkpoint-vocab ids -> ``encode_utterance`` -> ``vocode_blocks``
(or the TTS batcher when ``OS_TTS_BATCHER_ENABLED`` is on), in float32 on
``settings.tts_effective_device`` unless the caller names a device.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.kokoro import model as K
from open_speech_tpu_torch.models.kokoro.convert import (
    convert_kokoro,
    convert_voice_pack,
    select_voice_style,
)
from open_speech_tpu_torch.text.g2p import get_g2p, split_sentences
from open_speech_tpu_torch.text.g2p_langs import base_lang, normalize_ipa
from open_speech_tpu_torch.tts.backends.base import (
    DEFAULT_TTS_CAPABILITIES,
    TTSLoadedModelInfo,
    VoiceInfo,
)
from open_speech_tpu_torch.tts.voices import parse_voice_spec

logger = logging.getLogger(__name__)

VOICE_PREFIX_TO_LANG = {
    "a": "en-us", "b": "en-gb", "e": "es", "f": "fr-fr", "h": "hi",
    "i": "it", "j": "ja", "p": "pt-br", "z": "zh",
}

# voice registry (reference: src/tts/backends/kokoro.py:45-109)
ALL_KOKORO_VOICES: list[dict[str, str]] = [
    {"id": "af_heart", "name": "Heart", "lang": "a", "gender": "female"},
    {"id": "af_alloy", "name": "Alloy", "lang": "a", "gender": "female"},
    {"id": "af_aoede", "name": "Aoede", "lang": "a", "gender": "female"},
    {"id": "af_bella", "name": "Bella", "lang": "a", "gender": "female"},
    {"id": "af_jessica", "name": "Jessica", "lang": "a", "gender": "female"},
    {"id": "af_kore", "name": "Kore", "lang": "a", "gender": "female"},
    {"id": "af_nicole", "name": "Nicole", "lang": "a", "gender": "female"},
    {"id": "af_nova", "name": "Nova", "lang": "a", "gender": "female"},
    {"id": "af_river", "name": "River", "lang": "a", "gender": "female"},
    {"id": "af_sarah", "name": "Sarah", "lang": "a", "gender": "female"},
    {"id": "af_sky", "name": "Sky", "lang": "a", "gender": "female"},
    {"id": "am_adam", "name": "Adam", "lang": "a", "gender": "male"},
    {"id": "am_echo", "name": "Echo", "lang": "a", "gender": "male"},
    {"id": "am_eric", "name": "Eric", "lang": "a", "gender": "male"},
    {"id": "am_fenrir", "name": "Fenrir", "lang": "a", "gender": "male"},
    {"id": "am_liam", "name": "Liam", "lang": "a", "gender": "male"},
    {"id": "am_michael", "name": "Michael", "lang": "a", "gender": "male"},
    {"id": "am_onyx", "name": "Onyx", "lang": "a", "gender": "male"},
    {"id": "am_puck", "name": "Puck", "lang": "a", "gender": "male"},
    {"id": "am_santa", "name": "Santa", "lang": "a", "gender": "male"},
    {"id": "bf_alice", "name": "Alice", "lang": "b", "gender": "female"},
    {"id": "bf_emma", "name": "Emma", "lang": "b", "gender": "female"},
    {"id": "bf_isabella", "name": "Isabella", "lang": "b", "gender": "female"},
    {"id": "bf_lily", "name": "Lily", "lang": "b", "gender": "female"},
    {"id": "bm_daniel", "name": "Daniel", "lang": "b", "gender": "male"},
    {"id": "bm_fable", "name": "Fable", "lang": "b", "gender": "male"},
    {"id": "bm_george", "name": "George", "lang": "b", "gender": "male"},
    {"id": "bm_lewis", "name": "Lewis", "lang": "b", "gender": "male"},
    {"id": "ef_dora", "name": "Dora", "lang": "e", "gender": "female"},
    {"id": "em_alex", "name": "Alex", "lang": "e", "gender": "male"},
    {"id": "em_santa", "name": "Santa (ES)", "lang": "e", "gender": "male"},
    {"id": "ff_siwis", "name": "Siwis", "lang": "f", "gender": "female"},
    {"id": "hf_alpha", "name": "Alpha", "lang": "h", "gender": "female"},
    {"id": "hf_beta", "name": "Beta", "lang": "h", "gender": "female"},
    {"id": "hm_omega", "name": "Omega", "lang": "h", "gender": "male"},
    {"id": "hm_psi", "name": "Psi", "lang": "h", "gender": "male"},
    {"id": "if_sara", "name": "Sara", "lang": "i", "gender": "female"},
    {"id": "im_nicola", "name": "Nicola", "lang": "i", "gender": "male"},
    {"id": "jf_alpha", "name": "Alpha (JA)", "lang": "j", "gender": "female"},
    {"id": "jf_gongitsune", "name": "Gongitsune", "lang": "j", "gender": "female"},
    {"id": "jf_nezumi", "name": "Nezumi", "lang": "j", "gender": "female"},
    {"id": "jf_tebukuro", "name": "Tebukuro", "lang": "j", "gender": "female"},
    {"id": "jm_kumo", "name": "Kumo", "lang": "j", "gender": "male"},
    {"id": "pf_dora", "name": "Dora (PT)", "lang": "p", "gender": "female"},
    {"id": "zf_xiaobei", "name": "Xiaobei", "lang": "z", "gender": "female"},
    {"id": "zf_xiaoni", "name": "Xiaoni", "lang": "z", "gender": "female"},
    {"id": "zf_xiaoxiao", "name": "Xiaoxiao", "lang": "z", "gender": "female"},
    {"id": "zf_xiaoyi", "name": "Xiaoyi", "lang": "z", "gender": "female"},
    {"id": "zm_yunjian", "name": "Yunjian", "lang": "z", "gender": "male"},
    {"id": "zm_yunxi", "name": "Yunxi", "lang": "z", "gender": "male"},
    {"id": "zm_yunxia", "name": "Yunxia", "lang": "z", "gender": "male"},
    {"id": "zm_yunyang", "name": "Yunyang", "lang": "z", "gender": "male"},
]


def lang_code_from_voice_id(voice_id: str) -> str:
    if voice_id and len(voice_id) >= 2:
        return VOICE_PREFIX_TO_LANG.get(voice_id[0], "en-us")
    return "en-us"


class KokoroBackend:
    name = "kokoro"
    sample_rate = K.SAMPLE_RATE
    capabilities: dict[str, Any] = {
        **DEFAULT_TTS_CAPABILITIES,
        "voice_blend": True,
        "streaming": True,
        "languages": sorted(set(VOICE_PREFIX_TO_LANG.values())),
    }
    # fraction of IPA symbols allowed to miss the vocab before the request
    # is rejected instead of synthesizing mangled prosody
    MAX_DROP_RATE = 0.3

    @classmethod
    def is_available(cls) -> bool:
        return True

    def __init__(self, device: str | torch.device | None = None) -> None:
        # naming the card touches no CUDA state: loading does
        self.device = torch.device(device if device is not None else settings.tts_effective_device)
        self._cfg = K.resolve_kokoro_config()
        self._model: K.KModel | None = None
        self._loaded_at: float | None = None
        self._last_used: float | None = None
        self._g2p = get_g2p()
        self._from_checkpoint = False
        self._voice_cache: dict[str, np.ndarray] = {}
        # IPA symbol -> token id: the vendored kokoro-82M table until a
        # checkpoint's config.json replaces it
        self._vocab: dict[str, int] | None = self._load_vocab(None)
        self.last_drop_rate = 0.0

    # ── lifecycle ─────────────────────────────────────────────────────

    @staticmethod
    def _find_checkpoint() -> Path | None:
        """OS_KOKORO_CKPT_PATH, then the Hugging Face cache layout."""
        env = os.environ.get("OS_KOKORO_CKPT_PATH", "")
        if env and Path(env).is_file():
            return Path(env)
        hub = Path.home() / ".cache" / "huggingface" / "hub"
        hits = sorted(hub.glob("models--hexgrad--Kokoro-82M/snapshots/*/*.pth"))
        return hits[0] if hits else None

    def load_model(self, model_id: str = "kokoro") -> None:
        if self._model is not None:
            self._last_used = time.time()
            return
        t0 = time.time()
        ckpt = self._find_checkpoint()
        if ckpt is not None:
            state = torch.load(ckpt, map_location="cpu", weights_only=True)
            self._model, self._cfg = convert_kokoro(
                state, device=self.device,
                max_phonemes=self._cfg.max_phonemes, max_frames=self._cfg.max_frames,
            )
            self._vocab = self._load_vocab(ckpt)
            self._from_checkpoint = True
            logger.info("kokoro weights converted from %s", ckpt)
        else:
            self._from_checkpoint = False
            gen = torch.Generator(device=self.device).manual_seed(7)
            self._model = K.init_kokoro_params(gen, self._cfg, device=self.device)
            logger.warning(
                "No kokoro checkpoint found (OS_KOKORO_CKPT_PATH unset); "
                "running with random weights — audio is not speech"
            )
        self._loaded_at = self._last_used = time.time()
        logger.info("kokoro weights ready in %.1fs", time.time() - t0)
        # first calls pay CUDA's library set-up; take it here, not on a request
        for _chunk in self.synthesize("warmup", "af_heart"):
            pass
        if settings.os_tts_batcher_enabled and settings.os_precompile_on_load:
            from open_speech_tpu_torch.runtime.tts_batcher import get_tts_batcher

            rows = [int(b) for b in str(settings.os_tts_precompile_buckets).split(",") if b.strip()]
            get_tts_batcher(self).precompile(max(rows or [16]))
        logger.info("kokoro warmed up in %.1fs total", time.time() - t0)

    def unload_model(self, model_id: str = "kokoro") -> None:
        self._model = None
        self._loaded_at = None

    def is_model_loaded(self, model_id: str = "kokoro") -> bool:
        return self._model is not None and model_id in ("kokoro", self.name)

    def loaded_models(self) -> list[TTSLoadedModelInfo]:
        if self._model is None:
            return []
        return [
            TTSLoadedModelInfo(
                model="kokoro",
                backend=self.name,
                device=str(self.device),
                loaded_at=self._loaded_at or 0.0,
                last_used_at=self._last_used,
            )
        ]

    # ── voices ────────────────────────────────────────────────────────

    def list_voices(self) -> list[VoiceInfo]:
        return [
            VoiceInfo(
                id=v["id"],
                name=v["name"],
                language=VOICE_PREFIX_TO_LANG.get(v["lang"], "en-us"),
                gender=v["gender"],
            )
            for v in ALL_KOKORO_VOICES
        ]

    def _voice_rows(self, voice_id: str) -> np.ndarray:
        """Voice identity as [rows, 2*style_dim], rows indexed by utterance
        length: a converted pack (OS_KOKORO_VOICES_DIR/<id>.pt) when present,
        else the deterministic one-row ``voice_vector``."""
        cached = self._voice_cache.get(voice_id)
        if cached is not None:
            return cached
        rows = None
        vdir = os.environ.get("OS_KOKORO_VOICES_DIR", "")
        if vdir:
            pack = Path(vdir) / f"{voice_id}.pt"
            if pack.is_file():
                rows = convert_voice_pack(pack)
        if rows is None:
            if self._from_checkpoint:
                # real weights on a hashed-noise style give garbage audio
                # served as success: make the misconfiguration loud
                logger.warning(
                    "kokoro voice %r has no converted voice pack "
                    "(OS_KOKORO_VOICES_DIR unset or %s.pt missing) — "
                    "conditioning CONVERTED weights on a random style "
                    "vector; audio will not sound like the voice",
                    voice_id, voice_id,
                )
            rows = K.voice_vector(voice_id, self._cfg.voice_dim)[None, :]
        self._voice_cache[voice_id] = rows
        return rows

    def _style_for(self, voice: str, n_phonemes: int = 0) -> np.ndarray:
        """A voice spec (maybe a blend) -> one style vector [2*style_dim]:
        the weighted sum of each voice's row for this utterance length."""
        spec = parse_voice_spec(voice)
        vec = np.zeros(2 * self._cfg.style_dim, np.float32)
        for comp, w in zip(spec.components, spec.normalized_weights()):
            vec += w * select_voice_style(self._voice_rows(comp.voice_id), max(n_phonemes, 1))
        return vec

    # ── text ──────────────────────────────────────────────────────────

    @staticmethod
    def _load_vocab(ckpt_path) -> dict[str, int] | None:
        """IPA symbol table: OS_KOKORO_VOCAB_PATH, then the checkpoint's
        config.json, then the vendored copy (models/kokoro/vocab.json)."""
        vendored = Path(K.__file__).parent / "vocab.json"
        for cand in (
            Path(os.environ.get("OS_KOKORO_VOCAB_PATH", "/nonexistent")),
            Path(ckpt_path).parent / "config.json" if ckpt_path else vendored,
            vendored,
        ):
            if cand.is_file():
                try:
                    data = json.loads(cand.read_text())
                except (OSError, ValueError):
                    continue
                vocab = data.get("vocab", data)
                if isinstance(vocab, dict) and vocab:
                    return {str(k): int(v) for k, v in vocab.items() if not str(k).startswith("_")}
        return None

    def supports_language(self, voice_or_lang: str) -> bool:
        """Servable when G2P covers the language AND the symbol table can
        encode the result (non-English needs a vocab)."""
        if re.match(r"^[a-z][fm]_", voice_or_lang):  # a kokoro voice id
            voice_or_lang = lang_code_from_voice_id(voice_or_lang)
        lang = base_lang(voice_or_lang)
        if not self._g2p.supports_language(lang):
            return False
        return lang == "en" or self._vocab is not None

    def _encode_text(self, text: str, lang: str) -> list[int]:
        """Text -> checkpoint-vocab phoneme ids, padded with id 0 at both
        ends. Symbols missing from the vocab are counted; a drop rate above
        ``MAX_DROP_RATE`` raises ``ValueError`` (g2p_vocab_mismatch) rather
        than synthesizing misread text."""
        if self._vocab is None:
            return self._g2p.to_ids(text)
        res = self._g2p.phonemize_ipa_ex(text, voice=lang)
        raw, g2p_dropped = res if res is not None else ([], 0)
        phones = normalize_ipa(raw)
        ids = [self._vocab[c] for c in phones if c in self._vocab]
        missing = [c for c in phones if c not in self._vocab]
        total = len(phones) + g2p_dropped
        n_dropped = len(missing) + g2p_dropped
        self.last_drop_rate = n_dropped / max(total, 1)
        if n_dropped:
            logger.warning(
                "kokoro G2P dropped %d/%d symbols (%s): %d untransducible"
                " input chars + vocab-missing %r",
                n_dropped, total, lang, g2p_dropped,
                "".join(sorted(set(missing)))[:40],
            )
        if self.last_drop_rate > self.MAX_DROP_RATE or (total > 0 and not ids):
            raise ValueError(
                f"g2p_vocab_mismatch: {n_dropped}/{total} symbols for "
                f"lang '{lang}' untransducible or missing from the "
                "checkpoint vocab — text would be misread"
            )
        return [0] + ids + [0]

    # ── synthesis ─────────────────────────────────────────────────────

    def synthesize(
        self,
        text: str,
        voice: str,
        speed: float = 1.0,
        lang_code: str | None = None,
    ) -> Iterator[np.ndarray]:
        """Per sentence, float32 host blocks of 64 frames (the first audio
        waits for the encode and one block, not the sentence)."""
        if self._model is None:
            self.load_model("kokoro")
        self._last_used = time.time()
        voice = voice or "af_heart"
        # an explicit language wins over the voice id's prefix
        lang = lang_code or lang_code_from_voice_id(voice.split("+")[0].split("(")[0].strip())
        if not self.supports_language(lang):
            raise ValueError(
                f"language_not_supported: voice '{voice}' needs {lang} G2P "
                "(install espeak-ng or provide a checkpoint vocab)"
            )
        speed = speed if speed and speed > 0 else 1.0
        cfg = self._cfg
        for sentence in split_sentences(text) or [text]:
            ids = self._encode_text(sentence, lang)[: cfg.max_phonemes]
            n = len(ids)
            # the style row is indexed by the phoneme count without the two
            # boundary pads
            style_vec = self._style_for(voice, max(n - 2, 1))
            if settings.os_tts_batcher_enabled:
                from open_speech_tpu_torch.runtime.tts_batcher import get_tts_batcher

                yield from (c for c in get_tts_batcher(self).synthesize(ids, style_vec, speed) if c.size)
                continue
            phonemes = torch.zeros((1, cfg.max_phonemes), dtype=torch.int64)
            phonemes[0, :n] = torch.tensor(ids, dtype=torch.int64)
            style = torch.from_numpy(style_vec[None, :]).to(self.device)
            g, n_frames = K.encode_utterance(
                self._model, cfg, phonemes.to(self.device),
                torch.tensor([n], device=self.device), style,
                torch.tensor([speed], dtype=torch.float32, device=self.device),
            )
            # noise from a generator seeded 0 on the model's device, as a
            # row of the TTS batcher draws it
            for block in K.vocode_blocks(self._model, cfg, g, n_frames, style):
                if block[0].size:
                    yield block[0]
