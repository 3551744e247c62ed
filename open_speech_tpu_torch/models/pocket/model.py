"""Pocket-TTS (Kyutai) in PyTorch: Mimi-token LM TTS with audio-prompt voice
cloning. Counterpart of ``open_speech_tpu/models/pocket/model.py``.

  - ``state_for_audio_prompt(pcm)``: encode a reference clip to Mimi tokens
    and teacher-force them through the temporal stack; the warmed KV caches
    are the voice (``PromptState``);
  - ``generate_stream(text, state)``: prefill the text, then decide audio
    frames one step at a time and stream PCM blocks through the
    block-streaming Mimi decoder as frames complete.

A ``PromptState`` is shared: the backend caches one per voice, and any
number of requests may start from it. Generation writes its KV caches in
place, so ``generate_stream`` works on a copy of the state's caches and
the cached voice never changes.

The model lives on one device (the card unless the caller names another);
each call runs inside ``ops.vocoder.inference``: no autograd, float32
throughout with cuDNN's TF32 off. Temperature > 0 samples each stage from
a ``torch.Generator`` seeded with ``seed`` (the JAX model's draws come from
``jax.random``, so sampled tokens differ between the packages; greedy
tokens do not).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from open_speech_tpu_torch.models.pocket.lm import (
    TEST_TINY_LM,
    ParamTree,
    PocketLMConfig,
    _rms,
    depformer_sample,
    embed_grid,
    embed_step,
    init_caches,
    init_pocket_lm_params,
    temporal_prefill,
    temporal_step,
)
from open_speech_tpu_torch.models.pocket.mimi import (
    TEST_TINY,
    MimiConfig,
    MimiStreamingDecoder,
    init_mimi_params,
    mimi_encode,
)
from open_speech_tpu_torch.ops.vocoder import inference, tts_device

logger = logging.getLogger(__name__)

SAMPLE_RATE = 24_000


class ByteTokenizer:
    """Byte-level fallback text tokenizer: bytes map into [3, text_card)."""

    def __init__(self, text_card: int) -> None:
        self.span = text_card - 3

    def encode(self, text: str) -> list[int]:
        return [3 + (b % self.span) for b in text.encode("utf-8")]


class SentencePieceTokenizer:
    """A release's tokenizer: native sentencepiece ids, no offset."""

    def __init__(self, model_path: str) -> None:
        import sentencepiece  # only when a checkpoint ships a .model file

        self.sp = sentencepiece.SentencePieceProcessor(model_file=model_path)

    def encode(self, text: str) -> list[int]:
        return list(self.sp.encode(text))


@dataclass
class PromptState:
    """Warmed temporal KV caches after an audio (voice) prompt."""

    k_cache: torch.Tensor
    v_cache: torch.Tensor
    length: int  # steps already in the cache


def _delayed_grid(cfg: PocketLMConfig, tokens: np.ndarray) -> np.ndarray:
    """Frame tokens [B, K, F] -> the delayed step-input grid [B, K, F]."""
    b, k, f = tokens.shape
    grid = np.full((b, k, f), cfg.audio_initial, np.int64)
    for i, d in enumerate(cfg.delays):
        if d < f:
            grid[:, i, d:] = tokens[:, i, : f - d]
    return grid


# kept from the JAX model: encode_audio caps a prompt at its bucket, so the
# buckets decide which frames a long prompt keeps
_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, cap: int) -> int:
    """The smallest bucket >= n, at most ``cap``."""
    for b in _BUCKETS:
        if b >= n:
            return min(b, cap)
    return cap


def _prefill(params, cfg: PocketLMConfig, text_toks: torch.Tensor, audio_grid: torch.Tensor, caches,
             start, n):
    """Teacher-force a bucket-padded segment into ``caches`` (in place);
    ``n`` is the valid step count."""
    _, caches = temporal_prefill(params, cfg, embed_grid(params, text_toks, audio_grid), caches, start,
                                 length=n)
    return caches


def _gen_step(params, cfg: PocketLMConfig, text_tok, dep_text_tok, audio_in, caches, pos, temp: float = 0.0,
              generator: torch.Generator | None = None):
    """One generation step -> (audio tokens [B, n_q], text logits, caches)."""
    h, caches = temporal_step(params, cfg, embed_step(params, cfg, text_tok, audio_in), caches, pos)
    hn = _rms(h, params["out_norm"])
    text_logits = hn @ params["text_linear"]["w"]
    return depformer_sample(params, cfg, hn, dep_text_tok, temp, generator), text_logits, caches


class PocketTTS:
    """The pocket-tts model: codec + LM + the generation loop."""

    sample_rate = SAMPLE_RATE

    def __init__(self, lm_params: ParamTree, mimi_params: ParamTree, lm_cfg: PocketLMConfig,
                 mimi_cfg: MimiConfig, tokenizer=None) -> None:
        assert lm_cfg.n_q == mimi_cfg.n_q and lm_cfg.card == mimi_cfg.card, "LM and codec token spaces must agree"
        self.lm_params = lm_params
        self.mimi_params = mimi_params
        self.lm_cfg = lm_cfg
        self.mimi_cfg = mimi_cfg
        self.tokenizer = tokenizer or ByteTokenizer(lm_cfg.text_card)
        self.sample_rate = mimi_cfg.sample_rate

    @property
    def device(self) -> torch.device:
        return self.lm_params.device

    @classmethod
    def from_checkpoint(cls, path, device=None) -> "PocketTTS":
        """Converted weights from a kyutai release dir or weight file."""
        from open_speech_tpu_torch.models.pocket.convert import load_checkpoint

        return load_checkpoint(path, device=tts_device(device))

    @classmethod
    def random_init(cls, generator: torch.Generator, lm_cfg: PocketLMConfig | None = None,
                    mimi_cfg: MimiConfig | None = None, device=None) -> "PocketTTS":
        """Random weights from ``generator`` (LM first, then Mimi), at the
        test geometry unless configs are given, on ``device`` (the card
        unless the caller names another)."""
        lm_cfg = lm_cfg or TEST_TINY_LM
        mimi_cfg = mimi_cfg or TEST_TINY
        device = tts_device(device)
        return cls(init_pocket_lm_params(generator, lm_cfg, device),
                   init_mimi_params(generator, mimi_cfg, device), lm_cfg, mimi_cfg)

    # ── voice prompt (clone path) ────────────────────────────────────

    def encode_audio(self, pcm: np.ndarray, cap: int | None = None) -> np.ndarray:
        """PCM (24 kHz float mono, [T] or [B, T]) -> Mimi tokens [B, K, F].

        The waveform is zero-padded to a whole-frame bucket, as the JAX
        model pads it; the causal encoder's tokens for the real frames do not
        depend on the padding. ``cap`` bounds the frame count."""
        pcm = np.atleast_2d(np.asarray(pcm, np.float32))
        spf = self.mimi_cfg.samples_per_frame
        frames = max(1, -(-pcm.shape[1] // spf))
        fbucket = _bucket(frames, cap=cap or self.lm_cfg.max_ctx)
        frames = min(frames, fbucket)
        padded = np.zeros((pcm.shape[0], fbucket * spf), np.float32)
        n_copy = min(pcm.shape[1], fbucket * spf)
        padded[:, :n_copy] = pcm[:, :n_copy]
        with inference():
            toks = mimi_encode(self.mimi_params, self.mimi_cfg, torch.from_numpy(padded).to(self.device))
        return toks[:, :, :frames].cpu().numpy()

    def state_for_audio_prompt(self, pcm: np.ndarray) -> PromptState:
        """A reference clip -> warmed LM state (the cloned voice)."""
        max_prompt = self.lm_cfg.max_ctx // 2  # text and generation must still fit
        return self.state_for_tokens(self.encode_audio(pcm, cap=max_prompt))

    def state_for_tokens(self, tokens: np.ndarray) -> PromptState:
        """Mimi tokens [B, K, F] of a prompt -> its warmed LM state: the
        delayed grid, bucket-padded, teacher-forced from position 0 (at
        most max_ctx // 2 frames are kept)."""
        cfg = self.lm_cfg
        max_prompt = cfg.max_ctx // 2
        grid = _delayed_grid(cfg, np.asarray(tokens)[:, :, :max_prompt])
        b, _, steps = grid.shape
        pad_to = _bucket(steps, cap=max_prompt)
        padded = np.full((b, cfg.n_q, pad_to), cfg.audio_initial, np.int64)
        padded[:, :, :steps] = grid
        text = np.full((b, pad_to), cfg.text_pad_id, np.int64)
        dev = self.device
        with inference():
            caches = init_caches(cfg, b, self.lm_params["text_emb"].dtype, dev)
            caches = _prefill(self.lm_params, cfg, torch.from_numpy(text).to(dev), torch.from_numpy(padded).to(dev),
                              caches, 0, steps)
        return PromptState(*caches, length=steps)

    # ── generation ────────────────────────────────────────────────────

    def generate_stream(self, text: str, state: PromptState | None = None, *, max_frames: int | None = None,
                        temperature: float = 0.0, seed: int = 0, block_frames: int = 2,
                        frames_per_char: float = 1.0) -> Iterator[np.ndarray]:
        """Yield float32 PCM blocks (24 kHz) as frames complete.

        With no ``state`` the model speaks in its unconditioned voice.
        Deterministic for (text, state, seed, temperature)."""
        cfg = self.lm_cfg
        dev = self.device
        ids = [cfg.text_bos_id] + self.tokenizer.encode(text) + [cfg.text_eos_id]
        if state is not None and state.k_cache.shape[1] != 1:
            raise ValueError(
                "generate_stream is single-stream: PromptState carries "
                f"batch={state.k_cache.shape[1]} (build it from one mono clip, or run one generate_stream per voice)")
        start = 0 if state is None else state.length
        n_ids = min(len(ids), max(cfg.max_ctx - start - 2, 1))
        if max_frames is None:
            max_frames = max(4, int(len(text) * frames_per_char))
        max_delay = cfg.max_delay
        budget = cfg.max_ctx - start - n_ids - 1
        if budget - max_delay < 1:
            # no room for one frame: a forced one would write past max_ctx
            logger.warning("pocket generate_stream: context exhausted (start=%d, n_ids=%d, max_ctx=%d); "
                           "emitting nothing", start, n_ids, cfg.max_ctx)
            return
        max_frames = min(max_frames, budget - max_delay)

        pad_to = _bucket(n_ids, cap=max(cfg.max_ctx - start - 1, 1))
        text_np = np.full((1, pad_to), cfg.text_pad_id, np.int64)
        text_np[0, :n_ids] = ids[:n_ids]
        with inference():
            if state is None:
                caches = init_caches(cfg, 1, self.lm_params["text_emb"].dtype, dev)
            else:  # the cached voice stays as it is: generation writes a copy
                caches = (state.k_cache.clone(), state.v_cache.clone())
            audio_grid = torch.full((1, cfg.n_q, pad_to), cfg.audio_initial, dtype=torch.int64, device=dev)
            caches = _prefill(self.lm_params, cfg, torch.from_numpy(text_np).to(dev), audio_grid, caches, start,
                              n_ids)
        pos = start + n_ids
        generator = torch.Generator(device=dev).manual_seed(seed) if temperature > 0 else None
        delays = np.asarray(cfg.delays)
        n_steps = max_frames + max_delay
        outs = np.full((cfg.n_q, n_steps), cfg.audio_initial, np.int64)
        audio_in = torch.full((1, cfg.n_q), cfg.audio_initial, dtype=torch.int64, device=dev)
        text_pad = torch.full((1,), cfg.text_pad_id, dtype=torch.int64, device=dev)
        decoder = MimiStreamingDecoder(self.mimi_params, self.mimi_cfg, block_frames=block_frames)
        emitted = 0
        for s in range(n_steps):
            with inference():
                toks, _text_logits, caches = _gen_step(
                    self.lm_params, cfg, text_pad, text_pad, audio_in, caches,
                    torch.full((1,), pos, dtype=torch.int64, device=dev), temperature, generator)
                # streams whose frame index (s - delay) is out of range stay initial
                frame_idx = s - delays
                live = (frame_idx >= 0) & (frame_idx < max_frames)
                forced = np.where(live, toks[0].cpu().numpy(), cfg.audio_initial)
            outs[:, s] = forced
            audio_in = torch.from_numpy(forced[None]).to(dev)
            pos += 1
            ready = min(s + 1 - max_delay, max_frames)  # frames fully decided
            if ready - emitted >= block_frames or (ready == max_frames and ready > emitted):
                frames = np.stack([outs[k, emitted + delays[k]: ready + delays[k]] for k in range(cfg.n_q)])[None]
                emitted = ready
                yield decoder.feed(frames)[0]

    def generate(self, text: str, state: PromptState | None = None, **kw) -> np.ndarray:
        """Non-streaming convenience: the whole waveform [T]."""
        blocks = list(self.generate_stream(text, state, **kw))
        return np.concatenate(blocks) if blocks else np.zeros((0,), np.float32)
