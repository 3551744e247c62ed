"""Incremental O(n) streaming encoder for whisper.

Counterpart of ``open_speech_tpu/models/whisper/streaming.py``. Each mel
frame is encoded once:

  - the encoder runs **block-causally**: audio arrives in blocks of
    ``block_pos`` encoder positions; a new block's queries attend to the
    cached keys/values of every position so far (per-layer KV caches padded
    to ``n_audio_ctx``, read through the length-masked flash kernel K2 with
    ``kv_length = pos_start + npos``), and committed states are never
    recomputed. Interim results ride these states; the decoder masks
    positions past the real audio.
  - interim decodes run over a **bucketed** encoder-state prefix
    (256/512/1024/1500 positions), as in the JAX package.

The caches live on the model's device and are written in place. Committed
blocks own positions [0, _committed). An interim's tail blocks write only
positions >= _committed, which the next commit overwrites, except for the
clamped last block near the end of the window: it starts before
_committed, so the committed values it overwrites are saved first and put
back after the interim (the JAX interim works on a copy and never touches
the committed state; this keeps that contract without copying the caches).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from open_speech_tpu_torch.models.whisper.model import (
    Whisper,
    WhisperConfig,
    _merge_heads,
    _split_heads,
    conv_stem,
    layer_norm,
    linear,
    mlp,
)
from open_speech_tpu_torch.ops.attention import flash_attention
from open_speech_tpu_torch.ops.mel import log_mel_spectrogram

BLOCK_POS = 128  # encoder positions per block (2.56 s of audio)
DECODE_BUCKETS = (256, 512, 1024, 1500)
# confirmed-prefix ladder for interim decodes: forced token counts snap to
# these so prompt shapes stay bounded (see server/streaming.py work())
FORCED_BUCKETS = (16, 32, 64, 96, 128, 160)


def forced_bucket(n_confirmed_tokens: int, room: int = 1 << 30) -> int:
    """Largest ladder step <= the confirmed token count (0 below the
    ladder). ``room`` caps the step so sot + prefix + a generation tail
    still fit the model's text context (tiny test configs, long prefixes).
    """
    fb = 0
    for b in FORCED_BUCKETS:
        if b <= n_confirmed_tokens and b <= room:
            fb = b
    return fb


def forced_room(cfg, sot_len: int) -> int:
    """Max forced-prefix length leaving >=32 generated tokens + EOT."""
    return max(0, cfg.n_text_ctx - sot_len - 33)


# Hard cap on tokens GENERATED per interim decode. Real speech exits at EOT
# long before it; the cap only binds when no EOT comes (noise,
# hallucination), and bounds one interim's device time. The confirmed
# prefix is forced (one prefill pass), so a long unconfirmed tail is
# confirmed over the next few interims instead of regenerated whole.
INTERIM_TAIL_CAP = 48


def interim_budget(bucket: int, n_forced: int) -> int:
    """max_new_tokens for an interim decode at this (enc bucket, forced
    prefix) pair, shared by the serving path and the load-time warmup."""
    budget = min(224, max(32, (bucket * 12 * 2) // 100 + 16))
    budget = -(-budget // 16) * 16
    return max(32, min(INTERIM_TAIL_CAP, budget - n_forced))


def final_budget(bucket: int) -> int:
    """max_new_tokens for a FINAL decode over incremental encoder states:
    the whole utterance fresh (no forced prefix, no tail cap), scaled with
    the audio bucket up to whisper's 224-token window."""
    budget = min(224, max(32, (bucket * 12 * 2) // 100 + 16))
    return -(-budget // 16) * 16


@torch.no_grad()
def _encode_block(
    model: Whisper,
    mel_seg: torch.Tensor,
    pos_start: int,
    kcache: torch.Tensor,
    vcache: torch.Tensor,
    enc_buf: torch.Tensor,
    *,
    dh: int,
    npos: int,
) -> None:
    """Encode ``npos`` new positions given the cached prefix, in place.

    mel_seg: [B, n_mels, 2*npos + 4], mel frames [2*P0-2, 2*(P0+npos)+2)
    zero-padded at the utterance edges, so the conv stem's receptive field
    matches the full encoder exactly (local position j=1 is global P0+j-1
    after the stride-2 conv). kcache/vcache: [L, B, H, n_audio_ctx, Dh];
    enc_buf: [B, n_audio_ctx, D]. Writes K/V and encoder states at
    [pos_start, pos_start + npos).
    """
    enc = model.encoder
    x = conv_stem(enc, mel_seg, first_frame=2 * pos_start - 2)
    x = x[:, 1 : 1 + npos] + enc.pos[pos_start : pos_start + npos]  # valid interior
    end = pos_start + npos
    lens = torch.full((x.shape[0],), end, dtype=torch.int32, device=x.device)
    for i, blk in enumerate(enc.blocks):
        hn = layer_norm(x, blk.ln1)
        q = _split_heads(linear(hn, blk.attn.q), dh)
        kcache[i, :, :, pos_start:end] = _split_heads(linear(hn, blk.attn.k), dh)
        vcache[i, :, :, pos_start:end] = _split_heads(linear(hn, blk.attn.v), dh)
        att = flash_attention(q, kcache[i], vcache[i], causal=False, kv_length=lens)
        x = x + linear(_merge_heads(att), blk.attn.o)
        x = x + mlp(layer_norm(x, blk.ln_mlp), blk)
    enc_buf[:, pos_start:end] = layer_norm(x, enc.ln_post)


class StreamingWhisperEncoder:
    """Per-utterance incremental encoder state (one stream), on the model's
    device.

    ``append_audio`` buffers 16 kHz float PCM; committed blocks encode once
    and are never revisited. ``interim_states`` returns (enc_states
    [1, bucket, D], bucket): the committed prefix plus a freshly encoded
    tail covering the real audio, zeros past it, ready for
    ``greedy_decode``. ``block_encodes`` counts committed blocks and
    ``tail_encodes`` interim tail blocks; each block launches K2 once per
    encoder layer.
    """

    def __init__(self, model: Whisper, cfg: WhisperConfig, block_pos: int = BLOCK_POS):
        self.model = model
        self.cfg = cfg
        self.block_pos = min(block_pos, cfg.n_audio_ctx)
        dh = cfg.head_dim
        dtype = model.encoder.conv1.weight.dtype
        dev = model.device
        shape = (cfg.n_audio_layer, 1, model.audio_heads, cfg.n_audio_ctx, dh)
        self._kc = torch.zeros(shape, dtype=dtype, device=dev)
        self._vc = torch.zeros(shape, dtype=dtype, device=dev)
        self._enc = torch.zeros((1, cfg.n_audio_ctx, cfg.n_audio_state), dtype=dtype, device=dev)
        self._pcm = np.zeros((0,), np.float32)
        self._committed = 0  # encoder positions encoded-and-cached
        self.block_encodes = 0
        self.tail_encodes = 0

    # ── audio plumbing ────────────────────────────────────────────────

    def append_audio(self, pcm: np.ndarray) -> None:
        self._pcm = np.concatenate([self._pcm, np.asarray(pcm, np.float32)])
        self._commit_full_blocks()

    @property
    def total_positions(self) -> int:
        """Encoder positions covered by buffered audio (2 mel frames each)."""
        return min(len(self._pcm) // 320, self.cfg.n_audio_ctx)

    def _mel_segment(self, p0: int, npos: int) -> torch.Tensor:
        """Mel frames [2*p0-2, 2*(p0+npos)+2) with zero padding at edges.

        Two context frames each side guard the STFT's center/reflect
        padding so interior frames match the whole-utterance mel exactly.
        (One approximation remains: whisper's dynamic-range floor ``max -
        8`` uses the segment max, not the final utterance max; it only binds
        on bins 8 decades under the peak.)
        """
        lo_f, hi_f = 2 * p0 - 2, 2 * (p0 + npos) + 2
        ctx = 2  # reflect padding reaches 200 samples = 1.25 frames
        lo_c = max(lo_f - ctx, 0)
        hi_c = hi_f + ctx
        seg = self._pcm[lo_c * 160 : hi_c * 160]
        want = (hi_c - lo_c) * 160
        if len(seg) < want:
            seg = np.pad(seg, (0, want - len(seg)))
        mel = log_mel_spectrogram(
            torch.from_numpy(seg).to(self.model.device), n_mels=self.cfg.n_mels
        )
        start = max(lo_f, 0) - lo_c
        mel = mel[:, start : start + (hi_f - max(lo_f, 0))]
        if lo_f < 0:
            mel = F.pad(mel, (-lo_f, 0))
        return mel[None]  # [1, n_mels, 2*npos+4]

    def _commit_full_blocks(self) -> None:
        # +2 positions of margin: the last kept conv output reads one mel
        # frame past the block edge; commit only audio-backed states
        while (
            self.total_positions - self._committed >= self.block_pos + 2
            and self._committed < self.cfg.n_audio_ctx
        ):
            self._encode_block(self._committed)
            self._committed += self.block_pos
            self.block_encodes += 1

    def _encode_block(self, p0: int) -> None:
        _encode_block(
            self.model, self._mel_segment(p0, self.block_pos), p0,
            self._kc, self._vc, self._enc,
            dh=self.cfg.head_dim, npos=self.block_pos,
        )

    # ── interim state for decoding ────────────────────────────────────

    def decode_bucket(self) -> int:
        need = min(self.total_positions, self.cfg.n_audio_ctx)
        for b in DECODE_BUCKETS:
            if b >= need and b <= self.cfg.n_audio_ctx:
                return b
        return min(DECODE_BUCKETS[-1], self.cfg.n_audio_ctx)

    @property
    def real_positions(self) -> int:
        """Audio-backed encoder positions (for masked cross-attention)."""
        return min(self.total_positions, self.cfg.n_audio_ctx)

    def interim_states(self) -> tuple[torch.Tensor, int]:
        """(enc_states [1, bucket, D], bucket): committed prefix + a freshly
        encoded tail covering the real-audio remainder. Tail blocks are
        recomputed per interim and not committed; only audio-backed blocks
        are encoded, and positions between ``real_positions`` and the
        bucket edge stay zero (the decoder masks them via ``enc_len``)."""
        bucket = self.decode_bucket()
        p0 = self._committed
        last_start = self.cfg.n_audio_ctx - self.block_pos
        encode_to = min(bucket, -(-self.real_positions // self.block_pos) * self.block_pos)
        saved = None
        while p0 < encode_to:
            # a block may not run past n_audio_ctx: the final block starts
            # earlier instead, over committed positions, which it re-derives
            # over a longer context; the committed values come back after
            start = min(p0, last_start)
            if start < self._committed:
                c = self._committed
                saved = (start, c, self._kc[:, :, :, start:c].clone(),
                         self._vc[:, :, :, start:c].clone(), self._enc[:, start:c].clone())
            self._encode_block(start)
            self.tail_encodes += 1
            p0 = start + self.block_pos
        states = self._enc[:, :bucket].clone()
        if saved is not None:
            start, c, kc, vc, enc = saved
            self._kc[:, :, :, start:c] = kc
            self._vc[:, :, :, start:c] = vc
            self._enc[:, start:c] = enc
        return states, bucket

    def reset(self) -> None:
        self._kc.zero_()
        self._vc.zero_()
        self._enc.zero_()
        self._pcm = np.zeros((0,), np.float32)
        self._committed = 0
