"""Batched long-form transcription: decode many 30 s windows per step.

Counterpart of ``open_speech_tpu/models/whisper/batched.py``. The
sequential seek loop (``transcribe.py``) decodes one window at a time, each
conditioned on the previous text, so a T-second file costs ceil(T/30)
decodes in series. Here the file is cut into chunks of at most one window
at quiet points, up to 16 chunks are encoded and decoded as one batch with
no cross-window conditioning, and the per-chunk segments are merged. The
output schema is the sequential path's; the text can differ slightly
because conditioning is off.

Chunk cuts snap to the quietest point (short-time RMS) inside the trailing seconds of each
window, so words are not split at fixed grid edges.
"""

from __future__ import annotations

import numpy as np
import torch

from open_speech_tpu_torch.models.whisper.decode import (
    DecodeOptions,
    beam_decode,
    compression_ratio,
    detect_language,
    greedy_decode,
)
from open_speech_tpu_torch.models.whisper.model import Whisper, WhisperConfig, encode
from open_speech_tpu_torch.models.whisper.transcribe import (
    Segment,
    TranscribeOptions,
    TranscriptionInfo,
    transcribe,
)
from open_speech_tpu_torch.ops.mel import HOP_LENGTH, SAMPLE_RATE, log_mel_spectrogram

TIME_PER_FRAME = HOP_LENGTH / SAMPLE_RATE  # 0.01 s

# batch-size ladder: every decode batch is padded to a rung
BATCH_BUCKETS = (1, 2, 4, 8, 16)

# Conditioning-prefix length for prompted uploads: the initial_prompt is
# padded (leading space tokens) or trimmed (oldest dropped) to exactly this
# many tokens, as the JAX package does to bound its compiled shapes
BATCHED_PREV_LEN = 32

_CURVE_HOP = 512  # quietness-curve resolution (32 ms at 16 kHz)


def quietness_curve(audio: np.ndarray, hop: int = _CURVE_HOP) -> np.ndarray:
    """Short-time RMS per ``hop``-sample window (lower = quieter)."""
    n = len(audio) // hop
    if n == 0:
        return np.zeros((0,), np.float32)
    x = audio[: n * hop].astype(np.float32).reshape(n, hop)
    return np.sqrt((x * x).mean(axis=1))


def chunk_boundaries(
    n_samples: int,
    window_samples: int,
    curve: np.ndarray | None = None,
    *,
    curve_hop: int = _CURVE_HOP,
    snap_s: float = 3.0,
    min_chunk_s: float = 5.0,
) -> list[tuple[int, int]]:
    """Cut ``n_samples`` into consecutive chunks of <= ``window_samples``.

    Each interior cut snaps to the quietest curve point within the final
    ``snap_s`` seconds of the window (never earlier than ``min_chunk_s``
    into the chunk), and is aligned to the mel hop so chunk frame counts
    are exact.
    """
    snap = int(snap_s * SAMPLE_RATE)
    min_chunk = int(min_chunk_s * SAMPLE_RATE)
    out: list[tuple[int, int]] = []
    start = 0
    while start < n_samples:
        end = start + window_samples
        if end >= n_samples:
            out.append((start, n_samples))
            break
        if curve is not None and curve.size and snap > 0:
            lo = max(start + min(min_chunk, window_samples // 2), end - snap)
            w0, w1 = lo // curve_hop, end // curve_hop
            if w1 > w0:
                cut = (w0 + int(np.argmin(curve[w0:w1]))) * curve_hop
                # the quiet point itself stays in the EARLIER chunk, so a
                # trailing word's release tail is not orphaned
                end = min(max(cut + curve_hop, lo), end)
        end -= end % HOP_LENGTH  # whole mel frames per chunk
        end = max(end, start + HOP_LENGTH)
        out.append((start, end))
        start = end
    return out


def _split_all_segments(
    tokens: list[int], tokenizer, time_offset: float, window_frames: int
) -> list[tuple[list[int], float, float]]:
    """Split one window's tokens on timestamp pairs, KEEPING the tail.

    The sequential splitter drops tokens after the last consecutive
    timestamp pair because the seek loop re-decodes that audio; a batched
    window is decoded once, so its trailing group becomes a segment too.
    Timestamps are clamped to the chunk's real duration, so segments never
    overlap the next chunk.
    """
    sp = tokenizer.special
    ts = sp.timestamp_begin
    window_dur = window_frames * TIME_PER_FRAME
    segs: list[tuple[list[int], float, float]] = []
    if not tokens:
        return segs

    consecutive = [
        i + 1
        for i in range(len(tokens) - 1)
        if tokens[i] >= ts and tokens[i + 1] >= ts
    ]

    def _t(tok: int) -> float:
        return time_offset + min((tok - ts) * 0.02, window_dur)

    last_slice = 0
    for cut in consecutive:
        sliced = tokens[last_slice:cut]
        segs.append(([t for t in sliced if t < sp.eot], _t(sliced[0]), _t(sliced[-1])))
        last_slice = cut
    tail = tokens[last_slice:]
    if any(t < sp.eot for t in tail):
        timestamps = [t for t in tail if t >= ts]
        # a LEADING timestamp marks the start, a TRAILING one the end; a
        # tail with only its leading timestamp runs to the window edge
        if tail[0] >= ts:
            start = _t(tail[0])
        elif segs:
            start = segs[-1][2]  # continuation of the previous cut
        else:
            start = time_offset
        if tail[-1] >= ts or len(timestamps) > (1 if tail[0] >= ts else 0):
            end = _t(timestamps[-1])
        else:
            end = time_offset + window_dur
        segs.append(([t for t in tail if t < sp.eot], start, max(end, start)))
    return segs


def _bucket(n: int) -> int:
    for b in BATCH_BUCKETS:
        if b >= n:
            return b
    return BATCH_BUCKETS[-1]


def _decode_rows_with_fallback(
    model: Whisper, cfg: WhisperConfig, tokenizer, enc_out: torch.Tensor,
    prompt: np.ndarray, opts: TranscribeOptions,
) -> list[dict]:
    """Decode B rows with per-row temperature fallback.

    All rows decode at temperature 0 first (beam by default, as the REST
    path does); only rows failing the quality gates re-decode at the next
    temperature, re-batched and padded to the bucket ladder by repeating a
    real row. A sampled round draws from a generator seeded
    int(temperature * 1000), as ``transcribe.py`` does, so its tokens
    differ from the JAX package's ``jax.random`` draws by design.
    """
    sp = tokenizer.special
    suppress = tuple(tokenizer.non_speech_tokens)
    b = int(enc_out.shape[0])
    final: list[dict | None] = [None] * b
    pending = list(range(b))
    for temperature in opts.temperature:
        bucket = _bucket(len(pending))
        idx = pending + [pending[0]] * (bucket - len(pending))
        sub_enc = enc_out[torch.tensor(idx, device=enc_out.device)]
        sub_prompt = np.repeat(prompt, bucket, axis=0)  # the same prompt per chunk
        dopts = DecodeOptions(
            task=opts.task,
            temperature=temperature,
            beam_size=opts.beam_size,
            max_new_tokens=opts.max_new_tokens,
            timestamps=opts.timestamps,
            suppress_tokens=suppress,
        )
        if temperature == 0.0 and opts.beam_size > 1:
            result = beam_decode(model, cfg, sp, sub_enc, sub_prompt, dopts)
        else:
            gen = torch.Generator(device=enc_out.device).manual_seed(int(temperature * 1000))
            result = greedy_decode(model, cfg, sp, sub_enc, sub_prompt, dopts, generator=gen)
        still: list[int] = []
        for j, row in enumerate(pending):
            tokens = [int(t) for t in result.tokens[j][: int(result.lengths[j])]]
            ratio = compression_ratio(tokenizer.decode(tokens))
            entry = {
                "tokens": tokens,
                "avg_logprob": float(result.avg_logprob[j]),
                "no_speech_prob": float(result.no_speech_prob[j]),
                "compression_ratio": ratio,
                "temperature": temperature,
            }
            needs_fallback = False
            if (
                opts.compression_ratio_threshold is not None
                and ratio > opts.compression_ratio_threshold
            ):
                needs_fallback = True
            if (
                opts.logprob_threshold is not None
                and entry["avg_logprob"] < opts.logprob_threshold
            ):
                needs_fallback = True
            if (
                opts.no_speech_threshold is not None
                and entry["no_speech_prob"] > opts.no_speech_threshold
            ):
                needs_fallback = False  # silence: keep, the caller skips it
            final[row] = entry
            if needs_fallback and temperature != opts.temperature[-1]:
                still.append(row)
        pending = still
        if not pending:
            break
    return final  # type: ignore[return-value]


@torch.no_grad()
def transcribe_batched(
    model: Whisper,
    cfg: WhisperConfig,
    tokenizer,
    audio: np.ndarray,
    opts: TranscribeOptions = TranscribeOptions(),
    *,
    max_batch: int = 16,
) -> tuple[list[Segment], TranscriptionInfo]:
    """Transcribe long float32 16 kHz audio by batching independent chunks
    of at most one window, on the model's device.

    Single-window audio delegates to the sequential path (identical
    output). Cuts snap on the audio's short-time RMS.
    """
    sp = tokenizer.special
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    duration = len(audio) / SAMPLE_RATE
    window_samples = cfg.n_audio_ctx * 2 * HOP_LENGTH

    if len(audio) <= window_samples:
        return transcribe(model, cfg, tokenizer, audio, opts)

    chunks = chunk_boundaries(len(audio), window_samples, quietness_curve(audio))

    n = len(chunks)
    language = opts.language
    language_prob = 1.0
    segments: list[Segment] = []
    seg_id = 0
    max_batch = max(1, min(max_batch, BATCH_BUCKETS[-1]))

    pos = 0
    while pos < n:
        take = min(max_batch, n - pos)
        bucket = _bucket(take)
        # one [bucket, window] block of chunks right-padded with silence
        block = np.zeros((bucket, window_samples), np.float32)
        for j in range(take):
            s, e = chunks[pos + j]
            block[j, : e - s] = audio[s:e]
        mel = log_mel_spectrogram(torch.from_numpy(block).to(model.device), n_mels=cfg.n_mels)
        enc_out = encode(model, mel, cfg)

        if language is None:
            codes, probs = detect_language(model, cfg, sp, enc_out[:1])
            language, language_prob = codes[0], float(probs[0])

        prefix: list[int] = []
        if opts.initial_prompt:
            # chunks are independent, so the style/vocabulary hint
            # conditions every chunk, padded or trimmed to one length
            fb = min(BATCHED_PREV_LEN, cfg.n_text_ctx // 2 - 1)
            prev = tokenizer.encode(" " + opts.initial_prompt.strip())[-fb:]
            if prev and fb > 0:
                pad = tokenizer.encode(" ")
                filler = pad if len(pad) == 1 else [prev[0]]
                prev = filler * (fb - len(prev)) + prev
                prefix = [sp.startofprev] + prev
        prompt = np.asarray(
            [prefix + sp.sot_sequence(language or "en", opts.task, timestamps=opts.timestamps)],
            np.int32,
        )
        # only real rows enter the fallback rounds: the bucket's silent
        # padding rows would fail the gates and drag extra rounds along
        rows = _decode_rows_with_fallback(model, cfg, tokenizer, enc_out[:take], prompt, opts)
        for j in range(take):
            row = rows[j]
            s, e = chunks[pos + j]
            if opts.no_speech_threshold is not None:
                should_skip = row["no_speech_prob"] > opts.no_speech_threshold
                if (
                    opts.logprob_threshold is not None
                    and row["avg_logprob"] > opts.logprob_threshold
                ):
                    should_skip = False
                if should_skip:
                    continue
            for seg_tokens, start, end in _split_all_segments(
                row["tokens"], tokenizer, s / SAMPLE_RATE, (e - s) // HOP_LENGTH
            ):
                seg_text = tokenizer.decode(seg_tokens)
                if not seg_text.strip():
                    continue
                segments.append(
                    Segment(
                        id=seg_id,
                        seek=s // HOP_LENGTH,
                        start=round(start, 3),
                        end=round(end, 3),
                        text=seg_text,
                        tokens=seg_tokens,
                        temperature=row["temperature"],
                        avg_logprob=row["avg_logprob"],
                        compression_ratio=row["compression_ratio"],
                        no_speech_prob=row["no_speech_prob"],
                    )
                )
                seg_id += 1
        pos += take

    info = TranscriptionInfo(
        language=language or "en",
        language_probability=language_prob,
        duration=round(duration, 3),
    )
    return segments, info
