"""Long-form transcription: seek loop, temperature fallback, segments.

Counterpart of ``open_speech_tpu/models/whisper/transcribe.py``: 30 s window
seek loop, beam search at temperature 0 with sampled fallbacks on
quality-gate failure (compression_ratio > 2.4 or avg_logprob < -1.0),
<|nospeech|> skipping, timestamp-token segmentation and
condition-on-previous-text. The output ``Segment``s carry the fields of
verbose_json. With a ``draft`` model, temperature-0 greedy attempts of one
prompt row go through ``speculative.speculative_greedy_decode``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from open_speech_tpu_torch.models.whisper.decode import (
    DecodeOptions,
    DecodeResult,
    beam_decode,
    compression_ratio,
    detect_language,
    greedy_decode,
)
from open_speech_tpu_torch.models.whisper.model import Whisper, WhisperConfig, encode
from open_speech_tpu_torch.models.whisper.speculative import speculative_greedy_decode
from open_speech_tpu_torch.ops.mel import HOP_LENGTH, SAMPLE_RATE, log_mel_spectrogram

TIME_PER_FRAME = HOP_LENGTH / SAMPLE_RATE  # 0.01 s


@dataclass
class Segment:
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: list[int]
    temperature: float
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float


@dataclass
class TranscriptionInfo:
    language: str
    language_probability: float
    duration: float


@dataclass(frozen=True)
class TranscribeOptions:
    task: str = "transcribe"
    language: str | None = None
    beam_size: int = 5
    temperature: tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: float | None = 2.4
    logprob_threshold: float | None = -1.0
    no_speech_threshold: float | None = 0.6
    condition_on_previous_text: bool = True
    initial_prompt: str | None = None
    timestamps: bool = True
    max_new_tokens: int = 224


# geometric ladder of mel window counts (last rung = 1 h; longer files
# round up to multiples of it). The audio is zero-padded to a rung plus one
# silent window before the mel, as the JAX package does: the padding is
# part of the mel's peak, so it has to match exactly.
_WINDOW_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 120)


def _bucket_prev(prev: list[int], room: int) -> list[int]:
    """Trim previous-text conditioning to a bucketed length (the JAX
    package's prompt-shape ladder; conditioning is a soft prior)."""
    prev = prev[-room:]
    keep = 0
    for b in (4, 8, 16, 32, 64, 128, room):
        if b <= len(prev) and b <= room:
            keep = b
    return prev[len(prev) - keep :] if keep else []


@torch.no_grad()
def transcribe(
    model: Whisper,
    cfg: WhisperConfig,
    tokenizer,
    audio: np.ndarray,
    opts: TranscribeOptions = TranscribeOptions(),
    draft: dict | None = None,
) -> tuple[list[Segment], TranscriptionInfo]:
    """Transcribe float32 16 kHz mono audio of any length on the model's device.

    ``draft`` ({"model", "cfg", "gamma"}): a speculative draft sharing the
    vocabulary; each window is encoded by it too.
    """
    sp = tokenizer.special
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    duration = len(audio) / SAMPLE_RATE
    n_frames_total = len(audio) // HOP_LENGTH
    # a window is n_audio_ctx*2 feature frames (3000 = 30 s for real configs)
    frames_per_window = cfg.n_audio_ctx * 2
    window_samples = frames_per_window * HOP_LENGTH

    n_windows = max(1, -(-len(audio) // window_samples))
    n_windows = next(
        (b for b in _WINDOW_BUCKETS if b >= n_windows),
        -(-n_windows // _WINDOW_BUCKETS[-1]) * _WINDOW_BUCKETS[-1],
    )
    padded = np.zeros((n_windows + 1) * window_samples, np.float32)
    padded[: len(audio)] = audio
    mel_full = log_mel_spectrogram(
        torch.from_numpy(padded).to(model.device), n_mels=cfg.n_mels
    )

    language = opts.language
    language_prob = 1.0

    segments: list[Segment] = []
    all_tokens: list[int] = []
    prompt_reset_since = 0
    if opts.initial_prompt:
        all_tokens.extend(tokenizer.encode(" " + opts.initial_prompt.strip()))

    seek = 0
    seg_id = 0
    n_frames_total = max(n_frames_total, 1)
    while seek < n_frames_total:
        # the extra silent window above guarantees the slice never clamps
        window = mel_full[:, seek : seek + frames_per_window]
        window_frames = min(frames_per_window, n_frames_total - seek)
        time_offset = seek * TIME_PER_FRAME

        enc_out = encode(model, window[None], cfg)
        d_enc_out = (
            encode(draft["model"], window[None], draft["cfg"]) if draft is not None else None
        )

        if language is None:
            codes, probs = detect_language(model, cfg, sp, enc_out)
            language, language_prob = codes[0], float(probs[0])

        # build prompt: optional previous-text conditioning
        prompt: list[int] = []
        if opts.condition_on_previous_text and all_tokens[prompt_reset_since:]:
            prev = _bucket_prev(
                all_tokens[prompt_reset_since:], cfg.n_text_ctx // 2 - 1
            )
            if prev:
                prompt = [sp.startofprev] + prev
        prompt += sp.sot_sequence(
            language or "en", opts.task, timestamps=opts.timestamps
        )

        result = _decode_with_fallback(
            model, cfg, tokenizer, enc_out, np.array([prompt], np.int32), opts,
            draft=draft, d_enc_out=d_enc_out,
        )
        tokens = [int(t) for t in result.tokens[0][: result_len(result)]]
        text = tokenizer.decode(tokens)
        ratio = compression_ratio(text)

        # no-speech skip (whisper heuristic)
        if opts.no_speech_threshold is not None:
            should_skip = float(result.no_speech_prob[0]) > opts.no_speech_threshold
            if (
                opts.logprob_threshold is not None
                and float(result.avg_logprob[0]) > opts.logprob_threshold
            ):
                should_skip = False
            if should_skip:
                seek += window_frames
                continue

        new_segments, seek_advance = _split_segments(
            tokens, tokenizer, time_offset, window_frames
        )
        for seg_tokens, start, end in new_segments:
            seg_text = tokenizer.decode(seg_tokens)
            if not seg_text.strip():
                continue
            segments.append(
                Segment(
                    id=seg_id,
                    seek=seek,
                    start=round(start, 3),
                    end=round(end, 3),
                    text=seg_text,
                    tokens=seg_tokens,
                    temperature=result.temperature,
                    avg_logprob=float(result.avg_logprob[0]),
                    compression_ratio=ratio,
                    no_speech_prob=float(result.no_speech_prob[0]),
                )
            )
            seg_id += 1
            all_tokens.extend(seg_tokens)
        if result.temperature > 0.5:
            # unreliable window: don't condition the next one on it
            prompt_reset_since = len(all_tokens)
        seek += seek_advance

    info = TranscriptionInfo(
        language=language or "en",
        language_probability=language_prob,
        duration=round(duration, 3),
    )
    return segments, info


def result_len(result: DecodeResult) -> int:
    return int(result.lengths[0])


def _decode_with_fallback(
    model, cfg, tokenizer, enc_out, prompt, opts: TranscribeOptions,
    draft: dict | None = None, d_enc_out=None,
) -> DecodeResult:
    """Beam search at t=0 (greedy when beam_size is 1: speculative with a
    draft and one prompt row), then sampled decodes at the fallback
    temperatures, each from a generator seeded int(temperature * 1000)."""
    sp = tokenizer.special
    suppress = tuple(tokenizer.non_speech_tokens)
    result = None
    for temperature in opts.temperature:
        dopts = DecodeOptions(
            task=opts.task,
            temperature=temperature,
            beam_size=opts.beam_size,
            max_new_tokens=opts.max_new_tokens,
            timestamps=opts.timestamps,
            suppress_tokens=suppress,
        )
        if temperature == 0.0 and opts.beam_size > 1:
            result = beam_decode(model, cfg, sp, enc_out, prompt, dopts)
        elif (
            temperature == 0.0
            and draft is not None
            and d_enc_out is not None
            and prompt.shape[0] == 1
        ):
            result = speculative_greedy_decode(
                model, cfg, draft["model"], draft["cfg"], sp, enc_out, d_enc_out,
                prompt, dopts, gamma=int(draft.get("gamma", 4)),
            )
        else:
            gen = torch.Generator(device=enc_out.device).manual_seed(
                int(temperature * 1000)
            )
            result = greedy_decode(model, cfg, sp, enc_out, prompt, dopts, generator=gen)
        tokens = [int(t) for t in result.tokens[0][: result_len(result)]]
        text = tokenizer.decode(tokens)
        needs_fallback = False
        if (
            opts.compression_ratio_threshold is not None
            and compression_ratio(text) > opts.compression_ratio_threshold
        ):
            needs_fallback = True
        if (
            opts.logprob_threshold is not None
            and float(result.avg_logprob[0]) < opts.logprob_threshold
        ):
            needs_fallback = True
        if (
            opts.no_speech_threshold is not None
            and float(result.no_speech_prob[0]) > opts.no_speech_threshold
        ):
            needs_fallback = False  # silence: keep, the caller will skip
        if not needs_fallback:
            break
    return result


def _split_segments(
    tokens: list[int], tokenizer, time_offset: float, window_frames: int
) -> tuple[list[tuple[list[int], float, float]], int]:
    """Split sampled tokens on timestamp pairs.

    Returns (segments [(tokens, start_s, end_s)], seek advance in frames).
    """
    sp = tokenizer.special
    ts = sp.timestamp_begin
    window_dur = window_frames * TIME_PER_FRAME

    segs: list[tuple[list[int], float, float]] = []
    if not tokens:
        return segs, window_frames

    consecutive = [
        i + 1
        for i in range(len(tokens) - 1)
        if tokens[i] >= ts and tokens[i + 1] >= ts
    ]
    if consecutive:
        # windows with multiple complete segments
        last_slice = 0
        for cut in consecutive:
            sliced = tokens[last_slice:cut]
            start_tok, end_tok = sliced[0], sliced[-1]
            segs.append(
                (
                    [t for t in sliced if t < sp.eot],
                    time_offset + (start_tok - ts) * 0.02,
                    time_offset + (end_tok - ts) * 0.02,
                )
            )
            last_slice = cut
        last_ts = tokens[consecutive[-1] - 1]
        seek_advance = round((last_ts - ts) * 0.02 / TIME_PER_FRAME)
        if seek_advance <= 0:
            # degenerate pair at the window start: skip the window rather
            # than re-decode the same audio one frame later
            seek_advance = window_frames
        seek_advance = min(seek_advance, window_frames)
    else:
        # single segment covering the window (or ending at a final timestamp)
        timestamps = [t for t in tokens if t >= ts]
        end = time_offset + window_dur
        if timestamps and timestamps[-1] != ts:
            end = time_offset + (timestamps[-1] - ts) * 0.02
        start = time_offset + ((timestamps[0] - ts) * 0.02 if timestamps else 0.0)
        segs.append(([t for t in tokens if t < sp.eot], start, end))
        seek_advance = window_frames
    return segs, seek_advance


# ──────────────────────────────────────────────────────────────────────
# Response formatting (verbose_json schema)
# ──────────────────────────────────────────────────────────────────────


def build_response(
    segments: list[Segment],
    info: TranscriptionInfo,
    task: str,
    response_format: str,
) -> dict:
    """Assemble the API response dict."""
    from open_speech_tpu_torch.text.formatters import segments_to_srt, segments_to_vtt

    full_text = "".join(s.text for s in segments).strip()
    if response_format == "verbose_json":
        return {
            "task": task,
            "language": info.language,
            "duration": info.duration,
            "text": full_text,
            "segments": [
                {
                    "id": s.id,
                    "seek": int(s.seek),
                    "start": s.start,
                    "end": s.end,
                    "text": s.text,
                    "tokens": list(s.tokens),
                    "temperature": s.temperature,
                    "avg_logprob": s.avg_logprob,
                    "compression_ratio": s.compression_ratio,
                    "no_speech_prob": s.no_speech_prob,
                }
                for s in segments
            ],
        }
    if response_format == "text":
        return {"text": full_text, "raw_text": True}
    if response_format == "srt":
        return {"text": segments_to_srt(segments), "raw_text": True}
    if response_format == "vtt":
        return {"text": segments_to_vtt(segments), "raw_text": True}
    return {"text": full_text}
