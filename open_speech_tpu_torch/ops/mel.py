"""Whisper log-mel front-end as three matmuls.

Counterpart of ``open_speech_tpu/ops/mel.py``: framing (reflect padding,
``unfold``), window-folded real-DFT bases, power, the Slaney mel filterbank,
then log10 / clamp at the peak - 8 / (x + 4) / 4. Numerics follow
openai-whisper's ``log_mel_spectrogram``; the tables are built with numpy
exactly as the JAX package builds them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False): linear <1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    lin = 3.0 * f / 200.0
    log_step = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz, 15.0 + np.log(np.maximum(f, 1e-10) / min_log_hz) / log_step, lin
    )


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), 200.0 * m / 3.0)


@lru_cache(maxsize=4)
def mel_filterbank(n_mels: int, n_fft: int = N_FFT, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, [n_mels, n_fft//2+1]
    (librosa.filters.mel defaults: fmin=0, fmax=sr/2, norm="slaney")."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(
        hz_to_mel_slaney(np.array(0.0)), hz_to_mel_slaney(np.array(sr / 2.0)), n_mels + 2
    )
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@lru_cache(maxsize=4)
def _dft_bases_raw(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Plain real-DFT bases (no window): cos/sin [n_fft, n_fft//2+1].

    For callers that window frames themselves: kaldi fbank applies a povey
    window before the FFT (``models/wespeaker.py:kaldi_fbank``)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    return (
        np.cos(angle).astype(np.float32),
        (-np.sin(angle)).astype(np.float32),
    )


@lru_cache(maxsize=4)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT bases: cos/sin matrices [n_fft, n_fft//2+1]."""
    # periodic Hann (torch.hann_window default)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    cos_r, sin_r = _dft_bases_raw(n_fft)
    window = window[:, None].astype(np.float32)
    return cos_r * window, sin_r * window


def _frame(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-padded (reflect) framing, torch.stft semantics, last frame dropped.

    [..., n] -> [..., n//hop, n_fft]
    """
    pad = n_fft // 2
    lead = audio.shape[:-1]
    x = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (pad, pad), mode="reflect")
    n_frames = audio.shape[-1] // hop  # whisper drops the final frame
    frames = x[:, 0].unfold(-1, n_fft, hop)[:, :n_frames]
    return frames.reshape(*lead, n_frames, n_fft)


def log_mel_spectrogram(
    audio: torch.Tensor,
    n_mels: int = 128,
    n_fft: int = N_FFT,
    hop: int = HOP_LENGTH,
) -> torch.Tensor:
    """float32 PCM [-1,1] [..., n] -> log-mel features [..., n_mels, n//hop].

    The peak that floors the log spectrum is taken over the whole input.
    """
    # sub-hop clips would give 0 frames and reflect padding needs
    # n > n_fft//2: zero-extend tiny inputs to one full frame
    min_n = max(hop, n_fft // 2 + 1)
    if audio.shape[-1] < min_n:
        audio = pad_or_trim(audio, min_n)
    frames = _frame(audio.float(), n_fft, hop)
    cos_b, sin_b = (torch.from_numpy(b).to(audio.device) for b in _dft_bases(n_fft))
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im  # [..., T, n_bins]
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft)).to(audio.device)
    mel = power @ fb.T  # [..., T, n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(-1, -2)  # [..., n_mels, T]


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Pad with zeros / truncate the last axis to ``length`` (whisper's 30 s)."""
    n = audio.shape[-1]
    if n == length:
        return audio
    if n > length:
        return audio[..., :length]
    return F.pad(audio, (0, length - n))
