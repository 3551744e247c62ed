"""Spectral distance between two clips, for TTS output comparison.

Counterpart of ``open_speech_tpu/audio/spectral.py``: the log-mel spectral
distance between two waveforms, on the port's own resampler and mel
front end (``ops/resample.py``, ``ops/mel.py``), on the CPU: the clips are
host arrays and the result is one number.
"""

from __future__ import annotations

import numpy as np
import torch

from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
from open_speech_tpu_torch.ops.resample import resample_poly


def log_mel_distance(a: np.ndarray, b: np.ndarray, sample_rate: int, n_mels: int = 80) -> float:
    """Mean L2 distance between the log-mel spectrograms of two clips.

    The clips are cut to the shorter length and resampled to 16 kHz (the
    mel front end's rate). 0.0 = identical; < ~0.1 is perceptually
    negligible for same-content audio; different utterances land > 1.
    """
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    n = min(len(a), len(b))
    if n == 0:
        return float("inf")
    a, b = a[:n], b[:n]
    if sample_rate != 16000:
        a, b = (resample_poly(torch.from_numpy(x.copy()), 16000, sample_rate).numpy() for x in (a, b))
    if len(a) < 400:  # below one STFT frame
        return float(np.sqrt(np.mean((a - b) ** 2)))
    ma, mb = (log_mel_spectrogram(torch.from_numpy(x.copy()), n_mels=n_mels).numpy() for x in (a, b))
    return float(np.mean(np.linalg.norm(ma - mb, axis=0)) / np.sqrt(n_mels))


def spectral_report(a, b, sample_rate: int) -> dict:
    """Distance plus simple level diagnostics, for parity logs."""
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    return {
        "log_mel_distance": log_mel_distance(a, b, sample_rate),
        "rms_a": float(np.sqrt(np.mean(a**2))) if len(a) else 0.0,
        "rms_b": float(np.sqrt(np.mean(b**2))) if len(b) else 0.0,
        "len_ratio": (len(a) / len(b)) if len(b) else float("inf"),
    }
