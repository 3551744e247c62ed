"""Polyphase resampling on the caller's device.

Counterpart of ``open_speech_tpu/ops/resample.py``: the same Kaiser-windowed
sinc design (beta 5.0, 10 taps per phase, scipy's ``resample_poly``
defaults) and the same output. The JAX version runs one dilated XLA
convolution (upsample = input dilation, downsample = stride). Here the
filter is split into its ``up`` phases and the whole resample is one strided
polyphase convolution, written as a product of the strided input frames
with the [up, L] phase matrix: every output sample costs L multiply-adds and
nothing is zero-stuffed. It is a matmul rather than ``F.conv1d`` because a
float32 convolution on the card goes through cuDNN in TF32 by default (about
three decimal digits); a float32 matmul stays float32.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from open_speech_tpu_torch.config import settings


def _kaiser(n: int, beta: float) -> np.ndarray:
    """Kaiser window of length n (numpy has i0)."""
    m = np.arange(n, dtype=np.float64)
    alpha = (n - 1) / 2.0
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - ((m - alpha) / alpha) ** 2))
    return np.i0(arg) / np.i0(beta)


def _firwin_lowpass(num_taps: int, cutoff: float, beta: float = 5.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass; ``cutoff`` normalized to Nyquist=1.

    Matches scipy.signal.firwin(num_taps, cutoff, window=("kaiser", beta))
    with scale=True (unity DC gain).
    """
    m = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * m)
    h *= _kaiser(num_taps, beta)
    return h / h.sum()


@lru_cache(maxsize=64)
def _design(up: int, down: int) -> np.ndarray:
    """Anti-aliasing filter for an up/down pair (scipy resample_poly design)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = _firwin_lowpass(2 * half_len + 1, 1.0 / max_rate) * up
    return h.astype(np.float32)


@lru_cache(maxsize=64)
def _phases(up: int, down: int) -> tuple[np.ndarray, int]:
    """The filter as an [up, L] phase matrix, and the input offset u_lo.

    Output j = r + up*m is sum_l W[r, l] * x[m*down + l + u_lo], with
    W[r, l] = h[(l + u_lo)*up - r*down + half] (zero outside the filter):
    the zero-stuffed, strided convolution of the JAX version, one row per
    output phase r.
    """
    h = _design(up, down)
    taps = h.shape[0]
    half = (taps - 1) // 2
    u_lo = -(half // up)
    u_hi = (taps - 1 + (up - 1) * down - half) // up
    idx = (
        (np.arange(u_lo, u_hi + 1)[None, :]) * up
        - np.arange(up)[:, None] * down
        + half
    )
    valid = (idx >= 0) & (idx < taps)
    w = np.where(valid, h[np.clip(idx, 0, taps - 1)], 0.0).astype(np.float32)
    return w, u_lo


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Polyphase resample along the last axis; scipy.resample_poly semantics.

    Output length is ``ceil(n * up / down)``. Works on [..., n] float
    tensors, on their device, in float32.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)  # ceil
    w, u_lo = _phases(up, down)
    n_taps = w.shape[1]
    m_out = -(-n_out // up)  # output frames, one sample per phase each
    pad_r = max(0, (m_out - 1) * down + n_taps - (n_in - u_lo))
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, n_in).float(), (-u_lo, pad_r))
    frames = xp.unfold(-1, n_taps, down)[:, :m_out]  # [B, M, L]
    y = frames @ torch.from_numpy(w).to(x.device).T  # [B, M, up]
    return y.reshape(-1, m_out * up)[:, :n_out].reshape(*lead, n_out)


def resample_array(
    x: np.ndarray, src_rate: int, dst_rate: int, device: torch.device | str | None = None
) -> np.ndarray:
    """float32 numpy samples at src_rate -> float32 numpy samples at dst_rate.

    Runs on ``device``, ``settings.stt_device`` (the card) unless given.
    """
    if src_rate == dst_rate:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return resample_poly(t.to(device or settings.stt_device), dst_rate, src_rate).cpu().numpy()


def resample_pcm16(
    pcm: bytes, src_rate: int, dst_rate: int, device: torch.device | str | None = None
) -> bytes:
    """int16 PCM bytes at src_rate -> int16 PCM bytes at dst_rate.

    Runs on ``device``, ``settings.stt_device`` (the card) unless given.
    """
    if src_rate == dst_rate or not pcm:
        return bytes(pcm)
    x = np.frombuffer(pcm, dtype="<i2").astype(np.float32)
    y = np.clip(np.round(resample_array(x, src_rate, dst_rate, device)), -32768, 32767)
    return y.astype("<i2").tobytes()
