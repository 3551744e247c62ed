"""Vocoder building blocks in PyTorch: convolutions, layer norm, durations.

Counterpart of ``open_speech_tpu/ops/vocoder.py`` for what Kokoro's
ISTFTNet path uses. Tensors are channel-first, [B, C, T], and weights are
in PyTorch's layout: ``Conv1d`` [C_out, C_in/groups, K] and
``ConvTranspose1d`` [C_in, C_out/groups, K], unflipped. The JAX package
stores convolutions as [K, C_in, C_out] and transposed ones kernel-flipped;
``models/kokoro/convert.py`` maps one layout onto the other.

The convolutions are cuDNN's on the card. Piper's pieces (``istft``,
``adain1d``, ``style_mod``, ``resblock1``) come with the Piper slice.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=8)
def _synthesis_basis(n_fft: int, hop: int) -> tuple[np.ndarray, np.ndarray]:
    """(inverse-DFT basis [2*n_bins, n_fft], periodic Hann window [n_fft]).

    Frame n of an irfft is ``spec @ basis``: the real parts against the
    scaled cosines, then the imaginary parts against the scaled sines."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    # x[n] = (1/n_fft) * sum_k w_k * (re_k cos - im_k sin)
    scale = np.full((n_bins, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    cos_b = np.cos(ang) * scale
    sin_b = -np.sin(ang) * scale
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)
    return (
        np.concatenate([cos_b, sin_b], axis=0).astype(np.float32),
        window.astype(np.float32),
    )


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    dilation: int = 1,
    pad: int | None = None,
) -> torch.Tensor:
    """x [B, C_in, T], weight [C_out, C_in, K] -> [B, C_out, T_out].

    Default padding is 'same' ((K-1)*dilation split low-first, the larger
    half on the right when it is odd); ``pad`` pads both sides by that many.
    """
    k = weight.shape[-1]
    if pad is None:
        lo = (k - 1) * dilation // 2
        hi = (k - 1) * dilation - lo
    else:
        lo = hi = pad
    if lo != hi:
        x = F.pad(x, (lo, hi))
        lo = 0
    return F.conv1d(x, weight, bias, stride=stride, padding=lo, dilation=dilation)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int,
    pad: int | None = None,
    groups: int = 1,
) -> torch.Tensor:
    """``ConvTranspose1d``: x [B, C_in, T], weight [C_in, C_out/groups, K]
    -> [B, C_out, (T-1)*stride - 2*pad + K]. The HiFiGAN convention
    pad = (K-stride)//2 with even K-stride gives exactly T*stride."""
    if pad is None:
        pad = (weight.shape[-1] - stride) // 2
    return F.conv_transpose1d(x, weight, bias, stride=stride, padding=pad, groups=groups)


def layer_norm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the population variance
    (``jnp.var``), as ``nn.LayerNorm`` computes it."""
    return F.layer_norm(x, (x.shape[-1],), gain, bias, eps)


def compress_durations(pred_dur: torch.Tensor, budget: int) -> torch.Tensor:
    """Scale integer frame durations [B, T] into a frame budget.

    Unchanged when the total fits. Over budget, the scaled ends are rounded
    on the cumulative grid and differenced, so the total lands exactly on
    the budget (rounding each scaled duration on its own can overshoot it
    and cut the utterance's tail).

    The ends are the exact cumulative durations times budget/total, rounded
    half to even in float64, so every device gives the same frames. The JAX
    package rounds a float32 cumsum of the scaled durations instead; the two
    agree except where an end lies exactly on a half frame, which the JAX
    package's summation order decides."""
    total = pred_dur.sum(dim=1, keepdim=True)
    scale = torch.clamp(budget / torch.clamp(total, min=1.0), max=1.0)
    ends = torch.cumsum(pred_dur.double(), dim=1) * budget / total.double().clamp(min=1.0)
    ends_r = torch.round(ends)
    comp = torch.diff(ends_r, dim=1, prepend=torch.zeros_like(ends_r[:, :1])).to(pred_dur.dtype)
    return torch.where(scale < 1.0, comp, pred_dur)
