"""Vocoder building blocks in PyTorch: convolutions, layer norm, durations,
the inverse STFT, style conditioning and HiFiGAN's residual block.

Counterpart of ``open_speech_tpu/ops/vocoder.py``, under Kokoro's ISTFTNet
and Piper's HiFiGAN. Tensors are channel-first, [B, C, T], and weights are
in PyTorch's layout: ``Conv1d`` [C_out, C_in/groups, K], ``Linear``
[out, in] and ``ConvTranspose1d`` [C_in, C_out/groups, K], unflipped. The
JAX package stores convolutions as [K, C_in, C_out], linears as [in, out]
and transposed convolutions kernel-flipped; ``models/kokoro/convert.py``
and ``models/piper/convert.py`` map one layout onto the other.

The convolutions are cuDNN's on the card, in float32: both models run
inside ``inference()``, which holds cuDNN's TF32 off.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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


class _CudnnScope:
    """Holds ``torch.backends.cudnn.allow_tf32`` at one value while any
    vocoder call runs, and gives the process its own value back when the
    last one ends (reentrant and thread-safe). The flag is process-wide, so
    every model shares this one scope; with TF32 off this can only make a
    concurrent float32 STT call exact, which that path asks for anyway."""

    def __init__(self, allow_tf32: bool) -> None:
        self.allow_tf32 = allow_tf32
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = True

    def __enter__(self) -> None:
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = self.allow_tf32
            self._depth += 1

    def __exit__(self, *exc) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                torch.backends.cudnn.allow_tf32 = self._saved


# float32 convolutions and LSTMs on the card, as on the CPU and in the JAX
# models (PERF.md records TF32's error and time beside it)
CUDNN_F32 = _CudnnScope(allow_tf32=False)


def tts_device(device=None) -> torch.device:
    """``device``, or ``settings.tts_effective_device`` (the card) when None:
    where a TTS model's weights live unless its caller names a device."""
    if device is not None:
        return torch.device(device)
    from open_speech_tpu_torch.config import settings

    return torch.device(settings.tts_effective_device)


@contextmanager
def inference():
    """No autograd, and cuDNN in float32: the scope of every TTS model call."""
    with torch.inference_mode(), CUDNN_F32:
        yield


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    dilation: int = 1,
    pad: int | None = None,
    groups: int = 1,
) -> torch.Tensor:
    """x [B, C_in, T], weight [C_out, C_in/groups, K] -> [B, C_out, T_out].

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
    return F.conv1d(x, weight, bias, stride=stride, padding=lo, dilation=dilation, groups=groups)


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


def istft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse STFT: mag, phase [B, n_bins, T] -> waveform [B, T*hop].

    Frames come from one matmul against the inverse-DFT basis, times the
    periodic Hann window; ``F.fold`` overlaps and adds them and the
    window-square sum normalises. The centre pad of n_fft//2 is trimmed, and
    with hop > n_fft/2 the buffer is zero-extended to T*hop."""
    basis_np, window_np = _synthesis_basis(n_fft, hop)
    basis = torch.from_numpy(basis_np).to(mag.device)
    window = torch.from_numpy(window_np).to(mag.device)
    spec = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1)
    frames = torch.einsum("kn,bkt->bnt", basis, spec) * window[:, None]  # [B, n_fft, T]
    b, _, t = frames.shape
    out_len = (t - 1) * hop + n_fft

    def ola(y: torch.Tensor) -> torch.Tensor:
        return F.fold(y, (1, out_len), (1, n_fft), stride=(1, hop))[:, 0, 0]

    norm = ola(window.square()[None, :, None].expand(1, n_fft, t))
    out = ola(frames) / norm.clamp_min(1e-6)
    pad = n_fft // 2
    short = pad + t * hop - out_len
    if short > 0:
        out = F.pad(out, (0, short))
    return out[:, pad : pad + t * hop]


def adain1d(x: torch.Tensor, style: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Adaptive instance norm: x [B, C, T], style [B, S] -> [B, C, T].

    ``weight`` [2C, S] and ``bias`` [2C] (a ``Linear``) give the per-channel
    gain and bias from the style. The statistics span the whole time axis
    (population variance), so the op does not stream; ``style_mod`` does."""
    mean = x.mean(dim=2, keepdim=True)
    var = x.var(dim=2, keepdim=True, unbiased=False)
    xn = (x - mean) * torch.rsqrt(var + 1e-5)
    return style_mod(xn, style, weight, bias)


def style_mod(x: torch.Tensor, style: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Per-channel affine from the style alone: x * (1 + gamma) + beta, with
    ``adain1d``'s parameters and no normalisation, so block-wise vocoding is
    exact up to the convolutions' receptive field."""
    gb = F.linear(style, weight, bias)  # [B, 2C]
    c = x.shape[1]
    return x * (1.0 + gb[:, :c, None]) + gb[:, c:, None]


def resblock1(x: torch.Tensor, block: nn.Module, dilations=(1, 3, 5), mask: torch.Tensor | None = None) -> torch.Tensor:
    """HiFiGAN ResBlock1: pairs of 'same'-padded convolutions with leaky
    ReLUs, the first of each pair dilated. ``block`` holds ``convs1`` and
    ``convs2`` (``Conv1d``s, as piper_train names them). ``mask`` [B, 1, T]
    re-zeros the padded positions after every convolution, so a
    padded-bucket run equals an exact-length run on the valid prefix."""
    for c1, c2, d in zip(block.convs1, block.convs2, dilations):
        h = conv1d(F.leaky_relu(x, 0.1), c1.weight, c1.bias, dilation=d)
        if mask is not None:
            h = h * mask
        h = conv1d(F.leaky_relu(h, 0.1), c2.weight, c2.bias)
        if mask is not None:
            h = h * mask
        x = x + h
    return x


def resblock1_module(channels: int, kernel: int = 3, dilations=(1, 3, 5)) -> nn.Module:
    """An empty ResBlock1: ``convs1`` and ``convs2``, one ``Conv1d`` each
    per dilation (the dilation is ``resblock1``'s argument, not the
    module's)."""
    block = nn.Module()
    block.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel) for _ in dilations)
    block.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel) for _ in dilations)
    return block


@torch.no_grad()
def init_resblock1(generator: torch.Generator, channels: int, kernel: int = 3, dilations=(1, 3, 5),
                   device=None) -> nn.Module:
    """A ResBlock1 with the JAX package's random weights: normal *
    (kernel * channels)^-0.5 and zero biases, drawn from ``generator`` in
    the JAX order (c1_0, c2_0, c1_1, ...), on ``device`` (the generator's
    when None)."""
    block = resblock1_module(channels, kernel, dilations).to(device or generator.device)
    for c1, c2 in zip(block.convs1, block.convs2):
        for conv in (c1, c2):
            w = torch.randn(conv.weight.shape, generator=generator, device=generator.device)
            conv.weight.copy_(w * (kernel * channels) ** -0.5)
            conv.bias.zero_()
    return block.requires_grad_(False)


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
