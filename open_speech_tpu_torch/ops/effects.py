"""Audio-effects DSP in PyTorch, on the signal's device.

Counterpart of ``open_speech_tpu/ops/effects.py``, the same five kernels:

  * **IIR biquads** (the podcast EQ): the feedback recurrence
    ``s[t] = A s[t-1] + u[t]`` is an affine scan, run here as a log-depth
    doubling scan (Hillis-Steele) over the [n, 2, 2] pairs: ceil(log2 n)
    steps of elementwise 2x2 arithmetic, never a loop over samples. The
    filter design (bilinear-transform Butterworth high-pass, Orfanidis
    resonator) runs once on the host.
  * **Reverb**: one rfft/irfft round trip (cuFFT on the card) against a
    precomputed exponential-decay impulse response, on a pow2 length.
  * **Pitch shift**: a phase vocoder whose phase accumulator is an
    exclusive prefix sum (``cumsum``) of per-frame phase increments, then a
    linear resample back to the original length.
  * **Normalize / ring-mod**: masked elementwise arithmetic.

Every kernel takes a bucket-padded [n] float32 signal and, where the true
length matters, that length, and returns float32. The results agree with
the JAX package's to rounding, not bit for bit: the biquad scan, the
phase vocoder's cumulative phase and the ring modulator's carrier phase run
in float64 where JAX's run in float32, so the port is nearer the exact
result and the same on the card and the CPU (``tests/test_torch_effects.py``
states each bound).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

MIN_BUCKET = 4096


def length_bucket(n: int) -> int:
    """Next power-of-two bucket for a signal of ``n`` samples."""
    return max(MIN_BUCKET, 1 << max(0, (int(n) - 1).bit_length()))


# ── filter design (host, once per sample rate) ────────────────────────


def design_highpass_biquad(cutoff_hz: float, sr: int) -> tuple[np.ndarray, np.ndarray]:
    """2nd-order Butterworth high-pass via the bilinear transform (scipy's
    ``butter(2, fc/nyq, "high")``: tan prewarp, Q = 1/sqrt(2))."""
    k = math.tan(math.pi * cutoff_hz / sr)
    root2 = math.sqrt(2.0)
    a0 = 1.0 + root2 * k + k * k
    b = np.array([1.0, -2.0, 1.0]) / a0
    a = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - root2 * k + k * k) / a0])
    return b, a


def design_peak_biquad(center_hz: float, q: float, sr: int) -> tuple[np.ndarray, np.ndarray]:
    """2nd-order resonant peak, 0 dB at the centre (Orfanidis' resonator
    with -3 dB band edges, scipy's ``iirpeak``)."""
    w0 = 2.0 * math.pi * center_hz / sr
    beta = math.tan(w0 / (2.0 * q))  # gb = 1/sqrt(2) band edges
    gain = 1.0 / (1.0 + beta)
    b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * math.cos(w0), 2.0 * gain - 1.0])
    return b, a


# ── biquad cascade as a doubling scan ─────────────────────────────────


def _affine_scan(a: list[torch.Tensor], c: list[torch.Tensor]) -> list[torch.Tensor]:
    """Inclusive scan of affine maps s -> A s + c along the last axis.

    ``a`` holds A's four entries (a11, a12, a21, a22) and ``c`` its two,
    each [n]. Step k composes every element with the one 2^k before it
    (earlier map first), so after ceil(log2 n) steps element t is the
    composition of maps 0..t applied to a zero state: its ``c`` is s[t]."""
    n = c[0].shape[-1]
    off = 1
    while off < n:
        # the earlier maps, shifted right by off: identity (and zero c) before the start
        e11, e12, e21, e22 = (F.pad(x[..., :-off], (off, 0), value=v) for x, v in zip(a, (1.0, 0.0, 0.0, 1.0)))
        ec1, ec2 = (F.pad(x[..., :-off], (off, 0)) for x in c)
        l11, l12, l21, l22 = a
        a = [l11 * e11 + l12 * e21, l11 * e12 + l12 * e22, l21 * e11 + l22 * e21, l21 * e12 + l22 * e22]
        c = [l11 * ec1 + l12 * ec2 + c[0], l21 * ec1 + l22 * ec2 + c[1]]
        off *= 2
    return c


def _biquad_scan(x: torch.Tensor, b: np.ndarray, a: np.ndarray) -> torch.Tensor:
    """One normalised biquad over ``x`` [n] with zero initial state.

    The feed-forward taps are a 3-tap FIR; the feedback y[t] = u[t] -
    a1 y[t-1] - a2 y[t-2] is the affine scan of (A, u e_0) with the
    constant A = [[-a1, -a2], [1, 0]].

    The scan runs in float64. Each of its log2(n) rounds multiplies the
    earlier states by a power of A, whose entries grow to ~1/sin(theta) for
    poles at angle theta (the 80 Hz high-pass: ~70x), so in float32 it
    lands ~10x further from the exact filter than ``lax.associative_scan``
    (1.2e-4 against 1.3e-5 on a 2^19 bucket); in float64 it is exact to
    float32 output."""
    n = x.shape[0]
    b0, b1, b2 = (float(v) for v in b)
    u = (b0 * x + b1 * F.pad(x, (1, 0))[:n] + b2 * F.pad(x, (2, 0))[:n]).double()
    full = torch.ones_like(u)
    mat = [full * float(-a[1]), full * float(-a[2]), full, torch.zeros_like(u)]
    return _affine_scan(mat, [u, torch.zeros_like(u)])[0].float()


@lru_cache(maxsize=8)
def _podcast_sections(sr: int) -> tuple[tuple[float, ...], ...]:
    """High-pass at 80 Hz, then a Q=2 presence resonator at 3 kHz."""
    return tuple(
        tuple(float(v) for v in np.concatenate([b, a]))
        for b, a in (design_highpass_biquad(80.0, sr), design_peak_biquad(3000.0, 2.0, sr))
    )


def podcast_eq(x: torch.Tensor, sr: int) -> torch.Tensor:
    """The podcast EQ over a (possibly padded) signal."""
    y = x.float()
    for sec in _podcast_sections(sr):
        # float32 taps, as the JAX package's traced constants are
        b, a = (np.asarray(sec[:3], np.float32), np.asarray(sec[3:], np.float32))
        y = _biquad_scan(y, b, a)
    return y


# ── normalize / ring-mod ──────────────────────────────────────────────


def masked_rms_normalize(x: torch.Tensor, n_valid: int, target_amp: float) -> torch.Tensor:
    """Scale so the RMS over the first ``n_valid`` samples is
    ``target_amp``; a signal below -160 dBFS passes untouched."""
    mask = torch.arange(x.shape[0], device=x.device) < n_valid
    rms = torch.sqrt(torch.where(mask, x * x, 0.0).sum() / max(float(n_valid), 1.0))
    scale = torch.where(rms < 1e-8, 1.0, float(np.float32(target_amp)) / rms.clamp_min(1e-12))
    return x * scale


def ring_modulate(x: torch.Tensor, sr: int, carrier_hz: float = 100.0) -> torch.Tensor:
    """Multiply by a sine carrier (the 'robot' voice).

    The carrier's phase is taken in float64: in float32 its rounding at
    t = 12 s (~7,500 rad, one ulp 5e-4) decides the sample, and the card
    divides by sr as a multiply by the reciprocal where the CPU divides, so
    float32 carriers differed by 3e-4 between the two."""
    t = torch.arange(x.shape[0], dtype=torch.float64, device=x.device) / sr
    return x * torch.sin((2.0 * math.pi * carrier_hz) * t).float()


# ── reverb: spectral convolution with a decaying IR ───────────────────


@lru_cache(maxsize=16)
def _decay_ir(ir_len: int) -> np.ndarray:
    ir = np.exp(-np.linspace(0.0, 6.0, ir_len, dtype=np.float64))
    return (ir / ir.sum()).astype(np.float32)


def exp_decay_reverb(x: torch.Tensor, ir_len: int, mix: float) -> torch.Tensor:
    """Wet/dry mix of ``x`` with an exponential-decay FIR, via one FFT."""
    n = x.shape[0]
    fft_n = 1 << (n + ir_len - 1).bit_length()
    ir = torch.from_numpy(_decay_ir(ir_len)).to(x.device)
    wet = torch.fft.irfft(torch.fft.rfft(x, fft_n) * torch.fft.rfft(ir, fft_n), fft_n)[:n]
    mix32 = np.float32(mix)  # float32 arithmetic, as the JAX package's traced scalar
    return float(np.float32(1.0) - mix32) * x + float(mix32) * wet


# ── pitch shift: parallel phase vocoder ───────────────────────────────


_PV_NFFT = 2048
_PV_HOP = 512


@lru_cache(maxsize=2)
def _pv_window(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


@lru_cache(maxsize=32)
def _ola_norm(n_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """Overlap-add window-square normalisation (one window for every frame)."""
    w2 = _pv_window(n_fft).astype(np.float64) ** 2
    norm = np.zeros((n_frames - 1) * hop + n_fft)
    for f in range(n_frames):
        norm[f * hop : f * hop + n_fft] += w2
    return np.maximum(norm, 1e-8).astype(np.float32)


def _pv_analysis(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centred, reflect-padded Hann-windowed frames -> their rfft [T, bins]."""
    pad = n_fft // 2
    xp = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = xp.unfold(0, n_fft, hop)
    return torch.fft.rfft(frames * torch.from_numpy(_pv_window(n_fft)).to(x.device), dim=-1)


def _pv_synthesis(spec: torch.Tensor, n_fft: int, hop: int, out_len: int) -> torch.Tensor:
    """irfft, window, overlap-add (``F.fold``) and normalise; the centre pad
    trimmed to ``out_len`` samples."""
    window = torch.from_numpy(_pv_window(n_fft)).to(spec.device)
    frames = torch.fft.irfft(spec, n_fft, dim=-1) * window  # [T, n_fft]
    n_frames = frames.shape[0]
    total = (n_frames - 1) * hop + n_fft
    acc = F.fold(frames.T[None], (1, total), (1, n_fft), stride=(1, hop))[0, 0, 0]
    acc = acc / torch.from_numpy(_ola_norm(n_frames, n_fft, hop)).to(spec.device)
    start = max(0, min(n_fft // 2, total - out_len))  # dynamic_slice's clamp in the JAX package
    return acc[start : start + out_len]


def _stretch_kernel(x: torch.Tensor, rate: float, n_fft: int, hop: int) -> torch.Tensor:
    """Time-stretch by ``rate`` with all-parallel phase propagation.

    The per-output-frame phase update ``phi[t] = phi[t-1] + adv + dev[t-1]``
    depends only on input-frame phase deviations, so the accumulator is one
    exclusive cumsum. It runs in float64 and is reduced mod 2*pi before
    float32: the phase grows to ~2e6 rad over 12 s, where one float32 ulp
    is 0.125 rad, so a float32 cumsum rounds the top bins' phases by whole
    tenths of a radian, differently on the card and the CPU (6e-3 apart in
    the output)."""
    spec = _pv_analysis(x, n_fft, hop)
    n_in = spec.shape[0]
    pos = np.arange(0.0, n_in, rate)
    lo = np.minimum(pos.astype(np.int64), n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = torch.from_numpy((pos - lo).astype(np.float32)).to(x.device)[:, None]
    lo_t, hi_t = (torch.from_numpy(i).to(x.device) for i in (lo, hi))

    s_lo, s_hi = spec[lo_t], spec[hi_t]
    mag = (1.0 - frac) * s_lo.abs() + frac * s_hi.abs()
    adv = torch.from_numpy(np.linspace(0.0, math.pi * hop, n_fft // 2 + 1, dtype=np.float32)).to(x.device)
    dev = s_hi.angle() - s_lo.angle() - adv
    two_pi = float(np.float32(2.0 * math.pi))
    dev = dev - two_pi * torch.round(dev / two_pi)
    step = (adv + dev).double()  # [T_out, bins]
    phase = spec[0].angle().double() + torch.cumsum(step, dim=0) - step  # exclusive
    phase = torch.remainder(phase, 2.0 * math.pi).float()
    out_len = int(round(x.shape[0] / rate))
    return _pv_synthesis(torch.polar(mag, phase), n_fft, hop, out_len)


def _shift_resample(stretched: torch.Tensor, n_valid: int, rate: float) -> torch.Tensor:
    """Map the stretched signal back onto the original time axis: output
    sample k reads position k * (src_len - 1) / (n_valid - 1), linearly
    interpolated."""
    n = stretched.shape[0]
    out_n = int(round(n * rate))
    # float32 host arithmetic, as the JAX package traces it
    nv = np.float32(n_valid)
    src_len = max(np.round(nv / np.float32(rate)), np.float32(1.0))
    scale = (src_len - np.float32(1.0)) / max(nv - np.float32(1.0), np.float32(1.0))
    pos = torch.arange(out_n, dtype=torch.float32, device=stretched.device) * float(scale)
    lo = pos.to(torch.int64).clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    frac = pos - lo.float()
    return (1.0 - frac) * stretched[lo] + frac * stretched[hi]


def pitch_shift(x: torch.Tensor, n_valid: int, semitones: float) -> torch.Tensor:
    """Duration-preserving pitch shift of a bucket-padded signal: stretch by
    2^(-st/12), then resample the result back to the original length, which
    scales every frequency by 2^(st/12)."""
    rate = float(2.0 ** (-semitones / 12.0))
    stretched = _stretch_kernel(x.float(), rate, _PV_NFFT, _PV_HOP)
    return _shift_resample(stretched, n_valid, rate)
