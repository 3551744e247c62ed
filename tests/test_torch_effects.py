"""The speech effects chain of the port, held against the JAX package on the
CPU.

- ``apply_chain`` of both packages on the same numpy signals (a tone with
  vibrato plus noise, and speech-like bursts), at lengths inside and just
  past ``MIN_BUCKET``, for each of the five effects with their parameter
  presets, a chain of all five, unknown types and an empty signal. Bounds,
  max abs on signals of peak ~0.5, set at 2-5x the largest difference
  measured over these cases (in brackets):
    normalize, reverb: 1e-6 (6e-8, float32 rounding);
    podcast_eq: 5e-5 (2.1e-5: the JAX scan's own float32 error; the port's
      runs in float64 and is held to scipy's float64 ``lfilter`` within
      1e-6);
    robot: 2e-5 (3.5e-6: the JAX package's float32 carrier phase; the
      port's is float64);
    pitch: 5e-4, and the chain 1e-3 (8.5e-5 and 1.6e-4: the JAX package's
      float32 cumulative phase, which the port sums in float64 mod 2*pi; the
      difference grows with the signal: 4.7e-3 on 12 s at 24 kHz).
- The filter designs equal the JAX package's and scipy's ``butter`` and
  ``iirpeak``; ``length_bucket`` equals JAX's.
- ``spectral_report`` of both packages on the same clips, 16 kHz and 24 kHz,
  within 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax  # noqa: F401 — the JAX package below needs it on the CPU

import open_speech_tpu.audio.effects as JE
import open_speech_tpu.audio.spectral as JS
import open_speech_tpu.ops.effects as JF
import open_speech_tpu_torch.audio.effects as TE
import open_speech_tpu_torch.audio.spectral as TS
import open_speech_tpu_torch.ops.effects as TF

SR = 24000
TOL = {"normalize": 1e-6, "reverb": 1e-6, "podcast_eq": 5e-5, "robot": 2e-5, "pitch": 5e-4, "chain": 1e-3}


def _signal(n: int, seed: int = 0, sr: int = SR) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    tone = 0.3 * np.sin(2 * np.pi * 220 * t + 0.5 * np.sin(2 * np.pi * 5 * t))
    bursts = (np.sin(2 * np.pi * 3 * t) > 0.3) * 0.15 * rng.standard_normal(n)
    return (tone + bursts + 0.01 * rng.standard_normal(n)).astype(np.float32)


CASES = [
    ("normalize", [{"type": "normalize"}]),
    ("normalize", [{"type": "normalize", "target_lufs": -23}]),
    ("pitch", [{"type": "pitch", "semitones": 3}]),
    ("pitch", [{"type": "pitch", "semitones": -2.5}]),
    ("pitch", [{"type": "pitch", "semitones": 0.004}]),  # rounds to 0: untouched
    ("reverb", [{"type": "reverb"}]),
    ("reverb", [{"type": "reverb", "room": "large"}]),
    ("reverb", [{"type": "reverb", "room": "medium", "mix": 0.7}]),
    ("reverb", [{"type": "reverb", "room": "hall"}]),  # the fallback tail and mix
    ("podcast_eq", [{"type": "podcast_eq"}]),
    ("robot", [{"type": "robot"}]),
    ("chain", [{"type": "podcast_eq"}, {"type": "pitch", "semitones": 2}, {"type": "reverb", "room": "medium"},
               {"type": "robot"}, {"type": "normalize", "target_lufs": -18}, {"type": "bogus"}]),
]


@pytest.mark.parametrize("n", [3000, 4500])
@pytest.mark.parametrize("kind,effects", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_apply_chain_matches_jax(kind, effects, n):
    x = _signal(n, seed=n)
    want = JE.apply_chain(x, SR, effects)
    got = TE.apply_chain(x, SR, effects, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL[kind], rtol=0)
    if kind != "pitch" or effects[0]["semitones"] > 0.005:
        assert not np.allclose(got, x, atol=1e-3)  # the effect did something


@pytest.mark.parametrize("sr", [16000, 22050])
def test_podcast_eq_matches_jax_at_other_rates(sr):
    x = _signal(4096, seed=1, sr=sr)
    effects = [{"type": "podcast_eq"}, {"type": "robot"}]
    np.testing.assert_allclose(TE.apply_chain(x, sr, effects, device="cpu"), JE.apply_chain(x, sr, effects),
                               atol=TOL["podcast_eq"] + TOL["robot"], rtol=0)


def test_unknown_and_empty_inputs_pass_through():
    x = _signal(1000)
    np.testing.assert_array_equal(TE.apply_chain(x, SR, [{"type": "bogus"}], device="cpu"), x)
    np.testing.assert_array_equal(TE.apply_chain(x, SR, None, device="cpu"), x)
    assert TE.apply_chain(np.zeros(0, np.float32), SR, [{"type": "robot"}], device="cpu").size == 0
    silent = np.zeros(2000, np.float32)
    np.testing.assert_array_equal(TE.apply_chain(silent, SR, [{"type": "normalize"}], device="cpu"), silent)
    assert TE.SUPPORTED_EFFECTS == JE.SUPPORTED_EFFECTS


def test_filter_designs_and_buckets_match():
    for sr in (16000, 22050, 24000):
        jb, ja = JF.design_highpass_biquad(80.0, sr)
        tb, ta = TF.design_highpass_biquad(80.0, sr)
        sb, sa = ss.butter(2, 80.0 / (sr / 2), "high")
        np.testing.assert_allclose(np.stack([tb, ta]), np.stack([jb, ja]), rtol=0, atol=0)
        np.testing.assert_allclose(np.stack([tb, ta]), np.stack([sb, sa]), rtol=1e-9, atol=1e-12)
        pb, pa = TF.design_peak_biquad(3000.0, 2.0, sr)
        qb, qa = ss.iirpeak(3000.0, 2.0, fs=sr)
        np.testing.assert_allclose(np.stack([pb, pa]), np.stack(JF.design_peak_biquad(3000.0, 2.0, sr)), atol=0)
        np.testing.assert_allclose(np.stack([pb, pa]), np.stack([qb, qa]), rtol=1e-9, atol=1e-12)
    for n in (0, 1, 4096, 4097, 300_000):
        assert TF.length_bucket(n) == JF.length_bucket(n)


def test_biquad_scan_is_exact_to_float32():
    """The doubling scan against scipy's float64 ``lfilter`` on the same
    float32 taps, over a 2^16 bucket (16 doubling steps)."""
    x = _signal(1 << 16, seed=3)
    want = x.astype(np.float64)
    for sec in TF._podcast_sections(SR):
        b, a = (np.asarray(v, np.float32).astype(np.float64) for v in (sec[:3], sec[3:]))
        want = ss.lfilter(b, a, want)
    got = TF.podcast_eq(torch.from_numpy(x), SR).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sr", [16000, 24000])
def test_spectral_report_matches_jax(sr):
    a = _signal(sr, seed=4, sr=sr)
    b = (0.8 * a + 0.02 * np.random.default_rng(5).standard_normal(a.size)).astype(np.float32)
    want, got = JS.spectral_report(a, b, sr), TS.spectral_report(a, b, sr)
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-5, key
    assert TS.log_mel_distance(a, a, sr) == 0.0
    assert TS.log_mel_distance(a[:100], b[:100], sr) == pytest.approx(JS.log_mel_distance(a[:100], b[:100], sr),
                                                                      abs=1e-6)
    assert TS.log_mel_distance(a[:0], b, sr) == float("inf")
