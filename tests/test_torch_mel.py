"""Log-mel front-end: the PyTorch port against the JAX package.

Same PCM (numpy, seeded) through ``open_speech_tpu.ops.mel`` and
``open_speech_tpu_torch.ops.mel``; float32 on the CPU on both sides.
Tolerance 1e-4 absolute on the normalised log-mel (values are O(1); the
two sides sum the DFT and filterbank products in different orders).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.ops import mel as jmel
from open_speech_tpu_torch.ops import mel as tmel

TOL = 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n", [100, 401, 1600, 16000, 48_123])
def test_log_mel_matches_jax(n_mels, n):
    rng = np.random.default_rng(n + n_mels)
    pcm = (0.3 * rng.standard_normal(n)).astype(np.float32)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(pcm), n_mels=n_mels))
    out = tmel.log_mel_spectrogram(torch.from_numpy(pcm), n_mels=n_mels).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_log_mel_batched_peak_per_clip_and_silence():
    """[B, n] input: the peak is taken over each clip's whole mel; an
    all-zero clip floors at the clamp."""
    rng = np.random.default_rng(7)
    pcm = np.zeros((2, 4800), np.float32)
    pcm[0] = 0.5 * np.sin(2 * np.pi * 440 * np.arange(4800) / 16000)
    pcm[1, 2000:2400] = 0.01 * rng.standard_normal(400)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(pcm), n_mels=80))
    out = tmel.log_mel_spectrogram(torch.from_numpy(pcm), n_mels=80).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    silent = tmel.log_mel_spectrogram(torch.zeros(1600), n_mels=80)
    assert torch.allclose(silent, torch.full_like(silent, (-10.0 + 4.0) / 4.0))


def test_tables_and_pad_or_trim_match_jax():
    np.testing.assert_array_equal(tmel.mel_filterbank(128), jmel.mel_filterbank(128))
    for a, b in zip(tmel._dft_bases(400), jmel._dft_bases(400)):
        np.testing.assert_array_equal(a, b)
    x = np.arange(10, dtype=np.float32)
    for length in (4, 10, 16):
        np.testing.assert_array_equal(
            tmel.pad_or_trim(torch.from_numpy(x), length).numpy(),
            np.asarray(jmel.pad_or_trim(jnp.asarray(x), length)),
        )


@pytest.mark.parametrize("n_fft", [400, 512])
def test_dft_bases_equal_jax(n_fft):
    """The window-folded bases (whisper, GE2E) and the plain ones (kaldi
    fbank) are JAX's, array for array."""
    for port, jax_ in ((tmel._dft_bases, jmel._dft_bases), (tmel._dft_bases_raw, jmel._dft_bases_raw)):
        for got, want in zip(port(n_fft), jax_(n_fft)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
