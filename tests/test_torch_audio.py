"""G.711 codecs, the polyphase resampler and WAV ingest: the PyTorch port
against the JAX package.

The codecs are table lookups and must give the same bytes. The resampler
runs in float32 on both sides with different summation orders: float
outputs within 1e-5 of O(1) signals, PCM16 within 1 LSB (a rounding
boundary can fall either way). Everything here runs on the CPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.audio import ingest as JI
from open_speech_tpu.ops import audio as JA
from open_speech_tpu.ops import resample as JR
from open_speech_tpu_torch.audio import ingest as TI
from open_speech_tpu_torch.ops import audio as TA
from open_speech_tpu_torch.ops import resample as TR


def test_g711_tables_and_codecs_are_byte_identical():
    codes = np.arange(256, dtype=np.uint8)
    samples = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    np.testing.assert_array_equal(TA.ulaw_decode(codes), JA.ulaw_decode(codes))
    np.testing.assert_array_equal(TA.alaw_decode(codes), JA.alaw_decode(codes))
    np.testing.assert_array_equal(TA.ulaw_encode(samples), JA.ulaw_encode(samples))
    np.testing.assert_array_equal(TA.alaw_encode(samples), JA.alaw_encode(samples))
    raw = codes.tobytes()  # bytes input decodes the same as an array
    assert TA.ulaw_decode(raw).tobytes() == JA.ulaw_decode(raw).tobytes()
    assert TA.alaw_decode(raw).tobytes() == JA.alaw_decode(raw).tobytes()


def test_pcm16_to_wav_is_byte_identical():
    pcm = np.random.default_rng(0).integers(-32768, 32767, 999).astype("<i2").tobytes()
    for rate in (8000, 16000, 44100):
        assert TA.pcm16_to_wav(pcm, rate) == JA.pcm16_to_wav(pcm, rate)


@pytest.mark.parametrize(
    "up,down,n",
    [(2, 1, 800), (1, 3, 4800), (160, 441, 4410), (16, 11, 1103), (441, 160, 300),
     (3, 2, 1), (1, 2, 5), (4, 4, 10)],
)
def test_resample_poly_matches_jax(up, down, n):
    x = np.random.default_rng(up * 1000 + down).standard_normal((2, n)).astype(np.float32)
    want = np.asarray(JR.resample_poly(jnp.asarray(x), up, down))
    got = TR.resample_poly(torch.from_numpy(x), up, down).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [(8000, 16000), (44100, 16000), (48000, 16000),
                                     (22050, 16000), (16000, 8000), (16000, 16000)])
def test_resample_pcm16_within_one_lsb_of_jax(src, dst):
    pcm = (np.random.default_rng(src).uniform(-0.9, 0.9, src // 2) * 32767).astype("<i2")
    want = np.frombuffer(JR.resample_pcm16(pcm.tobytes(), src, dst), "<i2").astype(int)
    got = np.frombuffer(TR.resample_pcm16(pcm.tobytes(), src, dst, "cpu"), "<i2").astype(int)
    assert len(got) == len(want)
    assert np.abs(got - want).max() <= 1


def test_resample_pcm16_runs_on_the_configured_device_by_default(monkeypatch):
    from open_speech_tpu_torch.config import settings

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    pcm = np.zeros(800, "<i2").tobytes()
    monkeypatch.setattr(settings, "stt_device", "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        TR.resample_pcm16(pcm, 8000, 16000)  # the card, which this host lacks
    monkeypatch.setattr(settings, "stt_device", "cpu")
    assert len(TR.resample_pcm16(pcm, 8000, 16000)) == 3200


@pytest.mark.parametrize("rate", [8000, 22050, 44100, 16000])
def test_convert_to_wav_resamples_like_jax(rate):
    rng = np.random.default_rng(rate)
    t = np.arange(rate) / rate
    audio = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(rate)).astype(
        np.float32
    )
    wav = JA.write_wav(audio, rate)
    want, got = JI.convert_to_wav(wav), TI.convert_to_wav(wav, device="cpu")
    assert got[:44] == want[:44]  # same header: 16 kHz mono 16-bit, same length
    diff = np.frombuffer(got[44:], "<i2").astype(int) - np.frombuffer(want[44:], "<i2").astype(int)
    assert np.abs(diff).max() <= 1
    assert TI.convert_to_wav(b"not a wav") == b"not a wav"
