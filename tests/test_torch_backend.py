"""The served path end to end: ``TorchWhisperBackend`` (CPU) against
``JaxWhisperBackend`` on the trained fixture ``tests/fixtures/test-tiny-eot``.

Both backends discover the fixture through STT_MODEL_DIR, load it with
their own converters in float32, and transcribe the clips of
``tests/test_eot_ckpt.py``: EOT stop, silence through the no-speech gate,
and the 5-window seek loop. verbose_json must be equal (floats within
1e-4: float32 on the CPU, different summation orders); text, srt and vtt
must be byte-identical, both as the backend renders them and as the REST
route renders them from verbose_json.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.ops import audio as jcodec
from open_speech_tpu.text.formatters import format_transcription as jax_format
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.text.formatters import format_transcription

FIXTURES = Path(__file__).parent / "fixtures"
SR = 16000
WINDOW = int(1.2 * SR)  # test-tiny geometry: 1.2 s windows
TOL = 1e-4
MODEL = "test-tiny-eot"


def _beeps(rng: np.random.Generator, k: int) -> np.ndarray:
    clip = rng.normal(0, 0.003, WINDOW)
    span = WINDOW // k
    for i in range(k):
        dur = int(0.15 * SR)
        t = np.arange(dur) / SR
        clip[i * span : i * span + dur] += (
            0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
        )
    return clip.astype(np.float32)


def _clips() -> dict[str, np.ndarray]:
    """The three cases of tests/test_eot_ckpt.py (same seeds)."""
    rng = np.random.default_rng(11)
    beeps1, beeps3 = _beeps(rng, 1), _beeps(rng, 3)
    silence = np.random.default_rng(12).normal(0, 0.002, WINDOW).astype(np.float32)
    rng = np.random.default_rng(13)
    seek = np.concatenate([
        _beeps(rng, 1),
        rng.normal(0, 0.002, WINDOW).astype(np.float32),
        _beeps(rng, 2),
        rng.normal(0, 0.002, WINDOW).astype(np.float32),
        _beeps(rng, 3),
    ])
    return {"beeps1": beeps1, "beeps3": beeps3, "silence": silence, "seek": seek}


@pytest.fixture(scope="module")
def backends():
    from open_speech_tpu.backends.jax_whisper import JaxWhisperBackend
    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend

    saved = [
        (s, name, getattr(s, name))
        for s in (jax_settings, torch_settings)
        for name in ("stt_model_dir", "os_precompile_on_load", "stt_compute_type")
    ]
    for s in (jax_settings, torch_settings):
        s.stt_model_dir = str(FIXTURES)
        s.os_precompile_on_load = False
        s.stt_compute_type = "float32"
    try:
        jb = JaxWhisperBackend()
        tb = TorchWhisperBackend(device="cpu")
        jb.load_model(MODEL)
        tb.load_model(MODEL)
        yield jb, tb
    finally:
        for s, name, value in saved:
            setattr(s, name, value)


def _assert_close(a, b, path="resp"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= TOL, f"{path}: {a} vs {b}"
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


# (clip, beam, fallback) as tests/test_eot_ckpt.py drives them, plus the
# REST default beam 5 on the 3-beep clip
CASES = [
    ("beeps1", 1, False),
    ("beeps3", 1, False),
    ("beeps3", 5, True),
    ("silence", 1, True),
    ("seek", 1, True),
]


@pytest.mark.parametrize("clip,beam,fallback", CASES)
def test_verbose_json_and_renderings_match_jax(backends, clip, beam, fallback):
    jb, tb = backends
    wav = jcodec.write_wav(_clips()[clip], SR)
    kw = dict(language="en", beam_size=beam, fallback=fallback,
              response_format="verbose_json")
    ref = jb.transcribe(wav, MODEL, **kw)
    out = tb.transcribe(wav, MODEL, **kw)
    _assert_close(out, ref)
    if clip.startswith("beeps"):
        assert out["segments"] and sum(len(s["tokens"]) for s in out["segments"]) < 48
    if clip == "silence":
        assert out["text"].strip() == ""
    for fmt in ("text", "srt", "vtt"):
        assert format_transcription(out, fmt) == jax_format(ref, fmt)


@pytest.mark.parametrize("fmt", ["text", "srt", "vtt", "json"])
def test_backend_renderings_are_byte_identical(backends, fmt):
    jb, tb = backends
    wav = jcodec.write_wav(_clips()["seek"], SR)
    kw = dict(language="en", beam_size=1, response_format=fmt)
    ref, out = jb.transcribe(wav, MODEL, **kw), tb.transcribe(wav, MODEL, **kw)
    assert out == ref
    if fmt != "json":
        assert out["text"].encode() == ref["text"].encode()


def test_translate_and_router_path(backends):
    """translate() and the REST handlers through the port's router."""
    from open_speech_tpu_torch.runtime.router import (
        BackendRouter,
        transcription_response,
        translation_response,
    )

    jb, tb = backends
    wav = jcodec.write_wav(_clips()["beeps3"], SR)
    ref = jb.translate(wav, MODEL, response_format="srt")
    assert tb.translate(wav, MODEL, response_format="srt") == ref

    router = BackendRouter(device="cpu")
    router.load_model(MODEL)
    verbose = transcription_response(router, wav, model=MODEL, response_format="verbose_json")
    assert set(verbose) == {"task", "language", "duration", "text", "segments"}
    assert transcription_response(router, wav, model=MODEL) == {"text": verbose["text"]}
    srt = transcription_response(router, wav, model=MODEL, response_format="srt")
    assert srt == format_transcription(verbose, "srt")[0]
    assert isinstance(translation_response(router, wav, model=MODEL, response_format="text"), str)
    info = router.loaded_models()
    assert [(m.model, m.backend, m.device) for m in info] == [(MODEL, "torch-whisper", "cpu")]


@pytest.mark.parametrize("clip", ["beeps1", "silence"])
def test_detect_language_pcm_matches_jax(backends, clip):
    jb, tb = backends
    pcm = _clips()[clip]
    assert tb.detect_language_pcm(MODEL, pcm) == jb.detect_language_pcm(MODEL, pcm)


@pytest.mark.parametrize("rate", [8000, 44100])
def test_non_16k_input_is_resampled_like_jax(backends, rate):
    """A WAV at another rate goes through the polyphase resampler, in the
    backend and in the REST handler's ingest, and decodes to the same
    response as in the JAX package."""
    from open_speech_tpu.audio.ingest import convert_to_wav as jax_convert
    from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response

    jb, tb = backends
    clip = _clips()["beeps3"]
    src = np.interp(np.arange(int(len(clip) * rate / SR)) * SR / rate, np.arange(len(clip)), clip)
    wav = jcodec.write_wav(src.astype(np.float32), rate)
    kw = dict(language="en", beam_size=1, fallback=False, response_format="verbose_json")
    _assert_close(tb.transcribe(wav, MODEL, **kw), jb.transcribe(wav, MODEL, **kw))
    router = BackendRouter(device="cpu")
    router.load_model(MODEL)
    body = transcription_response(router, wav, model=MODEL, language="en")
    assert body == {"text": jb.transcribe(jax_convert(wav), MODEL, language="en")["text"]}
