"""Batched long-form transcription: the PyTorch port against the JAX package.

``models/whisper/batched.py`` on the CPU: the chunker, the quietness curve
and the tail-keeping segment splitter must equal JAX's exactly (numpy and
Python arithmetic on both sides). ``transcribe_batched`` runs random
test-tiny (``init_params(PRNGKey(0))`` carried over with
``params_from_jax_tree``) and the trained fixture ``tests/fixtures/
test-tiny-eot`` (each side's own loader) in float32 at temperature 0,
greedy and beam 5, with and without a prompt, on audio from numpy seeds:
tokens, texts, seeks, segment times and temperatures must be equal;
avg_logprob, compression ratio, no-speech and language probabilities
within 1e-4 (float32, different summation orders). The backend takes the
batched branch under the JAX backend's condition.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.models.whisper import FallbackTokenizer as JaxFallbackTokenizer
from open_speech_tpu.models.whisper import batched as JBd
from open_speech_tpu.models.whisper import convert as JC
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu.models.whisper.tokenizer import get_tokenizer as jax_tokenizer
from open_speech_tpu.models.whisper.transcribe import TranscribeOptions as JaxOptions
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.whisper import FallbackTokenizer
from open_speech_tpu_torch.models.whisper import batched as TBd
from open_speech_tpu_torch.models.whisper import convert as TC
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.models.whisper.tokenizer import get_tokenizer as torch_tokenizer
from open_speech_tpu_torch.models.whisper.transcribe import TranscribeOptions, transcribe
from open_speech_tpu_torch.ops import audio as codec

TOL = 1e-4
SR = 16000
FIXTURE = Path(__file__).parent / "fixtures" / "test-tiny-eot"
TCFG = TM.PRESETS["test-tiny"]
WINDOW = TCFG.n_audio_ctx * 2 * 160  # 1.2 s


# ── chunking and splitting ────────────────────────────────────────────


def _loud_with_dips(seconds: float, dips: list[float], seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    audio = (0.5 + 0.05 * rng.standard_normal(int(seconds * SR))).astype(np.float32)
    for d in dips:
        audio[int(d * SR) : int((d + 0.2) * SR)] = 0.001
    return audio


@pytest.mark.parametrize(
    "seconds,window_s,dips,kw",
    [
        (10.7, 3.0, None, {}),  # fixed grid: no curve
        (6.0, 3.0, [2.4], dict(snap_s=1.0)),  # snaps into the dip
        (8.0, 3.0, [0.0], dict(snap_s=10.0)),  # the min-chunk floor
        (47.3, 30.0, [27.9, 41.0], {}),  # whisper windows, default snap
        (5.0, 1.2, [1.9, 3.3], {}),  # test-tiny windows
        (0.9, 1.2, [], {}),  # shorter than one window
    ],
)
def test_chunking_matches_jax(seconds, window_s, dips, kw):
    audio = _loud_with_dips(seconds, dips or [], seed=int(seconds * 10))
    curve = TBd.quietness_curve(audio)
    np.testing.assert_array_equal(curve, JBd.quietness_curve(audio))
    use = curve if dips is not None else None
    got = TBd.chunk_boundaries(len(audio), int(window_s * SR), use, **kw)
    assert got == JBd.chunk_boundaries(len(audio), int(window_s * SR), use, **kw)
    assert got[0][0] == 0 and got[-1][1] == len(audio)


class _FakeSpecial:
    eot = 100
    timestamp_begin = 110


class _FakeTok:
    special = _FakeSpecial()


@pytest.mark.parametrize(
    "tokens,offset,frames",
    [
        ([110, 1, 2, 130, 130, 3, 4], 0.0, 100),  # trailing group kept
        ([110, 5, 120], 30.0, 100),  # one closed segment at an offset
        ([110, 5, 155, 155, 6, 155], 10.0, 50),  # clamped to the chunk
        ([1, 2, 3], 2.0, 100),  # no timestamp: the whole window
        ([110, 1, 120, 120, 100], 0.0, 100),  # eot-only tail dropped
        ([], 0.0, 100),
    ],
)
def test_split_all_segments_matches_jax(tokens, offset, frames):
    got = TBd._split_all_segments(tokens, _FakeTok(), offset, frames)
    assert got == JBd._split_all_segments(tokens, _FakeTok(), offset, frames)


def test_constants_and_buckets_match_jax():
    assert TBd.BATCH_BUCKETS == JBd.BATCH_BUCKETS
    assert TBd.BATCHED_PREV_LEN == JBd.BATCHED_PREV_LEN
    assert [TBd._bucket(n) for n in range(1, 20)] == [JBd._bucket(n) for n in range(1, 20)]


# ── transcribe_batched end to end ─────────────────────────────────────


@pytest.fixture(scope="module", params=["random", "eot"])
def pair(request):
    """(jax params, jax cfg, jax tokenizer, torch model, torch tokenizer)."""
    if request.param == "random":
        cfg = JM.PRESETS["test-tiny"]
        params = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
        model = TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG)
        jtok = JaxFallbackTokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
        ttok = FallbackTokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
    else:
        params, cfg = JC.load_params(str(FIXTURE), dtype=jnp.float32)
        model, _ = TC.load_params(str(FIXTURE), dtype=torch.float32)
        jtok = jax_tokenizer(str(FIXTURE), n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
        ttok = torch_tokenizer(str(FIXTURE), n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
    return params, cfg, jtok, model, ttok


def _beepy(seconds: float, seed: int) -> np.ndarray:
    """Beeps over noise with quiet gaps: speech-like for the EOT fixture."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    clip = rng.normal(0, 0.003, n)
    dur = int(0.15 * SR)
    for start in range(int(0.1 * SR), n - dur, int(0.45 * SR)):
        t = np.arange(dur) / SR
        clip[start : start + dur] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
    return clip.astype(np.float32)


def _same_result(got, want):
    segs, info = got
    jsegs, jinfo = want
    assert (info.language, info.duration) == (jinfo.language, jinfo.duration)
    assert info.language_probability == pytest.approx(jinfo.language_probability, abs=TOL)
    assert len(segs) == len(jsegs)
    for s, j in zip(segs, jsegs):
        assert (s.id, s.seek, s.start, s.end, s.text, s.tokens, s.temperature) == (
            j.id, j.seek, j.start, j.end, j.text, list(j.tokens), j.temperature)
        for key in ("avg_logprob", "compression_ratio", "no_speech_prob"):
            assert getattr(s, key) == pytest.approx(getattr(j, key), abs=TOL)


@pytest.mark.parametrize("beam", [1, 5])
@pytest.mark.parametrize("prompt", [None, "a style hint"])
def test_transcribe_batched_matches_jax(pair, beam, prompt):
    """5.2 s (five to seven chunks) in batches of four: one full bucket and
    one padded one. Without a prompt the language is detected on row 0."""
    params, cfg, jtok, model, ttok = pair
    audio = _beepy(5.2, seed=beam)
    kw = dict(language=None if prompt is None else "en", beam_size=beam,
              temperature=(0.0,), max_new_tokens=12, initial_prompt=prompt)
    want = JBd.transcribe_batched(params, cfg, jtok, audio, JaxOptions(**kw), max_batch=4)
    got = TBd.transcribe_batched(model, TCFG, ttok, audio, TranscribeOptions(**kw), max_batch=4)
    _same_result(got, want)
    n_chunks = len(TBd.chunk_boundaries(len(audio), WINDOW, TBd.quietness_curve(audio)))
    assert n_chunks > 4


def test_single_window_delegates_to_sequential(pair):
    params, cfg, jtok, model, ttok = pair
    audio = _beepy(1.0, seed=3)
    opts = TranscribeOptions(language="en", beam_size=5, temperature=(0.0,), max_new_tokens=12)
    got = TBd.transcribe_batched(model, TCFG, ttok, audio, opts)
    _same_result(got, transcribe(model, TCFG, ttok, audio, opts))
    _same_result(got, JBd.transcribe_batched(
        params, cfg, jtok, audio, JaxOptions(language="en", beam_size=5, temperature=(0.0,),
                                             max_new_tokens=12)))


def test_bucket_padding_is_inert_and_fallback_is_per_row(pair):
    """Three rows padded to the bucket of four equal four explicit rows;
    with every gate failing, each row ends at the last temperature, drawn
    from generators seeded by temperature (deterministic)."""
    _, _, _, model, ttok = pair
    rng = np.random.default_rng(2)
    block = rng.uniform(-0.1, 0.1, (4, WINDOW)).astype(np.float32)
    block[3] = block[0]  # the row padding repeats
    mel = TBd.log_mel_spectrogram(torch.from_numpy(block), n_mels=TCFG.n_mels)
    enc = TM.encode(model, mel, TCFG)
    prompt = np.asarray([ttok.special.sot_sequence("en", "transcribe")], np.int32)
    opts = TranscribeOptions(language="en", beam_size=1, temperature=(0.0,), max_new_tokens=8,
                             compression_ratio_threshold=None, logprob_threshold=None,
                             no_speech_threshold=None)
    rows3 = TBd._decode_rows_with_fallback(model, TCFG, ttok, enc[:3], prompt, opts)
    rows4 = TBd._decode_rows_with_fallback(model, TCFG, ttok, enc, prompt, opts)
    for a, b in zip(rows3, rows4[:3]):
        assert a["tokens"] == b["tokens"]
        assert a["avg_logprob"] == pytest.approx(b["avg_logprob"], abs=1e-6)
    hard = replace(opts, temperature=(0.0, 0.5, 1.0), logprob_threshold=1.0)
    first = TBd._decode_rows_with_fallback(model, TCFG, ttok, enc[:3], prompt, hard)
    again = TBd._decode_rows_with_fallback(model, TCFG, ttok, enc[:3], prompt, hard)
    assert [r["temperature"] for r in first] == [1.0] * 3
    assert first == again


def test_backend_routes_longform_to_batched(monkeypatch):
    """OS_STT_BATCHED_LONGFORM sends uploads over two windows decoded from
    temperature 0 down the batched path (prompted ones too); short clips
    and sampled requests stay sequential. The load-time warmup drives one
    rung: the largest bucket <= OS_STT_BATCH_WINDOWS."""
    from open_speech_tpu_torch.backends import torch_whisper as TW

    monkeypatch.setattr(torch_settings, "os_precompile_on_load", True)
    monkeypatch.setattr(torch_settings, "os_stream_incremental", False)
    monkeypatch.setattr(torch_settings, "os_stt_batched_longform", True)
    monkeypatch.setattr(torch_settings, "os_stt_batch_windows", 6)
    calls, rungs = [], []
    real, real_rows = TW.transcribe_batched, TW._decode_rows_with_fallback

    def spy(*args, **kwargs):
        calls.append(kwargs.get("max_batch"))
        return real(*args, **kwargs)

    def spy_rows(model, cfg, tok, enc_out, prompt, opts):
        rungs.append(int(enc_out.shape[0]))
        return real_rows(model, cfg, tok, enc_out, prompt, opts)

    monkeypatch.setattr(TW, "transcribe_batched", spy)
    monkeypatch.setattr(TW, "_decode_rows_with_fallback", spy_rows)
    backend = TW.TorchWhisperBackend(device="cpu", compute_type="float32")
    backend.load_model("test-tiny")
    assert rungs == [4]  # warmup: the largest bucket <= 6
    rng = np.random.default_rng(0)
    long_wav = codec.write_wav(rng.uniform(-0.1, 0.1, 3 * WINDOW).astype(np.float32), SR)
    edge_wav = codec.write_wav(rng.uniform(-0.1, 0.1, 2 * WINDOW).astype(np.float32), SR)
    kw = dict(language="en", beam_size=1, fallback=False)
    backend.transcribe(long_wav, "test-tiny", **kw)
    assert calls == [6]
    backend.transcribe(edge_wav, "test-tiny", **kw)  # exactly two windows
    backend.transcribe(long_wav, "test-tiny", temperature=0.7, **kw)
    assert calls == [6]
    backend.transcribe(long_wav, "test-tiny", prompt="style hint", **kw)
    assert calls == [6, 6]
