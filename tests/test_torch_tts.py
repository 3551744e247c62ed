"""Kokoro serving in the port against the JAX package, on the CPU: voices,
G2P and ids, text and audio helpers, the backend's per-request path, the
router, and the body of ``POST /v1/audio/speech``.

- Copied host modules (G2P, voices, pronunciation, postprocessing, encode)
  give the JAX modules' results on the same inputs; the voice-spec table,
  errors included.
- The backend's ``_encode_text`` gives the JAX backend's ids exactly over a
  corpus (English with numbers, abbreviations and punctuation; one sentence
  each in es, fr, hi, it, ja, pt and zh with the vendored vocab), with the
  same drop rate and the same ``g2p_vocab_mismatch`` error.
- The backend's per-request synthesis gives the JAX backend's chunk sizes
  exactly and its audio within ``TOL_AUDIO`` (harmonic features injected,
  ``tests/torch_tts_common.py``), on voice packs, a blend included.
- ``speech_response`` gives the JAX server's status and message for every
  rejected request (the JAX app driven through aiohttp's ``TestClient`` as
  ``tests/test_api.py`` drives it), and the served WAV/PCM equal the JAX
  server's within the audio tolerance.
"""

from __future__ import annotations

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from open_speech_tpu.audio import encode as JE
from open_speech_tpu.audio import postprocessing as JP
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.models.kokoro import model as JM
from open_speech_tpu.text import g2p as JG
from open_speech_tpu.text import pronunciation as JPR
from open_speech_tpu.tts import voices as JV
from open_speech_tpu_torch.audio import encode as TE
from open_speech_tpu_torch.audio import postprocessing as TP
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.kokoro import model as TM
from open_speech_tpu_torch.models.kokoro.convert import kokoro_from_jax_tree
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.runtime import speech as S
from open_speech_tpu_torch.text import g2p as TG
from open_speech_tpu_torch.text import pronunciation as TPR
from open_speech_tpu_torch.tts import voices as TV
from open_speech_tpu_torch.tts.router import TTSRouter
from tests.torch_tts_common import (
    CFG,
    TCFG,
    TEXT,
    TOL_AUDIO,
    inject_har,
    injected_har,
    jax_backend,
    jax_tree,
    one_torch_thread,
    torch_backend,
    voice_packs,
)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def tree():
    return jax_tree(CFG)


@pytest.fixture(scope="module")
def jtree(tree):
    import jax

    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def model(tree):
    return kokoro_from_jax_tree(tree, device="cpu")


@pytest.fixture(scope="module")
def har(jtree):
    return injected_har(jtree)


@pytest.fixture(scope="module")
def injected(har):
    """The harmonic features injected into both packages for the module."""
    with pytest.MonkeyPatch.context() as mp:
        inject_har(mp, har)
        yield


@pytest.fixture
def per_request(monkeypatch):
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_tts_batcher_enabled", False)


# ── voices ──────────────────────────────────────────────────────────────


def _spec(mod, voice):
    try:
        spec = mod.parse_voice_spec(voice)
    except ValueError as e:
        return ("error", str(e))
    return ([(c.voice_id, c.weight) for c in spec.components], spec.normalized_weights(),
            spec.is_blend, spec.primary_id)


@pytest.mark.parametrize("voice", [
    "af_bella", "alloy", "nova", "shimmer", "af_bella(2)+af_sky(1)", "af_heart+am_adam",
    "a(0)+b(0)", "af_bella(1.5)", "alloy+nova", " af_sky ( 2 ) ",
    "af bella", "af_bella(x)", "", "+af_sky", "af_sky()",
])
def test_voice_spec_matches_jax(voice):
    assert _spec(TV, voice) == _spec(JV, voice)
    assert TV.resolve_voice_name(voice) == JV.resolve_voice_name(voice)
    assert TV.OPENAI_VOICE_MAP == JV.OPENAI_VOICE_MAP


def test_voice_registry_and_capabilities_match_jax():
    from open_speech_tpu.tts.backends import kokoro_backend as JKB
    from open_speech_tpu_torch.tts.backends import kokoro_backend as TKB

    assert TKB.ALL_KOKORO_VOICES == JKB.ALL_KOKORO_VOICES
    assert TKB.VOICE_PREFIX_TO_LANG == JKB.VOICE_PREFIX_TO_LANG
    assert TKB.KokoroBackend.capabilities == JKB.KokoroBackend.capabilities
    j, t = JKB.KokoroBackend(), TKB.KokoroBackend(device="cpu")
    assert [vars(v) for v in t.list_voices()] == [vars(v) for v in j.list_voices()]
    for v in ("af_heart", "bm_lewis", "ef_dora", "zm_yunxi", "x", "", "jf_alpha"):
        assert TKB.lang_code_from_voice_id(v) == JKB.lang_code_from_voice_id(v)
    for lang in ("en-us", "en-gb", "es", "fr-fr", "hi", "it", "ja", "pt-br", "zh", "ko", "de",
                 "af_heart", "zf_xiaoni", "xx"):
        assert t.supports_language(lang) == j.supports_language(lang), lang


@pytest.mark.parametrize("n", [5, 40])
@pytest.mark.parametrize("voice", ["af_bella", "af_bella(2)+af_sky(1)"])
def test_style_rows_match_jax(tmp_path, monkeypatch, voice, n):
    """With voice packs (one row per utterance length) a single voice and a
    blend select the JAX backend's rows."""
    monkeypatch.setenv("OS_KOKORO_VOICES_DIR", voice_packs(tmp_path))
    j = jax_backend(None)
    t = torch_backend(None)
    np.testing.assert_array_equal(t._style_for(voice, n), j._style_for(voice, n))
    assert not np.array_equal(t._style_for(voice, n), t._style_for(voice, n + 1))


# ── G2P and ids ─────────────────────────────────────────────────────────

CORPUS = [
    ("Hello world.", "en-us"),
    ("Dr. Smith paid $3.50 for 12 apples on Jan. 5th, 2021!", "en-us"),
    ("Mr. and Mrs. O'Neil live at 221 Baker St., e.g. in London; it's 3:45 now?", "en-us"),
    ("The year 1999 had 365 days, and 42% of them were rainy.", "en-gb"),
    ("I read 1,234,567 books vs. 0.5 magazines etc.", "en-us"),
    ("¿Dónde está la biblioteca? Está a 300 metros.", "es"),
    ("Bonjour, je m'appelle Jean et j'ai vingt-cinq ans.", "fr-fr"),
    ("नमस्ते, आप कैसे हैं?", "hi"),
    ("Buongiorno, come stai oggi?", "it"),
    ("これはテストです。今日は良い天気ですね。", "ja"),
    ("Olá, tudo bem? Eu moro em São Paulo.", "pt-br"),
    ("你好，世界。今天天气很好。", "zh"),
    ("魑魅魍魎", "ja"),  # kanji outside the lexicon: g2p_vocab_mismatch
    ("鬱鬱鬱", "zh"),
]


def _ids(backend, text, lang):
    try:
        return backend._encode_text(text, lang), backend.last_drop_rate
    except ValueError as e:
        return ("error", str(e)), backend.last_drop_rate


@pytest.mark.parametrize("text,lang", CORPUS)
def test_encode_text_matches_jax(text, lang):
    """Ids, drop rate and mismatch error, sentence by sentence."""
    j, t = jax_backend(None), torch_backend(None)
    assert type(t._g2p).__name__ == type(j._g2p).__name__
    for sentence in JG.split_sentences(text) or [text]:
        assert _ids(t, sentence, lang) == _ids(j, sentence, lang)


def test_vocab_is_the_jax_packages():
    j, t = jax_backend(None), torch_backend(None)
    assert t._vocab == j._vocab and len(t._vocab) > 100


@pytest.mark.parametrize("text", [
    "One. Two! Three? Four", "  ", "No split here", "Dr. Who said: hi.  Then left!\nNew line.",
    "Ellipsis... next one.", "多语言。 Mixed! text",
])
def test_split_sentences_matches_jax(text):
    assert TG.split_sentences(text) == JG.split_sentences(text)
    assert TG.RuleG2P().phonemize(text) == JG.RuleG2P().phonemize(text)
    assert TG.RuleG2P().to_ids(text) == JG.RuleG2P().to_ids(text)


# ── pronunciation, postprocessing, encode ───────────────────────────────


def test_pronunciation_and_ssml_match_jax(tmp_path):
    path = tmp_path / "dict.json"
    path.write_text(json.dumps({"SQL": "sequel", "New York City": "the big apple", "a\\b": "x\\1"}))
    j, t = JPR.PronunciationDictionary(str(path)), TPR.PronunciationDictionary(str(path))
    text = "I use SQL in New York City and new york; sql. a\\b"
    assert t.apply(text) == j.apply(text) and len(t) == len(j) == 3
    for ssml in ('<speak>Hello<break time="500ms"/>world <emphasis>now</emphasis></speak>',
                 'a<break time="2s"/>b', "<p>plain</p>"):
        assert TPR.parse_ssml(ssml) == JPR.parse_ssml(ssml)


def _chunks(seed: int) -> list[np.ndarray]:
    """Audio chunks with silent leading, middle and trailing stretches."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in ("silent", "silent", "voiced", "silent", "voiced", "tail", "silent", "empty"):
        n = int(rng.integers(50, 400))
        if kind == "silent":
            out.append((0.005 * rng.standard_normal(n)).astype(np.float32))
        elif kind == "empty":
            out.append(np.zeros(0, np.float32))
        else:
            c = (rng.uniform(0.2, 1.6) * rng.standard_normal(n)).astype(np.float32)
            if kind == "tail":
                c[-40:] = 0.0
            out.append(c)
    return out


@pytest.mark.parametrize("trim,normalize", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_postprocessing_matches_jax(seed, trim, normalize):
    """``StreamingPostProcessor`` chunk for chunk, and the one-shot path."""
    chunks = _chunks(seed)
    pp = {m: m.StreamingPostProcessor(trim=trim, normalize=normalize) for m in (JP, TP)}
    for c in chunks:
        want, got = pp[JP].feed(c), pp[TP].feed(c)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(pp[TP].finish(), pp[JP].finish(), strict=True):
        np.testing.assert_array_equal(g, w)
    want = list(JP.process_tts_chunks(iter(chunks), trim=trim, normalize=normalize))
    got = list(TP.process_tts_chunks(iter(chunks), trim=trim, normalize=normalize))
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    silent = [np.zeros(10, np.float32)]
    np.testing.assert_array_equal(TP.trim_silence(silent[0]), JP.trim_silence(silent[0]))


@pytest.mark.parametrize("fmt", ["wav", "pcm"])
def test_encode_matches_jax(fmt):
    chunks = _chunks(3)
    audio = np.concatenate(chunks)
    assert TE.encode_audio(audio, 24000, fmt) == JE.encode_audio(audio, 24000, fmt)
    assert list(TE.encode_audio_streaming(iter(chunks), 24000, fmt)) == list(
        JE.encode_audio_streaming(iter(chunks), 24000, fmt))
    assert TE.CONTENT_TYPES == JE.CONTENT_TYPES


@pytest.mark.parametrize("fmt", ["mp3", "opus", "aac", "flac", "m4a", "ogg"])
def test_compressed_formats_without_ffmpeg_match_jax(monkeypatch, fmt):
    """Without ffmpeg a compressed format raises the JAX module's error
    (``ValueError`` for a format neither knows)."""
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "ffmpeg_available", lambda: False)
    audio = np.zeros(100, np.float32)
    errors = []
    for mod in (JE, TE):
        for call in (lambda: mod.encode_audio(audio, 24000, fmt),
                     lambda: list(mod.encode_audio_streaming(iter([audio]), 24000, fmt))):
            with pytest.raises((RuntimeError, ValueError)) as e:
                call()
            errors.append((type(e.value), str(e.value)))
    assert errors[2:] == errors[:2]
    assert TE.supported_formats() == JE.supported_formats() == {"wav", "pcm"}


# ── the model entry the backend calls ───────────────────────────────────


def test_vocode_blocks_takes_the_jax_call_shape(model):
    """``vocode_blocks(model, cfg, g, n_frames, style)``: the style is the
    fifth argument, as the JAX backend passes it, and unused."""
    rng = np.random.default_rng(5)
    ph = np.zeros((1, TCFG.max_phonemes), np.int64)
    ph[0, :30] = rng.integers(1, TCFG.n_symbols, 30)
    style = torch.from_numpy(TM.voice_vector("af_heart", TCFG.voice_dim)[None])
    g, n_frames = TM.encode_utterance(model, TCFG, torch.from_numpy(ph), torch.tensor([30]), style,
                                      torch.ones(1))
    got = list(TM.vocode_blocks(model, TCFG, g, n_frames, style))
    want = list(TM.vocode_streaming(model, TCFG, g, n_frames))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ── backend: per-request synthesis ──────────────────────────────────────


@pytest.mark.parametrize("voice", ["af_bella", "af_bella(2)+af_sky(1)"])
def test_backend_blocks_match_jax(tmp_path, monkeypatch, injected, per_request, jtree, model, voice):
    """Per sentence the 64-frame blocks of the JAX backend: the same chunk
    sizes, and the audio within TOL_AUDIO, on voice packs."""
    monkeypatch.setenv("OS_KOKORO_VOICES_DIR", voice_packs(tmp_path))
    want = list(jax_backend(jtree).synthesize(TEXT, voice))
    got = list(torch_backend(model).synthesize(TEXT, voice))
    assert [c.shape for c in got] == [c.shape for c in want]
    assert len(want) > 2 and len({c.shape for c in want}) > 1  # first, interior, last
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=TOL_AUDIO)


# ── router ──────────────────────────────────────────────────────────────


def test_router_resolves_to_the_card_by_default(monkeypatch):
    """No device: the backend is made for ``tts_effective_device`` (cuda);
    nothing is loaded, so nothing runs."""
    monkeypatch.setattr(torch_settings, "stt_device", "cuda")
    monkeypatch.setattr(torch_settings, "tts_device", None)
    from open_speech_tpu.tts.router import TTSRouter as JRouter
    from open_speech_tpu_torch.tts.router import NOT_PORTED

    router = TTSRouter()
    backend = router.get_backend("kokoro")
    assert backend.device == torch.device("cuda") and router.get_backend("piper").device == torch.device("cuda")
    jr = JRouter(device="cpu")
    # the JAX router's backends, but those the port has not ported yet (Pocket)
    assert router.list_backends() == [n for n in jr.list_backends() if n not in NOT_PORTED] == ["kokoro", "piper"]
    assert router.get_backend("kokoro/any") is backend and router.get_backend("nope") is backend
    assert router.get_capabilities("kokoro")["voice_blend"] is True
    assert router.loaded_models() == [] and not router.is_model_loaded("kokoro")
    want = [v.__dict__ for v in jr.list_voices() if not v.id.startswith("pocket/")]
    assert [v.__dict__ for v in router.list_voices()] == want and len(want) == 52 + 30
    assert TTSRouter(device="cpu").get_backend("kokoro").device == torch.device("cpu")


# ── speech_response against the JAX server ──────────────────────────────

# (name, JSON body, stream, settings changed on both sides)
REJECTED = [
    ("disabled", {"input": "hi"}, False, {"tts_enabled": False}),
    ("not an object", [1, 2], False, {}),
    ("missing input", {"model": "kokoro"}, False, {}),
    ("input not text", {"input": 5, "speed": 9}, False, {}),
    ("speed low", {"input": "hi", "speed": 0.1}, False, {}),
    ("speed text", {"input": "hi", "speed": "fast"}, True, {}),
    ("too long", {"input": "x" * 50, "response_format": "wav"}, False, {"tts_max_input_length": 10}),
    ("empty", {"input": "  ", "response_format": "wav"}, False, {}),
    ("voice design", {"input": "hi", "response_format": "wav", "voice_design": "deep"}, False, {}),
    ("clone", {"input": "hi", "reference_audio": "", "response_format": "wav"}, False, {}),
    ("format", {"input": "hi", "response_format": "xyz"}, True, {}),
    ("mismatch stream", {"input": "魑魅魍魎", "voice": "jf_alpha", "response_format": "pcm"}, True, {}),
    ("mismatch", {"input": "魑魅魍魎", "voice": "jf_alpha", "response_format": "wav"}, False, {}),
    ("language", {"input": "hi", "language": "ko", "response_format": "pcm"}, True, {}),
    ("mp3 stream", {"input": "hi", "response_format": "mp3"}, True, {}),
]


class _Unused:
    """Stands in for loaded weights: these requests fail before synthesis."""


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX server's (status, message) for each rejected request."""
    from open_speech_tpu.server import app as A

    backend = A.tts_router.get_backend("kokoro")
    answers = {}

    async def run(client):
        for name, body, stream, changed in REJECTED:
            with pytest.MonkeyPatch.context() as mp:
                for key, value in changed.items():
                    mp.setattr(jax_settings, key, value)
                mp.setattr(JE, "ffmpeg_available", lambda: False)
                mp.setattr(backend, "_params", _Unused())
                url = "/v1/audio/speech" + ("?stream=true" if stream else "")
                resp = await client.post(url, json=body)
                answers[name] = (resp.status, (await resp.json())["error"]["message"])

    async def main():
        async with TestClient(TestServer(A.create_app())) as client:
            await run(client)

    asyncio.new_event_loop().run_until_complete(main())
    return answers


def _pydantic_lines(message: str) -> str:
    """pydantic's message without its ``[type=...]`` tails and links."""
    return "\n".join(line.split(" [type=")[0] for line in message.splitlines()
                     if not line.startswith("    For further"))


@pytest.mark.parametrize("name,body,stream,changed", REJECTED, ids=[r[0] for r in REJECTED])
def test_rejected_requests_match_the_jax_server(monkeypatch, jax_answers, name, body, stream, changed):
    for key, value in changed.items():
        monkeypatch.setattr(torch_settings, key, value)
    monkeypatch.setattr(TE, "ffmpeg_available", lambda: False)
    router = TTSRouter(device="cpu")
    router.get_backend("kokoro")._model = _Unused()
    with pytest.raises(S.SpeechError) as e:
        S.speech_response(router, body, stream=stream)
    status, message = jax_answers[name]
    assert e.value.status == status
    if status == 422 and "validation error" in message:
        message = _pydantic_lines(message)
    assert e.value.message == message


def test_effects_name_their_later_item(injected, model):
    """The DSP is ported: with OS_EFFECTS_ENABLED on (the default), a
    request with effects raises no named error but answers the plain
    request's samples through ``apply_chain`` (the chain itself is held to
    the JAX package's in ``tests/test_torch_effects.py``), within two PCM
    steps of requantisation."""
    from open_speech_tpu_torch.audio.effects import apply_chain

    router = TTSRouter(device="cpu")
    backend = router.get_backend("kokoro")
    backend._model, backend._cfg = model, TCFG
    body = {"input": TEXT, "voice": "af_bella", "response_format": "pcm"}
    effects = [{"type": "reverb", "room": "small"}]
    _, plain = S.speech_response(router, body)
    _, effected = S.speech_response(router, {**body, "effects": effects})
    want = apply_chain(codec.pcm16_to_float(plain), 24000, effects, device="cpu")
    got = codec.pcm16_to_float(effected)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=2 / 32768)
    assert not np.allclose(got, codec.pcm16_to_float(plain), atol=1e-3)


@pytest.fixture(scope="module")
def jax_served(jtree, injected):
    """The JAX server's WAV and streamed PCM bytes for TEXT on the test
    weights (batcher off, voice af_bella: the fallback voice vector)."""
    from open_speech_tpu.server import app as A

    backend = A.tts_router.get_backend("kokoro")
    out = {}

    async def main():
        async with TestClient(TestServer(A.create_app())) as client:
            for fmt, stream in (("wav", False), ("pcm", True)):
                url = "/v1/audio/speech" + ("?stream=true" if stream else "")
                resp = await client.post(url, json={"input": TEXT, "voice": "af_bella",
                                                    "response_format": fmt})
                assert resp.status == 200, await resp.text()
                out[fmt] = (resp.headers["Content-Type"], await resp.read())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_settings, "os_tts_batcher_enabled", False)
        mp.setattr(backend, "_params", jtree)
        mp.setattr(backend, "_cfg", CFG)
        asyncio.new_event_loop().run_until_complete(main())
    return out


def test_served_audio_matches_the_jax_server(jax_served, injected, per_request, model):
    """One-shot WAV and streamed PCM: the same content type and sample
    count as the JAX server's, the samples within TOL_AUDIO after
    normalisation (both peak at 0.95) plus one PCM step."""
    router = TTSRouter(device="cpu")
    backend = router.get_backend("kokoro")
    backend._model, backend._cfg = model, TCFG
    ct, wav = S.speech_response(router, {"input": TEXT, "voice": "af_bella", "response_format": "wav"})
    ct_pcm, chunks = S.speech_response(
        router, {"input": TEXT, "voice": "af_bella", "response_format": "pcm"}, stream=True)
    pcm = b"".join(chunks)
    assert (ct, ct_pcm) == (jax_served["wav"][0], jax_served["pcm"][0])
    got, rate = codec.read_wav(wav)
    want, _ = codec.read_wav(jax_served["wav"][1])
    assert rate == 24000 and got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO + 2 / 32768)
    got, want = codec.pcm16_to_float(pcm), codec.pcm16_to_float(jax_served["pcm"][1])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO + 2 / 32768)


@pytest.mark.parametrize("batcher", [False, True])
def test_stream_consumer_that_leaves_stops_synthesis(monkeypatch, model, batcher):
    """A consumer that takes the first chunk and leaves: no further
    sentence is encoded or submitted."""
    from open_speech_tpu_torch.runtime import tts_batcher as TB

    monkeypatch.setattr(torch_settings, "os_tts_batcher_enabled", batcher)
    monkeypatch.setattr(torch_settings, "tts_trim_silence", False)
    calls = []
    real = TM.encode_utterance

    def counted(*args, **kw):
        calls.append(args[2].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(TM, "encode_utterance", counted)
    monkeypatch.setattr(TB, "encode_utterance", counted)
    router = TTSRouter(device="cpu")
    backend = router.get_backend("kokoro")
    backend._model, backend._cfg = model, TCFG
    try:
        _, chunks = S.speech_response(
            router, {"input": "One sentence here. Two sentences here. Three of them now.",
                     "response_format": "pcm"}, stream=True)
        first = next(chunks)
        chunks.close()
        assert len(first) > 0 and calls == [1]  # one sentence, one row
    finally:
        threads = [b._thread for b in TB._batchers.values() if b._thread is not None]
        TB.reset_tts_batchers()
        for thread in threads:
            thread.join(timeout=60)
            assert not thread.is_alive()
