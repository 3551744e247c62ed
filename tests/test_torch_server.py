"""The port's server against the JAX aiohttp app, on the CPU.

The JAX app (``open_speech_tpu.server.app.create_app``) is served through
``aiohttp.test_utils.TestServer``; the port's (``open_speech_tpu_torch.server
.app.create_app``) on a real ``127.0.0.1:0`` socket of its own shell. Both
get the same requests from aiohttp's client and the ``websockets`` package,
implementations of the protocols independent of the port's.

STT runs the trained fixture ``tests/fixtures/test-tiny-eot`` (float32) on
the clips of ``tests/test_torch_backend.py``; the JAX app's module router
serves a ``JaxWhisperBackend`` loaded from it, the port's app a CPU
``BackendRouter``. Kokoro runs ``tests/torch_tts_common.py``'s tree with
the harmonic features injected into both packages.

Equal means: the status and the ``Content-Type``; JSON bodies with floats
within 1e-4 (the model list's ``created`` within a few seconds, and the
backend's name, ``jax-whisper`` or ``torch-whisper``, normalised); text,
srt and vtt byte for byte; WAV/PCM within 2e-3 as ``test_torch_tts.py``
holds them; every rejected request's envelope (pydantic's 422 message
without its ``[type=...]`` tails, as ``test_torch_tts.py`` compares it);
the CORS and rate-limit headers; the WebSocket refusals' close codes and
reasons; a streaming session's event list (every interim awaited before
the next frame, as ``tests/test_torch_streaming.py:_run_both`` does in
process). A diarized transcription (``?diarize=true`` and the form field,
json, text and verbose_json) answers the JAX app's ``{"text", "segments"}``
body with each package's shared conv-embedder diarizer on one set of
weights (JAX's ``PRNGKey(23)`` tree carried over), and a failed
diarization the same 500. Two tests need no JAX: ``/health`` answers while a slow
transcription is in flight, and a streamed speech request whose client
leaves stops the synthesis. A last one starts ``python -m
open_speech_tpu_torch.server`` with TLS, as it starts by default.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time
from pathlib import Path

import aiohttp
import numpy as np
import pytest
import websockets
from aiohttp import FormData
from aiohttp.test_utils import TestServer

import open_speech_tpu.server.middleware as JMW
import open_speech_tpu.server.streaming as JSS
import open_speech_tpu_torch.server.streaming as TSS
from open_speech_tpu.audio import ingest as JI
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.ops import audio as JA
from open_speech_tpu.runtime.router import router as jax_router
from open_speech_tpu.server import app as JAPP
from open_speech_tpu_torch.audio import ingest as TI
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.kokoro.convert import kokoro_from_jax_tree
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response
from open_speech_tpu_torch.server import app as TAPP
from open_speech_tpu_torch.server.http import serve_app
from open_speech_tpu_torch.tts.router import TTSRouter
from tests.test_torch_backend import _clips
from tests.torch_tts_common import (
    CFG,
    TCFG,
    TOL_AUDIO,
    inject_har,
    injected_har,
    jax_tree,
    one_torch_thread,
)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
MODEL = "test-tiny-eot"
SR = 16000
TOL = 1e-4
CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods", "Access-Control-Allow-Headers")
COMPARED_HEADERS = CORS + ("X-RateLimit-Limit", "X-RateLimit-Remaining", "Retry-After", "Upgrade")

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


# ── both servers ────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def backends():
    from open_speech_tpu.backends.jax_whisper import JaxWhisperBackend

    with pytest.MonkeyPatch.context() as mp:
        for s in (jax_settings, torch_settings):
            mp.setattr(s, "stt_model_dir", str(FIXTURES))
            mp.setattr(s, "os_precompile_on_load", False)
            mp.setattr(s, "stt_compute_type", "float32")
        jb = JaxWhisperBackend()
        jb.load_model(MODEL)
        trouter = BackendRouter(device="cpu")
        trouter.load_model(MODEL)
        yield jb, trouter


@pytest.fixture
def both(backends, monkeypatch):
    """The JAX app's router serves the fixture backend; settings are shared
    defaults (no history, no SSL, the stream settings of the streaming
    tests). Returns a function applying settings to both packages."""
    jb, _ = backends
    monkeypatch.setattr(jax_router, "_default_backend", jb)
    for key in list(jax_router._backends):
        monkeypatch.setitem(jax_router._backends, key, jb)
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "stt_model_dir", str(FIXTURES))
        monkeypatch.setattr(s, "os_stream_incremental", True)
        monkeypatch.setattr(s, "os_batcher_enabled", False)
        monkeypatch.setattr(s, "os_stream_chunk_ms", 100)
        monkeypatch.setattr(s, "os_tts_batcher_enabled", False)
    monkeypatch.setattr(jax_settings, "os_history_enabled", False)
    JMW.reset_rate_limiter()

    def change(**values):
        for s in (jax_settings, torch_settings):
            for key, value in values.items():
                monkeypatch.setattr(s, key, value)
        JMW.reset_rate_limiter()

    yield change
    JMW.reset_rate_limiter()


@contextlib.asynccontextmanager
async def _servers(trouter, tts_router=None):
    """(JAX base URL, port base URL), both serving in this loop."""
    jserver = TestServer(JAPP.create_app(), host="127.0.0.1")
    await jserver.start_server()
    tapp = TAPP.create_app(stt_router=trouter, tts_router=tts_router or TTSRouter(device="cpu"))
    tserver = await serve_app(tapp, "127.0.0.1", 0)
    try:
        yield f"127.0.0.1:{jserver.port}", f"127.0.0.1:{tserver.port}"
    finally:
        await tserver.close()
        await tapp.cleanup()
        await jserver.close()


async def _request(session, base: str, method: str, path: str, make=None, **kw):
    if make is not None:
        kw["data"] = make()
    async with session.request(method, f"http://{base}{path}", **kw) as resp:
        return resp.status, dict(resp.headers), await resp.read()


def _ask_both(trouter, calls, tts_router=None):
    """Send each (method, path, make_data, kwargs) to both servers in turn."""
    async def main():
        out = []
        async with _servers(trouter, tts_router) as (jbase, tbase):
            async with aiohttp.ClientSession() as session:
                for method, path, make, kw in calls:
                    out.append((await _request(session, jbase, method, path, make, **kw),
                                await _request(session, tbase, method, path, make, **kw)))
        return out

    return asyncio.run(asyncio.wait_for(main(), 300))


def _normalise(value):
    if isinstance(value, dict):
        return {k: _normalise(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_normalise(v) for v in value]
    if isinstance(value, str):
        return value.replace("jax-whisper", "<backend>").replace("torch-whisper", "<backend>")
    return value


def _close(got, want, where="body"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for key in want:
            if key == "created":
                assert abs(got[key] - want[key]) <= 5, where
            else:
                _close(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, f"{where}: {got} vs {want}"
    else:
        assert got == want, f"{where}: {got!r} vs {want!r}"


def _pydantic_lines(message: str) -> str:
    """pydantic's message without its ``[type=...]`` tails and links."""
    return "\n".join(line.split(" [type=")[0] for line in message.splitlines()
                     if not line.startswith("    For further"))


def _same(jax, port) -> None:
    (js, jh, jb), (ts, th, tb) = jax, port
    assert ts == js, (tb[:300], jb[:300])
    assert th.get("Content-Type") == jh.get("Content-Type")
    for name in COMPARED_HEADERS:
        assert th.get(name) == jh.get(name), name
    if not jb:  # HEAD, a preflight
        assert tb == b""
    elif jh.get("Content-Type", "").startswith("application/json"):
        want, got = _normalise(json.loads(jb)), _normalise(json.loads(tb))
        if js == 422 and "validation error" in want["error"]["message"]:
            want["error"]["message"] = _pydantic_lines(want["error"]["message"])
        _close(got, want)
    else:
        assert tb == jb


# ── STT over HTTP ───────────────────────────────────────────────────────


def _wav(name: str) -> bytes:
    return codec.write_wav(_clips()[name], SR)


def _g711(name: str, tag: int) -> bytes:
    """The clip at 8 kHz as an A-law (6) or mu-law (7) WAV."""
    pcm = np.round(_clips()[name][::2] * 32767).astype(np.int16)
    codes = (JA.alaw_encode if tag == 6 else JA.ulaw_encode)(pcm).tobytes()
    fmt = (tag).to_bytes(2, "little") + (1).to_bytes(2, "little") + (8000).to_bytes(4, "little") * 2 \
        + (1).to_bytes(2, "little") + (8).to_bytes(2, "little")
    return (b"RIFF" + (4 + 8 + 16 + 8 + len(codes)).to_bytes(4, "little") + b"WAVE" + b"fmt "
            + (16).to_bytes(4, "little") + fmt + b"data" + len(codes).to_bytes(4, "little") + codes)


def _form(audio: bytes | None = b"", filename: str | None = "clip.wav", ctype: str | None = "audio/wav",
          **fields):
    def make():
        form = FormData()
        if audio is not None:
            if filename is None:
                form.add_field("file", audio.decode("latin-1"))
            else:
                form.add_field("file", audio, filename=filename, content_type=ctype)
        for key, value in fields.items():
            form.add_field(key, value)
        return form
    return make


T, TR = "/v1/audio/transcriptions", "/v1/audio/translations"

# (id, method, path, data maker, request kwargs, settings changed on both sides)
STT_CASES = [
    ("json", "POST", T, lambda: _form(_wav("beeps1"), model=MODEL), {}, {}),
    ("verbose-seek", "POST", T, lambda: _form(_wav("seek"), model=MODEL, response_format="verbose_json"), {}, {}),
    ("text", "POST", T, lambda: _form(_wav("beeps3"), model=MODEL, response_format="text"), {}, {}),
    ("srt", "POST", T, lambda: _form(_wav("seek"), model=MODEL, response_format="srt"), {}, {}),
    ("vtt", "POST", T, lambda: _form(_wav("beeps3"), model=MODEL, response_format="vtt"), {}, {}),
    ("language-prompt", "POST", T, lambda: _form(_wav("beeps1"), model=MODEL, language="en",
                                                 prompt="beep beep", response_format="verbose_json",
                                                 temperature="0"), {}, {}),
    ("no-content-type", "POST", T, lambda: _form(_wav("silence"), ctype=None, model=MODEL), {}, {}),
    ("alaw-wav", "POST", T, lambda: _form(_g711("beeps3", 6), model=MODEL, response_format="verbose_json"),
     {}, {}),
    ("mulaw-wav", "POST", T, lambda: _form(_g711("beeps1", 7), model=MODEL, response_format="verbose_json"),
     {}, {}),
    ("translate-json", "POST", TR, lambda: _form(_wav("beeps1"), model=MODEL), {}, {}),
    ("translate-srt", "POST", TR, lambda: _form(_wav("beeps3"), model=MODEL, response_format="srt"), {}, {}),
    # beeps only: translation samples its fallback on the seek clip's noise
    # windows (T=1.0), where torch.Generator and jax.random draw differently
    ("translate-verbose", "POST", TR, lambda: _form(_wav("beeps3"), model=MODEL,
                                                    response_format="verbose_json"), {}, {}),
    ("missing-file", "POST", T, lambda: _form(None, model=MODEL), {}, {}),
    ("file-as-text", "POST", T, lambda: _form(b"RIFF", filename=None, model=MODEL), {}, {}),
    ("text-body", "POST", T, None, {"data": b"abc", "headers": {"Content-Type": "text/plain"}}, {}),
    ("urlencoded", "POST", T, None, {"data": {"file": "x", "model": MODEL}}, {}),
    ("bad-temperature", "POST", T, lambda: _form(_wav("beeps1"), model=MODEL, temperature="hot"), {}, {}),
    ("empty", "POST", T, lambda: _form(b"", model=MODEL), {}, {}),
    ("upload-too-large", "POST", T, lambda: _form(b"\0" * (1024 * 1024 + 10), model=MODEL), {},
     {"os_max_upload_mb": 1}),
    ("body-too-large", "POST", T, lambda: _form(b"\0" * (2 * 1024 * 1024 + 10), model=MODEL), {},
     {"os_max_upload_mb": 1}),
    ("diarize-disabled", "POST", T + "?diarize=true", lambda: _form(_wav("beeps1"), model=MODEL), {}, {}),
    ("diarize-form-disabled", "POST", T, lambda: _form(_wav("beeps1"), model=MODEL, diarize="true"), {}, {}),
    ("unknown-model", "POST", T, lambda: _form(_wav("beeps1"), model="nope-model"), {}, {}),
    ("not-audio", "POST", T, lambda: _form(b"these bytes are no audio", filename="a.mp3",
                                           ctype="audio/mpeg", model=MODEL), {}, {}),
    ("noise-reduce", "POST", T, lambda: _form(_wav("beeps1"), model=MODEL), {}, {"stt_noise_reduce": True}),
    ("translate-missing-file", "POST", TR, lambda: _form(None), {}, {}),
    ("translate-unknown-model", "POST", TR, lambda: _form(_wav("beeps1"), model="nope-model"), {}, {}),
    ("translate-empty", "POST", TR, lambda: _form(b"", model=MODEL), {}, {}),
]


@pytest.mark.parametrize("name,method,path,make,kw,changed", STT_CASES, ids=[c[0] for c in STT_CASES])
def test_stt_routes_match_the_jax_app(both, backends, monkeypatch, name, method, path, make, kw, changed):
    for module in (JI, TI):  # neither machine has ffmpeg; hold that here too
        monkeypatch.setattr(module, "ffmpeg_available", lambda: False)
    both(**changed)
    [(jax, port)] = _ask_both(backends[1], [(method, path, make() if make else None, kw)])
    _same(jax, port)
    if name in ("json", "alaw-wav", "mulaw-wav", "translate-json"):
        assert jax[0] == 200 and json.loads(port[2])["text"].strip()


def test_backend_failure_is_a_500_on_both(both, backends, monkeypatch):
    jb, trouter = backends

    def boom(*args, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(jb, "transcribe", boom)
    monkeypatch.setattr(trouter.get_backend(MODEL), "transcribe", boom)
    [(jax, port)] = _ask_both(trouter, [("POST", T, _form(_wav("beeps1"), model=MODEL), {})])
    _same(jax, port)
    assert port[0] == 500 and json.loads(port[2]) == {"error": {"message": "device lost", "code": "http_error"}}


@pytest.fixture
def diarizers(both, monkeypatch, tmp_path):
    """``STT_DIARIZE_ENABLED`` on both packages, each package's shared
    diarizer on the conv embedder (no checkpoint is found): JAX's from
    ``PRNGKey(23)``, the port's on the CPU with those weights carried over.
    Returns the (JAX, port) diarizers."""
    import jax

    from open_speech_tpu import diarization as JDS
    from open_speech_tpu.models.diarize import JaxDiarizer
    from open_speech_tpu_torch import diarization as TDS
    from open_speech_tpu_torch.models.diarize import TorchDiarizer, diarizer_params_from_jax

    for var in ("OS_SEGMENTATION_CKPT_PATH", "OS_WESPEAKER_CKPT_PATH", "OS_DIARIZER_CKPT_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    both(stt_diarize_enabled=True)
    jd = JaxDiarizer()
    params = diarizer_params_from_jax(jax.tree_util.tree_map(np.asarray, jd.params), jd.cfg, device="cpu")
    td = TorchDiarizer(params=params, device="cpu")
    monkeypatch.setattr(JDS, "_shared", jd)
    monkeypatch.setattr(TDS, "_shared", td)
    return jd, td


def _two_speakers() -> bytes:
    from tests.test_diarize import _speaker_audio

    return codec.write_wav(np.concatenate([_speaker_audio(220, 4, 1), _speaker_audio(520, 4, 2)]), SR)


def test_diarize_enabled_names_its_later_item(both, backends, diarizers, monkeypatch):
    """Once a named 500 of the unported route: ``?diarize=true`` (and the
    form field) now answers the JAX app's ``{"text", "segments"}`` body
    whatever the ``response_format``, and with the setting off both
    answer 400."""
    wav = _two_speakers()
    calls = [("POST", T + "?diarize=true", _form(wav, model=MODEL), {}),
             ("POST", T, _form(wav, model=MODEL, diarize="true", response_format="text"), {}),
             ("POST", T + "?diarize=true", _form(wav, model=MODEL, response_format="verbose_json"), {})]
    answers = _ask_both(backends[1], calls)
    for jax, port in answers:
        _same(jax, port)
        body = json.loads(port[2])
        assert port[0] == 200 and set(body) == {"text", "segments"}, body
        assert len({s["speaker"] for s in body["segments"]}) == 2
        assert all(set(s) == {"speaker", "start", "end", "text"} for s in body["segments"])
    both(stt_diarize_enabled=False)
    [(jax, port)] = _ask_both(backends[1], calls[:1])
    _same(jax, port)
    assert port[0] == 400 and "STT_DIARIZE_ENABLED" in json.loads(port[2])["error"]["message"]


def test_a_failed_diarization_is_a_500_on_both(both, backends, diarizers, monkeypatch):
    def boom(audio):
        raise ValueError("no speakers here")

    for d in diarizers:
        monkeypatch.setattr(d, "diarize_audio", boom)
    [(jax, port)] = _ask_both(backends[1], [("POST", T + "?diarize=true", _form(_two_speakers(), model=MODEL), {})])
    _same(jax, port)
    assert port[0] == 500
    assert json.loads(port[2])["error"]["message"] == "Diarization failed: no speakers here"


# ── models, health, auth, CORS, rate limits, routing ────────────────────

KEY = "sk-test"
MISC_CASES = [
    ("health", [("GET", "/health", None, {})], {}),
    ("head-health", [("HEAD", "/health", None, {})], {}),
    ("models", [("GET", "/v1/models", None, {})], {}),
    ("head-models", [("HEAD", "/v1/models", None, {})], {}),
    ("model", [("GET", "/v1/models/whisper-1", None, {}), ("GET", "/v1/models/org/name.v2", None, {})], {}),
    ("models-tts-off", [("GET", "/v1/models", None, {})], {"tts_enabled": False}),
    ("not-found", [("GET", "/nope", None, {}), ("POST", "/v1/audio", None, {})], {}),
    ("method", [("POST", "/health", None, {}), ("GET", T, None, {}), ("PUT", "/v1/models", None, {}),
                ("GET", "/v1/audio/speech", None, {})], {}),
    ("preflight", [("OPTIONS", T, None, {}), ("OPTIONS", "/nope", None, {})], {}),
    ("auth", [("GET", "/v1/models", None, {}),
              ("GET", "/v1/models", None, {"headers": {"Authorization": f"Bearer {KEY}"}}),
              ("GET", "/v1/models", None, {"headers": {"Authorization": "Bearer wrong"}}),
              ("GET", f"/v1/models?api_key={KEY}", None, {}),
              ("GET", "/health", None, {}),
              ("OPTIONS", "/v1/models", None, {}),
              ("GET", "/nope", None, {}),
              ("POST", T, _form(_wav("beeps1"), model=MODEL), {})], {"os_api_key": KEY}),
    ("cors-origin", [("GET", "/health", None, {}), ("GET", "/nope", None, {}),
                     ("POST", T, _form(None), {})], {"os_cors_origins": "https://app.example"}),
    ("rate-limit", [("GET", "/v1/models", None, {}), ("GET", "/v1/models", None, {}),
                    ("GET", "/v1/models", None, {}), ("GET", "/health", None, {})],
     {"os_rate_limit": 2, "os_rate_limit_burst": 0}),
    ("ws-without-upgrade", [("GET", "/v1/audio/stream", None, {})], {}),
    ("ws-bad-handshake", [("GET", "/v1/audio/stream", None, {"headers": {"Upgrade": "websocket"}})], {}),
]


# the statuses both servers answer each case's calls with
MISC_STATUS = {
    "health": [200], "head-health": [200], "models": [200], "head-models": [200], "model": [200, 200],
    "models-tts-off": [200], "not-found": [404, 404], "method": [405] * 4, "preflight": [204, 204],
    "auth": [401, 200, 401, 200, 200, 204, 401, 401], "cors-origin": [200, 404, 422],
    "rate-limit": [200, 200, 429, 200], "ws-without-upgrade": [426], "ws-bad-handshake": [400],
}


@pytest.mark.parametrize("name,calls,changed", MISC_CASES, ids=[c[0] for c in MISC_CASES])
def test_other_routes_match_the_jax_app(both, backends, name, calls, changed):
    both(**changed)
    answers = _ask_both(backends[1], calls)
    for jax, port in answers:
        _same(jax, port)
    assert [port[0] for _, port in answers] == MISC_STATUS[name]


# ── speech ──────────────────────────────────────────────────────────────

TEXT = "The quick brown fox jumps over the lazy dog. It was 42 degrees outside!"


class _Unused:
    """Stands in for loaded weights: these requests fail before synthesis."""


SPEECH_REJECTED = [
    ("disabled", b'{"input": "hi"}', "", {"tts_enabled": False}),
    ("invalid-json", b"{bad", "", {}),
    ("not-an-object", b"[1, 2]", "", {}),
    ("missing-input", b'{"model": "kokoro"}', "", {}),
    ("speed", b'{"input": "hi", "speed": 9}', "?stream=true", {}),
    ("too-long", b'{"input": "xxxxxxxxxxxx", "response_format": "wav"}', "", {"tts_max_input_length": 10}),
    ("empty", b'{"input": "  "}', "", {}),
    ("format", b'{"input": "hi", "response_format": "xyz"}', "?stream=1", {}),
    ("voice-design", b'{"input": "hi", "voice_design": "deep", "response_format": "wav"}', "", {}),
    ("vocab-mismatch-stream", '{"input": "魑魅魍魎", "voice": "jf_alpha", "response_format": "pcm"}'.encode(),
     "?stream=true", {}),
]


@pytest.mark.parametrize("name,body,query,changed", SPEECH_REJECTED, ids=[c[0] for c in SPEECH_REJECTED])
def test_rejected_speech_requests_match_the_jax_app(both, backends, monkeypatch, name, body, query, changed):
    both(**changed)
    monkeypatch.setattr(JAPP.tts_router.get_backend("kokoro"), "_params", _Unused())
    tts = TTSRouter(device="cpu")
    tts.get_backend("kokoro")._model = _Unused()
    [(jax, port)] = _ask_both(backends[1], [("POST", "/v1/audio/speech" + query, None,
                                             {"data": body, "headers": {"Content-Type": "application/json"}})],
                              tts_router=tts)
    _same(jax, port)


@pytest.fixture(scope="module")
def kokoro():
    """The Kokoro test tree: the JAX tree, the port's model on it, and the
    harmonic features injected into both packages for the module."""
    import jax.numpy as jnp
    from jax import tree_util

    tree = jax_tree(CFG)
    jtree = tree_util.tree_map(jnp.asarray, tree)
    with pytest.MonkeyPatch.context() as mp:
        inject_har(mp, injected_har(jtree))
        yield jtree, kokoro_from_jax_tree(tree, device="cpu")


def test_served_speech_matches_the_jax_app(both, backends, monkeypatch, kokoro):
    """One-shot WAV and streamed PCM (chunked): status, content type, the
    sample count, the samples within TOL_AUDIO plus one PCM step."""
    jtree, model = kokoro
    backend = JAPP.tts_router.get_backend("kokoro")
    monkeypatch.setattr(backend, "_params", jtree)
    monkeypatch.setattr(backend, "_cfg", CFG)
    tts = TTSRouter(device="cpu")
    tts.get_backend("kokoro")._model, tts.get_backend("kokoro")._cfg = model, TCFG
    body = {"input": TEXT, "voice": "af_bella"}
    calls = [("POST", "/v1/audio/speech", None, {"json": {**body, "response_format": "wav"}}),
             ("POST", "/v1/audio/speech?stream=true", None, {"json": {**body, "response_format": "pcm"}})]
    (jwav, twav), (jpcm, tpcm) = _ask_both(backends[1], calls, tts_router=tts)
    for (js, jh, _), (ts, th, _) in ((jwav, twav), (jpcm, tpcm)):
        assert ts == js == 200 and th["Content-Type"] == jh["Content-Type"]
    assert tpcm[1].get("Transfer-Encoding") == jpcm[1].get("Transfer-Encoding") == "chunked"
    got, rate = codec.read_wav(twav[2])
    want, _ = codec.read_wav(jwav[2])
    assert rate == 24000 and got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO + 2 / 32768)
    got, want = codec.pcm16_to_float(tpcm[2]), codec.pcm16_to_float(jpcm[2])
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO + 2 / 32768)


# ── the streaming WebSocket ─────────────────────────────────────────────


async def _refusal(url: str, **kw) -> tuple[int, str]:
    async with websockets.connect(url, **kw) as ws:
        with pytest.raises(websockets.ConnectionClosed) as e:
            await ws.recv()
    return e.value.rcvd.code, e.value.rcvd.reason


WS_REFUSALS = [
    ("origin", "", {"origin": "https://bad.example"}, {"os_ws_allowed_origins": "https://ok.example"}),
    ("api-key", "", {}, {"os_api_key": KEY}),
    ("api-key-wrong", f"?api_key=wrong", {}, {"os_api_key": KEY}),
    ("too-many", "", {}, {"os_stream_max_connections": 0}),
    ("sample-rate", "?sample_rate=4000", {}, {}),
    ("encoding", "?encoding=opus", {}, {}),
]


@pytest.mark.parametrize("name,query,kw,changed", WS_REFUSALS, ids=[c[0] for c in WS_REFUSALS])
def test_websocket_refusals_match_the_jax_app(both, backends, name, query, kw, changed):
    both(**changed)

    async def main():
        async with _servers(backends[1]) as (jbase, tbase):
            return [await _refusal(f"ws://{base}/v1/audio/stream{query}", **kw) for base in (jbase, tbase)]

    jax, port = asyncio.run(asyncio.wait_for(main(), 60))
    assert port == jax and port[0] in (1008, 4001, 1013)


def _beeps(seconds: float, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    clip = rng.normal(0, 0.003, n)
    for i in range(k):
        dur = int(0.15 * SR)
        t = np.arange(dur) / SR
        clip[i * (n // k) : i * (n // k) + dur] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
    return np.clip(clip, -1, 1).astype(np.float32)


async def _session_events(base: str, sessions: dict, frames: list[bytes], query: str) -> list[dict]:
    """A session over the socket; each frame is sent once the server has
    taken the one before and its interim in flight has finished."""
    async with websockets.connect(f"ws://{base}/v1/audio/stream{query}") as ws:
        events = [json.loads(await ws.recv())]
        session = next(iter(sessions.values()))
        sent = 0
        for frame in frames:
            await ws.send(frame)
            sent += len(frame) // 2
            while session.total_samples < sent or (
                    session._interim_task is not None and not session._interim_task.done()):
                await asyncio.sleep(0.002)
        await ws.send(json.dumps({"type": "stop"}))
        async for message in ws:
            events.append(json.loads(message))
        assert ws.close_code == 1000
    return [{k: v for k, v in e.items() if k != "session_id"} for e in events]


@pytest.mark.parametrize("seconds", [1.0, 2.0])
def test_streaming_session_events_match_the_jax_app(both, backends, seconds):
    """1.0 s: the final decodes over the incremental states; 2.0 s overflows
    the 1.2 s test-tiny window, so the final takes the executor path."""
    audio = np.concatenate([_beeps(seconds / 2, 3, 1), _beeps(seconds / 2, 2, 2)])
    pcm = (audio * 32767).astype("<i2").tobytes()
    frames = [pcm[i : i + 3200] for i in range(0, len(pcm), 3200)]
    query = f"?model={MODEL}&language=en&vad=false"

    async def main():
        async with _servers(backends[1]) as (jbase, tbase):
            jev = await _session_events(jbase, JSS._active_sessions, frames, query)
            tev = await _session_events(tbase, TSS._active_sessions, frames, query)
        return jev, tev

    jev, tev = asyncio.run(asyncio.wait_for(main(), 120))
    assert tev == jev
    kinds = [(e["type"], e.get("is_final"), e.get("speech_final")) for e in tev]
    assert kinds[0][0] == "session.begin" and kinds[-1][0] == "session.end"
    assert ("transcript", False, False) in kinds and kinds.count(("transcript", True, True)) == 1


# ── the shell's own behaviour (no JAX) ──────────────────────────────────


class _SlowSTT:
    """An STT router whose transcription waits for ``release``."""

    def __init__(self) -> None:
        self.started, self.release = threading.Event(), threading.Event()

    def get_backend(self, _model):
        return self

    device = "cpu"

    def loaded_models(self):
        return []

    def transcribe(self, **kw):
        self.started.set()
        assert self.release.wait(30)
        return {"text": "done", "segments": [], "language": "en", "duration": 1.0}


def test_health_answers_while_a_transcription_runs():
    stt = _SlowSTT()

    async def main():
        app = TAPP.create_app(stt_router=stt, tts_router=TTSRouter(device="cpu"))
        server = await serve_app(app, "127.0.0.1", 0)
        base = f"127.0.0.1:{server.port}"
        try:
            async with aiohttp.ClientSession() as session:
                upload = asyncio.ensure_future(_request(session, base, "POST", T, _form(_wav("beeps1"))))
                while not stt.started.is_set():
                    await asyncio.sleep(0.01)
                t0 = time.perf_counter()
                health = await _request(session, base, "GET", "/health")
                health_s = time.perf_counter() - t0
                in_flight = not upload.done()
                stt.release.set()
                return health, health_s, in_flight, await upload
        finally:
            stt.release.set()
            await server.close()

    health, health_s, in_flight, upload = asyncio.run(asyncio.wait_for(main(), 60))
    assert health[0] == 200 and in_flight and health_s < 5
    assert upload[0] == 200 and json.loads(upload[2]) == {"text": "done"}


class _SlowTTS:
    """A TTS router whose synthesis yields one chunk per 20 ms and records
    how many it produced and whether it was closed."""

    name, capabilities, sample_rate = "kokoro", {}, 24000

    def __init__(self) -> None:
        self.produced, self.closed = 0, threading.Event()

    def get_backend(self, _model):
        return self

    def loaded_models(self):
        return []

    def synthesize(self, **kw):
        try:
            for _ in range(500):
                time.sleep(0.02)
                self.produced += 1
                yield np.full(2400, 0.1, np.float32)
        finally:
            self.closed.set()


def test_streamed_speech_stops_when_the_client_leaves(monkeypatch):
    monkeypatch.setattr(torch_settings, "tts_trim_silence", False)
    monkeypatch.setattr(torch_settings, "tts_normalize_output", False)
    tts = _SlowTTS()

    async def main():
        app = TAPP.create_app(stt_router=_SlowSTT(), tts_router=tts)
        server = await serve_app(app, "127.0.0.1", 0)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            body = json.dumps({"input": "hello there", "response_format": "pcm"}).encode()
            writer.write(b"POST /v1/audio/speech?stream=true HTTP/1.1\r\nContent-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            head = await reader.readuntil(b"\r\n\r\n")
            await reader.readuntil(b"\r\n")  # the first chunk's size line
            writer.close()
            for _ in range(500):
                if tts.closed.is_set():
                    break
                await asyncio.sleep(0.01)
            return head
        finally:
            await server.close()

    head = asyncio.run(asyncio.wait_for(main(), 60))
    assert head.startswith(b"HTTP/1.1 200 OK\r\n") and b"Transfer-Encoding: chunked" in head
    assert b"Content-Type: audio/pcm" in head
    assert tts.closed.is_set() and tts.produced < 100  # of 500: synthesis stopped


def test_startup_refuses_required_auth_without_a_key(monkeypatch):
    monkeypatch.setattr(torch_settings, "os_auth_required", True)
    monkeypatch.setattr(torch_settings, "os_api_key", "")
    app = TAPP.create_app(stt_router=_SlowSTT(), tts_router=TTSRouter(device="cpu"))
    with pytest.raises(RuntimeError, match="OS_AUTH_REQUIRED=true but OS_API_KEY is not set"):
        asyncio.run(app.startup())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_server_serves_tls_by_default_and_stops_on_sigterm(tmp_path, backends):
    """``python -m open_speech_tpu_torch.server`` with the settings' TLS
    default (a certificate made on first start), the fixture preloaded on
    the CPU: /health reports it, a clip transcribes to the in-process
    CPU text over https, and SIGTERM ends the process cleanly."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "OS_SSL_ENABLED"}
    env.update(OS_PORT=str(port), OS_HOST="127.0.0.1", STT_DEVICE="cpu", STT_MODEL_DIR=str(FIXTURES),
               STT_PRELOAD_MODELS=MODEL, STT_COMPUTE_TYPE="float32", OS_PRECOMPILE_ON_LOAD="false",
               OS_SSL_CERTFILE=str(tmp_path / "cert.pem"), OS_SSL_KEYFILE=str(tmp_path / "key.pem"),
               TTS_ENABLED="false", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-m", "open_speech_tpu_torch.server"], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ctx = ssl.create_default_context()
    ctx.check_hostname, ctx.verify_mode = False, ssl.CERT_NONE
    wav = _wav("beeps3")
    want = transcription_response(backends[1], wav, model=MODEL)

    async def main():
        async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(ssl=ctx)) as session:
            deadline = time.monotonic() + 90
            while True:
                try:
                    async with session.get(f"https://127.0.0.1:{port}/health") as r:
                        health = await r.json()
                        if health["models_loaded"] == 1:
                            break
                except aiohttp.ClientError:
                    pass
                assert time.monotonic() < deadline and proc.poll() is None, "the server did not come up"
                await asyncio.sleep(0.2)
            form = _form(wav, model=MODEL)()
            async with session.post(f"https://127.0.0.1:{port}{T}", data=form) as r:
                return health, r.status, await r.json()

    try:
        health, status, body = asyncio.run(asyncio.wait_for(main(), 120))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert health == {"status": "ok", "version": "0.1.0", "models_loaded": 1}
    assert status == 200 and body == want
    assert proc.returncode == 0, out.decode(errors="replace")[-2000:]
    assert (tmp_path / "cert.pem").exists() and b"Running on https://" in out
