"""The Studio's routes and the routes it changed, the port's app against the
JAX aiohttp app on the CPU.

Both apps run side by side in one loop (``tests/test_torch_server.py``'s
way: the JAX app on ``aiohttp.test_utils.TestServer``, the port's on its own
shell), each on directories of its own under ``tmp_path``: the JAX package
through its settings, a closed ``_store`` and fresh module managers (voice
library, TTS cache, composer), the port through the settings
``create_app`` reads. A script of requests runs against each app in turn,
each request built from that app's earlier answers (the ids differ).

Equal means: the status, the ``Content-Type``, the CORS headers and
``X-Cache``; JSON bodies with ids (``uuid4``) and timestamps masked, and
each app's directory read as ``<root>``, compared in full otherwise (names,
durations, ``turn_count``); audio byte for byte unless an effect ran.

- the (method, path) route sets of the two apps are equal, 58 each;
- the voice library, voice presets (``voice-presets.example.yml``, a list
  file, a malformed file, an absent one), profiles, history,
  conversations (rendered with one injected numpy synthesis on both apps)
  and composer routes, every error path included;
- history rows after a transcription, a translation (none), a whole and a
  streamed speech request; the cache's MISS then HIT and its bypasses
  (``?cache=false``, effects, a voice design, reference audio, streaming),
  with the backend's calls counted; a TTS and STT route with history off;
- ``/web`` and ``/static`` bytes and types, traversal attempts (raw request
  lines, ``..``, encoded ``..``, absolute names, NUL) answered as the JAX
  app answers them, and symlinks leaving a directory refused as aiohttp's
  ``add_static`` refuses them;
- two ``python -m open_speech_tpu_torch.server`` processes, each with its
  own studio database: a profile created on one never appears on the
  other (``tests/test_replica_serving.py``'s check, on the port).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import aiohttp
import numpy as np
import pytest
from aiohttp import FormData, web
from aiohttp.test_utils import TestServer

import open_speech_tpu.server.middleware as JMW
import open_speech_tpu.studio.storage as JS
from open_speech_tpu.cache.tts_cache import TTSCache as JCache
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.ops import audio as JA
from open_speech_tpu.runtime.router import router as jax_router
from open_speech_tpu.server import app as JAPP
from open_speech_tpu.studio.composer import MultiTrackComposer as JComposer
from open_speech_tpu.studio.voice_library import VoiceLibraryManager as JLibrary
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.runtime.router import BackendRouter
from open_speech_tpu_torch.server import app as TAPP
from open_speech_tpu_torch.server.http import Application, serve_app
from open_speech_tpu_torch.tts.router import TTSRouter

ROOT = Path(__file__).resolve().parent.parent
COMPARED = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods", "Access-Control-Allow-Headers",
            "X-Cache", "Allow")
MASKED = ("id", "created_at", "updated_at", "conversation_id", "composition_id")
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
TOL_FX = 1e-6  # tests/test_torch_effects.py's normalize bound


# ── a deterministic TTS backend and STT answer, the same in both apps ───


class ToneBackend:
    """A TTS backend of numpy tones: the same samples in both packages, so
    the routes' bytes compare exactly. Counts its syntheses."""

    name = "kokoro"
    sample_rate = 24000
    device = "cpu"  # where the port runs a request's effects
    capabilities = {"voice_design": True, "voice_clone": True}

    def __init__(self) -> None:
        self.calls = 0

    def synthesize(self, text, voice, speed=1.0, lang_code=None, voice_design=None, reference_audio=None,
                   clone_transcript=None):
        self.calls += 1
        seed = sum(map(ord, f"{text}|{voice}|{voice_design}|{len(reference_audio or b'')}"))
        for i in range(2):
            n = int(2400 * (1 + i) / speed)
            t = np.arange(n) / self.sample_rate
            yield (0.3 * np.sin(2 * np.pi * (200 + seed % 200 + 50 * i) * t)).astype(np.float32)

    def is_model_loaded(self, model_id):
        return True

    def loaded_models(self):
        return []

    def list_voices(self):
        return []


def _transcribe(**kw):
    return {"text": " heard the tone", "language": "en", "duration": 1.0,
            "segments": [{"id": 0, "start": 0.0, "end": 1.0, "text": " heard the tone"}]}


# ── both apps on their own directories ──────────────────────────────────


class Studio:
    """Both apps' settings, directories and fakes; ``run(script)`` serves
    both in one loop and runs ``script`` against each."""

    def __init__(self, tmp_path: Path, monkeypatch) -> None:
        self.mp = monkeypatch
        self.roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
        for side, s in (("jax", jax_settings), ("port", torch_settings)):
            root = self.roots[side]
            for name, value in (("os_studio_db_path", root / "studio.db"),
                                ("os_voice_library_path", root / "voices"),
                                ("os_conversations_dir", root / "conversations"),
                                ("os_composer_dir", root / "composer"), ("tts_cache_dir", root / "cache")):
                monkeypatch.setattr(s, name, str(value))
            for name, value in (("os_history_enabled", True), ("tts_cache_enabled", False),
                                ("os_tts_batcher_enabled", False), ("tts_enabled", True),
                                ("os_max_upload_mb", 100), ("os_api_key", ""), ("os_rate_limit", 0),
                                ("os_cors_origins", "*"), ("os_history_max_entries", 1000),
                                ("os_history_max_mb", 2000), ("os_voice_library_max_count", 100)):
                monkeypatch.setattr(s, name, value)
        monkeypatch.delenv("TTS_VOICES_CONFIG", raising=False)
        self.tones = {"jax": ToneBackend(), "port": ToneBackend()}
        monkeypatch.setitem(JAPP.tts_router._backends, "kokoro", self.tones["jax"])
        monkeypatch.setattr(jax_router, "transcribe", _transcribe)
        monkeypatch.setattr(jax_router, "translate", _transcribe)
        self.stt = BackendRouter(device="cpu")
        monkeypatch.setattr(self.stt, "transcribe", _transcribe)
        monkeypatch.setattr(self.stt, "translate", _transcribe)
        self.tts = TTSRouter(device="cpu")
        self.tts.register_backend("kokoro", self.tones["port"])
        self.synth = None  # the conversations' synthesis, when a script renders
        JMW.reset_rate_limiter()

    def set(self, **values) -> None:
        for s in (jax_settings, torch_settings):
            for key, value in values.items():
                self.mp.setattr(s, key, value)

    def _jax_app(self):
        """The JAX app on its directories: its store reopened, its module
        managers made anew from the settings of now."""
        JS.reset_db()
        s = jax_settings
        self.mp.setattr(JAPP, "voice_library", JLibrary(s.voice_library_path, max_count=s.voice_library_max_count))
        self.mp.setattr(JAPP, "tts_cache", JCache(s.tts_cache_dir, s.tts_cache_max_mb, s.tts_cache_enabled))
        self.mp.setattr(JAPP, "composer_manager", JComposer())
        if self.synth is not None:
            self.mp.setattr(JAPP.conversation_manager, "synthesize_fn", self.synth)
        return JAPP.create_app()

    def run(self, script) -> list[tuple[tuple, tuple]]:
        """``script(call, side)`` against the JAX app, then the port's:
        the pairs of (status, headers, body) in order."""
        async def main():
            out = {}
            jserver = TestServer(self._jax_app(), host="127.0.0.1")
            await jserver.start_server()
            tapp = TAPP.create_app(stt_router=self.stt, tts_router=self.tts)
            if self.synth is not None:
                tapp["conversations"].synthesize_fn = self.synth
            tserver = await serve_app(tapp, "127.0.0.1", 0)
            try:
                async with aiohttp.ClientSession() as session:
                    for side, port in (("jax", jserver.port), ("port", tserver.port)):
                        answers = []

                        async def call(method, path, **kw):
                            async with session.request(method, f"http://127.0.0.1:{port}{path}", **kw) as r:
                                answers.append((r.status, dict(r.headers), await r.read()))
                                return answers[-1]

                        await script(call, side)
                        out[side] = answers
            finally:
                await tserver.close()
                await tapp.cleanup()
                await jserver.close()
                JS.reset_db()
            return out

        out = asyncio.run(asyncio.wait_for(main(), 300))
        assert len(out["jax"]) == len(out["port"])
        return list(zip(out["jax"], out["port"]))

    def mask(self, value, side: str):
        root = str(self.roots[side])
        if isinstance(value, dict):
            return {k: (k if k in MASKED and value[k] is not None else self.mask(v, side)) for k, v in value.items()}
        if isinstance(value, list):
            return [self.mask(v, side) for v in value]
        if isinstance(value, str):
            return _UUID.sub("<id>", value.replace(root, "<root>"))
        return value

    def same(self, jax, port, audio_tol: float = 0.0) -> None:
        (js, jh, jb), (ts, th, tb) = jax, port
        assert ts == js, (tb[:300], jb[:300])
        assert th.get("Content-Type") == jh.get("Content-Type")
        for name in COMPARED:
            assert th.get(name) == jh.get(name), name
        if jh.get("Content-Type", "").startswith("application/json"):
            assert self.mask(json.loads(tb), "port") == self.mask(json.loads(jb), "jax")
        elif audio_tol and jh.get("Content-Type") == "audio/wav":
            want, got = JA.read_wav(jb)[0], JA.read_wav(tb)[0]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=audio_tol + 2 / 32768, rtol=0)
        else:
            assert tb == jb

    def check(self, answers, statuses: list[int], audio_tol: float = 0.0) -> None:
        for i, (jax, port) in enumerate(answers):
            try:
                self.same(jax, port, audio_tol)
            except AssertionError as e:
                raise AssertionError(f"request {i}: {e}") from e
        assert [port[0] for _, port in answers] == statuses


@pytest.fixture
def studio(tmp_path, monkeypatch):
    yield Studio(tmp_path, monkeypatch)
    JS.reset_db()
    JMW.reset_rate_limiter()


def _wav(seconds: float = 0.25, rate: int = 16000, freq: float = 330.0) -> bytes:
    t = np.arange(int(seconds * rate)) / rate
    return JA.write_wav((0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32), rate)


def _form(**fields):
    form = FormData()
    for key, value in fields.items():
        if isinstance(value, tuple):
            form.add_field(key, value[0], filename=value[1], content_type=value[2])
        else:
            form.add_field(key, value)
    return form


def _json(answer):
    return json.loads(answer[2])


# ── the route table ─────────────────────────────────────────────────────


def _pattern(path: str) -> str:
    return re.sub(r"\{(\w+)(:[^}]*)?\}", r"{\1}", path)


def test_route_sets_are_equal(studio):
    """The (method, path) pairs, HEAD aside, of both apps: 58 each."""
    jax = {(r.method, _pattern(r.resource.canonical)) for r in studio._jax_app().router.routes()
           if r.method != "HEAD"}
    app = TAPP.create_app(stt_router=studio.stt, tts_router=studio.tts)
    port = [(m, _pattern(p)) for m, p in app.router.routes() if m != "HEAD"]
    assert len(port) == len(set(port)) == len(jax) == 58
    assert set(port) == jax


# ── voice library and presets ───────────────────────────────────────────


def test_voice_library_routes_match_jax(studio):
    studio.set(os_voice_library_max_count=2)

    async def script(call, side):
        lib = "/api/voices/library"
        await call("POST", lib, data=_form(name="Narrator One", audio=(_wav(), "n.wav", "audio/mpeg")))
        await call("POST", lib, data=_form(name="bad", audio=(b"not a wav at all", "b.wav", "audio/wav")))
        await call("POST", lib, data=_form(name="!!!", audio=(_wav(), "x.wav", "audio/wav")))
        await call("POST", lib, data=_form(name="no audio"))
        await call("POST", lib, data=_form(name="text audio", audio="RIFF"))
        await call("POST", lib, data=_form(name="empty", audio=(b"", "e.wav", "audio/wav")))
        await call("POST", lib, data=_form(name="second", audio=(_wav(freq=440), "s.wav", "audio/wav")))
        await call("POST", lib, data=_form(name="third", audio=(_wav(), "t.wav", "audio/wav")))  # full
        await call("POST", lib, data=_form(name="second", audio=(_wav(freq=500), "s.wav", "audio/wav")))
        await call("GET", lib)
        await call("GET", f"{lib}/narrator_one")
        await call("GET", f"{lib}/Narrator One")
        await call("GET", f"{lib}/nobody")
        await call("GET", f"{lib}/...")
        await call("DELETE", f"{lib}/narrator_one")
        await call("DELETE", f"{lib}/narrator_one")
        await call("GET", lib)
        await call("PUT", lib)

    answers = studio.run(script)
    # a name with no letter in it fails the slug on both: a 500 (JAX's answer)
    studio.check(answers, [201, 422, 422, 422, 422, 422, 201, 422, 201, 200, 200, 200, 404, 500, 204, 404, 200,
                           405])
    assert [v["name"] for v in _json(answers[9][1])] == ["narrator_one", "second"]


def test_voice_upload_too_large_matches_jax(studio):
    async def script(call, side):
        await call("POST", "/api/voices/library", data=_form(name="big", audio=(_wav(2.0), "b.wav", "audio/wav")))

    studio.set(os_max_upload_mb=0)
    answers = studio.run(script)
    studio.check(answers, [answers[0][0][0]])
    assert answers[0][1][0] == 413


PRESET_FILES = {
    "example": (ROOT / "voice-presets.example.yml").read_text(),
    "list": "- name: Solo\n  voice: am_puck\n  speed: 1\n",
    "mapping-without-presets": "voices:\n  - name: X\n",
    "malformed": ":: not yaml [",
    "empty": "",
}


@pytest.mark.parametrize("name", [*PRESET_FILES, "absent", "unset"])
def test_voice_presets_match_jax(studio, tmp_path, monkeypatch, name):
    if name in PRESET_FILES:
        path = tmp_path / "voices.yml"
        path.write_text(PRESET_FILES[name])
        monkeypatch.setenv("TTS_VOICES_CONFIG", str(path))
    elif name == "absent":
        monkeypatch.setenv("TTS_VOICES_CONFIG", str(tmp_path / "absent.yml"))

    async def script(call, side):
        await call("GET", "/api/voice-presets")

    answers = studio.run(script)
    studio.check(answers, [200])
    presets = _json(answers[0][1])["presets"]
    if name == "example":
        assert [p["name"] for p in presets] == ["Will", "Female", "British Butler", "Narrator"]
    elif name == "list":
        assert presets == [{"name": "Solo", "voice": "am_puck", "speed": 1}]
    else:
        assert presets == TAPP.DEFAULT_VOICE_PRESETS


# ── profiles ────────────────────────────────────────────────────────────


def test_profile_routes_match_jax(studio):
    async def script(call, side):
        p = "/api/profiles"
        body = {"name": "Host", "backend": "kokoro", "voice": "af_sky", "speed": 1.3,
                "effects": [{"type": "reverb"}]}
        host = _json(await call("POST", p, json=body))
        await call("POST", p, json=body)  # 409
        await call("POST", p, json={"name": "x"})  # 422
        await call("POST", p, data=b"{not json", headers={"Content-Type": "application/json"})
        await call("POST", p, json=["a", "list"])
        guest = _json(await call("POST", p, json={"name": "Guest", "backend": "piper", "voice": "v",
                                                  "model": "piper/en_US-lessac-medium", "format": "wav",
                                                  "blend": "a(1)", "reference_audio_id": "r"}))
        await call("GET", p)
        await call("GET", f"{p}/{host['id']}")
        await call("GET", f"{p}/missing")
        await call("PUT", f"{p}/{host['id']}", json={"name": "Host", "backend": "kokoro", "voice": "af_heart",
                                                    "speed": 0.9})
        await call("PUT", f"{p}/{host['id']}", json={"name": "Guest", "backend": "kokoro", "voice": "x"})
        await call("PUT", f"{p}/missing", json={"name": "Z", "backend": "kokoro", "voice": "x"})
        await call("PUT", f"{p}/{host['id']}", json={"name": "Host"})
        await call("POST", f"{p}/{guest['id']}/default")
        await call("POST", f"{p}/missing/default")
        await call("GET", p)
        await call("DELETE", f"{p}/{guest['id']}")
        await call("DELETE", f"{p}/{guest['id']}")
        await call("GET", p)

    answers = studio.run(script)
    studio.check(answers, [201, 409, 422, 422, 422, 201, 200, 200, 404, 200, 409, 404, 422, 200, 404, 200, 204, 404,
                           200])
    assert _json(answers[15][1])["default_profile_id"] == _json(answers[5][1])["id"]


# ── history, the TTS cache ──────────────────────────────────────────────


def _speech(call, fmt="wav", query="", **fields):
    body = {"model": "kokoro", "input": "Hello studio.", "voice": "af_heart", "response_format": fmt, **fields}
    return call("POST", "/v1/audio/speech" + query, json=body)


def test_history_rows_after_transcription_and_speech_match_jax(studio):
    async def script(call, side):
        await call("POST", "/v1/audio/transcriptions", data=_form(file=(_wav(), "clip.wav", "audio/wav"),
                                                                  model="whisper-1"))
        await call("POST", "/v1/audio/translations", data=_form(file=(_wav(), "clip.wav", "audio/wav")))
        await _speech(call)
        await _speech(call, "pcm", "?stream=true", speed=1.25)
        await _speech(call, input="")  # rejected: no row
        await _speech(call, "pcm", "?stream=true", input="")
        rows = _json(await call("GET", "/api/history?limit=10"))["items"]
        await call("GET", "/api/history?type=tts&limit=1&offset=1")
        await call("GET", "/api/history?type=stt")
        await call("GET", "/api/history?limit=abc")
        stt = next(r for r in rows if r["type"] == "stt")
        await call("DELETE", f"/api/history/{stt['id']}")
        await call("DELETE", f"/api/history/{stt['id']}")
        await call("DELETE", "/api/history")
        await call("GET", "/api/history")

    answers = studio.run(script)
    studio.check(answers, [200, 200, 200, 200, 400, 400, 200, 200, 200, 422, 204, 404, 200, 200])
    rows = _json(answers[6][1])["items"]
    assert sorted((r["type"], r["streamed"], r["output_bytes"]) for r in rows) == sorted(
        [("stt", False, None), ("tts", False, len(answers[2][1][2])), ("tts", True, None)])
    assert _json(answers[12][1]) == {"deleted": 2}


def test_history_off_logs_nothing(studio):
    studio.set(os_history_enabled=False)

    async def script(call, side):
        await call("POST", "/v1/audio/transcriptions", data=_form(file=(_wav(), "clip.wav", "audio/wav")))
        await _speech(call)
        await _speech(call, "pcm", "?stream=true")
        await call("GET", "/api/history")

    answers = studio.run(script)
    studio.check(answers, [200] * 4)
    assert _json(answers[3][1])["total"] == 0


def test_tts_cache_hit_and_bypasses_match_jax(studio):
    studio.set(tts_cache_enabled=True)
    ref = __import__("base64").b64encode(_wav()).decode()

    async def script(call, side):
        miss = await _speech(call)
        hit = await _speech(call)
        assert hit[2] == miss[2] and hit[1].get("X-Cache") == "HIT"
        await _speech(call, query="?cache=false")
        await _speech(call, query="?cache=0")
        await _speech(call, effects=[{"type": "normalize"}])
        await _speech(call, effects=[{"type": "normalize"}])
        await _speech(call, voice_design="a calm voice")
        await _speech(call, voice_design="a calm voice")
        await _speech(call, reference_audio=ref)
        await _speech(call, reference_audio=ref)
        await _speech(call, "pcm", "?stream=true")
        await _speech(call, "pcm")  # another key: a miss, then stored
        await _speech(call, "pcm")
        await _speech(call, speed=1.5)
        await call("GET", "/api/history?type=tts&limit=50")

    answers = studio.run(script)
    studio.check(answers, [200] * 15, audio_tol=TOL_FX)
    hits = [port[1].get("X-Cache") for _, port in answers]
    assert hits == [None, "HIT"] + [None] * 10 + ["HIT", None, None]
    # a hit synthesizes nothing and logs nothing
    assert studio.tones["port"].calls == studio.tones["jax"].calls == 12
    assert _json(answers[-1][1])["total"] == 12


def test_tts_cache_off_serves_no_hit(studio):
    async def script(call, side):
        await _speech(call)
        await _speech(call)

    answers = studio.run(script)
    studio.check(answers, [200, 200])
    assert studio.tones["port"].calls == 2 and not any((studio.roots["port"] / "cache").glob("*"))


# ── conversations ───────────────────────────────────────────────────────


def _tone_synth(*, text, model, voice, speed, sample_rate):
    n = int(sample_rate * 0.04 * len(text) / speed)
    t = np.arange(n) / sample_rate
    return (0.3 * np.sin(2 * np.pi * (180 + sum(map(ord, voice + model)) % 200) * t)).astype(np.float32)


def test_conversation_routes_match_jax(studio):
    studio.synth = _tone_synth

    async def script(call, side):
        c = "/api/conversations"
        prof = _json(await call("POST", "/api/profiles", json={"name": "Host", "backend": "kokoro",
                                                               "voice": "af_sky", "speed": 1.25}))
        conv = _json(await call("POST", c, json={"name": "demo", "turns": [
            {"speaker": "Host", "text": "Welcome to the show.", "profile_id": prof["id"]},
            {"speaker": "Guest", "text": "Glad to be here.", "effects": [{"type": "normalize"}]}]}))
        cid = conv["id"]
        await call("POST", c, json={"turns": []})  # 422
        await call("POST", c, data=b"[]", headers={"Content-Type": "application/json"})
        empty = _json(await call("POST", c, json={"name": "empty"}))
        await call("GET", c)
        await call("GET", f"{c}?limit=1&offset=1")
        await call("GET", f"{c}/{cid}")
        await call("GET", f"{c}/missing")
        await call("POST", f"{c}/{cid}/turns", json={"speaker": "Host", "text": "Let us begin."})
        await call("POST", f"{c}/{cid}/turns", json={"speaker": "Host"})
        await call("POST", f"{c}/missing/turns", json={"speaker": "A", "text": "x"})
        await call("GET", f"{c}/{cid}/audio")  # not rendered yet
        await call("POST", f"{c}/{cid}/render", json={"format": "wav"})
        await call("GET", f"{c}/{cid}/audio")
        await call("POST", f"{c}/{cid}/render", json={"sample_rate": "fast"})
        await call("POST", f"{c}/{empty['id']}/render", json={})
        await call("POST", f"{c}/missing/render", json={})
        await call("GET", f"{c}/missing/audio")
        await call("DELETE", f"{c}/{cid}/turns/{conv['turns'][0]['id']}")
        await call("DELETE", f"{c}/{cid}/turns/{conv['turns'][0]['id']}")
        await call("GET", f"{c}/{cid}")
        await call("DELETE", f"{c}/{cid}")
        await call("DELETE", f"{c}/{cid}")

    answers = studio.run(script)
    studio.check(answers, [201, 201, 422, 422, 201, 200, 200, 200, 404, 201, 422, 404, 404, 200, 200, 400, 400, 404,
                           404, 204, 404, 200, 204, 404], audio_tol=TOL_FX)
    render = _json(answers[13][1])
    assert render["turn_count"] == 3 and render["duration_ms"] == 640 + 500 + 640 + 500 + 520
    assert [t["turn_index"] for t in _json(answers[21][1])["turns"]] == [0, 1]


# ── composer ────────────────────────────────────────────────────────────


def test_composer_routes_match_jax(studio):
    for root in studio.roots.values():
        (root / "conversations").mkdir(parents=True)
        t = np.arange(24000) / 24000
        (root / "conversations" / "a.wav").write_bytes(JA.write_wav((0.3 * np.sin(2 * np.pi * 440 * t))
                                                                    .astype(np.float32), 24000))
        (root / "conversations" / "b22.wav").write_bytes(_wav(1.0, 22050, 660))

    async def script(call, side):
        src = studio.roots[side] / "conversations"
        r = "/api/composer/render"
        mix = _json(await call("POST", r, json={"format": "wav", "name": "mix", "tracks": [
            {"source_path": str(src / "a.wav"), "volume": 0.5},
            {"source_path": str(src / "a.wav"), "offset_s": 0.5}]}))
        await call("GET", f"{r}/{mix['composition_id']}/audio")
        await call("POST", r, json={"tracks": [{"source_path": "/etc/passwd"}]})
        await call("POST", r, json={"tracks": [{"source_path": "x.wav", "muted": True}]})
        await call("POST", r, json={"tracks": [{"source_path": str(src / "nope.wav")}]})
        await call("POST", r, json={"name": "no tracks"})
        await call("POST", r, json={"tracks": [{"source_path": str(src / "a.wav")}], "sample_rate": "x"})
        await call("GET", "/api/composer/renders")
        await call("GET", "/api/composer/renders?limit=x")
        await call("GET", f"{r}/missing/audio")
        await call("DELETE", f"{r}/{mix['composition_id']}")
        await call("DELETE", f"{r}/{mix['composition_id']}")
        await call("GET", f"{r}/{mix['composition_id']}/audio")

    answers = studio.run(script)
    studio.check(answers, [200, 200, 403, 400, 400, 422, 400, 200, 422, 404, 204, 404, 404])
    assert _json(answers[0][1])["duration_ms"] == 1500
    assert JA.read_wav(answers[1][1][2])[0].size == 36000


def test_composer_resample_route_within_the_resampler_bound(studio):
    for root in studio.roots.values():
        (root / "conversations").mkdir(parents=True)
        (root / "conversations" / "b22.wav").write_bytes(_wav(1.0, 22050, 660))

    async def script(call, side):
        src = studio.roots[side] / "conversations"
        mix = _json(await call("POST", "/api/composer/render", json={"tracks": [
            {"source_path": str(src / "b22.wav"), "effects": [{"type": "normalize"}]}]}))
        await call("GET", f"/api/composer/render/{mix['composition_id']}/audio")

    answers = studio.run(script)
    studio.check(answers, [200, 200], audio_tol=1e-5)  # tests/test_torch_audio.py's resampler bound
    assert JA.read_wav(answers[1][1][2])[0].size == 24000


# ── the web UI ──────────────────────────────────────────────────────────


def _raw(port: int, target: str, method: str = "GET") -> tuple:
    """(status, content type, body) of one request line sent verbatim."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(f"{method} {target} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode("latin-1"))
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.lower(): v for k, v in (line.split(": ", 1) for line in lines[1:])}
    if headers.get("transfer-encoding") == "chunked":
        out = b""
        while True:
            size, _, rest = body.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, body = out + rest[:n], rest[n + 2:]
        body = out
    return int(lines[0].split(" ")[1]), headers.get("content-type"), body


TRAVERSALS = ["/static/app.js", "/static/app.css", "/static/index.html", "/static/", "/static",
              "/static/../server/app.py", "/static/%2e%2e/server/app.py", "/static/..%2fconfig.py",
              "/static/%2E%2E/%2E%2E/pyproject.toml", "/static//etc/passwd", "/static/%2fetc%2fpasswd",
              "/static/nope.js", "/static/./app.css", "/static/..", "/static/%00", "//static/app.js",
              "/static/%252e%252e/config.py", "/static/app.js/", "/static/app.js?v=2", "/web", "/web/"]


def _serve_raw(apps_targets) -> list:
    async def main():
        jserver = TestServer(apps_targets[0], host="127.0.0.1")
        await jserver.start_server()
        tserver = await serve_app(apps_targets[1], "127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        try:
            out = []
            for target, method in apps_targets[2]:
                out.append((await loop.run_in_executor(None, _raw, jserver.port, target, method),
                            await loop.run_in_executor(None, _raw, tserver.port, target, method)))
            return out
        finally:
            await tserver.close()
            await jserver.close()

    return asyncio.run(asyncio.wait_for(main(), 120))


def test_web_ui_and_static_files_match_jax(studio):
    targets = [(t, "GET") for t in TRAVERSALS] + [("/static/app.js", "HEAD"), ("/static/app.js", "POST"),
                                                  ("/web", "HEAD")]
    tapp = TAPP.create_app(stt_router=studio.stt, tts_router=studio.tts)
    answers = _serve_raw((studio._jax_app(), tapp, targets))
    for (target, method), (jax, port) in zip(targets, answers):
        assert port == jax, (method, target, port[:2], jax[:2])
    static = ROOT / "open_speech_tpu_torch" / "static"
    by_target = {t: port for (t, m), (_, port) in zip(targets, answers) if m == "GET"}
    assert by_target["/static/app.js"][2] == (static / "app.js").read_bytes()
    assert by_target["/static/app.css"][:2] == (200, "text/css")
    assert by_target["/web"] == (200, "text/html; charset=utf-8", (static / "index.html").read_bytes())
    assert [by_target[t][0] for t in ("/static/", "/static/../server/app.py", "/static/%2e%2e/server/app.py",
                                      "/static//etc/passwd", "/static/nope.js")] == [403, 404, 404, 404, 404]


def test_static_symlinks_leaving_the_directory_are_refused_as_aiohttp_refuses_them(tmp_path):
    """aiohttp's ``add_static`` and the port's on one directory with a
    symlink out of it, one within it and one to a directory outside, each
    app behind its package's error middleware."""
    from open_speech_tpu.server.errors import error_middleware as jax_errors
    from open_speech_tpu_torch.server.errors import error_middleware as port_errors

    d = tmp_path / "static"
    (d / "sub").mkdir(parents=True)
    (d / "a.txt").write_text("A")
    (d / "sub" / "b.txt").write_text("B")
    (tmp_path / "secret.txt").write_text("S")
    os.symlink(tmp_path / "secret.txt", d / "out.txt")
    os.symlink(d / "a.txt", d / "in.txt")
    os.symlink(tmp_path, d / "outdir")
    os.symlink(d / "loop", d / "loop")
    japp = web.Application(middlewares=[jax_errors])
    japp.router.add_static("/files", str(d))
    tapp = Application(middlewares=[port_errors])
    tapp.router.add_static("/files", d)
    targets = [(f"/files/{name}", "GET") for name in (
        "a.txt", "in.txt", "out.txt", "outdir/secret.txt", "sub/b.txt", "sub/../a.txt", "sub/%2e%2e/a.txt",
        "sub", "sub/..", "../secret.txt", "%2e%2e/secret.txt", "loop", "missing")]
    answers = _serve_raw((japp, tapp, targets))
    for (target, _), (jax, port) in zip(targets, answers):
        assert port == jax, (target, port, jax)
    assert [port[0] for _, port in answers] == [200, 200, 404, 404, 200, 200, 200, 403, 403, 404, 404, 404, 404]


# ── two replicas ────────────────────────────────────────────────────────


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_json(port: int, path: str, body: dict | None = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST" if body is not None else "GET",
                                 data=json.dumps(body).encode() if body is not None else None,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def test_two_port_replicas_keep_their_own_studio(tmp_path):
    """Two ``python -m open_speech_tpu_torch.server`` processes on the CPU,
    each with its own studio database and directories: both serve, and a
    profile created on one never appears on the other."""
    ports, procs = [_free_port(), _free_port()], []
    try:
        for i, port in enumerate(ports):
            data = tmp_path / f"replica{i}"
            env = dict(os.environ, OS_PORT=str(port), OS_HOST="127.0.0.1", OS_SSL_ENABLED="false",
                       OS_AUTH_REQUIRED="false", OS_STUDIO_DB_PATH=str(data / "studio.db"),
                       OS_VOICE_LIBRARY_PATH=str(data / "voices"), OS_CONVERSATIONS_DIR=str(data / "conv"),
                       OS_COMPOSER_DIR=str(data / "composer"), TTS_CACHE_DIR=str(data / "cache"),
                       STT_DEVICE="cpu", TTS_DEVICE="cpu", STT_PRELOAD_MODELS="", TTS_PRELOAD_MODELS="",
                       OS_WYOMING_ENABLED="false", PYTHONPATH=str(ROOT))
            procs.append(subprocess.Popen([sys.executable, "-m", "open_speech_tpu_torch.server"], cwd=ROOT,
                                          env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + 120
        for port, proc in zip(ports, procs):
            while True:
                if proc.poll() is not None:
                    pytest.fail(f"replica on :{port} exited:\n{proc.communicate()[0][-2000:]}")
                with contextlib.suppress(OSError):
                    if _http_json(port, "/health").get("status") in ("ok", "healthy"):
                        break
                assert time.monotonic() < deadline, f"replica on :{port} never became healthy"
                time.sleep(0.25)
        for n in range(4):
            assert _http_json(ports[n % 2], "/v1/models")["data"]
        created = _http_json(ports[0], "/api/profiles", {"name": "replica-test", "backend": "kokoro",
                                                         "voice": "af_heart"})
        assert created["name"] == "replica-test"
        names = [{p["name"] for p in _http_json(port, "/api/profiles")["profiles"]} for port in ports]
        assert names == [{"replica-test"}, set()]
        assert all((tmp_path / f"replica{i}" / "studio.db").exists() for i in range(2))
        for port in ports:
            assert _http_json(port, "/api/stats")["gauges"].get("streaming_sessions_active", 0) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
