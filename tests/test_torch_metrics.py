"""The port's serving metrics and the speech route's effects repair, held
against the JAX package on the CPU.

- **The ``Metrics`` class** (``server/metrics.py``, a copy of the JAX
  module): one seeded numpy sequence of counter increments, gauges
  (labelled ones too), observations and STT/TTS records goes into both
  packages' ``Metrics`` on one stubbed clock. The snapshots are equal and
  the Prometheus texts equal byte for byte.
- **``/metrics`` and ``/api/stats``** of both apps after the same
  transcription (the fixture ``test-tiny-eot``) and the same whole-body
  and streamed speech requests (``tests/test_torch_server.py``'s Kokoro
  test tree): the counters, the gauges and each summary's count are equal;
  the STT audio seconds within 1e-4; every time-derived value (walls,
  RTFx, TTFA, uptime) positive and finite; ``/api/stats`` has the same
  keys, ``replica`` compared by keys only.
- **The effects.** With ``OS_EFFECTS_ENABLED=false`` a whole-body request
  that carries ``effects`` gets the same status and audio from both apps
  (within ``TOL_AUDIO`` plus one PCM step, as ``tests/test_torch_server.py``
  holds served WAVs); with the setting on, or streamed, both apps apply
  them, and the port's PCM is the JAX app's within the same bound plus the
  reverb's rounding.
"""

from __future__ import annotations

import json
import math
import re
from types import SimpleNamespace

import numpy as np
import pytest

import open_speech_tpu.server.metrics as JMET
import open_speech_tpu_torch.server.metrics as TMET
from open_speech_tpu.server import app as JAPP
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.server import app as TAPP
from open_speech_tpu_torch.tts.router import TTSRouter
from tests.test_torch_server import (  # noqa: F401 — fixtures used by name
    MODEL,
    T,
    _ask_both,
    _form,
    _one_torch_thread,
    _same,
    _wav,
    backends,
    both,
    kokoro,
)
from tests.torch_tts_common import CFG, TCFG, TEXT, TOL_AUDIO

# ── the Metrics class ───────────────────────────────────────────────────


def _drive(m, rng: np.random.Generator, n: int) -> None:
    """``n`` seeded operations on one ``Metrics`` (past the 2048-sample
    reservoir of each summary, so samples also leave it)."""
    names = ["stt_errors_total", "custom_total", 'batch_occupancy{batcher="a/en/transcribe"}',
             'batch_occupancy{batcher="b/fr/translate"}', "streaming_sessions_active", "lat_seconds"]
    for _ in range(n):
        op = int(rng.integers(5))
        name = names[int(rng.integers(len(names)))]
        if op == 0:
            m.inc(name, int(rng.integers(1, 4)))
        elif op == 1:
            m.set_gauge(name, float(rng.uniform(0, 8)))
        elif op == 2:
            m.observe(name, float(rng.exponential(0.5)))
        elif op == 3:
            m.record_stt(audio_seconds=float(rng.uniform(0, 30)), wall_seconds=float(rng.uniform(0, 2)))
        else:
            m.record_tts(ttfa_seconds=float(rng.exponential(0.1)),
                         audio_seconds=float(rng.choice([0.0, rng.uniform(0, 20)])),
                         wall_seconds=float(rng.uniform(0, 3)))


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 700), (2, 12_000)])
def test_metrics_match_the_jax_module(monkeypatch, seed, n):
    clock = SimpleNamespace(time=lambda: 1_000.0)
    for module in (JMET, TMET):
        monkeypatch.setattr(module, "time", clock)
    jm, tm = JMET.Metrics(), TMET.Metrics()
    for m in (jm, tm):
        _drive(m, np.random.default_rng(seed), n)
    clock.time = lambda: 1_234.5678
    assert tm.snapshot() == jm.snapshot()
    assert tm.prometheus() == jm.prometheus()


# ── /metrics and /api/stats after served requests ───────────────────────


@pytest.fixture
def speech(both, backends, monkeypatch, kokoro):
    """Both apps' Kokoro on the test tree, fresh metrics on both sides.
    Returns (port STT router, port TTS router)."""
    jtree, model = kokoro
    backend = JAPP.tts_router.get_backend("kokoro")
    monkeypatch.setattr(backend, "_params", jtree)
    monkeypatch.setattr(backend, "_cfg", CFG)
    monkeypatch.setattr(JAPP, "metrics", JMET.Metrics())
    monkeypatch.setattr(TAPP, "metrics", TMET.Metrics())
    tts = TTSRouter(device="cpu")
    tts.get_backend("kokoro")._model, tts.get_backend("kokoro")._cfg = model, TCFG
    return backends[1], tts


_SAMPLE = re.compile(r"^(?P<name>[^ {]+)(?P<labels>\{[^}]*\})? (?P<value>\S+)$")


def _prometheus(text: str) -> dict:
    """{name and labels: value} of the samples, {name: type} of the types."""
    samples, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types[name] = kind
            continue
        m = _SAMPLE.match(line)
        assert m, line
        samples[m["name"] + (m["labels"] or "")] = float(m["value"])
    return samples | {"# TYPE": types}


def _timed(key: str) -> bool:
    """A sample whose value is a time or a rate: equal only in sign."""
    return any(k in key for k in ("wall_seconds", "rtfx", "ttfa_seconds", "uptime_seconds")) and not (
        key.endswith("_count"))


def test_metrics_and_stats_after_served_requests_match_the_jax_app(speech):
    trouter, tts = speech
    body = {"input": TEXT, "voice": "af_bella"}
    calls = [("POST", T, _form(_wav("beeps1"), model=MODEL), {}),
             ("POST", T, _form(_wav("beeps1"), model="nope-model"), {}),
             ("POST", "/v1/audio/speech", None, {"json": {**body, "response_format": "wav"}}),
             ("POST", "/v1/audio/speech?stream=true", None, {"json": {**body, "response_format": "pcm"}}),
             ("GET", "/metrics", None, {}), ("GET", "/api/stats", None, {})]
    answers = _ask_both(trouter, calls, tts_router=tts)
    assert [port[0] for _, port in answers] == [200, 404, 200, 200, 200, 200]
    for jax, port in answers[:2]:
        _same(jax, port)

    (jax, port) = answers[4]
    assert port[1]["Content-Type"] == jax[1]["Content-Type"] == "text/plain; charset=utf-8"
    want, got = _prometheus(jax[2].decode()), _prometheus(port[2].decode())
    assert set(got) == set(want) and got["# TYPE"] == want["# TYPE"]
    for key in want:
        if key == "# TYPE":
            continue
        if _timed(key):
            assert math.isfinite(got[key]) and (got[key] > 0) == (want[key] > 0), key
        else:
            assert abs(got[key] - want[key]) <= 1e-4, (key, got[key], want[key])
    assert got["open_speech_stt_requests_total"] == 1 and got["open_speech_stt_errors_total"] == 1
    assert got["open_speech_tts_requests_total"] == 2 and got["open_speech_tts_ttfa_seconds_count"] == 2
    assert got["open_speech_stt_rtfx_count"] == 1 and got['open_speech_tts_ttfa_seconds{quantile="0.50"}'] > 0
    assert got["open_speech_streaming_sessions_active"] == 0

    (jax, port) = answers[5]
    want, got = json.loads(jax[2]), json.loads(port[2])
    assert set(got) == set(want) and set(got["replica"]) == set(want["replica"])
    assert got["replica"]["replica"] == 0 and got["replica"]["replica_count"] == 1
    for key in ("counters", "gauges", "streaming_sessions", "batchers", "tts_batchers", "pocket_batchers"):
        assert got[key] == want[key], key
    assert set(got["histograms"]) == set(want["histograms"])
    for name, summary in want["histograms"].items():
        assert got["histograms"][name]["count"] == summary["count"], name
        if name == "stt_audio_seconds":
            for q, value in summary.items():
                assert abs(got["histograms"][name][q] - value) <= 1e-4, q


# ── the effects repair ──────────────────────────────────────────────────

EFFECTS = [{"type": "reverb", "room_size": 0.5}]


def test_effects_are_ignored_when_disabled_as_the_jax_app_does(speech, both):
    """OS_EFFECTS_ENABLED=false: a whole-body request with effects is served
    without them, by both apps alike."""
    trouter, tts = speech
    both(os_effects_enabled=False)
    body = {"input": TEXT, "voice": "af_bella", "response_format": "wav", "effects": EFFECTS}
    [(jax, port)] = _ask_both(trouter, [("POST", "/v1/audio/speech", None, {"json": body})], tts_router=tts)
    assert port[0] == jax[0] == 200 and port[1]["Content-Type"] == jax[1]["Content-Type"]
    got, rate = codec.read_wav(port[2])
    want, _ = codec.read_wav(jax[2])
    assert rate == 24000 and got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO + 2 / 32768)


@pytest.mark.parametrize("enabled,query", [(True, ""), (False, "?stream=true"), (True, "?stream=true")])
def test_effects_the_port_cannot_apply_name_their_item(speech, both, enabled, query):
    """The DSP is ported, so no named error is left: with the setting on,
    or streamed (where both apps always apply them), the port answers the
    JAX app's status, content type and effected PCM, within ``TOL_AUDIO``
    plus the reverb's float32 rounding and one PCM step. Streamed, the whole
    utterance goes out processed."""
    trouter, tts = speech
    both(os_effects_enabled=enabled)
    body = {"input": TEXT, "voice": "af_bella", "response_format": "pcm", "effects": EFFECTS}
    calls = [("POST", "/v1/audio/speech" + query, None, {"json": body}),
             ("POST", "/v1/audio/speech" + query, None, {"json": {**body, "effects": []}})]
    [(jax, port), (_, plain)] = _ask_both(trouter, calls, tts_router=tts)
    assert port[0] == jax[0] == plain[0] == 200 and port[1]["Content-Type"] == jax[1]["Content-Type"]
    got, want = codec.pcm16_to_float(port[2]), codec.pcm16_to_float(jax[2])
    assert got.shape == want.shape == codec.pcm16_to_float(plain[2]).shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO + 1e-6 + 2 / 32768)
    assert not np.allclose(got, codec.pcm16_to_float(plain[2]), atol=1e-3)  # the reverb was applied
