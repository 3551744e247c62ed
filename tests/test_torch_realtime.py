"""The OpenAI Realtime socket: the port (``open_speech_tpu_torch/server/
realtime/``) against the JAX package's, on the CPU.

Units: the event constructors and ``SessionConfig`` equal JAX's with the
random ids normalised (each id is replaced by its kind and the order it
first appeared in, so equal ids stay equal); the wire-format codecs and the
linear resampler are byte-equal; ``InputAudioBuffer`` gives JAX's VAD
events on a scripted probability track and on the real VAD (the Silero
tree of ``init_vad_params(PRNGKey(3))`` carried over with
``vad_params_from_jax_tree``; its probabilities agree within 1e-5, and the
threshold is kept more than 1e-4 from every chunk's probability), and
overflow and clear behave alike.

Sessions: both packages' ``realtime_endpoint`` read one list of client
events from a fake socket; the next event waits until a running
``response.create`` has ended, so the event order is fixed. STT runs the
trained fixture ``tests/fixtures/test-tiny-eot`` (JAX's module router
serves a ``JaxWhisperBackend``, the port gets a CPU ``BackendRouter``):
the executor path, the batcher with a pinned language, and the
auto-detect probe that pins it. TTS runs ``tests/torch_tts_common.py``'s
Kokoro tree with the harmonic features injected into both packages; the
decoded deltas must match within 2e-3 plus one PCM step. Equal means the
same normalised event list, the deltas' audio aside.

Served: ``/v1/realtime`` on the JAX app (aiohttp's ``TestServer``) and on
the port's socket, driven by the ``websockets`` client with the
``realtime`` subprotocol: a session's events, the idle timeout, and the
refusals (426, 4004, 1008, 4001).
"""

from __future__ import annotations

import asyncio
import base64
import json
import re
import threading
import time
import types

import aiohttp
import jax
import numpy as np
import pytest
import websockets
from aiohttp import WSMsgType

import open_speech_tpu.runtime.batcher_pool as JBP
import open_speech_tpu.server.realtime.server as JRS
import open_speech_tpu_torch.runtime.batcher_pool as TBP
import open_speech_tpu_torch.server.realtime.server as TRS
from open_speech_tpu.models.vad import silero as JS
from open_speech_tpu.ops import audio as JA
from open_speech_tpu.server import app as JAPP
from open_speech_tpu.server.realtime import audio_buffer as JAB
from open_speech_tpu.server.realtime import events as JE
from open_speech_tpu.server.realtime import session as JSN
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.vad import silero as TS
from open_speech_tpu_torch.ops import audio as TA
from open_speech_tpu_torch.server.realtime import audio_buffer as TAB
from open_speech_tpu_torch.server.realtime import events as TE
from open_speech_tpu_torch.server.realtime import session as TSN
from open_speech_tpu_torch.server.websocket import Message, MsgType
from open_speech_tpu_torch.tts.router import TTSRouter
from tests.test_torch_server import KEY, MODEL, _servers, backends, both, kokoro  # noqa: F401
from tests.torch_tts_common import CFG, TCFG, TOL_AUDIO, one_torch_thread

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

RATE_IN = 24000  # pcm16's wire rate
VAD_THRESHOLD = 0.515  # between the random VAD's tone (~0.53) and quiet (~0.50) chunks
SPEECH = "Hello there. How are you today?"


# ── helpers ─────────────────────────────────────────────────────────────

_ID = re.compile(r"^(evt|item|resp|sess)_[0-9a-f]+$")


def _norm(events: list[dict]) -> list[dict]:
    """Ids replaced by kind and order of first appearance; deltas by
    ``<audio>`` (their samples are compared within tolerance)."""
    seen: dict[str, str] = {}

    def walk(v, key=None):
        if isinstance(v, dict):
            return {k: walk(x, k) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if key == "delta":
            return "<audio>"
        if isinstance(v, str) and _ID.match(v):
            return seen.setdefault(v, f"{v.split('_')[0]}#{len(seen)}")
        return v

    return [walk(e) for e in events]


def _audio(events: list[dict]) -> bytes:
    return b"".join(base64.b64decode(e["delta"]) for e in events if e["type"] == "response.audio.delta")


def _same_events(got: list[dict], want: list[dict], fmt: str = "pcm16") -> None:
    assert _norm(got) == _norm(want)
    a, b = _audio(got), _audio(want)
    assert len(a) == len(b)
    if not a:
        return
    tol = TOL_AUDIO + 2 / 32768
    if fmt == "pcm16":
        np.testing.assert_allclose(TA.pcm16_to_float(a), TA.pcm16_to_float(b), atol=tol)
        return
    # G.711: the samples within tolerance plus one step of the codec where
    # they lie (its steps grow with the amplitude, to 1/32 of full scale)
    decode = TA.ulaw_decode if fmt == "g711_ulaw" else TA.alaw_decode
    table = np.unique(TA.pcm16_to_float(decode(np.arange(256, dtype=np.uint8))))
    got, want = TA.pcm16_to_float(decode(a)), TA.pcm16_to_float(decode(b))
    i = np.clip(np.searchsorted(table, want), 1, len(table) - 2)
    step = np.maximum(table[i + 1] - table[i], table[i] - table[i - 1])
    assert np.all(np.abs(got - want) <= tol + step)


def _tone_and_quiet(pattern: str, rate: int, seed: int = 0) -> np.ndarray:
    """0.5 s pieces: ``t`` a 440 Hz tone at 0.5, ``q`` noise at 0.003."""
    rng = np.random.default_rng(seed)
    n = rate // 2
    t = np.arange(n) / rate
    parts = [0.5 * np.sin(2 * np.pi * 440.0 * t) if c == "t" else rng.normal(0, 0.003, n) for c in pattern]
    return np.concatenate(parts).astype(np.float32)


def _beeps(seconds: float, k: int, seed: int, rate: int = RATE_IN) -> np.ndarray:
    """``tests/test_torch_server.py``'s beeps at ``rate``."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    clip = rng.normal(0, 0.003, n)
    for i in range(k):
        dur = int(0.15 * rate)
        t = np.arange(dur) / rate
        clip[i * (n // k): i * (n // k) + dur] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
    return np.clip(clip, -1, 1).astype(np.float32)


def _pcm16(audio: np.ndarray) -> bytes:
    return (audio * 32767).astype("<i2").tobytes()


def _appends(wire: bytes, chunk: int) -> list[dict]:
    return [{"type": "input_audio_buffer.append", "audio": base64.b64encode(wire[i:i + chunk]).decode()}
            for i in range(0, len(wire), chunk)]


NO_VAD = {"type": "session.update", "session": {"turn_detection": None}}
COMMIT = {"type": "input_audio_buffer.commit"}


class _WS:
    """A fake socket: hands out ``(event, wait)`` pairs, each after the
    response that a ``wait`` event before it started has ended."""

    def __init__(self, items, text, close) -> None:
        self.items, self.text, self.close_msg = list(items), text, close
        self.sent: list[dict] = []
        self.close_code = None
        self._mark = None

    def _response_ended(self) -> bool:
        return any(e["type"] in ("response.done", "error") for e in self.sent[self._mark:])

    async def receive(self, timeout=None):
        while self._mark is not None and not self._response_ended():
            await asyncio.sleep(0.002)
        self._mark = None
        if not self.items:
            return self.close_msg
        event, wait = self.items.pop(0)
        if isinstance(event, (int, float)):  # a pause, then the next event
            await asyncio.sleep(event)
            event, wait = self.items.pop(0)
        if wait and isinstance(event, dict) and event.get("type") == "response.create":
            self._mark = len(self.sent)
        return self.text(json.dumps(event) if isinstance(event, dict) else event)

    async def send_str(self, text: str) -> None:
        self.sent.append(json.loads(text))

    async def close(self, code=1000, message=b"") -> bool:
        self.close_code = code
        self.items = []
        return True


def _run_both(stt_router, items, jtts=None, ttts=None, model=MODEL):
    """Both endpoints over the same events; (JAX events, port events,
    JAX socket, port socket)."""
    items = [(e, True) if not isinstance(e, tuple) else e for e in items]
    jws = _WS(items, lambda d: types.SimpleNamespace(type=WSMsgType.TEXT, data=d),
              types.SimpleNamespace(type=WSMsgType.CLOSE, data=None))
    tws = _WS(items, lambda d: Message(MsgType.TEXT, d), Message(MsgType.CLOSE, 1000))

    async def serve(coro, pool):
        try:
            await asyncio.wait_for(coro, 120)
        finally:
            await pool.shutdown_batchers()

    asyncio.run(serve(JRS.realtime_endpoint(jws, jtts, model=model), JBP))
    asyncio.run(serve(TRS.realtime_endpoint(tws, stt_router, ttts, model=model), TBP))
    return jws.sent, tws.sent, jws, tws


# ── events and session config ───────────────────────────────────────────

EVENT_CALLS = [
    ("session_created", ({"id": "s", "voice": "alloy"},), {}),
    ("session_updated", ({"id": "s"},), {}),
    ("error", ("bad",), {}),
    ("error", ("bad",), {"code": "x", "event_id": "evt_1", "error_type": "server_error"}),
    ("input_audio_buffer_speech_started", (120, "item_a"), {}),
    ("input_audio_buffer_speech_stopped", (900, "item_a"), {}),
    ("input_audio_buffer_committed", ("item_a",), {"previous_item_id": "item_b"}),
    ("input_audio_buffer_cleared", (), {}),
    ("conversation_item_created", ({"id": "item_a"},), {}),
    ("conversation_item_input_audio_transcription_completed", ("item_a", 0, "hi"), {}),
    ("response_created", ({"id": "resp_a"},), {}),
    ("response_audio_delta", ("resp_a", "item_a", 0, 0, "AAAA"), {}),
    ("response_audio_done", ("resp_a", "item_a", 0, 0), {}),
    ("response_done", ({"id": "resp_a", "status": "completed"},), {}),
]


@pytest.mark.parametrize("name,args,kw", EVENT_CALLS, ids=[f"{c[0]}-{i}" for i, c in enumerate(EVENT_CALLS)])
def test_event_constructors_match_jax(name, args, kw):
    got, want = getattr(TE, name)(*args, **kw), getattr(JE, name)(*args, **kw)
    assert _norm([got]) == _norm([want])
    assert got["event_id"].startswith("evt_") and len(got["event_id"]) == len(want["event_id"])


def test_ids_match_jax_in_form():
    for fn in ("_event_id", "_item_id", "_response_id"):
        got, want = getattr(TE, fn)(), getattr(JE, fn)()
        assert got.split("_")[0] == want.split("_")[0] and len(got) == len(want)


SESSION_UPDATES = [
    {},
    {"session": {"voice": "nova", "input_audio_format": "g711_ulaw", "output_audio_format": "bogus",
                 "turn_detection": {"threshold": 0.8, "silence_duration_ms": 900}}},
    {"session": {"turn_detection": None, "model": "whisper-tiny", "output_audio_format": "g711_alaw"}},
    {"session": {"input_audio_transcription": {"model": "whisper-1", "language": "fr"},
                 "turn_detection": {"type": "none", "create_response": 1, "prefix_padding_ms": "200"}}},
    {"voice": "echo", "turn_detection": {"threshold": "0.3"}},  # no "session" wrapper
]


@pytest.mark.parametrize("update", SESSION_UPDATES)
def test_session_config_matches_jax(update):
    jc, tc = JSN.SessionConfig(model="m"), TSN.SessionConfig(model="m")
    assert _norm([tc.to_dict()]) == _norm([jc.to_dict()])
    for step in (update, {"session": {"turn_detection": None}}, update):  # off, then on again
        jc.update_from(step)
        tc.update_from(step)
        assert _norm([tc.to_dict()]) == _norm([jc.to_dict()])
        assert tc.vad_enabled == jc.vad_enabled


# ── codecs and the resampler ────────────────────────────────────────────


def _wire(fmt: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if fmt == "pcm16":
        return rng.integers(-32768, 32767, n, dtype=np.int16).astype("<i2").tobytes()
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("rate", [8000, 16000, 24000])
@pytest.mark.parametrize("fmt", ["pcm16", "g711_ulaw", "g711_alaw"])
def test_format_codecs_are_byte_equal_to_jax(fmt, rate):
    for n, seed in ((0, 0), (1, 1), (801, 2), (4800, 3)):
        wire = _wire(fmt, n, seed)
        assert TAB.decode_audio_to_pcm16(wire, fmt, rate) == JAB.decode_audio_to_pcm16(wire, fmt, rate)
        pcm = _wire("pcm16", n, seed + 10)
        assert TAB.encode_pcm16_to_format(pcm, rate, fmt) == JAB.encode_pcm16_to_format(pcm, rate, fmt)
    for module in (TAB, JAB):
        with pytest.raises(ValueError, match="Unsupported audio format: mp3"):
            module.decode_audio_to_pcm16(b"xx", "mp3")
        with pytest.raises(ValueError, match="Unsupported audio format: mp3"):
            module.encode_pcm16_to_format(b"xx", rate, "mp3")


@pytest.mark.parametrize("src,dst", [(24000, 16000), (16000, 24000), (8000, 16000), (16000, 8000),
                                     (22050, 16000), (16000, 16000)])
def test_linear_resample_is_byte_equal_to_jax(src, dst):
    for n, seed in ((0, 0), (1, 1), (3, 2), (2401, 3)):
        pcm = _wire("pcm16", n, seed)
        assert TA.linear_resample_pcm16(pcm, src, dst) == JA.linear_resample_pcm16(pcm, src, dst)


# ── the input buffer ────────────────────────────────────────────────────


class _Scripted:
    def __init__(self, probs) -> None:
        self.probs = iter(probs)

    def __call__(self, audio) -> float:
        return next(self.probs)


def _buffer_events(module, vad, chunks, **kw):
    buf = module.InputAudioBuffer(vad=vad, **kw)
    return [buf.append(c) for c in chunks], buf


@pytest.mark.parametrize("probs,silence_ms", [
    ([0.9, 0.9, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1], 200),
    ([0.1, 0.6, 0.4, 0.6, 0.4, 0.4, 0.4, 0.7, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2], 300),
    ([0.5, 0.49, 0.49, 0.49, 0.5, 0.5], 100),
])
def test_buffer_vad_events_match_jax_on_a_scripted_track(probs, silence_ms):
    chunks = [b"\x00" * 3200] * len(probs)
    jev, _ = _buffer_events(JAB, _Scripted(probs), chunks, threshold=0.5, silence_duration_ms=silence_ms)
    tev, _ = _buffer_events(TAB, _Scripted(probs), chunks, threshold=0.5, silence_duration_ms=silence_ms)
    assert tev == jev and any(tev)


@pytest.fixture(scope="module")
def vad_pair():
    params = JS.init_vad_params(jax.random.PRNGKey(3))
    return params, TS.vad_params_from_jax_tree(jax.tree.map(np.asarray, params))


def _vad_chunks(pattern: str) -> list[bytes]:
    pcm = _pcm16(_tone_and_quiet(pattern, 16000))
    return [pcm[i:i + 3200] for i in range(0, len(pcm), 3200)]


def _margin(model, chunks: list[bytes]) -> float:
    vad = TS.SileroVAD(model)
    return min(abs(vad(TA.pcm16_to_float(c)) - VAD_THRESHOLD) for c in chunks)


def test_buffer_vad_events_match_jax_on_the_real_vad(vad_pair):
    params, model = vad_pair
    chunks = _vad_chunks("qtttqqqttqqq")
    assert _margin(model, chunks) > 1e-4
    kw = dict(threshold=VAD_THRESHOLD, silence_duration_ms=300)
    jev, _ = _buffer_events(JAB, JS.SileroVAD(params), chunks, **kw)
    tev, _ = _buffer_events(TAB, TS.SileroVAD(model), chunks, **kw)
    assert tev == jev
    assert [e["type"] for es in tev for e in es] == ["speech_started", "speech_stopped"] * 2


def test_buffer_overflow_and_clear_match_jax():
    out = []
    for module in (JAB, TAB):
        buf = module.InputAudioBuffer(max_buffer_bytes=100)
        with pytest.raises(BufferError) as big:
            buf.append(b"\x00" * 200)
        buf.append(b"\x01" * 60)
        with pytest.raises(BufferError) as over:
            buf.append(b"\x00" * 60)
        kept = buf.get_audio()
        buf.clear()
        buf.append(b"\x02\x03" * 20)
        out.append((str(big.value), str(over.value), kept, buf.commit(), buf.get_audio(), buf.in_speech))
    assert out[1] == out[0]


# ── sessions through the endpoint ───────────────────────────────────────


def _stt_items(fmt: str = "pcm16") -> list:
    """Two explicit turns of beeps, then the requests that fail or do nothing."""
    first, second = _beeps(1.0, 3, 1), _beeps(0.8, 2, 2)
    if fmt == "pcm16":
        wires, chunk = (_pcm16(first), _pcm16(second)), 4800
    else:  # 8 kHz telephony
        wires = tuple(JA.ulaw_encode((a[::3] * 32767).astype(np.int16)).tobytes() for a in (first, second))
        chunk = 800
    update = {"type": "session.update", "session": {"turn_detection": None, "input_audio_format": fmt}}
    return ([update] + _appends(wires[0], chunk) + [COMMIT] + _appends(wires[1], chunk) + [COMMIT, COMMIT]
            + _appends(wires[0][:chunk // 4], chunk) + [COMMIT]  # < 50 ms: no turn
            + _appends(wires[1], chunk) + [{"type": "input_audio_buffer.clear"}, COMMIT,
                                           {"type": "input_audio_buffer.append", "audio": "!!notb64!!"},
                                           {"type": "input_audio_buffer.append", "audio": ""},
                                           {"type": "nope.nope", "event_id": "evt_client"},
                                           "{not json", json.dumps([1, 2]),
                                           {"type": "response.create", "response": {"modalities": ["text"]}},
                                           {"type": "response.create", "response": {}}])


@pytest.mark.parametrize("fmt", ["pcm16", "g711_ulaw"])
def test_session_events_match_jax(both, backends, fmt):
    jev, tev, _, _ = _run_both(backends[1], _stt_items(fmt))
    _same_events(tev, jev)
    done = [e["transcript"] for e in tev if e["type"].endswith("transcription.completed")]
    assert len(done) == 2 and all(done)
    codes = [e["error"]["code"] for e in tev if e["type"] == "error"]
    assert codes == ["invalid_audio", "unknown_event", "invalid_event", "invalid_event",
                     "unsupported_modality", "missing_input"]


def _counted(monkeypatch):
    counts = {"jax": [], "torch": []}

    def counted(name, fn):
        async def wrapper(backend, model, language, pcm, *a, **kw):
            counts[name].append(language)
            return await fn(backend, model, language, pcm, *a, **kw)
        return wrapper

    monkeypatch.setattr(JBP, "transcribe_pcm_batched", counted("jax", JBP.transcribe_pcm_batched))
    monkeypatch.setattr(TRS, "transcribe_pcm_batched", counted("torch", TRS.transcribe_pcm_batched))
    return counts


@pytest.mark.parametrize("pinned", [True, False], ids=["language-pinned", "auto-detect"])
def test_session_through_the_batcher_matches_jax(both, backends, monkeypatch, pinned):
    """With OS_BATCHER_ENABLED a pinned session's commits ride the batcher;
    an unpinned one probes the language once on a >= 1 s commit, pins it,
    and then rides it too."""
    both(os_batcher_enabled=True, os_stream_incremental=False)
    counts = _counted(monkeypatch)
    for pool in (JBP, TBP):
        pool.reset_pool()
    session = {"turn_detection": None}
    if pinned:
        session["input_audio_transcription"] = {"model": "whisper-1", "language": "en"}
    items = [{"type": "session.update", "session": session}]
    for k, seed in ((3, 5), (2, 6)):
        items += _appends(_pcm16(_beeps(1.1, k, seed)), 4800) + [COMMIT]
    probes = {"jax": 0, "torch": 0}
    for name, backend in (("jax", backends[0]), ("torch", backends[1].get_backend(MODEL))):
        real = backend.detect_language_pcm

        def probe(*a, _real=real, _name=name, **kw):
            probes[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(backend, "detect_language_pcm", probe)
    try:
        jev, tev, _, _ = _run_both(backends[1], items)
    finally:
        for pool in (JBP, TBP):
            pool.reset_pool()
    _same_events(tev, jev)
    assert counts["torch"] == counts["jax"] and len(counts["torch"]) == 2
    assert probes["torch"] == probes["jax"] == (0 if pinned else 1)
    assert all(e["transcript"] for e in tev if e["type"].endswith("transcription.completed"))


def _server_vad_items(pattern: str) -> list:
    update = {"type": "session.update",
              "session": {"turn_detection": {"type": "server_vad", "threshold": VAD_THRESHOLD,
                                             "silence_duration_ms": 300}}}
    return [update] + _appends(_pcm16(_tone_and_quiet(pattern, RATE_IN)), 2400)


def test_server_vad_turns_match_jax(both, backends, monkeypatch, vad_pair):
    """Server VAD on the same Silero tree: speech_started/stopped and the
    auto-committed turns, one item id across each turn's events."""
    params, model = vad_pair
    pattern = "qtttqqqttqqq"
    assert _margin(model, _vad_chunks(pattern)) > 1e-4

    async def jax_vad():
        return JS.SileroVAD(params)

    monkeypatch.setattr(JRS, "get_vad_model", jax_vad)
    shared = TS.SileroVAD(model)
    devices = []
    monkeypatch.setattr(TRS, "get_vad_model", lambda device: devices.append(device) or shared)
    jev, tev, _, _ = _run_both(backends[1], _server_vad_items(pattern))
    _same_events(tev, jev)
    kinds = [e["type"] for e in tev]
    assert kinds.count("input_audio_buffer.speech_started") == 2
    assert kinds.count("conversation.item.input_audio_transcription.completed") == 2
    assert [str(d) for d in devices] == ["cpu", "cpu"]  # the STT backend's device, at start and update
    turn = [e for e in _norm(tev) if "item_id" in e][:4]
    assert len({e["item_id"] for e in turn}) == 1


def test_a_failed_vad_load_disables_server_vad_as_in_jax(both, backends, monkeypatch, caplog):
    """The reference's swallowed failure, kept on the CPU: the session goes
    on without turn detection and logs a warning."""
    async def jax_fail():
        raise RuntimeError("no vad")

    def torch_fail(device):
        raise RuntimeError("no vad")

    monkeypatch.setattr(JRS, "get_vad_model", jax_fail)
    monkeypatch.setattr(TRS, "get_vad_model", torch_fail)
    jev, tev, _, _ = _run_both(backends[1], _server_vad_items("qttq") + [COMMIT])
    _same_events(tev, jev)
    assert "input_audio_buffer.speech_started" not in [e["type"] for e in tev]
    assert [r.message for r in caplog.records if r.name == TRS.__name__] == [
        "Failed to load VAD model, disabling server VAD"] * 2


def test_idle_append_closes_with_4008_as_jax(both, backends):
    both(os_realtime_idle_timeout_s=0)
    items = [NO_VAD] + _appends(_pcm16(_beeps(0.3, 1, 3)), 4800)
    jev, tev, jws, tws = _run_both(backends[1], items)
    _same_events(tev, jev)
    assert tev[-1]["error"] == {"type": "invalid_request_error",
                                "message": "Session idle timeout waiting for commit", "code": "idle_timeout"}
    assert tws.close_code == jws.close_code == 4008


def test_buffer_overflow_in_a_session_matches_jax(both, backends):
    both(os_realtime_max_buffer_mb=0)
    jev, tev, _, _ = _run_both(backends[1], [NO_VAD] + _appends(_pcm16(_beeps(0.2, 1, 4)), 4800))
    _same_events(tev, jev)
    assert tev[-1]["error"]["code"] == "buffer_overflow"


# ── responses (TTS) ─────────────────────────────────────────────────────


@pytest.fixture
def tts_pair(kokoro, monkeypatch):
    """(JAX TTS router, port TTS router) on the Kokoro test tree."""
    jtree, model = kokoro
    backend = JAPP.tts_router.get_backend("kokoro")
    monkeypatch.setattr(backend, "_params", jtree)
    monkeypatch.setattr(backend, "_cfg", CFG)
    tts = TTSRouter(device="cpu")
    tts.get_backend("kokoro")._model, tts.get_backend("kokoro")._cfg = model, TCFG
    return JAPP.tts_router, tts


@pytest.mark.parametrize("fmt", ["pcm16", "g711_alaw"])
def test_response_audio_matches_jax(both, backends, tts_pair, fmt):
    update = {"type": "session.update",
              "session": {"turn_detection": None, "voice": "af_bella", "output_audio_format": fmt}}
    items = [update, {"type": "response.create", "response": {"instructions": SPEECH}},
             {"type": "response.create", "response": {
                 "input": [{"content": [{"type": "input_audio"}, {"type": "input_text", "text": "Okay."}]}]}}]
    jev, tev, _, _ = _run_both(backends[1], items, *tts_pair)
    _same_events(tev, jev, fmt)
    kinds = [e["type"] for e in tev]
    assert kinds.count("response.done") == 2 and kinds.count("response.audio.delta") > 2
    assert [e["response"]["status"] for e in tev if e["type"] == "response.done"] == ["completed"] * 2


class _SlowTTS:
    """50 chunks of 100 ms, one per 50 ms; counts what was produced."""

    def __init__(self) -> None:
        self.produced, self.closed = 0, threading.Event()

    def get_backend(self, model):
        return types.SimpleNamespace(sample_rate=24000)

    def synthesize(self, **kw):
        try:
            for _ in range(50):
                time.sleep(0.05)
                self.produced += 1
                yield np.full(2400, 0.1, np.float32)
        finally:
            self.closed.set()


def test_cancel_stops_the_deltas_and_the_synthesis(both, backends):
    """``response.cancel`` mid-stream: both packages stop the deltas and
    end with response.done (cancelled); a second response.create while one
    runs is refused. The port also stops the synthesis at its next chunk."""
    create = {"type": "response.create", "response": {"instructions": "cancel me"}}
    items = [(create, False), (0.3, None), (create, False), (0.2, None),
             ({"type": "response.cancel"}, False), (1.0, None), (COMMIT, False)]
    jtts, ttts = _SlowTTS(), _SlowTTS()
    jev, tev, _, _ = _run_both(backends[1], items, jtts, ttts)
    for events in (jev, tev):
        kinds = [e["type"] for e in events]
        assert kinds[:2] == ["session.created", "response.created"]
        assert 0 < kinds.count("response.audio.delta") < 40
        assert [e["error"]["code"] for e in events if e["type"] == "error"] == [
            "conversation_already_has_active_response"]
        assert kinds[-1] == "response.done" and events[-1]["response"]["status"] == "cancelled"
    assert ttts.closed.wait(5) and ttts.produced < 25  # of 50: the synthesis stopped


# ── served: /v1/realtime on both servers ───────────────────────────────


async def _refusal(url: str, **kw) -> tuple[int, str]:
    async with websockets.connect(url, subprotocols=["realtime"], **kw) as ws:
        with pytest.raises(websockets.ConnectionClosed) as e:
            await ws.recv()
    return e.value.rcvd.code, e.value.rcvd.reason


RT_REFUSALS = [
    ("disabled", "", {}, {"os_realtime_enabled": False}),
    ("origin", "", {"origin": "https://bad.example"}, {"os_ws_allowed_origins": "https://ok.example"}),
    ("api-key", "", {}, {"os_api_key": KEY}),
    ("api-key-wrong", "?api_key=wrong", {}, {"os_api_key": KEY}),
]


@pytest.mark.parametrize("name,query,kw,changed", RT_REFUSALS, ids=[c[0] for c in RT_REFUSALS])
def test_realtime_refusals_match_the_jax_app(both, backends, name, query, kw, changed):
    both(**changed)

    async def main():
        async with _servers(backends[1]) as (jbase, tbase):
            return [await _refusal(f"ws://{base}/v1/realtime{query}", **kw) for base in (jbase, tbase)]

    jax, port = asyncio.run(asyncio.wait_for(main(), 60))
    assert port == jax and port[0] in (4004, 1008, 4001)


def test_realtime_without_upgrade_is_426_as_in_the_jax_app(both, backends):
    async def main():
        async with _servers(backends[1]) as (jbase, tbase):
            async with aiohttp.ClientSession() as session:
                out = []
                for base in (jbase, tbase):
                    async with session.get(f"http://{base}/v1/realtime") as r:
                        out.append((r.status, r.headers.get("Content-Type"), await r.json()))
                return out

    jax, port = asyncio.run(asyncio.wait_for(main(), 60))
    assert port == jax
    assert port[0] == 426 and port[2]["error"]["message"] == "/v1/realtime is a WebSocket endpoint"


async def _served_session(base: str, items: list, query: str = f"?model={MODEL}"):
    """(subprotocol, events, close code): each event sent once the server
    answered the one before (a commit's transcript, a response's done)."""
    async with websockets.connect(f"ws://{base}/v1/realtime{query}", subprotocols=["realtime"]) as ws:
        events = [json.loads(await ws.recv())]
        for item in items:
            await ws.send(json.dumps(item))
            kind = item["type"]
            until = {"session.update": "session.updated", "input_audio_buffer.commit":
                     "conversation.item.input_audio_transcription.completed",
                     "response.create": "response.done"}.get(kind)
            while until is not None:
                events.append(json.loads(await ws.recv()))
                if events[-1]["type"] == until:
                    break
        await ws.close()
        return ws.subprotocol, events


def test_served_session_matches_the_jax_app(both, backends, tts_pair):
    items = ([{"type": "session.update", "session": {"turn_detection": None, "voice": "af_bella"}}]
             + _appends(_pcm16(_beeps(1.0, 3, 7)), 4800) + [COMMIT]
             + [{"type": "response.create", "response": {"instructions": SPEECH}}])

    async def main():
        async with _servers(backends[1], tts_pair[1]) as (jbase, tbase):
            return [await _served_session(base, items) for base in (jbase, tbase)]

    (jproto, jev), (tproto, tev) = asyncio.run(asyncio.wait_for(main(), 300))
    assert tproto == jproto == "realtime"
    _same_events(tev, jev)
    assert tev[-1]["type"] == "response.done" and tev[-1]["response"]["status"] == "completed"


def test_served_idle_timeout_matches_the_jax_app(both, backends):
    both(os_realtime_idle_timeout_s=0.5)

    async def one(base):
        events = []
        async with websockets.connect(f"ws://{base}/v1/realtime", subprotocols=["realtime"]) as ws:
            with pytest.raises(websockets.ConnectionClosed):
                while True:
                    events.append(json.loads(await ws.recv()))
            return events, ws.close_code, ws.close_reason

    async def main():
        async with _servers(backends[1]) as (jbase, tbase):
            return [await one(base) for base in (jbase, tbase)]

    (jev, jcode, jwhy), (tev, tcode, twhy) = asyncio.run(asyncio.wait_for(main(), 60))
    assert _norm(tev) == _norm(jev) and [e["type"] for e in tev] == ["session.created", "error"]
    assert (tcode, twhy) == (jcode, jwhy) == (4008, "Session idle timeout")
