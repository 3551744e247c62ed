"""Streaming STT: the PyTorch port against the JAX package, on the CPU.

Encoder: ``StreamingWhisperEncoder`` on test-tiny (``init_params(PRNGKey(0))``
carried over with ``params_from_jax_tree``), with a 16-position block so
that 60 positions hold three commits and the clamped last block. Encoder
states, K/V caches and interim states within 1e-4 (float32, O(1)-O(10)
values, different summation orders); mel segments within 1e-5.

Session: the JAX ``StreamingSession`` (aiohttp message types, its module
router patched to a test entry, as ``tests/test_streaming_incremental.py``
does) and the port's (its own message type, the router passed in) run the
trained fixture ``tests/fixtures/test-tiny-eot``, each loaded by its own
converter, on the same PCM: VAD off, language "en", every interim awaited
before the next message. The event lists must be identical (greedy, T=0),
apart from the random session id. With ``OS_BATCHER_ENABLED`` (and the
incremental encoder off) both sessions submit through their continuous
batcher pools, and the event lists must still be identical.
"""

from __future__ import annotations

import asyncio
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import WSMsgType

import open_speech_tpu.runtime.batcher_pool as JBP
import open_speech_tpu.server.streaming as JSS
import open_speech_tpu_torch.runtime.batcher_pool as TBP
import open_speech_tpu_torch.server.streaming as TSS
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.models.whisper import convert as JC
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu.models.whisper import streaming as JST
from open_speech_tpu.models.whisper.tokenizer import get_tokenizer as jax_tokenizer
from open_speech_tpu.ops import audio as JA
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.whisper import convert as TC
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.models.whisper import streaming as TST
from open_speech_tpu_torch.models.whisper.tokenizer import get_tokenizer as torch_tokenizer

TOL = 1e-4
BLOCK = 16
SR = 16000
FIXTURE = Path(__file__).parent / "fixtures" / "test-tiny-eot"


# ── the incremental encoder ────────────────────────────────────────────


@pytest.fixture(scope="module")
def pair():
    cfg = JM.PRESETS["test-tiny"]
    params = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    model = TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TM.PRESETS["test-tiny"])
    return params, model


def _encoders(pair, block=BLOCK):
    params, model = pair
    return (
        JST.StreamingWhisperEncoder(params, JM.PRESETS["test-tiny"], block_pos=block),
        TST.StreamingWhisperEncoder(model, TM.PRESETS["test-tiny"], block_pos=block),
    )


def _audio(n_positions, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.4, 0.4, n_positions * 320).astype(np.float32)


def test_constants_and_budgets_match_jax():
    assert TST.BLOCK_POS == JST.BLOCK_POS
    assert TST.DECODE_BUCKETS == JST.DECODE_BUCKETS
    assert TST.FORCED_BUCKETS == JST.FORCED_BUCKETS
    assert TST.INTERIM_TAIL_CAP == JST.INTERIM_TAIL_CAP
    for bucket in (60, 256, 512, 1024, 1500):
        assert TST.final_budget(bucket) == JST.final_budget(bucket)
        for n_forced in (0, 16, 32, 64, 160):
            assert TST.interim_budget(bucket, n_forced) == JST.interim_budget(bucket, n_forced)
    for n in (0, 15, 16, 31, 100, 170):
        for room in (0, 20, 1 << 30):
            assert TST.forced_bucket(n, room) == JST.forced_bucket(n, room)
    for name in ("test-tiny", "large-v3-turbo"):
        for sot_len in (3, 4):
            assert TST.forced_room(TM.PRESETS[name], sot_len) == JST.forced_room(
                JM.PRESETS[name], sot_len
            )


@pytest.mark.parametrize("p0", [0, 16, 44])
def test_mel_segment_matches_jax(pair, p0):
    je, te = _encoders(pair)
    audio = _audio(60, seed=2)
    je._pcm = te._pcm = audio
    want = np.asarray(je._mel_segment(p0, BLOCK))
    got = te._mel_segment(p0, BLOCK).numpy()
    assert got.shape == want.shape == (1, 80, 2 * BLOCK + 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_chunked_commits_match_jax_and_commit_each_block_once(pair):
    je, te = _encoders(pair)
    audio = _audio(3 * BLOCK + 8, seed=1)
    per_chunk = []
    for start in range(0, len(audio), 1600):  # 100 ms chunks
        before = te.block_encodes
        je.append_audio(audio[start : start + 1600])
        te.append_audio(audio[start : start + 1600])
        per_chunk.append(te.block_encodes - before)
    assert te.block_encodes == je.block_encodes == 3
    assert max(per_chunk) == 1 and te._committed == je._committed == 3 * BLOCK
    for got, want in ((te._enc, je._enc), (te._kc, je._kc), (te._vc, je._vc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_interims_match_jax_and_leave_committed_state_alone(pair):
    """Interims interleaved with commits, on to the clamped last block
    (committed 48 > n_audio_ctx - block = 44): interim states equal JAX's,
    and no interim changes a committed position."""
    je, te = _encoders(pair)
    audio = _audio(60, seed=3)
    clamped = 0
    for start in range(0, len(audio) + 1600, 1600):
        je.append_audio(audio[start : start + 1600])
        te.append_audio(audio[start : start + 1600])
        c = te._committed
        assert c == je._committed
        snap = [t[..., :c, :].clone() for t in (te._kc, te._vc)] + [te._enc[:, :c].clone()]
        tails = te.tail_encodes
        want, bucket_j = je.interim_states()
        got, bucket_t = te.interim_states()
        assert bucket_t == bucket_j == 60 and got.shape == (1, 60, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        for before, now in zip(snap, [te._kc[..., :c, :], te._vc[..., :c, :], te._enc[:, :c]]):
            assert torch.equal(before, now), "an interim changed the committed state"
        np.testing.assert_allclose(
            te._kc[..., :c, :].numpy(), np.asarray(je._kc)[..., :c, :], atol=TOL, rtol=0
        )
        np.testing.assert_allclose(
            te._enc[:, :c].numpy(), np.asarray(je._enc)[:, :c], atol=TOL, rtol=0
        )
        clamped += c > 60 - BLOCK and te.tail_encodes > tails
    assert te.block_encodes == 3 and clamped >= 1


def test_reset_and_bucket_ladder(pair):
    _, te = _encoders(pair)
    te.append_audio(_audio(2 * BLOCK + 4, seed=5))
    assert te._committed > 0
    te.reset()
    assert te._committed == 0 and te.total_positions == 0
    assert not te._kc.any() and not te._enc.any()
    big = TST.StreamingWhisperEncoder.__new__(TST.StreamingWhisperEncoder)
    big.cfg = TM.PRESETS["tiny"]
    ref = JST.StreamingWhisperEncoder.__new__(JST.StreamingWhisperEncoder)
    ref.cfg = JM.PRESETS["tiny"]
    for positions in (10, 256, 257, 900, 1400, 1500):
        big._pcm = ref._pcm = np.zeros(positions * 320, np.float32)
        assert big.decode_bucket() == ref.decode_bucket()


# ── the session ────────────────────────────────────────────────────────


class _Backend:
    def __init__(self, entry):
        self.entry = entry
        self.device = "cpu"
        self._models = {"test-tiny-eot": entry}  # what the batcher pools read

    def _ensure_model(self, _model):
        return self.entry


class _Router:
    """Serves one model entry; the executor path returns a fixed text."""

    def __init__(self, entry):
        self.backend = _Backend(entry)
        self.calls: list[dict] = []

    def is_model_loaded(self, _model):
        return True

    def load_model(self, _model):
        pass

    def get_backend(self, _model):
        return self.backend

    def transcribe(self, **kw):
        self.calls.append(kw)
        return {"text": "final text"}


class _WS:
    """Yields the client's messages, each only once the session's interim
    in flight (if any) has finished: interims run synchronously."""

    def __init__(self, messages):
        self.messages = messages
        self.sent: list[dict] = []
        self.session = None
        self.closed = None

    async def send_str(self, text):
        self.sent.append(json.loads(text))

    async def close(self, **kw):
        self.closed = kw

    def __aiter__(self):
        return self._messages()

    async def _messages(self):
        for msg in self.messages:
            task = self.session._interim_task
            if task is not None:
                await asyncio.wait([task])
            yield msg


@pytest.fixture(scope="module")
def entries():
    params, cfg = JC.load_params(str(FIXTURE), dtype=jnp.float32)
    model, tcfg = TC.load_params(str(FIXTURE), dtype=torch.float32)
    return (
        {"params": params, "cfg": cfg,
         "tok": jax_tokenizer(str(FIXTURE), n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)},
        {"model": model, "cfg": tcfg,
         "tok": torch_tokenizer(str(FIXTURE), n_vocab=tcfg.n_vocab, n_langs=tcfg.n_langs)},
    )


@pytest.fixture
def stream_settings(monkeypatch):
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_stream_incremental", True)
        monkeypatch.setattr(s, "os_batcher_enabled", False)
        monkeypatch.setattr(s, "os_stream_chunk_ms", 100)


def _run_both(monkeypatch, entries, messages, jax_entry=None, torch_entry=None, **kw):
    """Drive both sessions with ``messages`` [(kind, data)] then stop.
    Returns (jax events, port events, jax router, port router, port session)."""
    jentry, tentry = entries
    messages = list(messages) + [("text", json.dumps({"type": "stop"}))]
    kinds = {"binary": (WSMsgType.BINARY, TSS.MsgType.BINARY),
             "text": (WSMsgType.TEXT, TSS.MsgType.TEXT)}
    kw = dict(dict(model="test-tiny-eot", language="en", sample_rate=SR, interim_results=True,
                   endpointing_ms=300, vad_enabled=False), **kw)

    jrouter = _Router(jax_entry if jax_entry is not None else jentry)
    monkeypatch.setattr(JSS, "backend_router", jrouter)
    jws = _WS([types.SimpleNamespace(type=kinds[k][0], data=d) for k, d in messages])
    jws.session = JSS.StreamingSession(ws=jws, **kw)

    trouter = _Router(torch_entry if torch_entry is not None else tentry)
    tws = _WS([TSS.Message(kinds[k][1], d) for k, d in messages])
    tws.session = TSS.StreamingSession(ws=tws, router=trouter, **kw)

    async def serve(ws, pool):
        try:
            await ws.session.run()
        finally:  # batchers the session started end with its loop
            await pool.shutdown_batchers()

    for ws, pool in ((jws, JBP), (tws, TBP)):
        asyncio.run(serve(ws, pool))
    strip = lambda evs: [{k: v for k, v in e.items() if k != "session_id"} for e in evs]  # noqa: E731
    return strip(jws.sent), strip(tws.sent), jrouter, trouter, tws.session


def _beeps(seconds: float, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    clip = rng.normal(0, 0.003, n)
    for i in range(k):
        dur = int(0.15 * SR)
        t = np.arange(dur) / SR
        start = i * (n // k)
        clip[start : start + dur] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
    return np.clip(clip, -1, 1).astype(np.float32)


def _pcm16(audio: np.ndarray) -> bytes:
    return (audio * 32767).astype("<i2").tobytes()


def _frames(data: bytes, size: int) -> list[tuple[str, bytes]]:
    return [("binary", data[i : i + size]) for i in range(0, len(data), size)]


def _kinds(events):
    return [(e["type"], e.get("is_final"), e.get("speech_final")) for e in events]


@pytest.mark.parametrize("seconds", [1.0, 2.0])
def test_session_events_match_jax(monkeypatch, entries, stream_settings, seconds):
    """1.0 s: the final decodes over the incremental states; 2.0 s overflows
    the 1.2 s test-tiny window, so the final takes the executor path."""
    audio = np.concatenate([_beeps(seconds / 2, 3, 1), _beeps(seconds / 2, 2, 2)])
    jev, tev, jr, tr, session = _run_both(monkeypatch, entries, _frames(_pcm16(audio), 3200))
    assert tev == jev
    kinds = _kinds(tev)
    assert kinds[0][0] == "session.begin" and kinds[-1][0] == "session.end"
    assert ("transcript", False, False) in kinds, "no interim transcript"
    assert kinds.count(("transcript", True, True)) == 1
    assert tev[-1]["errors"] == 0 and not session._inc_broken
    assert session._inc_encoder.tail_encodes > 0
    assert len(tr.calls) == len(jr.calls) == (1 if seconds > 1.2 else 0)
    assert tr.calls == jr.calls


def test_session_30s_overflow_final_matches_jax(monkeypatch, entries, stream_settings):
    """An utterance reaching 30 s is finalized mid-stream (on the executor
    path: it overflows the window) and a new one starts. 1 s chunks keep
    the interim count small."""
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_stream_chunk_ms", 1000)
    audio = np.tile(_beeps(1.0, 2, 3), 31)
    jev, tev, jr, tr, _ = _run_both(monkeypatch, entries, _frames(_pcm16(audio), 2 * SR))
    assert tev == jev
    finals = [e for e in tev if e.get("speech_final")]
    assert len(finals) == 2
    assert finals[0]["end"] == 30.0 and finals[1]["start"] == 30.0
    assert len(tr.calls) == len(jr.calls) == 1 and tr.calls == jr.calls


def test_session_config_retune_matches_jax(monkeypatch, entries, stream_settings):
    """A mid-session sample-rate change finalizes the utterance, rebases
    the clock and resamples what follows."""
    first = _pcm16(_beeps(0.6, 2, 4))
    second = _pcm16(_beeps(0.8, 3, 5)[::2])  # 8 kHz
    messages = (
        _frames(first, 3200)
        + [("text", json.dumps({"type": "config", "sample_rate": 8000, "interim_results": True}))]
        + _frames(second, 1600)
    )
    jev, tev, _, _, session = _run_both(monkeypatch, entries, messages)
    assert tev == jev
    assert session.client_sample_rate == 8000 and session.chunk_bytes == 1600
    assert len([e for e in tev if e.get("speech_final")]) == 2


def test_session_mulaw_ingress_matches_jax(monkeypatch, entries, stream_settings):
    audio = _beeps(1.0, 3, 6)[::2]  # 8 kHz telephony
    codes = JA.ulaw_encode((audio * 32767).astype(np.int16)).tobytes()
    jev, tev, _, _, session = _run_both(
        monkeypatch, entries, _frames(codes, 800), sample_rate=8000, encoding="g711_ulaw"
    )
    assert tev == jev
    assert session.encoding == "mulaw" and session.needs_resample
    assert ("transcript", True, True) in _kinds(tev)


def test_mock_backend_falls_back_to_executor_like_jax(monkeypatch, entries, stream_settings):
    """A backend whose entry is not the framework's model: the session
    probes once, then every transcription takes the executor path."""
    audio = _beeps(0.5, 2, 7)
    bogus = {"weights": None}
    jev, tev, jr, tr, session = _run_both(
        monkeypatch, entries, _frames(_pcm16(audio), 3200), jax_entry=bogus, torch_entry=bogus
    )
    assert tev == jev
    assert session._inc_broken and session._inc_encoder is None
    assert len(tr.calls) == len(jr.calls) > 1 and tr.calls == jr.calls
    assert tr.calls[0]["beam_size"] == 1 and tr.calls[0]["language"] == "en"


@pytest.fixture
def batcher_settings(monkeypatch, stream_settings):
    """OS_BATCHER_ENABLED=1 with the incremental encoder off, as the JAX
    package's batcher tests run it; each call's submissions are counted."""
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_batcher_enabled", True)
        monkeypatch.setattr(s, "os_stream_incremental", False)
    counts = {"jax": 0, "torch": 0}

    def counted(name, fn):
        async def wrapper(*args, **kw):
            counts[name] += 1
            return await fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(JBP, "transcribe_pcm_batched", counted("jax", JBP.transcribe_pcm_batched))
    monkeypatch.setattr(TSS, "transcribe_pcm_batched", counted("torch", TSS.transcribe_pcm_batched))
    for pool in (JBP, TBP):
        pool.reset_pool()
    yield counts
    for pool in (JBP, TBP):
        pool.reset_pool()


@pytest.mark.parametrize("seconds", [1.0, 2.0])
def test_session_via_batcher_matches_jax(monkeypatch, entries, batcher_settings, seconds):
    """Every interim and the final go through the shared batcher (2.0 s
    overflows the 1.2 s window: the mel is trimmed, as in JAX)."""
    audio = np.concatenate([_beeps(seconds / 2, 3, 8), _beeps(seconds / 2, 2, 9)])
    jev, tev, jr, tr, session = _run_both(monkeypatch, entries, _frames(_pcm16(audio), 3200))
    assert tev == jev
    kinds = _kinds(tev)
    assert ("transcript", False, False) in kinds and kinds.count(("transcript", True, True)) == 1
    assert tev[-1]["errors"] == 0 and session._inc_encoder is None
    assert tr.calls == jr.calls == []  # no executor fallback
    assert batcher_settings["torch"] == batcher_settings["jax"] == session._transcription_count > 1


def test_concurrent_sessions_share_one_batcher(entries, batcher_settings):
    """Three sessions on one loop: one shared batcher decodes every pass
    and retires every slot."""
    async def go():
        routers = [_Router(entries[1]) for _ in range(3)]
        wss = []
        for i, router in enumerate(routers):
            audio = _beeps(1.0, 2 + i, 20 + i)
            msgs = [TSS.Message(TSS.MsgType.BINARY, d) for _, d in _frames(_pcm16(audio), 3200)]
            ws = _WS(msgs + [TSS.Message(TSS.MsgType.TEXT, json.dumps({"type": "stop"}))])
            ws.session = TSS.StreamingSession(
                ws=ws, router=router, model="test-tiny-eot", language="en", sample_rate=SR,
                interim_results=True, endpointing_ms=300, vad_enabled=False)
            wss.append(ws)
        try:
            await asyncio.wait_for(asyncio.gather(*(ws.session.run() for ws in wss)), 120)
            return wss, routers, TBP.pool_stats()
        finally:
            await TBP.shutdown_batchers()

    wss, routers, stats = asyncio.run(go())
    (batcher,) = stats.values()
    passes = sum(ws.session._transcription_count for ws in wss)
    assert batcher_settings["torch"] == passes == batcher["completed"]
    assert batcher["occupancy"] == 0
    for ws, router in zip(wss, routers):
        assert ws.sent[-1]["type"] == "session.end" and ws.sent[-1]["errors"] == 0
        assert router.calls == []


def test_batcher_is_not_ported_yet(monkeypatch, entries, batcher_settings):
    """The batcher setting no longer refuses a session. An auto-detect
    session whose backend cannot detect a language never rides the
    batcher (it would force English): every pass takes the executor path,
    as in JAX."""
    audio = _beeps(1.5, 3, 10)
    jev, tev, jr, tr, session = _run_both(
        monkeypatch, entries, _frames(_pcm16(audio), 3200), language=None
    )
    assert tev == jev and session._lang_probe_failed
    assert len(tr.calls) == len(jr.calls) > 1 and tr.calls == jr.calls
    assert batcher_settings == {"jax": 0, "torch": 0}


@pytest.mark.parametrize(
    "kw", [dict(sample_rate=4000), dict(sample_rate=200000), dict(encoding="opus"),
           dict(active=10)],
)
def test_endpoint_refusals_match_jax(monkeypatch, entries, kw):
    kw = dict(kw)
    active = kw.pop("active", 0)
    closes = []
    for mod, extra in ((JSS, {}), (TSS, {"router": _Router(entries[1])})):
        monkeypatch.setattr(mod, "_active_sessions", {str(i): None for i in range(active)})
        ws = _WS([])
        asyncio.new_event_loop().run_until_complete(
            mod.streaming_endpoint(ws, **extra, model="test-tiny-eot", **kw)
        )
        closes.append(ws.closed)
    assert closes[0] is not None and closes[1] == closes[0]


def test_local_agreement_matches_jax():
    hypotheses = ["hello", "hello world", "Hello world again", "hello there", "", "a b c"]
    ours, ref = TSS.LocalAgreement2(), JSS.LocalAgreement2()
    for text in hypotheses:
        assert ours.process(text) == ref.process(text)
        assert ours.confirmed_words == ref.confirmed_words
    assert ours.flush() == ref.flush()
