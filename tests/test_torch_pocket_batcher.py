"""Pocket's slot-pool batcher and serving of the port, held against the JAX
package on the CPU (the weights of ``tests/torch_pocket_common.py``).

- **The batcher**: ``tests/test_pocket_batcher.py``'s eight behaviours on
  the port (a row equals its solo ``generate_stream``, the exact final
  partial block, concurrent rows independent, recycled slots, a late join
  mid-flight, queueing beyond the slots, ``stop`` failing what is pending,
  an exhausted context emitting nothing), each within ``TOL_PCM``; and
  four jobs admitted in one wave through both packages' batchers: every
  Mimi block each row decodes holds JAX's tokens exactly, and the PCM
  within ``TOL_PCM``. A cached prompt state is only read.
- **The backend** with the batcher on equals it off; a failed warmup is
  logged and the model stays loaded; ``unload_model`` releases the pool
  and the prompt cache; the registry's stats and reset.
- **The routes**, both apps on the same weights through
  ``tests/test_torch_server.py``'s harness: ``/v1/audio/speech`` with
  ``pocket/alice``, a base64 ``reference_audio``, raw bytes that do not
  decode, and ``voice_design``, whole (WAV) and streamed (PCM);
  ``/v1/audio/speech/clone`` (WAV) and its 400s, 413 and 500 (mp3 without
  ffmpeg); the capabilities and voices routes. Equal means the status and
  ``Content-Type``, JSON bodies as the harness compares them, and audio of
  the same length within ``TOL_PCM`` plus two PCM steps (the shared trim
  and peak normalisation, then int16).
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time

import numpy as np
import pytest
import torch

import open_speech_tpu.runtime.pocket_batcher as JB
import open_speech_tpu_torch.models.pocket.lm as TL
import open_speech_tpu_torch.models.pocket.model as TMo
import open_speech_tpu_torch.runtime.pocket_batcher as TB
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.ops import audio as JA
from open_speech_tpu.server import app as JAPP
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.runtime.router import BackendRouter
from open_speech_tpu_torch.tts.router import TTSRouter
from tests.torch_pocket_common import TLM, models, one_thread

TOL_PCM = 2e-5  # PCM of a row against its reference, max abs (|pcm| < 1)

_one_thread = pytest.fixture(scope="module", autouse=True)(one_thread)


@pytest.fixture(scope="module")
def pair():
    return models()


@pytest.fixture()
def batcher(pair):
    b = TB.PocketBatcher(pair[1], slots=4, block_frames=2)
    yield b
    b.stop(wait=True)


def _solo(tm, text, state=None, max_frames=None):
    kw = {"block_frames": 2}
    if max_frames is not None:
        kw["max_frames"] = max_frames
    blocks = list(tm.generate_stream(text, state, **kw))
    return np.concatenate(blocks) if blocks else np.zeros((0,), np.float32)


def _batched(b, text, state=None, max_frames=None):
    blocks = list(b.synthesize(text, state, max_frames))
    return np.concatenate(blocks) if blocks else np.zeros((0,), np.float32)


def _close(got, want, tol=TOL_PCM):
    assert got is not None and got.shape == want.shape and got.size
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _prompt(tm):
    return np.sin(np.linspace(0, 80.0, 2 * tm.mimi_cfg.samples_per_frame)).astype(np.float32)


# ── JAX's eight batcher behaviours, on the port ─────────────────────────


def test_single_job_matches_solo(pair, batcher):
    _close(_batched(batcher, "hello world", max_frames=6), _solo(pair[1], "hello world", max_frames=6))


def test_partial_final_block(pair, batcher):
    """A frame budget not divisible by the block emits the exact tail."""
    _close(_batched(batcher, "odd", max_frames=5), _solo(pair[1], "odd", max_frames=5))


def test_concurrent_rows_are_independent(pair, batcher):
    """Different texts and voices batched together == each alone; the
    cached prompt state is only read."""
    tm = pair[1]
    state = tm.state_for_audio_prompt(_prompt(tm))
    k0 = state.k_cache.clone()
    prompts = [("the quick brown fox", None, 8), ("jumps over", None, 6), ("a lazy dog", None, 5),
               ("cloned voice", state, 6)]
    refs = [_solo(tm, t, s, m) for t, s, m in prompts]
    results: list = [None] * len(prompts)
    errs: list = []

    def run(i):
        try:
            results[i] = _batched(batcher, *prompts[i])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errs, errs
    for got, ref in zip(results, refs):
        _close(got, ref)
    assert batcher.stats["peak_live"] >= 2  # they shared the pool
    assert torch.equal(state.k_cache, k0)


def test_slot_recycling_after_completion(pair, batcher):
    """More sequential jobs than slots: recycled rows stay exact."""
    ref = _solo(pair[1], "again", max_frames=4)
    for _ in range(6):
        _close(_batched(batcher, "again", max_frames=4), ref)


def test_late_join_mid_flight(pair, batcher):
    tm = pair[1]
    ref_a = _solo(tm, "first utterance going long", max_frames=12)
    ref_b = _solo(tm, "late", max_frames=4)
    got_a: list = []
    done_a = threading.Event()

    def run_a():
        for blk in batcher.synthesize("first utterance going long", None, 12):
            got_a.append(blk)
        done_a.set()

    th = threading.Thread(target=run_a)
    th.start()
    t0 = time.time()
    while not got_a and time.time() - t0 < 60:  # the pool is mid-flight once a block is out
        time.sleep(0.005)
    assert got_a, "first stream produced nothing in 60s"
    got_b = _batched(batcher, "late", max_frames=4)
    th.join(timeout=60)
    assert done_a.is_set()
    _close(np.concatenate(got_a), ref_a)
    _close(got_b, ref_b)


def test_queueing_beyond_slots(pair):
    tm = pair[1]
    b = TB.PocketBatcher(tm, slots=2, block_frames=2)
    try:
        ref = _solo(tm, "overflow", max_frames=4)
        results: list = [None] * 5
        errs: list = []

        def run(i):
            try:
                results[i] = _batched(b, "overflow", max_frames=4)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert not errs, errs
        for got in results:
            _close(got, ref)
    finally:
        b.stop(wait=True)


def test_stop_fails_pending(pair):
    b = TB.PocketBatcher(pair[1], slots=2, block_frames=2)
    list(b.synthesize("warm", None, 4))
    b.stop(wait=True)
    assert b._kc is None and b.model is None  # the pool is released
    with pytest.raises(RuntimeError):
        list(b.synthesize("after stop", None, 4))


def test_context_exhausted_emits_nothing(pair):
    tm = pair[1]
    b = TB.PocketBatcher(tm, slots=2, block_frames=2)
    try:
        state = TMo.PromptState(*TL.init_caches(TLM, 1), length=TLM.max_ctx - 2)
        assert list(b.synthesize("text", state, 4)) == []
    finally:
        b.stop(wait=True)


# ── the port's batcher against JAX's ────────────────────────────────────


def _blocks_per_row(monkeypatch, module) -> dict:
    """Wrap ``module._mimi_group``: the token blocks each row decodes."""
    log: dict = {}
    real = module._mimi_group

    def logged(mimi_params, cfg, tokens, state, reset_mask, decode_mask):
        toks, decode = np.asarray(tokens), np.asarray(decode_mask)
        for row in np.flatnonzero(decode):
            log.setdefault(int(row), []).append(toks[row].copy())
        return real(mimi_params, cfg, tokens, state, reset_mask, decode_mask)

    monkeypatch.setattr(module, "_mimi_group", logged)
    return log


def _one_wave(module, b, jobs) -> list[np.ndarray]:
    """Queue every job before the scheduler starts, so both packages admit
    them in one wave in this order (rows 0, 1, ...); each job's PCM."""
    outs = []
    for text, state, frames in jobs:
        out: queue.Queue = queue.Queue()
        b._queue.put(module._Job(text, state, out, frames))
        outs.append(out)
    b._ensure_thread()
    pcm = []
    for out in outs:
        blocks = []
        while (item := out.get(timeout=120)) is not None:
            assert not isinstance(item, Exception), item
            blocks.append(np.asarray(item))
        pcm.append(np.concatenate(blocks))
    return pcm


def test_batcher_tokens_equal_the_jax_batchers(pair, monkeypatch):
    jm, tm = pair
    jstate, tstate = jm.state_for_audio_prompt(_prompt(tm)), tm.state_for_audio_prompt(_prompt(tm))
    jobs = [("the quick brown fox", "voice", 9), ("jumps over", None, 5), ("a lazy dog", "voice", 6),
            ("hi", None, 3)]
    jlog, tlog = _blocks_per_row(monkeypatch, JB), _blocks_per_row(monkeypatch, TB)
    jb, tb = JB.PocketBatcher(jm, slots=4, block_frames=2), TB.PocketBatcher(tm, slots=4, block_frames=2)
    try:
        want = _one_wave(JB, jb, [(t, jstate if s else None, f) for t, s, f in jobs])
        got = _one_wave(TB, tb, [(t, tstate if s else None, f) for t, s, f in jobs])
    finally:
        jb.stop()
        tb.stop(wait=True)
    assert sorted(tlog) == sorted(jlog) == [0, 1, 2, 3]
    for row in range(4):
        assert len(tlog[row]) == len(jlog[row]) == -(-jobs[row][2] // 2)
        assert all(np.array_equal(t, j) for t, j in zip(tlog[row], jlog[row])), row
    for g, w in zip(got, want):
        _close(g, w)


# ── the backend ─────────────────────────────────────────────────────────


def _backend(tm):
    from open_speech_tpu_torch.tts.backends.pocket_tts import PocketTTSBackend

    b = PocketTTSBackend(device="cpu")
    b._model, b._loaded_at = tm, time.time()
    return b


def test_backend_batcher_on_equals_off_and_unload_releases_it(pair, monkeypatch):
    monkeypatch.setattr(torch_settings, "os_pocket_batch_slots", 4)
    b = _backend(pair[1])
    wav = JA.write_wav(_prompt(pair[1]), 24000)
    monkeypatch.setattr(torch_settings, "os_tts_batcher_enabled", False)
    off = np.concatenate(list(b.synthesize("served twice", "x", reference_audio=wav)))
    monkeypatch.setattr(torch_settings, "os_tts_batcher_enabled", True)
    on = np.concatenate(list(b.synthesize("served twice", "x", reference_audio=wav)))
    _close(on, off)
    stats = TB.pocket_batcher_stats()
    assert stats[str(id(b))]["jobs"] == 1 and len(b._prompt_cache) == 1
    pool = TB._batchers[id(b)]
    b.unload_model()
    assert id(b) not in TB._batchers and pool._kc is None and not pool._thread.is_alive()
    assert b._model is None and b._prompt_cache == {} and b.loaded_models() == []


def test_a_failed_warmup_is_logged_and_the_model_stays(monkeypatch, caplog):
    from open_speech_tpu_torch.tts.backends.pocket_tts import PocketTTSBackend

    monkeypatch.setattr(torch_settings, "os_precompile_on_load", True)
    monkeypatch.setenv("OS_POCKET_CKPT_PATH", "")

    def boom(self, *a, **kw):
        raise RuntimeError("no room on the card")

    monkeypatch.setattr(TMo.PocketTTS, "generate_stream", boom)
    b = PocketTTSBackend(device="cpu")
    with caplog.at_level("ERROR"):
        b.load_model()
    assert b.is_model_loaded("pocket-tts") and "pocket-tts warmup failed" in caplog.text
    assert b._model.lm_cfg.d_model == TLM.d_model and b._model.lm_cfg.max_ctx == 512  # the tiny preset
    assert [m.model for m in b.loaded_models()] == ["pocket-tts"]


def test_reset_pocket_batchers_stops_every_batcher(pair):
    b = _backend(pair[1])
    batcher = TB.get_pocket_batcher(b)
    assert TB.get_pocket_batcher(b) is batcher and str(id(b)) in TB.pocket_batcher_stats()
    TB.reset_pocket_batchers()
    assert TB.pocket_batcher_stats() == {} and batcher._stopping


# ── the routes, on both apps ────────────────────────────────────────────


@pytest.fixture()
def served(pair, monkeypatch):
    """Both apps serving Pocket on the pair's weights (fresh prompt caches,
    batcher off), and the port's TTS router."""
    jm, tm = pair
    jback = JAPP.tts_router.get_backend("pocket-tts")
    monkeypatch.setattr(jback, "_model", jm)
    monkeypatch.setattr(jback, "_prompt_cache", {})
    monkeypatch.setattr(jback, "_device_arg", "cpu")
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_tts_batcher_enabled", False)
        monkeypatch.setattr(s, "tts_enabled", True)
    monkeypatch.setattr(jax_settings, "os_history_enabled", False)
    tts = TTSRouter(device="cpu")
    tts.get_backend("pocket-tts")._model = tm
    return tts


def _speech(body, stream=False):
    path = "/v1/audio/speech" + ("?stream=true" if stream else "")
    return ("POST", path, None, {"json": body})


def _clone(fmt="wav", ref=None, model="pocket-tts", text="Clone this voice please.", **fields):
    from aiohttp import FormData

    def make():
        form = FormData()
        form.add_field("input", text)
        form.add_field("model", model)
        form.add_field("response_format", fmt)
        for key, value in fields.items():
            form.add_field(key, value)
        if ref is not None:
            form.add_field("reference_audio", ref, filename="ref.wav", content_type="audio/wav")
        return form

    return ("POST", "/v1/audio/speech/clone", make, {})


def _audio(ctype: str, body: bytes) -> np.ndarray:
    if ctype == "audio/wav":
        samples, rate = JA.read_wav(body)
        assert rate == 24000
        return samples
    return JA.pcm16_to_float(body)


def _same_answer(jax, port):
    from tests.test_torch_server import _same

    (js, jh, jb), (ts, th, tb) = jax, port
    if js != 200 or not jh.get("Content-Type", "").startswith("audio/"):
        _same(jax, port)
        return
    assert ts == 200 and th.get("Content-Type") == jh.get("Content-Type"), (ts, tb[:300])
    want, got = _audio(jh["Content-Type"], jb), _audio(th["Content-Type"], tb)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=TOL_PCM + 2 / 32768, rtol=0)


def _ref_wav(freq: float = 200.0, rate: int = 16000) -> bytes:
    t = np.arange(rate) / rate
    return JA.write_wav((0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32), rate)


def test_speech_and_clone_routes_answer_as_the_jax_app(served, monkeypatch):
    from tests.test_torch_server import _ask_both

    ref = _ref_wav()
    text = "Hello there."
    calls = [
        _speech({"model": "pocket-tts", "voice": "pocket/alice", "input": text, "response_format": "wav"}),
        _speech({"model": "pocket-tts", "voice": "pocket/alice", "input": text, "response_format": "pcm"}, True),
        _speech({"model": "pocket-tts", "input": text, "response_format": "wav",
                 "reference_audio": base64.b64encode(ref).decode(), "clone_transcript": "a tone"}),
        _speech({"model": "pocket-tts", "input": text, "response_format": "pcm",
                 "reference_audio": base64.b64encode(ref).decode()}, True),
        _speech({"model": "pocket-tts", "input": text, "response_format": "wav", "reference_audio": "not@base64!"}),
        _speech({"model": "pocket-tts", "input": text, "response_format": "wav",
                 "voice_design": "a warm narrator"}),
        _speech({"model": "pocket-tts", "input": text, "response_format": "pcm",
                 "voice_design": "a warm narrator"}, True),
        _speech({"model": "kokoro", "input": text, "voice_design": "a warm narrator"}),
        _speech({"model": "kokoro", "input": text, "reference_audio": "abc"}),
        _clone(ref=ref, transcript="a tone", voice="pocket/bob", language="en"),
        _clone(ref=ref, fmt="pcm"),
        _clone(ref=ref, model="kokoro"),
        _clone(ref=b""),
        _clone(ref=ref, fmt="mp3"),
        _clone(ref=ref, text="  "),
        ("GET", "/api/tts/capabilities?model=pocket-tts", None, {}),
        ("GET", "/v1/audio/voices?model=pocket-tts", None, {}),
    ]
    answers = _ask_both(BackendRouter(device="cpu"), calls, tts_router=served)
    for (jax_answer, port_answer), call in zip(answers, calls):
        try:
            _same_answer(jax_answer, port_answer)
        except AssertionError as e:
            raise AssertionError(f"{call[:2]}: {e}") from e
    statuses = [port[0] for _, port in answers]
    # raw bytes that are no WAV fail the clone's read: a 500 on both
    assert statuses == [200] * 4 + [500] + [200] * 2 + [400, 400, 200, 200, 400, 400, 500, 400, 200, 200]
    voices = json.loads(answers[-1][1][2])["voices"]
    assert [v["id"] for v in voices] == [f"pocket/{s}" for s in
                                          ("alice", "bob", "carol", "dave", "eve", "frank", "grace", "henry")]
    # too large: one byte over a 0 MB limit (the apps' own limit is off at 0)
    monkeypatch.setattr(jax_settings, "os_max_upload_mb", 0)
    monkeypatch.setattr(torch_settings, "os_max_upload_mb", 0)
    [(jax_answer, port_answer)] = _ask_both(BackendRouter(device="cpu"), [_clone(ref=ref)], tts_router=served)
    _same_answer(jax_answer, port_answer)
    assert port_answer[0] == 413


def test_clone_with_a_voice_library_ref_names_its_queue_item(served):
    from tests.test_torch_server import _ask_both

    [(_, port)] = _ask_both(BackendRouter(device="cpu"), [_clone(voice_library_ref="narrator")], tts_router=served)
    assert port[0] == 500
    assert json.loads(port[2])["error"]["message"] == "the voice library is not ported yet: ROADMAP.md module item 1"
