"""The port's client SDK (``open_speech_tpu_torch.client``, on the stdlib)
against the JAX package's (httpx and websockets).

``tests/test_client_sdk.py``'s seven cases run as one test parametrised
over both clients: each case runs as written there, against the same
``websockets.sync.server`` fakes, with that module's ``OpenSpeechClient``
swapped for the client under test.

Then the port's client against the port's app (``create_app`` over a CPU
``BackendRouter`` with the trained fixture ``tests/fixtures/test-tiny-eot``,
served on 127.0.0.1): ``transcribe`` returns the direct call's body, a
``stream_transcribe`` session ends with the final transcript the
``websockets`` client gets from the same audio, and a ``RealtimeSession``
(sync and async) commit gives the transcript of the served session of
``tests/test_torch_realtime.py``. The client imports neither httpx,
websockets nor torch.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import websockets

import open_speech_tpu.client as JC
import open_speech_tpu_torch.client as TC
import tests.test_client_sdk as SDK
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response
from open_speech_tpu_torch.server.app import create_app
from open_speech_tpu_torch.server.http import serve_app
from open_speech_tpu_torch.tts.router import TTSRouter
from tests.test_torch_backend import _clips
from tests.test_torch_realtime import COMMIT, _appends, _beeps, _pcm16, _served_session
from tests.test_torch_server import FIXTURES, MODEL, ROOT

CASES = ["test_ws_url_scheme", "test_headers_with_api_key",
         "test_stream_transcribe_against_fake_server",
         "test_async_stream_transcribe_against_fake_server",
         "test_stream_transcribe_reconnect_limit",
         "test_stream_transcribe_source_error_surfaces",
         "test_stream_transcribe_early_session_end_is_terminal"]
SR = 16000
NO_VAD = {"type": "session.update", "session": {"turn_detection": None}}
DONE = "conversation.item.input_audio_transcription.completed"


@pytest.mark.parametrize("client", [JC.OpenSpeechClient, TC.OpenSpeechClient], ids=["jax", "port"])
@pytest.mark.parametrize("case", CASES)
def test_sdk_case(case, client, monkeypatch):
    monkeypatch.setattr(SDK, "OpenSpeechClient", client)
    getattr(SDK, case)()


def test_client_imports_no_httpx_websockets_or_torch():
    probe = ("import sys, open_speech_tpu_torch.client; "
             "print(sorted(m for m in ('httpx', 'websockets', 'torch', 'numpy') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    assert out == "[]"


# ── against the port's served app ───────────────────────────────────────


@pytest.fixture(scope="module")
def router():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(settings, "stt_model_dir", str(FIXTURES))
        mp.setattr(settings, "os_precompile_on_load", False)
        mp.setattr(settings, "stt_compute_type", "float32")
        trouter = BackendRouter(device="cpu")
        trouter.load_model(MODEL)
        yield trouter


@pytest.fixture
def served(router, monkeypatch):
    """The port's app on 127.0.0.1 in a loop on a thread of its own; yields
    (base URL, the loop)."""
    for key, value in (("stt_model_dir", str(FIXTURES)), ("os_stream_incremental", True),
                       ("os_batcher_enabled", False), ("os_stream_chunk_ms", 100),
                       ("os_tts_batcher_enabled", False), ("os_history_enabled", False)):
        monkeypatch.setattr(settings, key, value)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(300)

    app = create_app(stt_router=router, tts_router=TTSRouter(device="cpu"))
    server = run(serve_app(app, "127.0.0.1", 0))
    try:
        yield f"127.0.0.1:{server.port}", run
    finally:
        run(server.close())
        run(app.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()


def test_transcribe_equals_the_direct_call(router, served):
    base, _ = served
    client = TC.OpenSpeechClient(f"http://{base}")
    for name, clip in _clips().items():
        wav = codec.write_wav(clip, SR)
        assert client.transcribe(wav, model=MODEL) == transcription_response(router, wav, model=MODEL), name
    with pytest.raises(TC.HTTPStatusError) as e:
        client.transcribe(b"not a wav", model=MODEL)
    assert 400 <= e.value.status < 500


def test_stream_transcribe_final_equals_the_websockets_clients(served):
    base, _ = served
    audio = np.concatenate([_beeps(1.0, 3, 7, rate=SR), np.zeros(SR // 2, np.float32)])
    frames = [_pcm16(audio[i:i + SR // 10]) for i in range(0, len(audio), SR // 10)]
    url = f"ws://{base}/v1/audio/stream?model={MODEL}&sample_rate={SR}&vad=false"

    async def reference():
        async with websockets.connect(url) as ws:
            events = [json.loads(await ws.recv())]
            for frame in frames:
                await ws.send(frame)
            await ws.send(json.dumps({"type": "stop"}))
            async for raw in ws:
                events.append(json.loads(raw))
            return events

    want = asyncio.run(asyncio.wait_for(reference(), 300))
    got = list(TC.OpenSpeechClient(f"http://{base}").stream_transcribe(
        iter(frames), model=MODEL, vad=False))

    def finals(events):
        return [e["text"] for e in events if e["type"] == "transcript" and e.get("speech_final")]

    assert got[0]["type"] == "session.begin" and got[-1]["type"] == "session.end"
    assert finals(got) == finals(want) and finals(got)[0]


def test_realtime_commit_equals_the_served_session(served):
    base, _ = served
    wire = _pcm16(_beeps(1.0, 3, 7))
    _, events = asyncio.run(asyncio.wait_for(
        _served_session(base, [NO_VAD] + _appends(wire, 4800) + [COMMIT]), 300))
    want = [e["transcript"] for e in events if e["type"] == DONE]
    assert len(want) == 1 and want[0]

    got, arrived = [], threading.Event()

    def on_transcript(evt):
        if evt["type"] == DONE:
            got.append(evt["transcript"])
            arrived.set()

    session = TC.OpenSpeechClient(f"http://{base}").realtime_session(model=MODEL)
    try:
        assert session._ws.subprotocol == "realtime"
        session.on_transcript(on_transcript)
        session._send(NO_VAD)
        for i in range(0, len(wire), 4800):
            session.send_audio(wire[i:i + 4800])
        session.commit()
        assert arrived.wait(300)
    finally:
        session.close()
    assert got == want

    async def async_session():
        sess = await TC.OpenSpeechClient(f"http://{base}").async_realtime_session(model=MODEL)
        done = asyncio.get_running_loop().create_future()

        async def on_done(evt):
            if evt["type"] == DONE and not done.done():
                done.set_result(evt["transcript"])

        try:
            sess.on_transcript(on_done)
            await sess._send(NO_VAD)
            for i in range(0, len(wire), 4800):
                await sess.send_audio(wire[i:i + 4800])
            await sess.commit()
            return await asyncio.wait_for(done, 300)
        finally:
            await sess.close()

    assert asyncio.run(async_session()) == want[0]
