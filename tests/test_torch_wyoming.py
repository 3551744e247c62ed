"""The Wyoming TCP server: the port (``open_speech_tpu_torch/server/
wyoming/``) against the JAX package's, on the CPU.

Both packages' ``start_wyoming_server`` listen on 127.0.0.1 (port 0), and
one client conversation goes to each: ``describe`` (the ``info`` payloads
equal but for the voices of the TTS backends not ported yet), ``transcribe`` of the beeps clip that the
trained fixture ``tests/fixtures/test-tiny-eot`` reads, sent at sample
widths 1, 2 and 4, in two channels and at 8 kHz (the text equal, and equal
at widths 2 and 4 to the port router's text for the same 16 kHz audio), ``synthesize`` on
``tests/torch_tts_common.py``'s Kokoro tree (the samples within 2e-3 plus
one PCM step), VAD gating on one Silero tree (the audio handed to the
router byte-equal), and an unknown event that is ignored. Frames written by
one package's protocol are read by the other's. Last, ``python -m
open_speech_tpu_torch.server`` with ``OS_WYOMING_ENABLED`` serves
``describe`` on its Wyoming port.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import open_speech_tpu.server.wyoming.server as JWS
import open_speech_tpu_torch.server.wyoming.server as TWS
from open_speech_tpu.models.vad import silero as JS
from open_speech_tpu.runtime.router import router as jax_router
from open_speech_tpu.server.wyoming import protocol as JP
from open_speech_tpu_torch.audio.preprocessing import preprocess_stt_audio
from open_speech_tpu_torch.models.vad import silero as TS
from open_speech_tpu_torch.ops import audio as TA
from open_speech_tpu_torch.server.wyoming import protocol as TP
from tests.test_torch_realtime import SPEECH, VAD_THRESHOLD, _tone_and_quiet, tts_pair  # noqa: F401
from tests.test_torch_server import MODEL, backends, both, kokoro  # noqa: F401
from tests.torch_tts_common import TOL_AUDIO, one_torch_thread

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

ROOT = Path(__file__).resolve().parent.parent
SR = 16000


def _beeps(seconds: float, k: int, seed: int) -> np.ndarray:
    """``tests/test_torch_server.py``'s beeps."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    clip = rng.normal(0, 0.003, n)
    for i in range(k):
        dur = int(0.15 * SR)
        t = np.arange(dur) / SR
        clip[i * (n // k): i * (n // k) + dur] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
    return np.clip(clip, -1, 1).astype(np.float32)


async def _conversation(port: int, events: list, until: tuple[str, ...]) -> list:
    """Send ``events``; read replies until one of each type in ``until``
    arrived, in order."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        for event in events:
            await TP.write_event(writer, event)
        replies = []
        for kind in until:
            while True:
                event = await asyncio.wait_for(TP.read_event(reader), 120)
                assert event is not None, f"connection closed before {kind}"
                replies.append(event)
                if event.type == kind:
                    break
        return replies
    finally:
        writer.close()


def _talk_to_both(stt, tts, events, until):
    """(JAX replies, port replies) to one conversation each."""
    async def main():
        out = []
        for module, routers in ((JWS, stt[0:1] + tts[0:1]), (TWS, stt[1:2] + tts[1:2])):
            server = await module.start_wyoming_server(*routers, host="127.0.0.1", port=0)
            try:
                out.append(await _conversation(server.sockets[0].getsockname()[1], events, until))
            finally:
                server.close()
                await server.wait_closed()
        return out

    return asyncio.run(asyncio.wait_for(main(), 300))


@pytest.fixture
def routers(both, backends):
    """(JAX STT router, port STT router), the fixture on both."""
    return jax_router, backends[1]


def _event_tuple(e):
    return e.type, e.data, e.payload


# ── describe, unknown events ────────────────────────────────────────────


def test_describe_matches_jax(routers, tts_pair):
    """The info equals JAX's, Piper's and Pocket's voices included."""
    jax_replies, port_replies = _talk_to_both(routers, tts_pair, [TP.Event("bogus-event", {"x": 1}),
                                                                 TP.Event("describe")], ("info",))
    (info,), (want,) = port_replies, jax_replies
    voices = [v["name"] for v in want.data["tts"][0]["voices"]]
    assert len(voices) == 52 + 30 + 8 and sum(v.startswith("pocket/") for v in voices) == 8
    assert _event_tuple(info) == _event_tuple(want)
    names = [m["name"] for m in info.data["asr"][0]["models"]]
    assert len(names) == 8 and names[0] == "whisper-tiny"
    assert info.data["tts"][0]["voices"] and info.data["asr"][0]["version"] == "0.1.0"


# ── transcribe ──────────────────────────────────────────────────────────


def _sent_as(audio: np.ndarray, case: str) -> tuple[bytes, dict]:
    """The clip's bytes and audio-chunk metadata for a transcribe case."""
    ints = (audio * 32767).astype(np.int16)
    if case == "8k":
        return ints[::2].astype("<i2").tobytes(), {"rate": 8000, "width": 2, "channels": 1}
    if case == "width-1":
        return ((ints >> 8) + 128).astype(np.uint8).tobytes(), {"rate": SR, "width": 1, "channels": 1}
    if case == "width-4":
        low = np.random.default_rng(0).integers(0, 1 << 16, ints.size)
        return ((ints.astype(np.int64) << 16) | low).astype("<i4").tobytes(), {"rate": SR, "width": 4,
                                                                                  "channels": 1}
    if case == "stereo":
        right = (ints // 2).astype(np.int16)
        return np.stack([ints, right], 1).astype("<i2").tobytes(), {"rate": SR, "width": 2, "channels": 2}
    return ints.astype("<i2").tobytes(), {"rate": SR, "width": 2, "channels": 1}


def _transcribe_events(payload: bytes, meta: dict, **data) -> list:
    step = meta["rate"] // 10 * meta["width"] * meta["channels"]
    return ([TP.Event("transcribe", {"name": MODEL, **data}), TP.Event("audio-start", meta)]
            + [TP.Event("audio-chunk", meta, payload[i:i + step]) for i in range(0, len(payload), step)]
            + [TP.Event("audio-stop")])


@pytest.mark.parametrize("case,language", [
    ("width-2", None), ("width-1", "en"), ("width-4", None), ("stereo", "en"), ("8k", None)])
def test_transcribe_matches_jax(both, routers, monkeypatch, case, language):
    both(stt_vad_enabled=False)
    payload, meta = _sent_as(_beeps(1.0, 3, 1), case)
    events = _transcribe_events(payload, meta, **({"language": language} if language else {}))
    jax_replies, port_replies = _talk_to_both(routers, (None, None), events, ("transcript",))
    assert [_event_tuple(e) for e in port_replies] == [_event_tuple(e) for e in jax_replies]
    text = port_replies[-1].data["text"]
    assert text.strip()
    if case in ("width-2", "width-4"):  # the same 16-bit samples: the router's own text
        wav = preprocess_stt_audio(TA.pcm16_to_wav(_sent_as(_beeps(1.0, 3, 1), "width-2")[0], SR),
                                   noise_reduce=False, normalize=True)
        direct = routers[1].transcribe(audio=wav, model=MODEL, language=language, response_format="json",
                                       temperature=0.0)
        assert text == direct["text"]


def test_transcribe_of_nothing_sends_no_transcript(both, routers):
    """audio-stop without chunks answers nothing; describe still answers."""
    both(stt_vad_enabled=False)
    events = [TP.Event("transcribe", {"name": MODEL}), TP.Event("audio-stop"), TP.Event("describe")]
    jax_replies, port_replies = _talk_to_both(routers, (None, None), events, ("info",))
    assert [e.type for e in port_replies] == [e.type for e in jax_replies] == ["info"]


def test_vad_gating_matches_jax(both, routers, monkeypatch):
    """With the VAD on (one Silero tree on both sides), the speech segments
    alone reach the router: the same bytes and the same text."""
    params = JS.init_vad_params(jax.random.PRNGKey(3))
    model = TS.vad_params_from_jax_tree(jax.tree.map(np.asarray, params))
    audio = _tone_and_quiet("qtttqqqqttq", SR)
    pcm = (audio * 32767).astype("<i2").tobytes()
    track = TS.SileroVAD(model)._prob_track(TA.pcm16_to_float(pcm))
    assert np.abs(track - VAD_THRESHOLD).min() > 1e-4
    both(stt_vad_enabled=True, stt_vad_threshold=VAD_THRESHOLD)

    async def jax_vad():
        return JS.SileroVAD(params)

    devices = []
    monkeypatch.setattr(JWS, "get_vad_model", jax_vad)
    monkeypatch.setattr(TWS, "get_vad_model", lambda device: devices.append(str(device)) or TS.SileroVAD(model))
    heard = {"jax": [], "torch": []}
    for name, router in (("jax", routers[0]), ("torch", routers[1])):
        real = router.transcribe

        def transcribe(*a, _real=real, _name=name, **kw):
            heard[_name].append(kw["audio"])
            return _real(*a, **kw)

        monkeypatch.setattr(router, "transcribe", transcribe)
    payload, meta = _sent_as(audio, "width-2")
    jax_replies, port_replies = _talk_to_both(routers, (None, None), _transcribe_events(payload, meta),
                                              ("transcript",))
    assert [_event_tuple(e) for e in port_replies] == [_event_tuple(e) for e in jax_replies]
    assert heard["torch"] == heard["jax"] and len(heard["torch"]) == 1
    gated, _ = TA.read_wav(heard["torch"][0])
    assert 0 < gated.size < audio.size  # the quiet stretches were cut
    assert devices == ["cpu"]


# ── synthesize ──────────────────────────────────────────────────────────


def test_synthesize_matches_jax(both, tts_pair):
    events = [TP.Event("synthesize", {"text": SPEECH, "voice": {"name": "af_bella"}})]
    jax_replies, port_replies = _talk_to_both((None, None), tts_pair, events, ("audio-stop",))
    assert [(e.type, e.data) for e in port_replies] == [(e.type, e.data) for e in jax_replies]
    assert [len(e.payload) for e in port_replies] == [len(e.payload) for e in jax_replies]
    got = TA.pcm16_to_float(b"".join(e.payload for e in port_replies))
    want = TA.pcm16_to_float(b"".join(e.payload for e in jax_replies))
    assert got.size > SR // 2
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO + 2 / 32768)


# ── the wire format, the width conversion ───────────────────────────────

FRAMES = [
    JP.Event("describe"),
    JP.Event("transcribe", {"name": "whisper-tiny", "language": "en"}),
    JP.Event("audio-chunk", {"rate": 16000, "width": 2, "channels": 1}, bytes(range(256)) * 3),
    JP.Event("synthesize", {"text": "héllo\nwörld", "voice": {"name": "af_heart"}}),
]


class _Writer:
    def __init__(self) -> None:
        self.data = bytearray()

    def write(self, data: bytes) -> None:
        self.data += data

    async def drain(self) -> None:
        pass


@pytest.mark.parametrize("writer_pkg,reader_pkg", [(JP, TP), (TP, JP), (TP, TP)],
                         ids=["jax-to-port", "port-to-jax", "port-to-port"])
def test_frames_cross_between_packages(writer_pkg, reader_pkg):
    async def main():
        out = _Writer()
        for e in FRAMES:
            await writer_pkg.write_event(out, writer_pkg.Event(e.type, e.data, e.payload))
        # a frame with a separate data block, as the wyoming package writes it
        extra = json.dumps({"text": "more"}).encode()
        out.data += json.dumps({"type": "synthesize", "data": {"a": 1}, "data_length": len(extra),
                                "payload_length": 3}).encode() + b"\n" + extra + b"xyz"
        out.data += b"not json\n"
        reader = asyncio.StreamReader()
        reader.feed_data(bytes(out.data))
        reader.feed_eof()
        return [await reader_pkg.read_event(reader) for _ in range(len(FRAMES) + 3)], bytes(out.data)

    got, wire = asyncio.run(main())
    want = [(e.type, e.data, e.payload) for e in FRAMES] + [("synthesize", {"a": 1, "text": "more"}, b"xyz")]
    assert [_event_tuple(e) for e in got[:-2]] == want
    assert got[-2:] == [None, None]  # a line that is not JSON ends the stream, then EOF


def test_protocol_writes_the_same_bytes_as_jax():
    async def main(pkg):
        out = _Writer()
        for e in FRAMES:
            await pkg.write_event(out, pkg.Event(e.type, e.data, e.payload))
        return bytes(out.data)

    assert asyncio.run(main(TP)) == asyncio.run(main(JP))


def test_pcm_width_conversion_matches_jax():
    rng = np.random.default_rng(2)
    for width, n in ((1, 301), (4, 1203), (4, 1200)):
        pcm = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert TWS._pcm_to_16bit(pcm, width) == JWS._pcm_to_16bit(pcm, width)
    for module in (TWS, JWS):
        with pytest.raises(ValueError, match="unsupported Wyoming PCM width: 3"):
            module._pcm_to_16bit(b"\x00" * 6, 3)


# ── the server process ──────────────────────────────────────────────────


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_server_serves_wyoming(tmp_path):
    """``OS_WYOMING_ENABLED=true python -m open_speech_tpu_torch.server``
    opens the Wyoming port beside HTTP; ``describe`` gets the info, and
    SIGTERM ends the process cleanly."""
    port, wport = _free_port(), _free_port()
    env = dict(os.environ, OS_PORT=str(port), OS_HOST="127.0.0.1", OS_SSL_ENABLED="false",
               OS_WYOMING_ENABLED="true", OS_WYOMING_PORT=str(wport), STT_DEVICE="cpu",
               TTS_ENABLED="false", STT_PRELOAD_MODELS="", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-m", "open_speech_tpu_torch.server"], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    async def describe():
        deadline = time.monotonic() + 90
        while True:
            try:
                return await _conversation(wport, [TP.Event("describe")], ("info",))
            except OSError:
                assert time.monotonic() < deadline and proc.poll() is None, "the Wyoming port did not open"
                await asyncio.sleep(0.2)

    try:
        (info,) = asyncio.run(asyncio.wait_for(describe(), 120))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert info.type == "info" and info.data["asr"][0]["name"] == "open-speech"
    assert proc.returncode == 0, out.decode(errors="replace")[-2000:]
    assert f"Wyoming server listening on 127.0.0.1:{wport}".encode() in out
