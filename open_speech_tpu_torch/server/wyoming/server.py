"""Wyoming TCP server (Home Assistant's voice pipeline).

Counterpart of ``open_speech_tpu/server/wyoming/server.py``: the same
describe/transcribe/audio-chunk/audio-stop/synthesize events and replies.
STT path: join chunks -> VAD speech-segment extraction -> WAV wrap ->
preprocess -> transcribe. TTS path: synth -> postprocess -> resample to
16 kHz -> audio-start/chunk/stop events. Resampling and the VAD run on the
STT backend's device (the VAD's as ``OS_VAD_DEVICE`` resolves it).
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

from open_speech_tpu_torch import __version__
from open_speech_tpu_torch.audio.postprocessing import process_tts_chunks
from open_speech_tpu_torch.audio.preprocessing import preprocess_stt_audio
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.vad.silero import SileroVAD, get_vad_model
from open_speech_tpu_torch.ops.audio import float_to_pcm16, pcm16_to_wav
from open_speech_tpu_torch.ops.resample import resample_pcm16
from open_speech_tpu_torch.runtime.registry import get_known_models
from open_speech_tpu_torch.server.wyoming.protocol import Event, read_event, write_event
from open_speech_tpu_torch.tts.backends.base import backend_sample_rate

logger = logging.getLogger(__name__)

WYOMING_SAMPLE_RATE = 16000


def build_info(stt_router, tts_router) -> dict:
    """The capability ``info`` payload."""
    asr_models = [
        {
            "name": m["id"],
            "description": m.get("description", ""),
            "attribution": {"name": "open-speech-tpu", "url": ""},
            "installed": True,
            "languages": ["en"],
            "version": __version__,
        }
        for m in get_known_models() if m["type"] == "stt"
    ][:8]
    tts_voices = []
    try:
        for v in tts_router.list_voices():
            tts_voices.append(
                {
                    "name": v.id,
                    "description": v.name,
                    "attribution": {"name": "open-speech-tpu", "url": ""},
                    "installed": True,
                    "languages": [v.language or "en"],
                    "version": __version__,
                }
            )
    except Exception:  # noqa: BLE001 — an info without voices, as the JAX server sends it
        pass
    return {
        "asr": [
            {
                "name": "open-speech",
                "description": "Open Speech TPU STT",
                "attribution": {"name": "open-speech-tpu", "url": ""},
                "installed": True,
                "version": __version__,
                "models": asr_models,
            }
        ],
        "tts": [
            {
                "name": "open-speech",
                "description": "Open Speech TPU TTS",
                "attribution": {"name": "open-speech-tpu", "url": ""},
                "installed": True,
                "version": __version__,
                "voices": tts_voices,
            }
        ],
    }


def _pcm_to_16bit(pcm: bytes, width: int) -> bytes:
    """Integer PCM of sample width 1/2/4 bytes → little-endian 16-bit.

    Wyoming audio-chunk events carry an explicit ``width`` field."""
    if width == 1:  # unsigned 8-bit, center at 0
        arr = np.frombuffer(pcm, dtype=np.uint8).astype(np.int16)
        return ((arr - 128) << 8).astype("<i2").tobytes()
    if width == 4:
        arr = np.frombuffer(pcm[: len(pcm) - len(pcm) % 4], dtype="<i4")
        return (arr >> 16).astype("<i2").tobytes()
    raise ValueError(f"unsupported Wyoming PCM width: {width}")


def _extract_speech_pcm(pcm: bytes, rate: int, device) -> bytes:
    """VAD-gate the audio to speech-only segments (16 kHz out). Blocking:
    runs in the executor."""
    if not pcm:
        return pcm
    if rate != WYOMING_SAMPLE_RATE:
        pcm = resample_pcm16(pcm, rate, WYOMING_SAMPLE_RATE, device)
    if not settings.stt_vad_enabled:
        return pcm
    try:
        shared = get_vad_model(device)
        vad = SileroVAD(shared.session, threshold=settings.stt_vad_threshold)
        segments = vad.get_speech_segments(
            pcm,
            min_speech_ms=settings.stt_vad_min_speech_ms,
            silence_ms=settings.stt_vad_silence_ms,
        )
        if not segments:
            return pcm
        parts = []
        for seg in segments:
            start = seg.start_ms * WYOMING_SAMPLE_RATE // 1000 * 2
            end = seg.end_ms * WYOMING_SAMPLE_RATE // 1000 * 2
            parts.append(pcm[start:end])
        return b"".join(parts)
    except Exception:  # noqa: BLE001 — the JAX server transcribes the ungated audio
        logger.exception("Wyoming VAD segment extraction failed")
        return pcm


class OpenSpeechEventHandler:
    """One Wyoming TCP connection."""

    def __init__(self, reader, writer, stt_router, tts_router, info: dict):
        self.reader = reader
        self.writer = writer
        self.stt_router = stt_router
        self.tts_router = tts_router
        self.info = info
        self._audio_chunks: list[bytes] = []
        self._audio_rate = 16000
        self._audio_width = 2
        self._audio_channels = 1
        self._transcribe_model: str | None = None
        self._transcribe_language: str | None = None

    async def run(self) -> None:
        try:
            while True:
                event = await read_event(self.reader)
                if event is None:
                    break
                if not await self.handle_event(event):
                    break
        except Exception:  # noqa: BLE001 — one connection's fault ends only that connection
            logger.exception("Wyoming connection error")
        finally:
            self.writer.close()

    async def handle_event(self, event: Event) -> bool:
        etype = event.type
        if etype == "describe":
            await write_event(self.writer, Event("info", self.info))
            return True
        if etype == "transcribe":
            self._transcribe_model = event.data.get("name")
            self._transcribe_language = event.data.get("language")
            self._audio_chunks = []
            return True
        if etype == "audio-chunk":
            self._audio_rate = event.data.get("rate", 16000)
            self._audio_width = event.data.get("width", 2)
            self._audio_channels = event.data.get("channels", 1)
            self._audio_chunks.append(event.payload)
            return True
        if etype == "audio-stop":
            if self._audio_chunks:
                text = await self._transcribe()
                await write_event(
                    self.writer, Event("transcript", {"text": text})
                )
                self._audio_chunks = []
            return True
        if etype == "synthesize":
            voice = (event.data.get("voice") or {}).get("name")
            await self._synthesize(event.data.get("text", ""), voice)
            return True
        logger.debug("Unhandled Wyoming event type: %s", etype)
        return True

    def _prepare(self, pcm: bytes, model: str) -> bytes:
        """Joined chunks -> the 16 kHz mono WAV the router transcribes."""
        if self._audio_width != 2:
            # everything below assumes 16-bit samples; widen/narrow first
            # rather than misreading width-1/width-4 PCM as noise
            pcm = _pcm_to_16bit(pcm, self._audio_width)
        if self._audio_channels > 1:
            arr = np.frombuffer(pcm, dtype="<i2")
            usable = len(arr) - len(arr) % self._audio_channels
            arr = arr[:usable].reshape(-1, self._audio_channels).mean(axis=1)
            pcm = arr.astype("<i2").tobytes()
        backend = self.stt_router.get_backend(model)
        device = getattr(backend, "device", None) or settings.stt_device
        pcm = _extract_speech_pcm(pcm, self._audio_rate, device)
        wav = pcm16_to_wav(pcm, WYOMING_SAMPLE_RATE)
        return preprocess_stt_audio(
            wav,
            noise_reduce=settings.stt_noise_reduce,
            normalize=settings.stt_normalize,
        )

    async def _transcribe(self) -> str:
        pcm = b"".join(self._audio_chunks)
        model = self._transcribe_model or settings.stt_model
        loop = asyncio.get_running_loop()
        wav = await loop.run_in_executor(None, self._prepare, pcm, model)
        try:
            result = await loop.run_in_executor(
                None,
                lambda: self.stt_router.transcribe(
                    audio=wav,
                    model=model,
                    language=self._transcribe_language,
                    response_format="json",
                    temperature=0.0,
                ),
            )
            return result.get("text", "")
        except Exception:  # noqa: BLE001 — an empty transcript, as the JAX server answers
            logger.exception("Wyoming transcription failed")
            return ""

    async def _synthesize(self, text: str, voice: str | None) -> None:
        loop = asyncio.get_running_loop()
        model = settings.tts_model
        voice = voice or settings.tts_voice

        def _synth() -> bytes:
            chunks = process_tts_chunks(
                self.tts_router.synthesize(
                    text=text, model=model, voice=voice, speed=1.0
                ),
                trim=settings.tts_trim_silence,
                normalize=settings.tts_normalize_output,
            )
            merged = list(chunks)
            if not merged:
                return b""
            audio = np.concatenate(merged)
            backend = self.tts_router.get_backend(model)
            native = backend_sample_rate(backend, model)
            pcm = float_to_pcm16(audio)
            return resample_pcm16(pcm, native, WYOMING_SAMPLE_RATE,
                                  getattr(backend, "device", None))

        try:
            pcm16 = await loop.run_in_executor(None, _synth)
        except Exception:  # noqa: BLE001 — an empty stream, as the JAX server sends it
            logger.exception("Wyoming synthesis failed")
            pcm16 = b""
        meta = {"rate": WYOMING_SAMPLE_RATE, "width": 2, "channels": 1}
        await write_event(self.writer, Event("audio-start", meta))
        chunk_size = WYOMING_SAMPLE_RATE // 10 * 2  # 100 ms
        for i in range(0, len(pcm16), chunk_size):
            await write_event(
                self.writer,
                Event("audio-chunk", meta, pcm16[i : i + chunk_size]),
            )
        await write_event(self.writer, Event("audio-stop", meta))


async def start_wyoming_server(
    stt_router, tts_router, host: str = "127.0.0.1", port: int = 10400
):
    """Start the TCP server; returns the asyncio.Server (close() to stop)."""
    info = build_info(stt_router, tts_router)

    async def on_connect(reader, writer):
        handler = OpenSpeechEventHandler(reader, writer, stt_router, tts_router, info)
        await handler.run()

    server = await asyncio.start_server(on_connect, host, port)
    logger.info("Wyoming server listening on %s:%d", host, port)
    return server
