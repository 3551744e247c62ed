"""Real-time streaming transcription sessions (Deepgram-style protocol).

Counterpart of ``open_speech_tpu/server/streaming.py``, the session behind
``/v1/audio/stream``:

  Client -> Server: binary PCM16 LE mono frames (or G.711 with
    ``encoding=mulaw|alaw``), or JSON text messages {"type":"stop"} /
    {"type":"config", ...}
  Server -> Client: JSON events session.begin / transcript {is_final,
    speech_final} / vad / error / session.end

Per-chunk VAD gating and endpointing, the 30 s utterance force-finalize,
LocalAgreement2 stable-prefix partials, the coalescing interim scheduler,
language pinning for auto-detect sessions, and a dedicated transcription
executor. Interims (and window-sized finals) run over the O(n) incremental
encoder (``models/whisper/streaming.py``, K2 on the card); a failing
incremental decode falls back to the per-request executor path, as in the
JAX package.

The JAX package runs this over an aiohttp WebSocket. Here the session takes
any ``ws`` that yields ``Message``s (``MsgType`` BINARY / TEXT / CLOSE) and
has ``send_str`` and ``close`` (``server/websocket.py``'s socket, which
``server/app.py`` binds to ``/v1/audio/stream``), and the router is a
constructor argument. With
``OS_BATCHER_ENABLED``, transcriptions that the incremental path does not
serve go through the shared continuous batcher
(``runtime/batcher_pool.py``) once the session's language is known.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import uuid

import numpy as np

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.vad.silero import VAD_SAMPLE_RATE, SileroVAD, get_vad_model
from open_speech_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
from open_speech_tpu_torch.models.whisper.model import Whisper
from open_speech_tpu_torch.models.whisper.streaming import (
    StreamingWhisperEncoder,
    final_budget,
    forced_bucket,
    forced_room,
    interim_budget,
)
from open_speech_tpu_torch.ops.audio import (
    alaw_decode,
    pcm16_to_float,
    pcm16_to_wav,
    ulaw_decode,
)
from open_speech_tpu_torch.ops.resample import resample_pcm16
from open_speech_tpu_torch.runtime.batcher_pool import transcribe_pcm_batched
from open_speech_tpu_torch.server.websocket import Message, MsgType  # noqa: F401 — Message: callers build messages from here

logger = logging.getLogger(__name__)

INTERNAL_SAMPLE_RATE = VAD_SAMPLE_RATE  # 16 kHz

MAX_UTTERANCE_SECONDS = 30
MAX_UTTERANCE_BYTES = MAX_UTTERANCE_SECONDS * INTERNAL_SAMPLE_RATE * 2

MIN_SAMPLE_RATE = 8000
MAX_SAMPLE_RATE = 192000

# accepted ?encoding= values -> canonical name; G.711 is decoded at ingress
# and unknown codecs are rejected at connect
_ENCODINGS = {
    "pcm_s16le": "pcm_s16le",
    "linear16": "pcm_s16le",
    "mulaw": "mulaw",
    "ulaw": "mulaw",
    "g711_ulaw": "mulaw",
    "alaw": "alaw",
    "g711_alaw": "alaw",
}


def _canonical_encoding(name: str) -> str:
    return _ENCODINGS[str(name).lower()]


# Dedicated pool so streaming work can't starve REST requests
_streaming_executor = concurrent.futures.ThreadPoolExecutor(
    max_workers=4, thread_name_prefix="stream-transcribe"
)


def _agreement_length(a: list[str], b: list[str]) -> int:
    """Length of the case-insensitive common prefix of two word lists."""
    n = 0
    for x, y in zip(a, b):
        if x.lower() != y.lower():
            break
        n += 1
    return n


class LocalAgreement2:
    """Stable-prefix commit policy for interim hypotheses.

    Each interim transcription covers the whole utterance so far; a word
    becomes *committed* once two consecutive hypotheses agree on it (and on
    everything before it). Committed words are never retracted.
    """

    def __init__(self):
        self._last_hyp: list[str] = []
        self._committed: list[str] = []

    @property
    def confirmed_words(self) -> list[str]:
        return self._committed

    def process(self, hypothesis: str) -> tuple[list[str], list[str]]:
        """Feed one whole-utterance hypothesis.

        Returns (newly committed words, still-pending tail of the current
        hypothesis).
        """
        words = hypothesis.split()
        stable = _agreement_length(self._last_hyp, words)
        fresh: list[str] = []
        if stable > len(self._committed):
            fresh = words[len(self._committed) : stable]
            # re-take the whole prefix: casing may differ between runs and
            # the newest hypothesis wins
            self._committed = words[:stable]
        self._last_hyp = words
        return fresh, words[len(self._committed) :]

    def flush(self) -> list[str]:
        """Commit the uncommitted tail of the last hypothesis (stream end)."""
        tail = self._last_hyp[len(self._committed) :]
        self._committed = self._committed + tail
        return tail

    def reset(self):
        self._last_hyp = []
        self._committed = []


_active_sessions: dict[str, "StreamingSession"] = {}


class StreamingSession:
    """One streaming transcription session over ``ws``, served by ``router``."""

    def __init__(
        self,
        ws,
        router,
        model: str,
        language: str | None,
        sample_rate: int,
        interim_results: bool,
        endpointing_ms: int,
        vad_enabled: bool = True,
        encoding: str = "pcm_s16le",
    ):
        self.ws = ws
        self.router = router
        self.session_id = str(uuid.uuid4())
        self.model = model
        self.language = language
        # mulaw/alaw frames are decoded to PCM16 at ingress (LUT);
        # everything downstream runs in the PCM16 domain
        self.encoding = _canonical_encoding(encoding)
        self.client_sample_rate = sample_rate
        self.needs_resample = sample_rate != INTERNAL_SAMPLE_RATE
        self.interim_results = interim_results
        self.endpointing_ms = endpointing_ms
        self.vad_enabled = vad_enabled

        self.audio_buffer = bytearray()
        self.chunk_samples = int(sample_rate * settings.stt_stream_chunk_ms / 1000)
        self.chunk_bytes = self.chunk_samples * 2

        self.agreement = LocalAgreement2()
        self.vad_state: SileroVAD | None = None

        self.utterance_start = 0.0
        self.total_samples = 0
        self.silence_samples = 0
        self.endpointing_samples = int(INTERNAL_SAMPLE_RATE * endpointing_ms / 1000)
        self.speech_active = False
        self.utterance_audio = bytearray()

        self._running = False
        self._transcription_count = 0
        self._error_count = 0

        # incremental-encoder state (one per utterance)
        self._inc_encoder: StreamingWhisperEncoder | None = None
        self._inc_fed = 0  # utterance bytes already fed to the encoder
        self._inc_broken = False  # backend unsupported: stop probing
        self._inc_failures = 0  # consecutive runtime failures

        # auto-detect pinning: detected once after ~1 s of speech
        self._detected_language: str | None = None
        self._lang_probe_failed = False

        # coalescing interim scheduler: at most ONE interim transcription
        # in flight; chunks landing while busy only mark it dirty
        self._interim_task: asyncio.Task | None = None
        self._interim_dirty = False
        self._interims_coalesced = 0

    @property
    def effective_language(self) -> str | None:
        """Client-pinned language, or the session's detected-and-pinned one."""
        return self.language or self._detected_language

    def _device(self):
        """The device the model runs on: resampling runs there, and the VAD
        unless ``OS_VAD_DEVICE`` names another (``get_vad_model``)."""
        backend = self.router.get_backend(self.model)
        return getattr(backend, "device", None) or settings.stt_device

    async def run(self):
        self._running = True
        loop = asyncio.get_running_loop()
        try:
            if not self.router.is_model_loaded(self.model):
                await loop.run_in_executor(None, lambda: self.router.load_model(self.model))
        except Exception as e:  # noqa: BLE001
            logger.error("[%s] Failed to load model: %s", self.session_id[:8], e)
            await self._send_event({"type": "error", "message": f"Failed to load model: {e}"})
            # still a proper session teardown: clients keying on
            # session.end must not see a bare socket drop
            await self._send_event(
                {
                    "type": "session.end",
                    "reason": "model_load_failed",
                    "transcriptions": 0,
                    "errors": 1,
                }
            )
            return

        if self.vad_enabled:
            shared = await loop.run_in_executor(None, get_vad_model, self._device())
            self.vad_state = SileroVAD(shared.session, threshold=settings.stt_vad_threshold)
        else:
            self.vad_state = None

        await self._send_event(
            {
                "type": "session.begin",
                "session_id": self.session_id,
                "model": self.model,
                "sample_rate": self.client_sample_rate,
                "internal_sample_rate": INTERNAL_SAMPLE_RATE,
                "vad_enabled": self.vad_enabled,
            }
        )

        try:
            async for msg in self.ws:
                if msg.type == MsgType.BINARY and msg.data:
                    await self._handle_audio(msg.data)
                elif msg.type == MsgType.TEXT and msg.data:
                    await self._handle_text(msg.data)
                elif msg.type == MsgType.CLOSE:
                    break
                if not self._running:
                    break  # a stop message must end the session immediately
        except Exception as e:  # noqa: BLE001
            logger.exception("[%s] Streaming session error: %s", self.session_id[:8], e)
        finally:
            await self._flush()
            await self._send_event(
                {
                    "type": "session.end",
                    "reason": "client_stop" if not self._running else "disconnect",
                    "transcriptions": self._transcription_count,
                    "errors": self._error_count,
                }
            )

    async def _handle_text(self, text: str):
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            logger.warning("[%s] Malformed JSON text frame", self.session_id[:8])
            return
        if data.get("type") == "stop":
            self._running = False
        elif data.get("type") == "config":
            # mid-session reconfiguration: sample_rate retunes the
            # resampler and chunking; language/interim_results apply to
            # subsequent utterances
            rate = data.get("sample_rate")
            if rate:
                try:
                    rate = int(rate)
                except (TypeError, ValueError):
                    rate = -1
                if not (MIN_SAMPLE_RATE <= rate <= MAX_SAMPLE_RATE):
                    # an accepted tiny rate would make chunk_bytes 0 and
                    # turn _handle_audio into an event-loop-blocking spin
                    await self._send_event(
                        {
                            "type": "error",
                            "message": (
                                f"Invalid sample_rate: must be {MIN_SAMPLE_RATE}-{MAX_SAMPLE_RATE}"
                            ),
                        }
                    )
                    return
                if rate != self.client_sample_rate:
                    # buffered bytes were captured at the old rate and the
                    # running clock is in old-rate samples: finalize the
                    # in-flight utterance first, then rebase the sample
                    # counter so elapsed time stays continuous
                    await self._flush()
                    self.total_samples = int(self.total_samples * rate / self.client_sample_rate)
                    self.client_sample_rate = rate
                self.needs_resample = self.client_sample_rate != INTERNAL_SAMPLE_RATE
                self.chunk_samples = int(
                    self.client_sample_rate * settings.stt_stream_chunk_ms / 1000
                )
                self.chunk_bytes = self.chunk_samples * 2
            if "language" in data:
                self.language = data["language"] or None
            if "interim_results" in data:
                self.interim_results = bool(data["interim_results"])

    async def _handle_audio(self, data: bytes):
        if self.encoding != "pcm_s16le":
            dec = ulaw_decode if self.encoding == "mulaw" else alaw_decode
            data = dec(np.frombuffer(data, np.uint8)).astype("<i2").tobytes()
        if len(data) % 2 != 0:
            data = data[:-1]
        if not data:
            return
        self.audio_buffer.extend(data)
        self.total_samples += len(data) // 2
        while len(self.audio_buffer) >= self.chunk_bytes:
            chunk = bytes(self.audio_buffer[: self.chunk_bytes])
            del self.audio_buffer[: self.chunk_bytes]
            await self._process_chunk(chunk)

    def _to_internal_rate(self, pcm: bytes) -> bytes:
        if not self.needs_resample:
            return pcm
        return resample_pcm16(pcm, self.client_sample_rate, INTERNAL_SAMPLE_RATE, self._device())

    def _start_utterance(self, chunk: bytes) -> None:
        self.speech_active = True
        self.utterance_start = (self.total_samples - len(chunk) // 2) / self.client_sample_rate
        self.utterance_audio = bytearray()
        self.agreement.reset()
        self._reset_incremental()

    async def _process_chunk(self, chunk: bytes):
        chunk_16k = self._to_internal_rate(chunk)

        if not self.vad_enabled or self.vad_state is None:
            if not self.speech_active:
                self._start_utterance(chunk)
            self.utterance_audio.extend(chunk_16k)
            if len(self.utterance_audio) >= MAX_UTTERANCE_BYTES:
                await self._finalize_utterance()
            else:
                self._schedule_interim()
            return

        samples = np.frombuffer(chunk_16k, dtype=np.int16).astype(np.float32) / 32768.0
        speech_prob = await asyncio.get_running_loop().run_in_executor(
            _streaming_executor, self.vad_state, samples
        )
        is_speech = speech_prob >= settings.stt_vad_threshold

        if is_speech:
            self.silence_samples = 0
            if not self.speech_active:
                self._start_utterance(chunk)
                await self._send_event({"type": "vad", "state": "speech_start"})
            self.utterance_audio.extend(chunk_16k)
            if len(self.utterance_audio) >= MAX_UTTERANCE_BYTES:
                await self._finalize_utterance()
            else:
                self._schedule_interim()
        elif self.speech_active:
            self.silence_samples += len(chunk_16k) // 2
            self.utterance_audio.extend(chunk_16k)
            if self.silence_samples >= self.endpointing_samples:
                await self._finalize_utterance()
            else:
                self._schedule_interim()

    def _schedule_interim(self) -> None:
        """Coalescing interim scheduler: at most one interim transcription
        runs at a time; a chunk landing while one is in flight only marks
        it dirty and the worker re-runs ONCE over all audio that arrived
        meanwhile. Interims are previews, so dropping intermediate ones
        loses nothing, while queueing one decode per chunk would push
        interim latency behind real time whenever a decode overruns the
        chunk cadence. Finals always run (_finalize_utterance awaits the
        in-flight interim first)."""
        if len(self.utterance_audio) < 3200:  # <100 ms: nothing to preview
            return
        if self._interim_task is not None and not self._interim_task.done():
            self._interim_dirty = True
            self._interims_coalesced += 1
            return
        self._interim_dirty = False
        self._interim_task = asyncio.create_task(self._interim_worker())

    async def _interim_worker(self) -> None:
        while True:
            self._interim_dirty = False
            await self._transcribe_utterance()
            # catch-up pass over audio that landed mid-decode; stop when
            # clean, or when the utterance ended (final supersedes)
            if not self._interim_dirty or not self.speech_active:
                return

    async def _await_interim(self) -> None:
        """Wait out any in-flight interim (finals and teardown must not
        race it on the incremental encoder or the agreement state)."""
        task = self._interim_task
        if task is not None:
            self._interim_dirty = False  # the final supersedes catch-ups
            try:
                await task
            except Exception:  # noqa: BLE001 — worker logs its own errors
                pass
            self._interim_task = None

    async def _run_transcription(self, final: bool = False) -> dict | None:
        try:
            await self._maybe_pin_language()
            result = None
            if settings.os_stream_incremental and not self._inc_broken:
                # interims AND window-sized finals ride the incremental
                # encoder (finals re-decode fresh over the encoded states)
                result = await self._transcribe_incremental(final=final)
            if result is None:
                # the shared batcher builds one prompt per (model, language)
                # and would force English on None: sessions ride it once a
                # language is known, client-pinned or detected and pinned
                if settings.os_batcher_enabled and self.effective_language:
                    result = await self._transcribe_batched()
                else:
                    result = await self._transcribe_executor()
            self._transcription_count += 1
            return result
        except Exception as e:  # noqa: BLE001
            self._error_count += 1
            logger.error(
                "[%s] Transcription error (#%d): %s", self.session_id[:8], self._error_count, e
            )
            await self._send_event({"type": "error", "message": f"Transcription failed: {e}"})
            return None

    async def _maybe_pin_language(self) -> None:
        """Detect-once-then-pin for auto-detect sessions: language detection
        over the first ~1 s of speech, pinned for the rest of the session.
        A backend without detect support (mocks, plugins) fails the probe
        once and the session stays on the per-request path."""
        if self.language or self._detected_language or self._lang_probe_failed:
            return
        if len(self.utterance_audio) < 2 * INTERNAL_SAMPLE_RATE:  # <1 s
            return
        pcm_bytes = bytes(self.utterance_audio)

        def probe() -> str:
            backend = self.router.get_backend(self.model)
            code = backend.detect_language_pcm(self.model, pcm16_to_float(pcm_bytes))
            if not isinstance(code, str) or not code:
                raise TypeError("backend returned no language code")
            return code

        try:
            self._detected_language = await asyncio.get_running_loop().run_in_executor(
                _streaming_executor, probe
            )
            logger.info(
                "[%s] Pinned detected language %r", self.session_id[:8], self._detected_language
            )
        except Exception as e:  # noqa: BLE001 — stay on per-request path
            self._lang_probe_failed = True
            logger.debug(
                "[%s] Language probe unsupported (%s); staying on per-request path",
                self.session_id[:8], e,
            )

    def _reset_incremental(self) -> None:
        if self._inc_encoder is not None:
            self._inc_encoder.reset()
        self._inc_fed = 0

    async def _transcribe_incremental(self, final: bool = False) -> dict | None:
        """O(n) path: feed only new audio into the per-session block-causal
        encoder, re-decode over the bucketed prefix.

        ``final=True`` reuses the same encoder states for the utterance's
        final transcript: a fresh full-budget decode with no forced prefix,
        without re-encoding audio the encoder already holds. Utterances
        longer than the model window fall back to the full path (return
        None, probing stays enabled): the encoder holds one window.

        Returns None (and stops probing) when the backend's model entry is
        not a port ``Whisper``: scripted/mock backends in tests and plugins
        fall back to the full per-chunk path.
        """
        try:
            backend = self.router.get_backend(self.model)
            entry = backend._ensure_model(self.model)
            if not isinstance(entry, dict) or not isinstance(entry.get("model"), Whisper):
                raise TypeError("not a torch-whisper model entry")
            model, cfg, tok = entry["model"], entry["cfg"], entry["tok"]
            int(cfg.n_audio_layer)  # quacks like a WhisperConfig?
        except Exception:  # noqa: BLE001 — unsupported backend, not an error
            self._inc_broken = True
            return None

        if self._inc_encoder is None or self._inc_encoder.model is not model:
            self._inc_encoder = StreamingWhisperEncoder(model, cfg)
            self._inc_fed = 0
        new_len = len(self.utterance_audio)
        if final and new_len // 640 >= cfg.n_audio_ctx:
            # utterance overflows the model window: the incremental encoder
            # truncates at n_audio_ctx positions, so an exact final needs
            # the full multi-window path
            return None
        new_bytes = bytes(self.utterance_audio[self._inc_fed : new_len])
        encoder = self._inc_encoder
        language = self.effective_language or "en"

        # confirmed-prefix conditioning: LocalAgreement2's stable prefix is
        # forced into the prompt (one prefill pass), so each interim only
        # generates the unconfirmed tail; the forced length snaps to a
        # bucket ladder. Finals decode fresh (no forced prefix).
        conf_words = [] if final else list(self.agreement.confirmed_words)

        def work() -> dict:
            if new_bytes:
                encoder.append_audio(pcm16_to_float(new_bytes))
            # mark consumed only after the encoder actually took the audio:
            # advancing before a failed append would leave a permanent hole
            # in every later interim hypothesis
            self._inc_fed = new_len
            enc_states, bucket = encoder.interim_states()
            sp = tok.special
            try:
                sot = sp.sot_sequence(language, "transcribe", timestamps=False)
            except ValueError:  # unknown language code: neutral default
                sot = sp.sot_sequence("en", "transcribe", timestamps=False)
            forced: list[int] = []
            if conf_words:
                # leading space: whisper transcript tokens are space-prefixed
                # BPE pieces (openai-whisper encodes prefixes as ' ' + text)
                conf_ids = tok.encode(" " + " ".join(conf_words))
                fb = forced_bucket(len(conf_ids), forced_room(cfg, len(sot)))
                forced = [int(t) for t in conf_ids[:fb]]
            budget = final_budget(bucket) if final else interim_budget(bucket, len(forced))
            opts = DecodeOptions(
                language=language, timestamps=False, beam_size=1,
                max_new_tokens=budget, suppress_blank=True,
            )
            prompt = np.asarray([list(sot) + forced], np.int32)
            res = greedy_decode(
                model, cfg, sp, enc_states, prompt, opts,
                enc_len=np.asarray([encoder.real_positions], np.int32),
            )
            tail = [int(t) for t in res.tokens[0][: res.lengths[0]]]
            return {"text": tok.decode(forced + tail).strip()}

        try:
            result = await asyncio.get_running_loop().run_in_executor(_streaming_executor, work)
            self._inc_failures = 0
            return result
        except Exception as e:  # noqa: BLE001
            # runtime failure: fall back to the per-request path for this
            # chunk (the encoder state is still consistent because _inc_fed
            # only advances after a successful append), and stop probing if
            # it persists
            self._inc_failures += 1
            logger.warning(
                "[%s] Incremental interim failed (%d): %s",
                self.session_id[:8], self._inc_failures, e,
            )
            if self._inc_failures >= 3:
                self._inc_broken = True
                logger.warning(
                    "[%s] Disabling incremental path after repeated failures",
                    self.session_id[:8],
                )
            return None

    async def _transcribe_executor(self) -> dict:
        """Per-request path: whole inference on the streaming executor."""
        wav_data = pcm16_to_wav(bytes(self.utterance_audio), INTERNAL_SAMPLE_RATE)
        return await asyncio.get_running_loop().run_in_executor(
            _streaming_executor,
            lambda: self.router.transcribe(
                audio=wav_data,
                model=self.model,
                language=self.effective_language,
                response_format="json",
                temperature=0.0,
                # latency path: greedy, no temperature-fallback sweep
                beam_size=1,
                fallback=False,
            ),
        )

    async def _transcribe_batched(self) -> dict:
        """Continuous-batching path: every live session's decode shares
        device steps through the shared batcher pool."""
        return await transcribe_pcm_batched(
            self.router.get_backend(self.model), self.model, self.effective_language,
            pcm16_to_float(bytes(self.utterance_audio)),
        )

    async def _transcribe_utterance(self):
        if len(self.utterance_audio) < 3200:  # <100 ms: skip
            return
        result = await self._run_transcription()
        if result is None:
            return
        text = result.get("text", "").strip()
        if not text:
            return
        new_confirmed, pending = self.agreement.process(text)
        now = self.total_samples / self.client_sample_rate
        if new_confirmed:
            await self._send_event(
                {
                    "type": "transcript",
                    "is_final": True,
                    "speech_final": False,
                    "text": " ".join(self.agreement.confirmed_words),
                    "start": self.utterance_start,
                    "end": now,
                    "confidence": 0.95,
                }
            )
        if self.interim_results and pending:
            await self._send_event(
                {
                    "type": "transcript",
                    "is_final": False,
                    "speech_final": False,
                    "text": " ".join(self.agreement.confirmed_words + pending),
                    "start": self.utterance_start,
                    "end": now,
                    "confidence": 0.90,
                }
            )

    async def _finalize_utterance(self):
        await self._await_interim()  # finals never race a preview
        if len(self.utterance_audio) < 3200:
            was_active = self.speech_active
            self.speech_active = False
            self.silence_samples = 0
            if was_active and self.vad_enabled:
                await self._send_event({"type": "vad", "state": "speech_end"})
            return

        result = await self._run_transcription(final=True)
        if result is None:
            self.speech_active = False
            self.silence_samples = 0
            if self.vad_enabled:
                await self._send_event({"type": "vad", "state": "speech_end"})
            return

        text = result.get("text", "").strip()
        now = self.total_samples / self.client_sample_rate
        if text:
            await self._send_event(
                {
                    "type": "transcript",
                    "is_final": True,
                    "speech_final": True,
                    "text": text,
                    "start": self.utterance_start,
                    "end": now,
                    "confidence": 0.95,
                }
            )
        if self.vad_enabled:
            await self._send_event({"type": "vad", "state": "speech_end"})
        self.speech_active = False
        self.silence_samples = 0
        self.utterance_audio = bytearray()
        self.agreement.reset()
        self._reset_incremental()

    async def _flush(self):
        await self._await_interim()  # never leak a task past the session
        remaining = bytes(self.audio_buffer)
        self.audio_buffer.clear()
        if self.speech_active and len(self.utterance_audio) > 0:
            # stop/disconnect mid-utterance: fold in any sub-chunk tail and
            # emit the final transcript
            if remaining:
                self.utterance_audio.extend(self._to_internal_rate(remaining))
            await self._finalize_utterance()

    async def _send_event(self, event: dict):
        try:
            await self.ws.send_str(json.dumps(event))
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "[%s] Failed to send event %s: %s",
                self.session_id[:8], event.get("type", "?"), e,
            )


async def streaming_endpoint(
    ws,
    router,
    model: str | None = None,
    language: str | None = None,
    sample_rate: int = 16000,
    encoding: str = "pcm_s16le",
    interim_results: bool = True,
    endpointing: int = 300,
    vad: bool | None = None,
):
    """Run a streaming session over an accepted ``ws``, served by ``router``."""
    if len(_active_sessions) >= settings.stt_stream_max_connections:
        await ws.close(code=1013, message=b"Too many concurrent streams")
        return
    if sample_rate < MIN_SAMPLE_RATE or sample_rate > MAX_SAMPLE_RATE:
        await ws.close(
            code=1008,
            message=f"Invalid sample_rate: must be {MIN_SAMPLE_RATE}-{MAX_SAMPLE_RATE}".encode(),
        )
        return
    if str(encoding).lower() not in _ENCODINGS:
        await ws.close(
            code=1008,
            message=(
                f"Unsupported encoding {encoding!r}: one of {sorted(set(_ENCODINGS))}"
            ).encode(),
        )
        return

    vad_enabled = vad if vad is not None else settings.stt_vad_enabled
    session = StreamingSession(
        ws=ws,
        router=router,
        model=model or settings.stt_default_model,
        language=language,
        sample_rate=sample_rate,
        interim_results=interim_results,
        endpointing_ms=endpointing,
        vad_enabled=vad_enabled,
        encoding=encoding,
    )
    _active_sessions[session.session_id] = session
    try:
        logger.info(
            "Streaming session %s started (model=%s, rate=%d, vad=%s)",
            session.session_id, session.model, sample_rate, vad_enabled,
        )
        await session.run()
    finally:
        _active_sessions.pop(session.session_id, None)
        logger.info(
            "Streaming session %s ended (transcriptions=%d, errors=%d)",
            session.session_id, session._transcription_count, session._error_count,
        )
