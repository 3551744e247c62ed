"""TTS output encoding (reference: src/tts/pipeline.py).

Pure-python WAV and raw-PCM writers (:40-66) are always available; compressed
formats (mp3/opus/aac/flac/m4a) shell out to ffmpeg one-shot (:78-107) or
through a persistent streaming pipe with a reader thread (:133-222), gated on
the binary's presence. ``encode_audio_streaming`` yields encoded chunks as
generation progresses (:224-264) — without the event-loop-blocking
``time.sleep`` the reference has in its drain loop (SURVEY quirk list).
"""

from __future__ import annotations

import logging
import queue
import shutil
import subprocess
import threading
from typing import Iterator

import numpy as np

from open_speech_tpu_torch.ops import audio as codec

logger = logging.getLogger(__name__)

CONTENT_TYPES = {
    "mp3": "audio/mpeg",
    "opus": "audio/ogg",
    "aac": "audio/aac",
    "flac": "audio/flac",
    "wav": "audio/wav",
    "pcm": "audio/pcm",
    "m4a": "audio/mp4",
}

_FFMPEG_FORMATS = {
    "mp3": ["-f", "mp3", "-b:a", "128k"],
    "opus": ["-f", "ogg", "-c:a", "libopus", "-b:a", "96k"],
    "aac": ["-f", "adts", "-c:a", "aac", "-b:a", "128k"],
    "flac": ["-f", "flac"],
    "m4a": ["-f", "ipod", "-movflags", "frag_keyframe+empty_moov"],
}


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def supported_formats() -> set[str]:
    base = {"wav", "pcm"}
    if ffmpeg_available():
        base |= set(_FFMPEG_FORMATS)
    return base


def float_to_pcm16(audio: np.ndarray) -> bytes:
    return codec.float_to_pcm16(audio)


def encode_audio(
    audio: np.ndarray, sample_rate: int, output_format: str = "wav"
) -> bytes:
    """One-shot encode of a float32 [-1,1] buffer."""
    fmt = output_format.lower()
    if fmt == "wav":
        return codec.write_wav(audio, sample_rate)
    if fmt == "pcm":
        return codec.float_to_pcm16(audio)
    args = _FFMPEG_FORMATS.get(fmt)
    if args is None:
        raise ValueError(f"Unsupported format: {output_format}")
    if not ffmpeg_available():
        raise RuntimeError(
            f"Format '{fmt}' requires ffmpeg, which is not installed; "
            "use wav or pcm"
        )
    proc = subprocess.run(
        [
            "ffmpeg", "-f", "f32le", "-ar", str(sample_rate), "-ac", "1",
            "-i", "pipe:0", *args, "pipe:1",
        ],
        input=np.asarray(audio, np.float32).tobytes(),
        capture_output=True,
        timeout=120,
        check=True,
    )
    return proc.stdout


class StreamingFFmpegEncoder:
    """Persistent ffmpeg pipe for chunked encode (reference :133-222)."""

    def __init__(self, sample_rate: int, output_format: str):
        args = _FFMPEG_FORMATS[output_format]
        self._proc = subprocess.Popen(
            [
                "ffmpeg", "-f", "f32le", "-ar", str(sample_rate), "-ac", "1",
                "-i", "pipe:0", *args, "pipe:1",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        self._out: queue.Queue[bytes | None] = queue.Queue()
        self._eof = False  # end-of-stream sentinel already consumed
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        try:
            while True:
                data = self._proc.stdout.read(4096)
                if not data:
                    break
                self._out.put(data)
        finally:
            self._out.put(None)

    def feed(self, audio: np.ndarray) -> None:
        self._proc.stdin.write(np.asarray(audio, np.float32).tobytes())
        self._proc.stdin.flush()

    def read_available(self) -> list[bytes]:
        chunks = []
        while not self._eof:
            try:
                item = self._out.get_nowait()
            except queue.Empty:
                break
            if item is None:
                # remember EOF: finish() must not block on a second sentinel
                # (ffmpeg can exit early — encode error, kill)
                self._eof = True
                break
            chunks.append(item)
        return chunks

    def finish(self) -> Iterator[bytes]:
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        while not self._eof:
            item = self._out.get()
            if item is None:
                self._eof = True
                break
            yield item
        self._proc.wait(timeout=30)

    def close(self) -> None:
        """Terminate ffmpeg without draining (abandoned stream)."""
        if self._proc.poll() is None:
            try:
                self._proc.stdin.close()
            except OSError:
                pass
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()


def encode_audio_streaming(
    chunks: Iterator[np.ndarray], sample_rate: int, output_format: str = "wav"
) -> Iterator[bytes]:
    """Encode a stream of float chunks into a stream of encoded bytes.

    wav: header with max RIFF size first, then PCM chunks (streamable WAV);
    pcm: raw chunks; compressed: persistent ffmpeg pipe.
    """
    fmt = output_format.lower()
    if fmt == "pcm":
        for chunk in chunks:
            yield codec.float_to_pcm16(chunk)
        return
    if fmt == "wav":
        # unknown final length: use the max data size so players stream it
        yield codec.wav_header(0xFFFFFFFF - 36, sample_rate, 1)
        for chunk in chunks:
            yield codec.float_to_pcm16(chunk)
        return
    if fmt not in _FFMPEG_FORMATS:
        raise ValueError(f"Unsupported format: {output_format}")
    if not ffmpeg_available():
        raise RuntimeError(f"Format '{fmt}' requires ffmpeg, which is not installed")
    enc = StreamingFFmpegEncoder(sample_rate, fmt)
    try:
        for chunk in chunks:
            enc.feed(chunk)
            yield from enc.read_available()
        yield from enc.finish()
    finally:
        # consumer may stop iterating mid-stream (client disconnect):
        # never leak a live ffmpeg with stdin held open
        enc.close()
