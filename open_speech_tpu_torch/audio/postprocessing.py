"""TTS output postprocessing: silence trim + peak normalize.

Parity with reference src/audio/postprocessing.py (threshold-based trim :8,
0.95 peak normalize :17, chunk-collapsing ``process_tts_chunks`` :26-40) plus
the piece the reference lacks: ``StreamingPostProcessor``, a streaming-safe
trim/normalize so true generation streaming survives postprocessing (the
reference collapses the generator into one chunk, defeating its own streaming
path — SURVEY §3.3 notes this as an anti-pattern not to replicate; the batch
entrypoint keeps the collapsing behavior for output parity).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def trim_silence(audio: np.ndarray, threshold: float = 0.01) -> np.ndarray:
    if len(audio) == 0:
        return audio
    idx = np.where(np.abs(audio) > threshold)[0]
    if len(idx) == 0:
        return audio
    return audio[idx[0] : idx[-1] + 1]


def normalize_output(audio: np.ndarray, peak: float = 0.95) -> np.ndarray:
    if len(audio) == 0:
        return audio
    max_val = float(np.max(np.abs(audio)))
    if max_val <= 1e-8:
        return audio
    return np.clip(audio * (peak / max_val), -1.0, 1.0)


def process_tts_chunks(
    chunks: Iterator[np.ndarray],
    *,
    trim: bool = True,
    normalize: bool = True,
) -> Iterator[np.ndarray]:
    """Batch path: collapse, trim, normalize (reference-identical)."""
    all_chunks = list(chunks)
    if not all_chunks:
        return iter(())
    audio = np.concatenate(all_chunks)
    if trim:
        audio = trim_silence(audio)
    if normalize:
        audio = normalize_output(audio)
    return iter([audio.astype(np.float32)])


class StreamingPostProcessor:
    """Trim/normalize that preserves chunk-at-a-time streaming.

    - Leading silence: dropped exactly (buffers only silent prefixes).
    - Trailing silence: a small lookahead of fully-silent chunks is held back
      and only emitted if speech resumes; at ``finish()`` held silence is
      dropped, matching the batch trim on the tail.
    - Normalization: streaming can't know the global peak, so gain tracks the
      running peak (monotonically decreasing gain, never clipping). The first
      chunk sets the initial estimate.
    """

    def __init__(
        self,
        *,
        trim: bool = True,
        normalize: bool = True,
        threshold: float = 0.01,
        peak: float = 0.95,
    ):
        self._trim = trim
        self._normalize = normalize
        self._threshold = threshold
        self._peak = peak
        self._started = False  # first non-silent sample seen
        self._held: list[np.ndarray] = []  # trailing-silence lookahead
        self._running_max = 0.0

    def feed(self, chunk: np.ndarray) -> list[np.ndarray]:
        chunk = np.asarray(chunk, dtype=np.float32)
        if chunk.size == 0:
            return []
        out: list[np.ndarray] = []
        if self._trim and not self._started:
            idx = np.where(np.abs(chunk) > self._threshold)[0]
            if len(idx) == 0:
                # hold, don't drop: if the stream never starts, batch
                # trim_silence returns all-silent audio unchanged
                self._held.append(chunk)
                return []
            self._held = []  # speech found: leading silence is trimmed
            chunk = chunk[idx[0] :]
            self._started = True
        if self._trim:
            if np.max(np.abs(chunk)) <= self._threshold:
                self._held.append(chunk)  # maybe trailing silence
                return []
            # speech resumed: flush held silence first
            out.extend(self._held)
            self._held = []
            # hold back this chunk's own silent suffix — if the stream ends
            # here, the batch trim would have cut it
            voiced = np.where(np.abs(chunk) > self._threshold)[0]
            tail_start = voiced[-1] + 1
            if tail_start < len(chunk):
                self._held.append(chunk[tail_start:])
                chunk = chunk[:tail_start]
        out.append(chunk)
        return [self._apply_gain(c) for c in out]

    def finish(self) -> list[np.ndarray]:
        """End of stream: held trailing silence is dropped (trim semantics);
        an all-silent stream is emitted whole (batch trim returns it
        unchanged rather than producing zero samples)."""
        held, self._held = self._held, []
        if not self._started and held:
            return [self._apply_gain(c) for c in held]
        return []

    def _apply_gain(self, chunk: np.ndarray) -> np.ndarray:
        if not self._normalize:
            return chunk
        self._running_max = max(self._running_max, float(np.max(np.abs(chunk))))
        if self._running_max <= 1e-8:
            return chunk
        gain = self._peak / self._running_max
        return np.clip(chunk * gain, -1.0, 1.0).astype(np.float32)
