"""Concurrent Kokoro and Piper requests batched onto one device pass.

Counterpart of ``open_speech_tpu/runtime/tts_batcher.py``. Jobs arrive
from request threads (every serving path calls the backend's sync
generator); one daemon scheduler thread per loaded model owns the card,
gathers the jobs that arrive together and hands each job its rows' audio
back over a ``queue.Queue`` as host float32 arrays.

- ``TTSBatcher`` (Kokoro): one batched ``encode_utterance`` and one
  blockwise ``vocode_streaming`` over the gathered jobs.
- ``PiperBatcher`` (VITS): one batched ``synthesize_vits``. VITS renders
  the whole masked utterance in one pass, so the batch is the streaming
  unit: each job's PCM lands as one chunk.

Row independence: every op of both models is per row (masked norms,
per-row LSTM lengths and frame masks), and each row's noise is a function
of that row alone (Kokoro: its own generator seeded 0 on the model's
device; Piper: ``_row_noise`` of the row's seed), so a batched row equals
the same request synthesized alone. The JAX version pads the batch to a
bucket (1, 4, 16, 64) so that XLA compiles few programs; eager torch
compiles nothing per shape, so both batches here are exactly the jobs
gathered (a padded row would cost a full row of convolutions for nothing).

The scheduler thread never holds the interpreter lock across a device
sync: PyTorch releases it inside its ops, the copies to the host included,
so request threads run while the card works.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from open_speech_tpu_torch.models.kokoro.model import KModel, KokoroConfig, encode_utterance, vocode_streaming
from open_speech_tpu_torch.models.piper.model import PiperConfig, PiperModel, synthesize_vits

logger = logging.getLogger(__name__)

MAX_BATCH = 64  # rows per device pass
GATHER_WINDOW_S = 0.010  # wait this long for peers before launching
_STOP = object()  # queue sentinel ending a stopped batcher's thread


class _BatchScheduler:
    """Queue, gather and thread shell of a batched-TTS scheduler.

    Subclasses implement ``_run_batch(jobs)``: jobs are ``(*payload,
    out_queue)`` tuples, and the implementation puts audio chunks, then
    ``None``, on every job's queue."""

    def __init__(self, model, cfg) -> None:
        self.model = model
        self.cfg = cfg
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._stopping = False
        self._last_batch_end = 0.0
        self.stats = {"batches": 0, "jobs": 0, "peak_batch": 0}

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=type(self).__name__.lower())
                self._thread.start()

    def stop(self) -> None:
        """End the scheduler thread and drop the model. A replaced batcher
        (model reload) would otherwise keep a thread blocked on its queue
        and the old weights on the card: repeated reloads would leak card
        memory."""
        self._stopping = True
        self._queue.put(_STOP)

    def submit(self, payload: tuple) -> Iterator[np.ndarray]:
        """Submit one job; yields its float32 audio chunks as they land."""
        if self._stopping:
            raise RuntimeError(f"{type(self).__name__} stopped (model was reloaded)")
        self._ensure_thread()
        out: queue.Queue = queue.Queue()
        self._queue.put((*payload, out))
        while True:
            item = out.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    # ── scheduler thread ──────────────────────────────────────────────

    def _gather(self) -> list:
        jobs = [self._queue.get()]
        # an idle arrival with no queued peers launches at once: the
        # gather window would add its length to every solo request's first
        # audio. A batch that ended under 50 ms ago means a burst: then wait.
        if self._queue.empty() and time.monotonic() - self._last_batch_end > 0.05:
            return jobs
        deadline = time.monotonic() + GATHER_WINDOW_S
        while len(jobs) < MAX_BATCH:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                jobs.append(self._queue.get(timeout=timeout))
            except queue.Empty:
                break
        return jobs

    def _loop(self) -> None:
        while True:
            jobs = self._gather()
            if self._stopping:
                err = RuntimeError(f"{type(self).__name__} stopped")
                for job in jobs:
                    if job is not _STOP:
                        job[-1].put(err)
                        job[-1].put(None)
                self.model = None  # release the card's weights promptly
                return
            jobs = [j for j in jobs if j is not _STOP]
            if not jobs:
                continue
            try:
                self._run_batch(jobs)
            except Exception as e:  # noqa: BLE001 — the thread must outlive a failed batch
                logger.exception("TTS batch failed")
                for *_rest, out in jobs:
                    out.put(e)
                    out.put(None)
            self._last_batch_end = time.monotonic()

    def _count(self, jobs: list) -> None:
        self.stats["batches"] += 1
        self.stats["jobs"] += len(jobs)
        self.stats["peak_batch"] = max(self.stats["peak_batch"], len(jobs))

    def _run_batch(self, jobs: list) -> None:  # pragma: no cover
        raise NotImplementedError


class TTSBatcher(_BatchScheduler):
    """Batches Kokoro synthesis jobs onto shared device passes."""

    model: KModel | None
    cfg: KokoroConfig

    def precompile(self, rows: int = 4) -> None:
        """One batch of ``rows`` warmup jobs ahead of traffic, long enough
        for a first block and interior blocks: the first burst then finds
        the card's libraries set up for batched shapes."""
        ids = list(range(1, 33))
        sink: queue.Queue = queue.Queue()
        style = np.zeros(2 * self.cfg.style_dim, np.float32)
        self._run_batch([(ids, style, 1.0, sink)] * min(rows, MAX_BATCH))
        while sink.get() is not None:  # drain
            pass

    def synthesize(self, phoneme_ids: list[int], style: np.ndarray, speed: float) -> Iterator[np.ndarray]:
        """Submit one utterance; yields float32 audio chunks as they land."""
        return self.submit((phoneme_ids, style, speed))

    def _run_batch(self, jobs: list) -> None:
        cfg, model = self.cfg, self.model
        dev = model.device
        n = len(jobs)
        phonemes = np.zeros((n, cfg.max_phonemes), np.int64)
        lengths = np.ones((n,), np.int64)
        styles = np.zeros((n, 2 * cfg.style_dim), np.float32)
        speeds = np.ones((n,), np.float32)
        for i, (ids, style, speed, _out) in enumerate(jobs):
            ids = list(ids)[: cfg.max_phonemes]
            phonemes[i, : len(ids)] = ids
            lengths[i] = max(len(ids), 1)
            styles[i] = style
            speeds[i] = speed if speed and speed > 0 else 1.0
        g, n_frames = encode_utterance(
            model, cfg, *(torch.from_numpy(a).to(dev) for a in (phonemes, lengths, styles, speeds)))
        # per-row generators: a row's noise does not depend on its peers
        gens = [torch.Generator(device=dev).manual_seed(0) for _ in range(n)]
        queues = [out for *_r, out in jobs]
        totals = None
        emitted = np.zeros((n,), np.int64)
        for block in vocode_streaming(model, cfg, g, n_frames, rng=gens, block_frames=32,
                                      first_block_frames=16, wire="i16"):
            if totals is None:  # vocode_streaming has read n_frames by now
                totals = n_frames.cpu().numpy().astype(np.int64) * cfg.samples_per_frame
            width = block.shape[1]
            for i, out in enumerate(queues):
                take = int(min(width, totals[i] - emitted[i]))
                if take > 0:
                    out.put(block[i, :take])
                    emitted[i] += take
        for out in queues:
            out.put(None)
        self._count(jobs)


class PiperBatcher(_BatchScheduler):
    """Batches Piper (VITS) jobs: one ``synthesize_vits`` per batch."""

    model: PiperModel | None
    cfg: PiperConfig

    def precompile(self, rows: int = 4) -> None:
        """One batch of ``rows`` warmup jobs ahead of traffic: the card's
        libraries are then set up for batched shapes."""
        sink: queue.Queue = queue.Queue()
        self._run_batch([(list(range(1, 17)), 0, 1.0, 0, sink)] * min(rows, MAX_BATCH))
        while sink.get() is not None:  # drain
            pass

    def synthesize(self, phoneme_ids: list[int], speaker_id: int, speed: float, seed: int) -> Iterator[np.ndarray]:
        """Submit one piece; yields its float32 PCM (a single chunk)."""
        return self.submit((phoneme_ids, speaker_id, speed, seed))

    def _run_batch(self, jobs: list) -> None:
        cfg = self.cfg
        n = len(jobs)
        phonemes = np.zeros((n, cfg.max_phonemes), np.int64)
        lengths = np.ones((n,), np.int64)
        speakers = np.zeros((n,), np.int64)
        speeds = np.ones((n,), np.float32)
        seeds = []
        for i, (ids, speaker, speed, seed, _out) in enumerate(jobs):
            ids = list(ids)[: cfg.max_phonemes]
            phonemes[i, : len(ids)] = ids
            lengths[i] = max(len(ids), 1)
            speakers[i] = speaker
            speeds[i] = speed if speed and speed > 0 else 1.0
            seeds.append(seed)
        audio, n_frames = _piper_rows(self.model, cfg, *(torch.from_numpy(a) for a in (
            phonemes, lengths, speakers, speeds)), seeds)
        totals = n_frames.cpu().numpy() * cfg.samples_per_frame
        audio = audio.cpu().numpy()
        for i, (*_r, out) in enumerate(jobs):
            out.put(audio[i, : int(totals[i])])
            out.put(None)
        self._count(jobs)


def _row_noise(seed: int, cfg: PiperConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One row's (dp noise [2, P] scaled by noise_scale_w, z noise [hidden,
    F]) from a CPU generator seeded with the row's seed alone, then moved
    to ``device``: a row's noise depends on neither its batch peers nor the
    device, so the card's rows equal the CPU's. (The JAX package folds the
    seed into ``PRNGKey(0)``; ``jax.random`` and ``torch.Generator`` draw
    different numbers, so parity tests inject JAX's rows here.)"""
    gen = torch.Generator().manual_seed(int(seed))
    dp = torch.randn((2, cfg.max_phonemes), generator=gen) * cfg.noise_scale_w
    z = torch.randn((cfg.hidden, cfg.max_frames), generator=gen)
    return dp.to(device), z.to(device)


def _piper_rows(model: PiperModel, cfg: PiperConfig, phonemes, lengths, speakers, speeds, seeds):
    """``synthesize_vits`` with each row's noise drawn from that row's seed.

    ``synthesize_vits`` draws batch-shaped noise from one generator, right
    for a fixed batch; a batcher mixes arbitrary requests, so each row's
    noise must be a function of the row alone: ``_row_noise`` per row,
    injected as the explicit dp/z noise."""
    rows = [_row_noise(seed, cfg, model.device) for seed in seeds]
    dp_noise = torch.stack([dp for dp, _ in rows])
    z_noise = torch.stack([z for _, z in rows])
    return synthesize_vits(model, cfg, phonemes, lengths, speakers, speeds, dp_noise=dp_noise, z_noise=z_noise)


# ──────────────────────────────────────────────────────────────────────
# registry: one batcher per loaded model
# ──────────────────────────────────────────────────────────────────────

_batchers: dict[tuple, _BatchScheduler] = {}
_registry_lock = threading.Lock()


def get_tts_batcher(backend) -> TTSBatcher:
    """The batcher of the backend's loaded model. Keyed by the backend,
    with a check that the batcher holds the backend's current model: a
    reload replaces (and stops) it."""
    key = ("kokoro", id(backend))
    with _registry_lock:
        b = _batchers.get(key)
        if b is None or b.model is not backend._model:
            if b is not None:
                b.stop()  # end the old thread; drop the old weights
            b = TTSBatcher(backend._model, backend._cfg)
            _batchers[key] = b
        return b


def get_piper_batcher(backend, mid: str) -> PiperBatcher:
    """The batcher of one loaded Piper voice, replaced (and the old one
    stopped) when the voice was reloaded."""
    model, cfg, _meta = backend._models[mid]
    key = ("piper", id(backend), mid)
    with _registry_lock:
        b = _batchers.get(key)
        if b is None or b.model is not model:
            if b is not None:
                b.stop()
            b = PiperBatcher(model, cfg)
            _batchers[key] = b
        return b


def release_piper_batcher(backend, mid: str) -> None:
    """Stop the batcher of an unloading Piper voice (drops its weights)."""
    key = ("piper", id(backend), mid)
    with _registry_lock:
        b = _batchers.pop(key, None)
    if b is not None:
        b.stop()


def tts_batcher_stats() -> dict:
    with _registry_lock:  # a snapshot: get_tts_batcher may insert concurrently
        return {"/".join(str(p) for p in k): dict(b.stats) for k, b in _batchers.items()}


def reset_tts_batchers() -> None:
    with _registry_lock:
        for b in _batchers.values():
            b.stop()
        _batchers.clear()
