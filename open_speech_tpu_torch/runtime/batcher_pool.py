"""Shared batcher pool: one ContinuousBatcher per (model, language, task).

Counterpart of ``open_speech_tpu/runtime/batcher_pool.py``. Streaming
sessions submit mel windows here instead of running whole model calls on
executor threads, so every live session's decode advances in one device
block per tick. Opt-in via ``OS_BATCHER_ENABLED``; keyed per prompt
configuration, because a batcher's slots share one prompt.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np
import torch

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim
from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

logger = logging.getLogger(__name__)

_batchers: dict[tuple, ContinuousBatcher] = {}
_lock: asyncio.Lock | None = None
_lock_loop: asyncio.AbstractEventLoop | None = None
_retiring: set[asyncio.Task] = set()  # drain tasks, held until they end


def _pool_lock() -> asyncio.Lock:
    """The pool mutex, bound to the *running* loop.

    A module-level ``asyncio.Lock`` binds to the first loop that acquires
    it; batchers from a dead loop are unusable anyway (their scheduler task
    died with it), so a new loop gets a new lock."""
    global _lock, _lock_loop
    loop = asyncio.get_running_loop()
    if _lock is None or _lock_loop is not loop:
        _lock = asyncio.Lock()
        _lock_loop = loop
    return _lock


def _on_live_loop(batcher) -> bool:
    loop = getattr(batcher, "_bound_loop", None)
    if loop is None:
        # never started through the pool: treat as live, so it still
        # gets a graceful drain on the current loop
        return True
    try:
        return loop is asyncio.get_running_loop()
    except RuntimeError:  # pragma: no cover - no running loop
        return False


def _start_retire(batcher) -> None:
    task = asyncio.get_running_loop().create_task(_retire(batcher))
    _retiring.add(task)
    task.add_done_callback(_retiring.discard)


async def _retire(batcher) -> None:
    for _ in range(600):  # up to ~60 s of draining
        if batcher.occupancy == 0 and batcher._queue.empty():
            break
        await asyncio.sleep(0.1)
    await batcher.stop()


def _is_current(batcher, backend, model_id: str) -> bool:
    # the backend's loaded model object: a reload makes a new one
    entry = getattr(backend, "_models", {}).get(model_id)
    return entry is not None and entry.get("model") is batcher.model


async def get_batcher(
    backend, model_id: str, language: str | None, task: str = "transcribe"
) -> ContinuousBatcher:
    key = (model_id, language or "en", task)
    live = _batchers.get(key)
    if live is not None and _on_live_loop(live) and _is_current(live, backend, model_id):
        return live
    async with _pool_lock():
        live = _batchers.get(key)
        if live is not None:
            if not _on_live_loop(live):
                # scheduler task died with an earlier event loop: nothing
                # to drain (its futures are gone too), just drop it
                del _batchers[key]
            elif _is_current(live, backend, model_id):
                return live
            else:
                # the model was unloaded or reloaded: a stale batcher would
                # pin the old weights and decode with them. Retire it once
                # its in-flight work drains.
                del _batchers[key]
                _start_retire(live)
        # a model load reads the disk and warms up: never on the loop
        entry = await asyncio.get_running_loop().run_in_executor(
            None, backend._ensure_model, model_id
        )
        batcher = ContinuousBatcher(
            entry["model"],
            entry["cfg"],
            entry["tok"].special,
            slots=settings.os_batch_max_sessions,
            max_new_tokens=min(224, settings.os_batch_max_tokens),
            language=language or "en",
            task=task,
            suppress_tokens=tuple(entry["tok"].non_speech_tokens),
        )
        batcher.start()
        _batchers[key] = batcher
        logger.info(
            "Continuous batcher started for %s (lang=%s, slots=%d)",
            model_id, language or "en", settings.os_batch_max_sessions,
        )
        return batcher


async def transcribe_pcm_batched(
    backend, model_id: str, language: str, pcm, task: str = "transcribe"
) -> dict:
    """One utterance window through the shared batcher: mel framing,
    duration-scaled token budget, token decode. The batched-STT entry the
    streaming session submits through."""
    loop = asyncio.get_running_loop()
    entry = await loop.run_in_executor(None, backend._ensure_model, model_id)
    cfg, tok = entry["cfg"], entry["tok"]
    batcher = await get_batcher(backend, model_id, language, task)
    window_samples = cfg.n_audio_ctx * 2 * 160
    duration_s = len(pcm) / 16000

    def _mel() -> torch.Tensor:
        # device work stays off the event loop; the window stays on the
        # device for the admission's encode
        audio = torch.from_numpy(np.asarray(pcm, np.float32)).to(batcher.device)
        return log_mel_spectrogram(pad_or_trim(audio, window_samples), n_mels=cfg.n_mels)

    mel = await loop.run_in_executor(None, _mel)
    budget = -(-min(224, int(duration_s * 12) + 12) // 16) * 16
    tokens = await batcher.transcribe_window(mel, max_new_tokens=budget)
    return {"text": tok.decode(tokens).strip()}


async def shutdown_batchers() -> None:
    for batcher in list(_batchers.values()):
        if _on_live_loop(batcher):
            await batcher.stop()
    _batchers.clear()


async def retire_stale(backend) -> int:
    """Retire batchers whose model was unloaded or reloaded, so an evicted
    model's weights and KV pools are not pinned by a batcher nobody will
    use again. Returns the number removed."""
    stale = []
    removed = 0
    async with _pool_lock():
        for key, batcher in list(_batchers.items()):
            if not _is_current(batcher, backend, key[0]):
                del _batchers[key]
                removed += 1
                # dead-loop batchers are dropped without a drain task
                if _on_live_loop(batcher):
                    stale.append(batcher)
    for batcher in stale:
        _start_retire(batcher)
    return removed


def reset_pool() -> None:
    """Drop batchers without awaiting (tests, fresh event loops)."""
    global _lock, _lock_loop
    _batchers.clear()
    _lock = None
    _lock_loop = None


def pool_stats() -> dict:
    """Per-batcher occupancy and throughput."""
    return {
        f"{model_id}/{lang}/{task}": {**b.stats, "occupancy": b.occupancy, "slots": b.n_slots}
        for (model_id, lang, task), b in _batchers.items()
    }
