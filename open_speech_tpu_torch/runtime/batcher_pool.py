"""Shared batcher pool: one continuous batcher per (model, language, task).

Counterpart of ``open_speech_tpu/runtime/batcher_pool.py``. Streaming
sessions submit mel windows here instead of running whole model calls on
executor threads, so every live session's decode advances in one device
block per tick. Opt-in via ``OS_BATCHER_ENABLED``; keyed per prompt
configuration, because a batcher's slots share one prompt. The model's
family picks the batcher: Whisper's ``ContinuousBatcher``, or an audio-LLM's
(Voxtral) ``AudioLLMBatcher``.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np
import torch

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.voxtral.model import VoxtralConfig
from open_speech_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim
from open_speech_tpu_torch.runtime import tracing
from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher, SlotScheduler

logger = logging.getLogger(__name__)

_batchers: dict[tuple, SlotScheduler] = {}
_lock: asyncio.Lock | None = None
_lock_loop: asyncio.AbstractEventLoop | None = None
_retiring: set[asyncio.Task] = set()  # drain tasks, held until they end


def _settings_mesh():
    """The mesh of ``OS_TPU_MESH`` when it has a model axis, else None.

    The backend shards the model at load (``_maybe_shard``); the batcher
    takes the same mesh so its pools hold the same heads. A model axis of
    1 needs no mesh (building one is a collective that independent data
    replicas must not wait on). An invalid mesh is logged and the batcher
    runs on the model as loaded, as the backend serves it."""
    spec = (settings.os_tpu_mesh or "").strip()
    if not spec:
        return None
    try:
        from open_speech_tpu_torch.parallel.mesh import mesh_from_settings, parse_mesh

        return mesh_from_settings() if parse_mesh(spec)[1] > 1 else None
    except Exception:  # noqa: BLE001 — serve unsharded, as the backend does
        logger.exception("OS_TPU_MESH invalid; batcher unsharded")
        return None


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


def _audio_llm_batcher(entry: dict, language: str):
    """An audio-LLM's batcher: the model, its transcription prompt and end
    token from the entry's ``tok`` (``models/voxtral/tokens.py``)."""
    from open_speech_tpu_torch.runtime.audio_llm_batcher import AudioLLMBatcher

    tok = entry["tok"]
    return AudioLLMBatcher(
        entry["model"], tok.transcription_prompt(language), tok.eos,
        slots=settings.os_batch_max_sessions,
        max_new_tokens=min(AudioLLMBatcher.token_budget(30.0), settings.os_batch_max_tokens),
    )


async def get_batcher(
    backend, model_id: str, language: str | None, task: str = "transcribe"
) -> SlotScheduler:
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
        if isinstance(entry["cfg"], VoxtralConfig):
            if task != "transcribe":
                raise ValueError(f"{model_id} serves transcription only through the batcher")
            batcher = _audio_llm_batcher(entry, language or "en")
        else:
            kwargs = dict(
                slots=settings.os_batch_max_sessions,
                max_new_tokens=min(224, settings.os_batch_max_tokens),
                language=language or "en",
                task=task,
                suppress_tokens=tuple(entry["tok"].non_speech_tokens),
            )
            make = getattr(backend, "make_batcher", None)  # a model group's leader
            if make is not None:
                batcher = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: make(model_id, **kwargs))
            else:
                batcher = ContinuousBatcher(entry["model"], entry["cfg"], entry["tok"].special,
                                            mesh=_settings_mesh(), **kwargs)
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
    streaming session submits through. While spans are recorded
    (``runtime/tracing.py``) the window gets an id, which its mel front end
    and its spans in the batcher carry."""
    wid = tracing.window_id() if tracing.on() else None
    loop = asyncio.get_running_loop()
    entry = await loop.run_in_executor(None, backend._ensure_model, model_id)
    tok = entry["tok"]
    batcher = await get_batcher(backend, model_id, language, task)
    n_mels, frames = batcher.mel_shape
    window_samples = frames * 160
    duration_s = len(pcm) / 16000

    def _mel() -> torch.Tensor:
        # device work stays off the event loop; the window stays on the
        # device for the admission's encode
        span = tracing.begin("stt.mel", (wid,)) if wid is not None else None
        audio = torch.from_numpy(np.asarray(pcm, np.float32)).to(batcher.device)
        mel = log_mel_spectrogram(pad_or_trim(audio, window_samples), n_mels=n_mels)
        if span is not None:
            tracing.end(span)
        return mel

    mel = await loop.run_in_executor(None, _mel)
    budget = batcher.token_budget(duration_s)
    token = tracing.window.set(wid) if wid is not None else None
    try:
        tokens = await batcher.transcribe_window(mel, max_new_tokens=budget)
    finally:
        if token is not None:
            tracing.window.reset(token)
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
