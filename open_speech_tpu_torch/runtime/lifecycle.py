"""Background model eviction daemon (reference behavior: src/lifecycle.py).

Every 30 s: drop non-default models idle past OS_MODEL_TTL, then trim to
OS_MAX_LOADED_MODELS oldest-first. Eviction happens under the router lock.
"""

from __future__ import annotations

import asyncio
import logging
import time

from open_speech_tpu_torch.config import settings

logger = logging.getLogger(__name__)

_SWEEP_INTERVAL_S = 30


class ModelLifecycleManager:
    def __init__(self, router, manager=None) -> None:
        self._router = router
        # optional ModelManager: its check_ttl covers the TTS backends
        # (the STT sweep below runs first with the router lock + re-check,
        # so the manager pass only ever finds idle TTS models)
        self._manager = manager
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._run())
        logger.info(
            "Model lifecycle started (ttl=%ds, max_loaded=%d)",
            settings.os_model_ttl,
            settings.os_max_loaded_models,
        )

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is None:
            return
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(_SWEEP_INTERVAL_S)
            try:
                await self._sweep()
            except Exception:  # noqa: BLE001
                logger.exception("Lifecycle eviction error")

    def _idle_victims(self, backend, now: float) -> list[str]:
        ttl = settings.os_model_ttl
        if ttl <= 0:
            return []
        load_lock = getattr(backend, "_load_lock", None)
        if load_lock is not None and load_lock.locked():
            # a load + precompile sweep is in flight (it holds the load
            # lock for its whole duration, minutes on a cold cache);
            # evicting anything now risks unloading the very model being
            # warmed — its _last_used stamp predates the sweep
            return []
        return [
            model_id
            for model_id in list(backend._models)
            if model_id != settings.stt_model
            and now - backend._last_used.get(model_id, now) > ttl
        ]

    def _overflow_victims(self, backend) -> list[str]:
        limit = settings.os_max_loaded_models
        if limit <= 0:
            return []
        excess = len(backend._models) - limit
        if excess <= 0:
            return []
        candidates = sorted(
            (m for m in backend._models if m != settings.stt_model),
            key=lambda m: backend._last_used.get(m, 0),
        )
        return candidates[:excess]

    async def _unload_if_still_victim(self, backend, model_id: str, reason: str) -> None:
        """Re-check victimhood at unload time: a request may have bumped
        _last_used between victim selection and here (selection runs
        outside any lock), and unloading a just-active model costs a full
        reload + warmup recompile on its next request."""
        async with self._router._lock:
            if model_id not in backend._models:
                return
            still = (
                self._idle_victims(backend, time.time())
                if reason == "TTL"
                else self._overflow_victims(backend)
            )
            if model_id not in still:
                return
            idle = time.time() - backend._last_used.get(model_id, 0)
            logger.info("%s eviction: unloading %s (idle %.0fs)", reason, model_id, idle)
            backend.unload_model(model_id)

    async def _sweep(self) -> None:
        backend = self._router._default_backend
        now = time.time()
        for model_id in self._idle_victims(backend, now):
            await self._unload_if_still_victim(backend, model_id, "TTL")
        for model_id in self._overflow_victims(backend):
            await self._unload_if_still_victim(backend, model_id, "LRU")
        if self._manager is not None:
            self._manager.check_ttl()
        # a retired model's weights + KV pools must not stay pinned by a
        # stale continuous batcher (runtime/batcher_pool.retire_stale)
        try:
            from open_speech_tpu_torch.runtime import batcher_pool

            n = await batcher_pool.retire_stale(backend)
            if n:
                logger.info("Retired %d stale batcher(s)", n)
        except Exception:  # noqa: BLE001
            logger.exception("Stale-batcher retirement failed")
