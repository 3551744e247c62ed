"""Serving a model sharded over a model axis: one rank answers, the others follow.

The JAX server shards whisper over its local chips from one process
(GSPMD). PyTorch runs one process per rank, so under ``OS_TPU_MESH="d,m"``
with m > 1 each model group of m ranks serves as one replica: its
model-coordinate-0 rank (the leader) runs the HTTP server, and the other
ranks run ``follow``, which receives each STT call from the leader
(``broadcast_object_list`` over the model group) and makes it on its own
shard. A sharded call all-reduces inside every row-parallel linear, so the
ranks must make the same calls in the same order: the leader broadcasts
and runs each call under one lock.

The calls that run the model: loading and unloading a model (its warmup
included), transcription and translation (batched long-form and
speculative decoding inside them), language detection, and the continuous
batcher's admissions, ticks and pool resets (``LeaderBatcher``: each op
carries the leader's scheduler state, so a follower's batcher steps the
same slots at the same positions; its stop frees the followers' copies).
The streaming session's incremental encoder calls the model directly, so
``serve_model_axis`` turns it off; sessions then take the batcher or the
executor path. An idle leader
sends a no-op every ``HEARTBEAT_S``: a follower waits in a collective
between calls, and a collective that waits past the group's timeout (10
minutes under NCCL) aborts its process.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import threading
import time
from collections import Counter

import torch

from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

logger = logging.getLogger(__name__)

# the scheduler state a batcher op reads and writes on the host
_STATE = ("_tokens", "_pos", "_step_idx", "_last", "_penult", "_max_ts", "_active",
          "_steps", "_max_new")
_STOP = ("stop", (), {})
_NOOP = ("noop", (), {})
HEARTBEAT_S = 30.0


def _broadcast(call, group, src: int):
    import torch.distributed as dist

    box = [call]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


class ModelGroupLeader:
    """The leader's STT backend: the calls that run the model are broadcast
    to the followers and then run here, under one lock; every other
    attribute is the wrapped backend's."""

    def __init__(self, backend, group, src: int) -> None:
        self._backend = backend
        self._group = group
        self._src = src
        self._lock = threading.RLock()
        self._batchers = 0
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self._heartbeat = threading.Thread(target=self._beat, name="model-group-heartbeat",
                                           daemon=True)
        self._heartbeat.start()

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def run(self, call: tuple, local):
        """Broadcast ``call`` = (name, args, kwargs), then run ``local()``."""
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("the model group has stopped")
            _broadcast(call, self._group, self._src)
            try:
                return local()
            finally:
                self._last = time.monotonic()

    def _beat(self) -> None:
        while not self._stopped.wait(HEARTBEAT_S / 4):
            with self._lock:
                if not self._stopped.is_set() and time.monotonic() - self._last >= HEARTBEAT_S:
                    _broadcast(_NOOP, self._group, self._src)
                    self._last = time.monotonic()

    def _call(self, name: str, *args, **kwargs):
        return self.run((name, args, kwargs), lambda: getattr(self._backend, name)(*args, **kwargs))

    def load_model(self, model_id: str) -> None:
        return self._call("load_model", model_id)

    def unload_model(self, model_id: str) -> None:
        return self._call("unload_model", model_id)

    def transcribe(self, audio: bytes, model: str, **kwargs):
        return self._call("transcribe", audio, model, **kwargs)

    def translate(self, audio: bytes, model: str, **kwargs):
        return self._call("translate", audio, model, **kwargs)

    def detect_language_pcm(self, model_id: str, pcm):
        return self._call("detect_language_pcm", model_id, pcm)

    def _ensure_model(self, model_id: str) -> dict:
        with self._lock:  # no unload between the test and the lookup
            if not self._backend.is_model_loaded(model_id):
                self.load_model(model_id)
            return self._backend._ensure_model(model_id)

    def make_batcher(self, model_id: str, **kwargs) -> "LeaderBatcher":
        """A continuous batcher whose device ops the followers mirror."""
        with self._lock:
            self._batchers += 1
            key = self._batchers
            entry = self._ensure_model(model_id)
            return self.run(("batcher_new", (key, model_id), kwargs),
                            lambda: LeaderBatcher(self, key, entry, **kwargs))

    def stop(self) -> None:
        """Let the followers return; later calls raise."""
        with self._lock:
            if not self._stopped.is_set():
                self._stopped.set()
                _broadcast(_STOP, self._group, self._src)
        self._heartbeat.join()


def _model_args(entry: dict) -> tuple:
    return (entry["model"], entry["cfg"], entry["tok"].special)


class LeaderBatcher(ContinuousBatcher):
    """The leader's batcher: admissions, ticks and pool resets are
    broadcast with the scheduler state they start from."""

    def __init__(self, leader: ModelGroupLeader, key: int, entry: dict, **kwargs) -> None:
        super().__init__(*_model_args(entry), **kwargs)
        self._leader, self._key = leader, key

    def _op(self, op: str, payload, local):
        state = {name: getattr(self, name).copy() for name in _STATE}
        return self._leader.run(("batcher", (self._key, op, state, payload), {}), local)

    def _admit_device(self, batch) -> None:
        payload = [(slot, mel.cpu().numpy(), max_new) for slot, mel, max_new, _future in batch]
        self._op("admit", payload, lambda: super(LeaderBatcher, self)._admit_device(batch))

    def _tick(self) -> None:
        self._op("tick", None, lambda: super(LeaderBatcher, self)._tick())

    def _reset_pools(self) -> None:
        self._op("reset", None, lambda: super(LeaderBatcher, self)._reset_pools())

    async def stop(self) -> None:
        """Stop, and let the followers free their copies' pools."""
        await super().stop()
        await asyncio.get_running_loop().run_in_executor(None, self._op, "close", None, lambda: None)


class _NoLoop:
    def call_soon_threadsafe(self, *args) -> None:
        pass


class _NoFuture:
    """Stands for a request's future in a follower's batcher: nobody waits."""

    def done(self) -> bool:
        return False

    def get_loop(self) -> _NoLoop:
        return _NoLoop()


def follow(backend, group, src: int) -> Counter:
    """A follower's loop: make each call the leader broadcasts, until it
    says stop; returns how many of each it received. A call that fails here
    failed on the leader too (the same code on the same inputs); it is
    logged and the loop goes on."""
    batchers: dict[int, ContinuousBatcher] = {}
    calls: Counter = Counter()
    while True:
        name, args, kwargs = _broadcast(None, group, src)
        calls[name] += 1
        if name == "stop":
            return calls
        if name == "noop":
            continue
        try:
            if name == "batcher_new":
                key, model_id = args
                entry = backend._ensure_model(model_id)
                batchers[key] = ContinuousBatcher(*_model_args(entry), **kwargs)
            elif name == "batcher" and args[1] == "close":
                del batchers[args[0]]
            elif name == "batcher":
                _follow_batcher(batchers[args[0]], *args[1:])
            else:
                getattr(backend, name)(*args, **kwargs)
        except Exception:  # noqa: BLE001 — the leader reports it to its caller
            logger.exception("model-group call %s failed on this rank", name)


def _follow_batcher(batcher: ContinuousBatcher, op: str, state: dict, payload) -> None:
    for attr, value in state.items():
        getattr(batcher, attr)[:] = value
    if op == "admit":
        batch = [(slot, torch.from_numpy(mel), max_new, _NoFuture()) for slot, mel, max_new in payload]
        try:
            batcher._admit_device(batch)
        finally:
            batcher._slots.clear()  # the leader keeps the requests
    elif op == "tick":
        batcher._tick()
        batcher._slots.clear()
    else:
        batcher._reset_pools()


def serve_model_axis(backend, mesh):
    """This rank's part in serving ``mesh``'s model axis: the leader's
    backend (``ModelGroupLeader``) on model coordinate 0, else None after
    following the leader until it stops (a follower ignores SIGTERM and
    SIGINT). Turns the streaming session's incremental encoder off on every
    rank (it calls the model directly)."""
    import torch.distributed as dist

    from open_speech_tpu_torch.config import settings

    settings.os_stream_incremental = False
    group = mesh.get_group("model")
    src = dist.get_global_rank(group, 0)
    if mesh.get_local_rank("model") == 0:
        return ModelGroupLeader(backend, group, src)
    # a follower ends when its leader stops: a signal that torchrun passes
    # on to every rank must not leave the leader's last broadcast unmatched
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    calls = follow(backend, group, src)
    logger.info("model group: the leader stopped after %d calls", sum(calls.values()))
    return None
