"""Pocket-TTS continuous session batcher: a slot pool for the Mimi LM.

Counterpart of ``open_speech_tpu/runtime/pocket_batcher.py``. Concurrent
sessions share the card's programs, as in the STT continuous batcher:

  - the temporal KV pool ([L, S, H, max_ctx, Dh], S = slots) is allocated
    once for the batcher's lifetime and written in place;
  - a joining session copies its voice-prompt caches into a free slot row
    (the cached ``PromptState`` is only read), then ONE batched text
    prefill over the pool warms every joining row (rows that do not join
    pass length 0 and keep their caches);
  - one **pool group** advances every live slot ``block`` frames, with
    per-slot positions and delayed-stream live masks on the card, and the
    decided tokens stay on the card (a per-slot token buffer);
  - completed frame blocks decode through ONE batched stateful Mimi step:
    rows that start a stream reset their state, rows that do not emit keep
    theirs (a per-row select), so a row's PCM equals its solo run;
  - slots retire when their frame budget is done and are reusable at once.

Which rows emit, and which frames, follows from the host's counters
alone, so the host uploads each group's plan through one pinned buffer
and reads the card back ONCE per group: the PCM of the rows that emit (or,
in a group where none does, one token, which frees the buffer for the
next group). Generation is greedy (temperature 0, the serving default).
The JAX version donates its pool to each jitted group; eager torch
compiles nothing per shape, so ``precompile`` only warms one group.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from open_speech_tpu_torch.models.pocket.lm import (
    PocketLMConfig,
    _rms,
    depformer_sample,
    embed_step,
    temporal_prefill,
    temporal_step,
)
from open_speech_tpu_torch.models.pocket.mimi import (
    init_mimi_stream_state,
    mimi_decode_step,
    select_mimi_stream_rows,
    zero_mimi_stream_rows,
)
from open_speech_tpu_torch.models.pocket.model import PromptState, _bucket
from open_speech_tpu_torch.ops.vocoder import inference

logger = logging.getLogger(__name__)

_STOP = object()


# ──────────────────────────────────────────────────────────────────────
# device steps (no host sync inside)
# ──────────────────────────────────────────────────────────────────────


def _pool_group(params, cfg: PocketLMConfig, kc, vc, outs, audio_in, plan, delays, n_sub: int):
    """Advance every slot ``n_sub`` generation steps.

    kc/vc: the [L, S, H, max_ctx, Dh] pool; outs [S, n_q, T] each slot's
    decided tokens by step; audio_in [S, n_q] this step's delayed-stream
    inputs; plan [4, S]: the next cache position, the slot's step counter
    at the group's start, its step budget (frames + max_delay) and its
    frame budget. Rows past their budget (idle ones have 0) hold their
    position and feed ``initial`` tokens. Returns the next group's
    audio_in; the pool and ``outs`` are written in place."""
    pos, s0, n_lim, max_frames = plan
    s_slots = audio_in.shape[0]
    rows = torch.arange(s_slots, device=audio_in.device)
    text_pad = torch.full((s_slots,), cfg.text_pad_id, dtype=torch.int64, device=audio_in.device)
    for t in range(n_sub):
        h, _ = temporal_step(params, cfg, embed_step(params, cfg, text_pad, audio_in), (kc, vc), pos)
        toks = depformer_sample(params, cfg, _rms(h, params["out_norm"]), text_pad)
        s = s0 + t
        frame_idx = s[:, None] - delays[None, :]
        step_live = s < n_lim
        live = (frame_idx >= 0) & (frame_idx < max_frames[:, None]) & step_live[:, None]
        audio_in = torch.where(live, toks, cfg.audio_initial)
        outs[rows, :, s.clamp(max=outs.shape[2] - 1)] = audio_in
        pos = pos + step_live.to(pos.dtype)
    return audio_in


def _install_row(kc_pool, vc_pool, k1, v1, row: int) -> None:
    """Copy a batch-1 prompt cache ([L, 1, H, ctx, Dh]) into pool row
    ``row``; the source (a cached voice) is only read."""
    kc_pool[:, row].copy_(k1[:, 0])
    vc_pool[:, row].copy_(v1[:, 0])


def _pool_prefill(params, cfg: PocketLMConfig, text_grid, kc, vc, start, length) -> None:
    """Batched text prefill over the POOL for joining rows only: text_grid
    [S, T_bucket]; start/length [S]. The other rows pass length 0 and keep
    their caches; the audio side is all-initial (text-only prefill)."""
    initial_vec = params["emb"][:, cfg.audio_initial].sum(dim=0)  # [D]
    x = params["text_emb"][text_grid] + initial_vec[None, None]
    temporal_prefill(params, cfg, x, (kc, vc), start, length=length)


def _mimi_group(mimi_params, cfg, tokens, state, reset_mask, decode_mask):
    """One batched Mimi block decode: rows in ``reset_mask`` start a fresh
    stream, rows in ``decode_mask`` advance theirs, the others keep their
    state (their tokens this group are placeholders)."""
    state_in = zero_mimi_stream_rows(state, reset_mask)
    pcm, stepped = mimi_decode_step(mimi_params, cfg, tokens, state_in)
    return pcm, select_mimi_stream_rows(decode_mask, stepped, state_in)


# ──────────────────────────────────────────────────────────────────────
# the scheduler
# ──────────────────────────────────────────────────────────────────────


@dataclass
class _Slot:
    active: bool = False
    out: "queue.Queue | None" = None
    max_frames: int = 0
    n_steps: int = 0  # max_frames + max_delay
    s_done: int = 0
    emitted: int = 0
    needs_reset: bool = False  # a fresh stream: its Mimi row resets at the first decode


@dataclass
class _Job:
    text: str
    state: PromptState | None
    out: queue.Queue
    seed_frames: int | None = None  # an explicit max_frames


class PocketBatcher:
    """Schedules concurrent pocket-tts sessions onto the slot pool."""

    def __init__(self, model, slots: int | None = None, block_frames: int | None = None) -> None:
        from open_speech_tpu_torch.config import settings

        self.model = model
        self.cfg: PocketLMConfig = model.lm_cfg
        self.device = model.device
        self.slots = int(slots or settings.os_pocket_batch_slots)
        self.block = int(block_frames or settings.os_pocket_block_frames)
        self._queue: queue.Queue = queue.Queue()
        self._waiting: list[_Job] = []
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._stopping = False
        self._device_ready = False
        self.stats = {"groups": 0, "jobs": 0, "peak_live": 0}
        self._host_reset()

    # ── pool state ────────────────────────────────────────────────────

    def _host_reset(self) -> None:
        s = self.slots
        self._slots = [_Slot() for _ in range(s)]
        self._pos = np.zeros((s,), np.int64)
        self._s0 = np.zeros((s,), np.int64)
        self._n_steps = np.zeros((s,), np.int64)
        self._max_frames = np.zeros((s,), np.int64)

    def _device_init(self) -> None:
        cfg, s, dev = self.cfg, self.slots, self.device
        dtype = self.model.lm_params["text_emb"].dtype
        shape = (cfg.n_layers, s, cfg.n_heads, cfg.max_ctx, cfg.head_dim)
        self._kc = torch.zeros(shape, dtype=dtype, device=dev)
        self._vc = torch.zeros(shape, dtype=dtype, device=dev)
        # a step budget is at most max_ctx; a group may run `block` past it
        self._outs = torch.full((s, cfg.n_q, cfg.max_ctx + self.block), cfg.audio_initial,
                                dtype=torch.int64, device=dev)
        self._audio_in = torch.full((s, cfg.n_q), cfg.audio_initial, dtype=torch.int64, device=dev)
        self._delays = torch.arange(cfg.n_q, device=dev).clamp(max=1) * cfg.acoustic_delay
        self._mimi_state = init_mimi_stream_state(self.model.mimi_params, self.model.mimi_cfg, batch=s)
        # the group's plan: [pos, s0, n_steps, max_frames, reset, decode] x S,
        # then the token gather index [S, n_q, block]; uploaded through one
        # pinned buffer, free again after the group's one sync
        n = 6 * s + s * cfg.n_q * self.block
        self._plan_host = torch.empty((n,), dtype=torch.int64, pin_memory=dev.type == "cuda")
        self._device_ready = True

    # ── public API ────────────────────────────────────────────────────

    def synthesize(self, text: str, state: PromptState | None, max_frames: int | None = None) -> Iterator[np.ndarray]:
        """Submit one utterance; yields float32 PCM blocks as they land."""
        if self._stopping:
            raise RuntimeError("pocket batcher stopped (model was reloaded)")
        self._ensure_thread()
        out: queue.Queue = queue.Queue()
        self._queue.put(_Job(text, state, out, max_frames))
        while True:
            item = out.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def stop(self, wait: bool = False) -> None:
        """End the scheduler thread and release the card's buffers; with
        ``wait``, return once the thread has let them go (an unload frees
        the pool before it returns)."""
        self._stopping = True
        self._queue.put(_STOP)
        thread = self._thread
        if wait and thread is not None and thread is not threading.current_thread():
            thread.join(timeout=120)

    def precompile(self) -> None:
        """Run one short session through every step (install, prefill,
        groups, the Mimi group) ahead of traffic: the card's libraries set
        up for the pool's shapes."""
        list(self.synthesize("hi", None, max_frames=self.block * 2))

    # ── scheduler thread ──────────────────────────────────────────────

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop, daemon=True, name="pocket-batcher")
                self._thread.start()

    def _any_live(self) -> bool:
        return any(sl.active for sl in self._slots)

    def _loop(self) -> None:
        while True:
            try:
                self._drain_joins(block=not self._any_live() and not self._waiting)
            except Exception:  # noqa: BLE001 — keep the scheduler alive
                logger.exception("pocket batcher join failed")
            if self._stopping:
                self._fail_all(RuntimeError("pocket batcher stopped"))
                # release the card's buffers promptly
                self.model = None
                self._kc = self._vc = self._outs = self._audio_in = self._mimi_state = None
                self._plan_host = None
                return
            if not self._any_live():
                continue
            try:
                with inference():
                    self._run_group()
            except Exception as e:  # noqa: BLE001
                logger.exception("pocket pool group failed")
                for sl in self._slots:
                    if sl.active and sl.out is not None:
                        sl.out.put(e)
                        sl.out.put(None)
                self._host_reset()

    def _fail_all(self, err: Exception) -> None:
        while True:  # jobs still queued behind the STOP sentinel
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                self._waiting.append(item)
        for sl in self._slots:
            if sl.active and sl.out is not None:
                sl.out.put(err)
                sl.out.put(None)
        for job in self._waiting:
            job.out.put(err)
            job.out.put(None)
        self._waiting = []

    # ── joins ─────────────────────────────────────────────────────────

    def _drain_joins(self, block: bool) -> None:
        jobs: list[_Job] = []
        try:
            item = self._queue.get(block=block)
            if item is _STOP:
                return
            jobs.append(item)
            if block and not self._stopping:
                # an idle pool's burst lands within a few ms: admit it as one
                # wave, one pool prefill (arrivals mid-serving are batched by
                # the group cadence already)
                deadline = time.monotonic() + 0.005
                while len(jobs) < self.slots:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = self._queue.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is _STOP:
                        self._waiting.extend(jobs)
                        return
                    jobs.append(item)
            while True:
                item = self._queue.get_nowait()
                if item is _STOP:
                    self._waiting.extend(jobs)
                    return
                jobs.append(item)
        except queue.Empty:
            pass
        jobs = self._waiting + jobs
        self._waiting = []
        if not jobs:
            return
        free = [i for i, sl in enumerate(self._slots) if not sl.active]
        admit, self._waiting = jobs[: len(free)], jobs[len(free):]
        if admit:
            with inference():
                self._install(admit, free[: len(admit)])

    def _install(self, jobs: list[_Job], rows: list[int]) -> None:
        """Jobs into slot rows: prompt-cache copies, then ONE batched text
        prefill over the pool."""
        if not self._device_ready:
            self._device_init()
        cfg, dev = self.cfg, self.device
        max_delay = cfg.max_delay
        texts: list[tuple[int, list[int], int]] = []  # (row, ids, start)
        for job, row in zip(jobs, rows):
            state = job.state
            start = 0 if state is None else int(state.length)
            ids = [cfg.text_bos_id] + self.model.tokenizer.encode(job.text) + [cfg.text_eos_id]
            n_ids = min(len(ids), max(cfg.max_ctx - start - 2, 1))
            budget = cfg.max_ctx - start - n_ids - 1
            if budget - max_delay < 1:
                logger.warning("pocket batcher: context exhausted (start=%d, n_ids=%d, max_ctx=%d); emitting "
                               "nothing", start, n_ids, cfg.max_ctx)
                job.out.put(None)
                continue
            if state is not None and state.k_cache.shape[1] != 1:
                job.out.put(ValueError(
                    f"pocket batcher serves single-stream prompt states (got batch={state.k_cache.shape[1]})"))
                job.out.put(None)
                continue
            max_frames = max(int(job.seed_frames), 1) if job.seed_frames is not None else max(4, len(job.text))
            max_frames = min(max_frames, budget - max_delay)
            if state is None:
                self._kc[:, row].zero_()
                self._vc[:, row].zero_()
            else:
                _install_row(self._kc, self._vc, state.k_cache, state.v_cache, row)
            self._audio_in[row] = cfg.audio_initial
            sl = self._slots[row]
            sl.active, sl.out = True, job.out
            sl.max_frames, sl.n_steps = max_frames, max_frames + max_delay
            sl.s_done = sl.emitted = 0
            sl.needs_reset = True
            self._pos[row] = start + n_ids
            self._s0[row] = 0
            self._n_steps[row] = sl.n_steps
            self._max_frames[row] = max_frames
            texts.append((row, ids[:n_ids], start))
            self.stats["jobs"] += 1
        if not texts:
            return
        bucket = _bucket(max(len(ids) for _r, ids, _s in texts), cap=max(cfg.max_ctx - 1, 1))
        grid = np.full((self.slots, bucket), cfg.text_pad_id, np.int64)
        start_v = np.zeros((self.slots,), np.int64)
        length_v = np.zeros((self.slots,), np.int64)
        for row, ids, start in texts:
            grid[row, : len(ids)] = ids
            start_v[row] = start
            length_v[row] = len(ids)
        _pool_prefill(self.model.lm_params, cfg, torch.from_numpy(grid).to(dev), self._kc, self._vc,
                      torch.from_numpy(start_v).to(dev), torch.from_numpy(length_v).to(dev))

    # ── groups ────────────────────────────────────────────────────────

    def _run_group(self) -> None:
        cfg, block, s = self.cfg, self.block, self.slots
        spf = self.model.mimi_cfg.samples_per_frame
        delays = np.asarray(cfg.delays)
        plan = np.zeros((6, s), np.int64)
        plan[0], plan[1], plan[2], plan[3] = self._pos, self._s0, self._n_steps, self._max_frames
        index = np.zeros((s, cfg.n_q, block), np.int64)
        emits: list[tuple[_Slot, int, int]] = []  # (slot, row, samples)
        live_now = 0
        # the group's outcome follows from the counters: plan it first
        for row, sl in enumerate(self._slots):
            if not sl.active:
                continue
            live_now += 1
            live_steps = max(min(block, sl.n_steps - sl.s_done), 0)
            sl.s_done += live_steps
            self._s0[row] = sl.s_done
            self._pos[row] += live_steps
            ready = min(max(sl.s_done - cfg.max_delay, 0), sl.max_frames)
            n_new = 0
            if ready - sl.emitted >= block:
                n_new = block
            elif sl.s_done >= sl.n_steps and ready > sl.emitted:
                n_new = ready - sl.emitted  # the final partial block, padded with its last frame
            if n_new > 0:
                steps = sl.emitted + np.minimum(np.arange(block), n_new - 1)
                index[row] = steps[None, :] + delays[:, None]
                plan[4, row] = sl.needs_reset
                plan[5, row] = 1
                sl.needs_reset = False
                sl.emitted += n_new
                emits.append((sl, row, n_new * spf))
        self.stats["groups"] += 1
        self.stats["peak_live"] = max(self.stats["peak_live"], live_now)

        host = self._plan_host
        host.numpy()[: 6 * s] = plan.reshape(-1)
        host.numpy()[6 * s:] = index.reshape(-1)
        dev_plan = host.to(self.device, non_blocking=True)
        self._audio_in = _pool_group(self.model.lm_params, cfg, self._kc, self._vc, self._outs, self._audio_in,
                                     dev_plan[: 4 * s].view(4, s), self._delays, block)
        if emits:
            tokens = self._outs.gather(2, dev_plan[6 * s:].view(s, cfg.n_q, block))
            mimi_cfg = self.model.mimi_cfg
            pcm, self._mimi_state = _mimi_group(
                self.model.mimi_params, mimi_cfg, tokens.clamp(max=mimi_cfg.card - 1), self._mimi_state,
                dev_plan[4 * s: 5 * s].bool(), dev_plan[5 * s: 6 * s].bool())
            pcm = pcm.float().cpu().numpy()  # the ONE host sync of the group
            for sl, row, n_samples in emits:
                sl.out.put(pcm[row, :n_samples].copy())
        else:
            self._audio_in[:1, :1].cpu()  # the group's one sync: the plan buffer is free again

        for row, sl in enumerate(self._slots):  # retire finished rows
            if sl.active and sl.s_done >= sl.n_steps and sl.emitted >= sl.max_frames:
                sl.out.put(None)
                sl.active, sl.out = False, None
                self._n_steps[row] = self._max_frames[row] = self._s0[row] = 0


# ──────────────────────────────────────────────────────────────────────
# the registry: one batcher per loaded model
# ──────────────────────────────────────────────────────────────────────

_batchers: dict[int, PocketBatcher] = {}
_registry_lock = threading.Lock()


def get_pocket_batcher(backend) -> PocketBatcher:
    """One batcher per loaded pocket model (a reload gets a new one: the
    old one must not keep serving the previous weights)."""
    key = id(backend)
    with _registry_lock:
        b = _batchers.get(key)
        if b is None or b.model is not backend._model:
            if b is not None:
                b.stop()
            b = PocketBatcher(backend._model)
            _batchers[key] = b
        return b


def release_pocket_batcher(backend) -> None:
    """Stop and drop an unloading backend's batcher; returns once its pool
    is released."""
    with _registry_lock:
        b = _batchers.pop(id(backend), None)
    if b is not None:
        b.stop(wait=True)


def pocket_batcher_stats() -> dict:
    with _registry_lock:
        return {str(k): dict(b.stats) for k, b in _batchers.items()}


def reset_pocket_batchers() -> None:
    with _registry_lock:
        for b in _batchers.values():
            b.stop()
        _batchers.clear()
