"""Continuous batching of whisper decodes over a slot pool.

Counterpart of ``open_speech_tpu/runtime/batcher.py``. Concurrent requests
share the card through a fixed pool of decode slots:

  - the KV pools ([L, 2, S, H, T, Dh], S = slots) are allocated once for
    the batcher's lifetime: no per-request allocation;
  - arriving requests are encoded as one batch and claim free slots: their
    cross-attention K/V land in those slots' rows, and their prompt is fed
    one token per step;
  - one tick advances EVERY slot ``steps_per_tick`` positions, each at its
    own position, with the whisper rules, the greedy pick, the retire test
    (EOT or budget) and the token feedback on the device, and syncs with
    the host once;
  - a slot retires on EOT or at its token budget and is reusable at once.

Greedy only: this is the latency path. The JAX version donates the self-KV
pool to each jitted tick and gets a new buffer back; here the pools are
written in place, so a tick that the epoch guard discards has already
written them (harmless: a failed slot's rows are rewritten from position 0
by its next admission before they are read). All device work of one
batcher runs on one CUDA stream, and the scheduler loop never lets an
admission and a tick overlap.

Under a ``mesh`` (``parallel/mesh.py``) the batcher runs on a model
sharded over the mesh's model axis (it shards an unsharded one in place),
and its pools hold this rank's heads, H / m of them, beside its q/k/v
columns: a tick then needs only the all-reduces of the row-parallel
linears. Every rank of the model group runs the same admissions and ticks.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.whisper.decode import (
    DecodeOptions,
    _apply_rules,
    _blank_tokens,
    _suppress_mask,
)
from open_speech_tpu_torch.models.whisper.model import (
    Whisper,
    WhisperConfig,
    _merge_heads,
    _split_heads,
    cross_attend,
    decode_attention,
    embed_tokens,
    encode,
    layer_norm,
    linear,
    mlp,
    output_logits,
    precompute_cross_kv_dense,
)
from open_speech_tpu_torch.models.whisper.tokenizer import SpecialTokens

# the KV pools' type (bf16 halves the pool the tick reads every step)
_CACHE_DTYPE = torch.bfloat16

logger = logging.getLogger(__name__)


def _set_exception_if_pending(future: asyncio.Future, exc: Exception) -> None:
    if not future.done():
        future.set_exception(exc)


def _set_result_if_pending(future: asyncio.Future, value) -> None:
    # a concurrent stop()/_fail_all may already have failed this future
    # from the event loop while the tick ran in its executor thread
    if not future.done():
        future.set_result(value)


# ──────────────────────────────────────────────────────────────────────
# Device step with per-slot positions
# ──────────────────────────────────────────────────────────────────────


def _slot_step_body(
    model: Whisper, tokens: torch.Tensor, pos: torch.Tensor, self_kv: torch.Tensor,
    cross_kv: torch.Tensor, dh: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode position for every slot, each at its own position.

    tokens: [S, 1]; pos: [S] (per-slot position); dh: the head dim; self_kv:
    [L, 2, S, H, T, Dh], WRITTEN IN PLACE at each slot's position; cross_kv: [L, 2, S, H,
    T_enc, Dh]. Returns (logits [S, vocab] float32, self_kv). The JAX
    package's ``_slot_decode_step`` is this body under ``jax.jit``; eager
    PyTorch calls the body itself (the prompt feed, and the tick's block).
    """
    dec = model.decoder
    s = tokens.shape[0]
    rows = torch.arange(s, device=tokens.device)
    # the JAX version's dynamic_update_slice clamps its start index to the
    # cache; an index past it would be a device-side fault here
    at = pos.clamp(0, self_kv.shape[4] - 1)
    x = embed_tokens(dec, tokens) + dec.pos_emb[pos][:, None, :]  # [S, 1, d]
    length = pos + 1
    for i, blk in enumerate(dec.blocks):
        hn = layer_norm(x, blk.ln1)
        q = _split_heads(linear(hn, blk.attn.q), dh)
        k_new = _split_heads(linear(hn, blk.attn.k), dh)  # [S, H, 1, Dh]
        v_new = _split_heads(linear(hn, blk.attn.v), dh)
        # per-slot insertion: one scatter on the T axis for all slots
        self_kv[i, 0, rows, :, at] = k_new[:, :, 0].to(self_kv.dtype)
        self_kv[i, 1, rows, :, at] = v_new[:, :, 0].to(self_kv.dtype)
        attn = decode_attention(q, self_kv[i, 0], self_kv[i, 1], length)
        x = x + linear(_merge_heads(attn), blk.attn.o)
        hc = layer_norm(x, blk.ln_cross)
        qc = _split_heads(linear(hc, blk.cross.q), dh)
        x = x + linear(_merge_heads(cross_attend(qc, cross_kv[i], s)), blk.cross.o)
        x = x + mlp(layer_norm(x, blk.ln_mlp), blk)
    logits = output_logits(layer_norm(x, dec.ln), dec)
    return logits[:, 0], self_kv


def _ruled_argmax(
    logits, step_idx, last, penult, max_ts, suppress, active,
    *, special, max_init_tok, blank,
):
    """Apply the whisper logit rules per slot and pick greedy tokens.

    step_idx/last/penult/max_ts/active: [S] per-slot rule state; the [S]
    step_idx gives each slot its own begin rules in ``_apply_rules``.
    """
    ruled = _apply_rules(
        logits,
        step_idx=step_idx,
        last=last,
        penult=penult,
        max_ts=max_ts,
        suppress=suppress,
        special=special,
        timestamps=True,
        max_initial_ts_tok=max_init_tok,
        blank_tokens=blank,
    )
    return torch.where(active, ruled.argmax(dim=-1), special.eot)


@torch.no_grad()
def _slot_decode_block(
    model, tokens, pos, self_kv, cross_kv,
    last, penult, max_ts, step_idx, active, steps, max_new, suppress,
    *, dh, k_steps, special, max_init_tok, blank,
):
    """Advance every slot ``k_steps`` decode positions on the device.

    The rules, greedy pick, retire test (EOT / budget) and token feedback
    run on the device per sub-step, and nothing here reads a value back,
    so the host syncs once per block (on the packed result), not once per
    token. Returns ([K + 8, S] int32: the K emitted rows, then tokens, pos,
    last, penult, max_ts, step_idx, active, steps; self_kv).
    """
    eot = special.eot
    emitted = []
    for _ in range(k_steps):
        logits, self_kv = _slot_step_body(model, tokens, pos, self_kv, cross_kv, dh)
        tok = _ruled_argmax(
            logits, step_idx, last, penult, max_ts, suppress, active,
            special=special, max_init_tok=max_init_tok, blank=blank,
        )
        steps = steps + active.long()
        is_eot = tok == eot
        done = active & (is_eot | (steps >= max_new))
        appended = active & ~is_eot
        penult = torch.where(appended, last, penult)
        last = torch.where(appended, tok, last)
        is_ts = appended & (tok >= special.timestamp_begin)
        max_ts = torch.where(is_ts, torch.maximum(max_ts, tok), max_ts)
        step_idx = step_idx + appended.long()
        emitted.append(torch.where(active, tok, eot))
        pos = pos + active.long()
        active = active & ~done
        tokens = torch.where(active, tok, eot)[:, None]
    state = [tokens[:, 0], pos, last, penult, max_ts, step_idx, active.long(), steps]
    return torch.stack(emitted + state).int(), self_kv


# ──────────────────────────────────────────────────────────────────────
# Scheduler
# ──────────────────────────────────────────────────────────────────────


@dataclass
class _Slot:
    future: asyncio.Future
    tokens: list[int] = field(default_factory=list)
    steps: int = 0
    max_new: int = 224


class ContinuousBatcher:
    """Async scheduler multiplexing transcription windows onto one card."""

    def __init__(
        self,
        model: Whisper,
        cfg: WhisperConfig,
        special: SpecialTokens,
        *,
        slots: int = 8,
        max_new_tokens: int = 224,
        language: str = "en",
        task: str = "transcribe",
        suppress_tokens: tuple[int, ...] = (),
        mesh=None,
    ) -> None:
        if mesh is not None:
            tp = mesh["model"].size()
            if cfg.n_text_head % tp:
                raise ValueError(
                    f"n_text_head={cfg.n_text_head} not divisible by model-axis size {tp}"
                )
            if tp > 1 and model.tp_size == 1:
                from open_speech_tpu_torch.parallel.mesh import shard_model

                shard_model(model, mesh)
        self.mesh = mesh
        self.model = model
        self.cfg = cfg
        self.special = special
        self.n_slots = slots
        self.max_new_tokens = max_new_tokens
        self.device = model.device
        # every kernel of this batcher goes to one stream, whichever
        # executor thread issues it
        self._stream = (
            torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        )
        # self-KV length follows the token budget (bucketed to 64), not
        # n_text_ctx: every tick reads the whole pool
        self._prompt = list(special.sot_sequence(language, task))
        need = len(self._prompt) + max_new_tokens + 1
        self._cache_len = min(cfg.n_text_ctx, -(-need // 64) * 64)
        self._self_kv = self._zeros_self_kv()
        self._cross_kv = torch.zeros(
            (cfg.n_text_layer, 2, slots, model.text_heads, cfg.n_audio_ctx, cfg.text_head_dim),
            dtype=_CACHE_DTYPE, device=self.device,
        )
        self._tokens = np.full((slots,), special.eot, np.int64)
        self._pos = np.zeros((slots,), np.int64)
        self._step_idx = np.zeros((slots,), np.int64)
        self._last = np.full((slots,), special.eot, np.int64)
        self._penult = np.full((slots,), special.eot, np.int64)
        self._max_ts = np.full((slots,), special.timestamp_begin - 1, np.int64)
        self._active = np.zeros((slots,), bool)
        self._steps = np.zeros((slots,), np.int64)
        self._max_new = np.full((slots,), max_new_tokens, np.int64)
        self._state_host = (
            torch.empty((9, slots), dtype=torch.int64, pin_memory=True)
            if self.device.type == "cuda" else None
        )
        # decode positions per host sync
        self.steps_per_tick = max(1, settings.os_batch_steps_per_tick)
        self._slots: dict[int, _Slot] = {}
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        opts = DecodeOptions(suppress_tokens=suppress_tokens)
        self._suppress = torch.from_numpy(_suppress_mask(cfg.n_vocab, special, opts)).to(
            self.device
        )
        # the constants greedy and beam decoding use, so the paths agree
        self._max_init_tok = special.timestamp_begin + int(
            round(opts.max_initial_timestamp / 0.02)
        )
        self._blank = _blank_tokens(special, opts)
        # bumped whenever in-flight work is failed; a tick that observes a
        # stale epoch discards its results instead of racing _fail_all
        self._epoch = 0
        self.stats = {"ticks": 0, "completed": 0, "peak_occupancy": 0, "tokens": 0}

    # ── public API ────────────────────────────────────────────────────

    def start(self) -> None:
        if self._task is None:
            # recorded so the pool can tell a batcher whose scheduler task
            # died with an earlier event loop
            self._bound_loop = asyncio.get_running_loop()
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        self._fail_all(RuntimeError("batcher stopped"))
        self._drain_queue(RuntimeError("batcher stopped"))

    async def transcribe_window(self, mel, max_new_tokens: int | None = None) -> list[int]:
        """Submit one mel window [n_mels, 2 * n_audio_ctx] (numpy or a
        tensor on any device); awaits its token ids."""
        # a copy of host input (the caller may reuse its buffer); a tensor
        # is taken as it is
        mel = mel if isinstance(mel, torch.Tensor) else torch.tensor(np.asarray(mel))
        expect = (self.cfg.n_mels, self.cfg.n_audio_ctx * 2)
        if tuple(mel.shape) != expect:
            # rejected here, not inside the admission batch: a malformed
            # request must never take co-batched healthy requests down
            raise ValueError(f"mel window shape {tuple(mel.shape)} != {expect}")
        if self._task is None:
            self.start()
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        # clamp to the slot pool's KV capacity, sized at construction
        budget = min(
            max_new_tokens or self.max_new_tokens,
            self._cache_len - len(self._prompt) - 1,
        )
        await self._queue.put((mel, budget, future))
        return await future

    @property
    def occupancy(self) -> int:
        return int(self._active.sum())

    # ── scheduler loop ────────────────────────────────────────────────

    async def _loop(self) -> None:
        consecutive_failures = 0
        while True:
            try:
                admitted = await self._admit()
                if not self._active.any():
                    if not admitted:
                        # idle: block until work arrives
                        item = await self._queue.get()
                        self._queue.put_nowait(item)
                    continue
                await asyncio.get_running_loop().run_in_executor(None, self._tick)
                await asyncio.sleep(0)  # yield so new arrivals admit per tick
                consecutive_failures = 0
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                # a device error must not strand callers: fail every
                # in-flight future, release the slots and keep serving,
                # but back off, and give up if the error persists
                consecutive_failures += 1
                logger.exception(
                    "Batcher tick failed (%d in a row); failing live slots",
                    consecutive_failures,
                )
                self._fail_all(e)
                try:
                    self._reset_pools()
                except Exception:  # noqa: BLE001 — the device is gone: give up now
                    logger.exception("Batcher could not rebuild its KV pool")
                    consecutive_failures = 3
                if consecutive_failures >= 3:
                    logger.error("Batcher giving up after repeated failures")
                    # queued callers must not hang: the scheduler is dead
                    # until a new submission restarts it
                    self._drain_queue(e)
                    self._task = None
                    return
                await asyncio.sleep(0.1 * consecutive_failures)

    def _fail_all(self, exc: Exception) -> None:
        self._epoch += 1  # any in-flight tick discards its results
        for slot in list(self._slots):
            state = self._slots.pop(slot)
            self._active[slot] = False
            if not state.future.done():
                state.future.get_loop().call_soon_threadsafe(
                    _set_exception_if_pending, state.future, exc
                )

    def _drain_queue(self, exc: Exception) -> None:
        while not self._queue.empty():  # pending submissions never ran
            _mel, _max_new, future = self._queue.get_nowait()
            if not future.done():
                future.get_loop().call_soon_threadsafe(_set_exception_if_pending, future, exc)

    def _zeros_self_kv(self) -> torch.Tensor:
        cfg = self.cfg
        return torch.zeros(
            (cfg.n_text_layer, 2, self.n_slots, self.model.text_heads, self._cache_len,
             cfg.text_head_dim),
            dtype=_CACHE_DTYPE, device=self.device,
        )

    def _reset_pools(self) -> None:
        """A fresh self-KV pool after a failed tick (run after _fail_all):
        the failed tick may have stopped part-way through its in-place
        writes. Its work is drained first, so no copy from the pinned state
        buffer is still in flight when the next tick refills it."""
        if self._stream is not None:
            self._stream.synchronize()
        self._self_kv = self._zeros_self_kv()

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A COPY of host state on the device (a blocking copy: the
        admission's prompt feed). The scheduler mutates its numpy state
        while device work is in flight, and ``torch.from_numpy`` aliases."""
        return torch.from_numpy(np.array(array, np.int64)).to(self.device)

    def _state_to_device(self) -> torch.Tensor:
        """The tick's [9, S] scheduler state, copied, on the device. On the
        card it goes through the batcher's own pinned buffer without a host
        sync: the buffer is free again once the previous tick's one sync
        (or _reset_pools) has run, and allocating pinned memory per tick
        would sync whenever the pinned pool grows."""
        state = np.stack([
            self._tokens, self._pos, self._last, self._penult, self._max_ts,
            self._step_idx, self._active, self._steps, self._max_new,
        ]).astype(np.int64)
        if self._state_host is None:
            return torch.from_numpy(state)
        self._state_host.numpy()[:] = state
        return self._state_host.to(self.device, non_blocking=True)

    async def _admit(self) -> bool:
        """Claim free slots for queued requests; run encode + prompt feed.

        A failing admission (device error during encode or prompt feed)
        fails ONLY the requests being admitted and releases their slots;
        requests already decoding on other slots are untouched.
        """
        free = [i for i in range(self.n_slots) if not self._active[i]]
        batch: list[tuple[int, torch.Tensor, int, asyncio.Future]] = []
        while free and not self._queue.empty():
            mel, max_new, future = self._queue.get_nowait()
            batch.append((free.pop(0), mel, max_new, future))
        if not batch:
            return False
        loop = asyncio.get_running_loop()
        try:
            # all device work stays off the event loop
            await loop.run_in_executor(None, lambda: self._admit_device(batch))
        except Exception as e:  # noqa: BLE001
            logger.exception("Batcher admission failed for %d request(s)", len(batch))
            for slot, _mel, _max_new, future in batch:
                self._slots.pop(slot, None)
                self._active[slot] = False
                if not future.done():
                    future.get_loop().call_soon_threadsafe(_set_exception_if_pending, future, e)
            return False
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], self.occupancy)
        return True

    @torch.no_grad()
    def _admit_device(self, batch) -> None:
        """Executor-thread half of admission (device work and state)."""
        with self._on_stream():
            mels = torch.stack([b[1].to(self.device, torch.float32) for b in batch])
            enc_out = encode(self.model, mels, self.cfg)
            # one batched scatter of the dense cross-KV into the claimed
            # slots (a per-slot loop would rewrite the pool per request);
            # dense for an int8 model too, as in the JAX batcher: the pool
            # holds bf16 rows
            cross = precompute_cross_kv_dense(self.model, enc_out, self.cfg).to(_CACHE_DTYPE)
            slot_ids = torch.tensor([b[0] for b in batch], device=self.device)
            self._cross_kv[:, :, slot_ids] = cross
            prompt = self._prompt
            for slot, _mel, max_new, future in batch:
                self._slots[slot] = _Slot(future=future, max_new=max_new)
                self._active[slot] = True
                self._pos[slot] = 0
                self._step_idx[slot] = 0
                self._max_ts[slot] = self.special.timestamp_begin - 1
                self._last[slot] = prompt[-1]
                self._penult[slot] = prompt[-2] if len(prompt) > 1 else prompt[-1]
                self._steps[slot] = 0
                self._max_new[slot] = max_new
            # feed all but the last prompt token; every slot steps, and a
            # slot mid-decode writes its current position from its pending
            # token, which its next tick writes again before reading it.
            # The last prompt token stays queued in _tokens: the next
            # tick's first sub-step consumes it.
            for i in range(len(prompt) - 1):
                for slot, *_ in batch:
                    self._tokens[slot] = prompt[i]
                _slot_step_body(
                    self.model, self._to_device(self._tokens[:, None]),
                    self._to_device(self._pos), self._self_kv, self._cross_kv,
                    self.cfg.text_head_dim,
                )
                for slot, *_ in batch:
                    self._pos[slot] += 1
            for slot, *_ in batch:
                self._tokens[slot] = prompt[-1]

    def _tick(self) -> None:
        """Advance all live slots ``steps_per_tick`` positions (executor).

        One device block generates up to K tokens per slot; the single
        host sync then drains the [K, S] token block into the per-slot
        result lists.
        """
        epoch = self._epoch
        with self._on_stream():
            state = self._state_to_device()
            packed, self._self_kv = _slot_decode_block(
                self.model, state[0][:, None], state[1], self._self_kv, self._cross_kv,
                state[2], state[3], state[4], state[5], state[6].bool(), state[7], state[8],
                self._suppress,
                dh=self.cfg.text_head_dim,
                k_steps=self.steps_per_tick,
                special=self.special,
                max_init_tok=self._max_init_tok,
                blank=self._blank,
            )
            packed = packed.cpu().numpy()  # the ONE host sync per tick
        if epoch != self._epoch:
            # stop()/_fail_all ran while this tick was in flight: its slots
            # were failed already, and applying this state would revive them
            return
        k = self.steps_per_tick
        emitted = packed[:k]  # [K, S]
        # the device state is authoritative after the block; mirror it
        # BEFORE resolving futures, so a woken caller sees it
        (
            self._tokens[:], self._pos[:], self._last[:], self._penult[:],
            self._max_ts[:], self._step_idx[:],
        ) = packed[k : k + 6]
        self._active[:] = packed[k + 6].astype(bool)
        self._steps[:] = packed[k + 7]
        eot = self.special.eot
        for slot in list(self._slots):
            state = self._slots[slot]
            for j in range(k):
                t = int(emitted[j, slot])
                state.steps += 1
                done = t == eot or state.steps >= state.max_new
                if t != eot:
                    state.tokens.append(t)
                    self.stats["tokens"] += 1
                if done:
                    self.stats["completed"] += 1
                    del self._slots[slot]
                    state.future.get_loop().call_soon_threadsafe(
                        _set_result_if_pending, state.future, state.tokens
                    )
                    break
        self.stats["ticks"] += 1
