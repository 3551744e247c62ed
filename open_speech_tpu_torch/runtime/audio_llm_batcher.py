"""Continuous batching of an audio-LLM transcriber (Voxtral) over a slot pool.

The scheduler is Whisper's (``runtime/batcher.py:SlotScheduler``: queue,
slots, loop, epoch guard, futures, stats, spans); this module brings the
model's parts:

  - one self-KV pool [L, 2, S, H_kv, T, Dh] in the model's dtype, allocated
    once, no cross pool;
  - an admission encodes its windows as one batch (Whisper's encoder, then
    the adapter) and prefills every window's prompt but its last token in
    one dense causal pass that writes K and V into the claimed slots; the
    last prompt token stays queued as the slot's next input, so the next
    tick's first step reads its logits;
  - an admission takes at most ``PREFILL_POSITIONS`` prompt positions of
    windows: the prefill stalls every live slot's tick while it runs;
  - one tick advances every slot ``steps_per_tick`` positions, each at its
    own RoPE position, with the greedy pick (no rules), the retire test
    (end token or budget) and the token feedback on the device, and syncs
    with the host once. Its scheduler state goes in through one pinned copy
    and its result comes out through one copy; the admission makes no
    pinned copy, so a device trace tells the two apart.

Greedy only. As in Whisper's batcher, the pool is written in place and
all device work of one batcher runs on one CUDA stream.
"""

from __future__ import annotations

import numpy as np
import torch

from open_speech_tpu_torch.models.voxtral.model import (
    Voxtral,
    decode_step,
    encode_audio,
    prefill,
    rope_tables,
)
from open_speech_tpu_torch.runtime import tracing
from open_speech_tpu_torch.runtime.batcher import SlotScheduler

# The prompt positions one admission may prefill: 8 windows of Voxtral's
# 382-position prompt. An admission stalls every live slot's tick while it
# runs. At Voxtral-Small-24B's widths on one H100 (tools/
# torch_voxtral_admission.py) the audio tower, adapter and prefill take
# 71 ms for one window and 42-46 ms a window from two windows on (8: 346
# ms, 16: 684 ms): past two windows a larger admission saves nothing a
# window and only lengthens the stall, and 8 windows keep it near 0.35 s,
# three ticks of the pool, where 64 would stall it for ~2.7 s.
PREFILL_POSITIONS = 3072


@torch.no_grad()
def _decode_block(model, tokens, pos, cache, rope, active, steps, max_new, *, k_steps, end):
    """Advance every slot ``k_steps`` positions on the device: the greedy
    pick, the retire test (``end`` or the budget) and the token feedback per
    step, nothing read back. Returns [K + 4, S] int64: the K emitted rows,
    then tokens, pos, active and steps."""
    emitted = []
    for _ in range(k_steps):
        logits = decode_step(model, tokens, pos, cache, rope)
        tok = torch.where(active, logits.argmax(dim=-1), end)
        steps = steps + active.long()
        done = active & ((tok == end) | (steps >= max_new))
        emitted.append(tok)
        pos = pos + active.long()
        active = active & ~done
        tokens = torch.where(active, tok, end)
    return torch.stack(emitted + [tokens, pos, active.long(), steps])


class AudioLLMBatcher(SlotScheduler):
    """Async scheduler multiplexing transcription windows of an audio-LLM
    onto one card. ``prompt`` is the transcription request's ids, its
    ``[AUDIO]`` placeholders included; ``end_token`` retires a slot."""

    def __init__(
        self,
        model: Voxtral,
        prompt: list[int],
        end_token: int,
        *,
        slots: int = 8,
        max_new_tokens: int = 144,
    ) -> None:
        super().__init__(model.device, slots, max_new_tokens)
        cfg = model.cfg
        if sum(t == cfg.audio_token_id for t in prompt) != cfg.audio_positions:
            raise ValueError(f"the prompt holds {cfg.audio_positions} audio positions of one window")
        self.model = model
        self.cfg = cfg
        self._end_token = end_token
        self._prompt = list(prompt)
        # the prefill's ids (all but the last prompt token), on the device once
        self._prefill_ids = torch.tensor(self._prompt[:-1], device=self.device)
        need = len(self._prompt) + max_new_tokens + 1
        self._cache_len = -(-need // 64) * 64
        self._rope = rope_tables(cfg, self._cache_len, self.device)
        self._kv = self._zeros_kv()
        self._tokens = np.full((slots,), end_token, np.int64)
        self._pos = np.zeros((slots,), np.int64)
        self._steps = np.zeros((slots,), np.int64)
        self._max_new = np.full((slots,), max_new_tokens, np.int64)
        self._state_host = (
            torch.empty((5, slots), dtype=torch.int64, pin_memory=True)
            if self.device.type == "cuda" else None
        )
        self.stats["prefill_positions"] = 0

    @property
    def mel_shape(self) -> tuple[int, int]:
        return self.cfg.audio.n_mels, 2 * self.cfg.audio.n_audio_ctx

    @staticmethod
    def token_budget(duration_s: float) -> int:
        """A window's budget: 4 tokens a second of audio plus 16, rounded up
        to 16 (the batcher clamps it to its pool)."""
        return -(-(int(duration_s * 4) + 16) // 16) * 16

    async def transcribe_window(self, mel, max_new_tokens: int | None = None) -> list[int]:
        """Submit one mel window [n_mels, 3000] (a tensor on any device);
        awaits its token ids."""
        mel = mel if isinstance(mel, torch.Tensor) else torch.tensor(np.asarray(mel))
        if tuple(mel.shape) != self.mel_shape:
            raise ValueError(f"mel window shape {tuple(mel.shape)} != {self.mel_shape}")
        budget = min(max_new_tokens or self.max_new_tokens,
                     self._cache_len - len(self._prompt) - 1)
        return await self._submit(mel, budget)

    def _admission_size(self, free: int) -> int:
        return min(free, max(1, PREFILL_POSITIONS // len(self._prefill_ids)))

    def _zeros_kv(self) -> torch.Tensor:
        cfg = self.cfg
        return torch.zeros(
            (cfg.layers, 2, self.n_slots, cfg.kv_heads, self._cache_len, cfg.head_dim),
            dtype=self.model.embed.dtype, device=self.device,
        )

    def _reset_pools(self) -> None:
        """A fresh pool after a failed tick (run after _fail_all), once the
        stream's work, the pinned state copy included, has drained."""
        if self._stream is not None:
            self._stream.synchronize()
        self._kv = self._zeros_kv()

    @torch.no_grad()
    def _admit_device(self, batch) -> None:
        """Executor-thread half of admission: the encoder and adapter over
        the batch's windows, then the prefill into their slots."""
        span = None
        if tracing.on():
            span = tracing.begin("batcher.admit", self._admitting, child="admit.encode")
        positions = len(batch) * len(self._prefill_ids)
        with self._on_stream():
            mels = torch.stack([b[1].to(self.device, torch.float32) for b in batch])
            audio = encode_audio(self.model, mels)
            if span is not None:
                span.next("admit.prefill")
            slots = torch.tensor([b[0] for b in batch], device=self.device)
            prefill(self.model, audio, self._prefill_ids, self._kv, slots)
            self._claim(batch)
            for slot, _mel, max_new, _future in batch:
                self._tokens[slot] = self._prompt[-1]
                self._pos[slot] = len(self._prefill_ids)
                self._steps[slot] = 0
                self._max_new[slot] = max_new
        self.stats["prefill_positions"] += positions
        if span is not None:
            span.end_child(positions)
            tracing.end(span, len(batch))

    def _state_to_device(self) -> torch.Tensor:
        """The tick's [5, S] state, copied to the device through the pinned
        buffer without a host sync (free again after the last tick's sync)."""
        state = np.stack([self._tokens, self._pos, self._active, self._steps,
                          self._max_new]).astype(np.int64)
        if self._state_host is None:
            return torch.from_numpy(state)
        self._state_host.numpy()[:] = state
        return self._state_host.to(self.device, non_blocking=True)

    def _tick(self) -> None:
        """Advance all live slots ``steps_per_tick`` positions (executor):
        one device block, then the one host sync and the drain."""
        span = tokens = None
        if tracing.on():
            span, tokens = tracing.begin("batcher.tick", child="tick.enqueue"), self.stats["tokens"]
        epoch = self._epoch
        k = self.steps_per_tick
        with self._on_stream():
            state = self._state_to_device()
            packed = _decode_block(
                self.model, state[0], state[1], self._kv, self._rope, state[2].bool(), state[3],
                state[4], k_steps=k, end=self._end_token,
            )
            if span is not None:
                span.next("tick.sync")
            packed = packed.cpu().numpy()  # the ONE host sync per tick
        if epoch != self._epoch:
            # stop()/_fail_all ran while this tick was in flight
            if span is not None:
                tracing.end(span, 0)
            return
        if span is not None:
            span.next("tick.drain")
        self._tokens[:], self._pos[:] = packed[k], packed[k + 1]
        self._active[:] = packed[k + 2].astype(bool)
        self._steps[:] = packed[k + 3]
        self._deliver(packed[:k])
        if span is not None:
            tracing.end(span, self.stats["tokens"] - tokens)
