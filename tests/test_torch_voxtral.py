"""The port's Voxtral against ``tests/voxtral_oracle.py`` on the CPU.

A tiny Voxtral on seeded random weights: the port's test-tiny Whisper
encoder (60 frames, 15 audio positions) under a 2-layer language model of
hidden 96, 4 query heads of 32 (q 128 wide, not 96, as in the 24B) over 2
KV heads, SwiGLU 256 and a vocabulary of 512, all in float32 here so the
comparison is of the algorithm. Every weight is distinct per head.

- the adapter folds frames 4i..4i+3 into position i, in order;
- the GQA head map: query head h reads KV head h // 2; the oracle with
  h % 2 in its place differs from the port, so the test can tell;
- RoPE at a slot's own offset equals the oracle's rotation there;
- prefill, then cached decoding through ``AudioLLMBatcher`` (3 slots
  admitted at different ticks), gives at every decoded position the
  logits of the oracle's full forward pass over the prompt and the served
  tokens.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.voxtral import model as VM
from open_speech_tpu_torch.models.voxtral.tokens import AUDIO, VoxtralTokens
from open_speech_tpu_torch.models.whisper.model import PRESETS
from open_speech_tpu_torch.ops.attention import flash_attention
from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
from open_speech_tpu_torch.runtime import audio_llm_batcher as AB
from tests import voxtral_oracle as O

# The published config's keys, at the tiny size (``VoxtralConfig.from_hf``)
AUDIO_CFG = PRESETS["test-tiny"]
HF = {
    "audio_config": {
        "num_mel_bins": AUDIO_CFG.n_mels, "max_source_positions": AUDIO_CFG.n_audio_ctx,
        "hidden_size": AUDIO_CFG.n_audio_state, "num_attention_heads": AUDIO_CFG.n_audio_head,
        "num_hidden_layers": AUDIO_CFG.n_audio_layer,
        "intermediate_size": 4 * AUDIO_CFG.n_audio_state,
    },
    "text_config": {
        "hidden_size": 96, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 32, "intermediate_size": 256, "vocab_size": 512,
        "rope_theta": 1e8, "rms_norm_eps": 1e-5, "hidden_act": "silu",
    },
    "projector_hidden_act": "gelu",
    "audio_token_id": AUDIO,
}
ORACLE_CFG = {"heads": 4, "kv_heads": 2, "head_dim": 32, "rms_eps": 1e-5, "layers": 2,
              "rope_theta": 1e8, "audio_heads": AUDIO_CFG.n_audio_head,
              "audio_layers": AUDIO_CFG.n_audio_layer, "audio_token_id": AUDIO}
LANG = {"en": [300, 301, 302]}
EOS = 2


@pytest.fixture(scope="module")
def tiny():
    """(port model in float32, the oracle's float32 weights by name)."""
    cfg = VM.VoxtralConfig.from_hf(HF)
    model = VM.Voxtral.empty(cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight") or ".ln" in name:  # gains about 1, biases about 0
                base = 1.0 if name.endswith("weight") else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                fan_in = p.shape[1] * (p.shape[2] if p.dim() == 3 else 1) if p.dim() > 1 else 50
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in**-0.5)
        model.encoder.pos.copy_(torch.randn(model.encoder.pos.shape, generator=gen) * 0.1)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return model, weights


def _mel(seed: int) -> torch.Tensor:
    pcm = np.random.default_rng(seed).uniform(-0.3, 0.3, AUDIO_CFG.n_audio_ctx * 2 * 160)
    return log_mel_spectrogram(torch.from_numpy(pcm.astype(np.float32)), n_mels=AUDIO_CFG.n_mels)


def test_adapter_folds_four_consecutive_frames_in_order(tiny):
    model, w = tiny
    enc = torch.randn(2, AUDIO_CFG.n_audio_ctx, AUDIO_CFG.n_audio_state,
                      generator=torch.Generator().manual_seed(1))
    got = VM.adapt(model, enc)
    assert got.shape == (2, AUDIO_CFG.n_audio_ctx // 4, 96)
    for b in range(2):
        # float32 products of the same terms in another grouping: 1e-5
        torch.testing.assert_close(got[b], O.adapter(w, enc[b]), rtol=1e-5, atol=1e-5)
    # a frame order of 4 x (t / 4) transposed would give other rows
    shuffled = enc.view(2, 4, -1, enc.shape[-1]).transpose(1, 2).reshape(enc.shape)
    assert (VM.adapt(model, shuffled)[0] - got[0]).abs().max() > 1e-2


def test_grouped_heads_read_kv_head_h_over_g():
    """Query head h reads KV head h // 2 in the plain K1 the CPU runs, and
    the map h % 2 would give other outputs."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, 9, 32, generator=gen)
    k = torch.randn(2, 2, 9, 32, generator=gen)
    v = torch.randn(2, 2, 9, 32, generator=gen)
    got = flash_attention(q, k, v, causal=True)
    for h in range(4):
        want = O._mha(q[:, h], k[:, h // 2], v[:, h // 2], True)
        torch.testing.assert_close(got[:, h], want, rtol=1e-5, atol=1e-5)
        if h % 2 != h // 2:
            wrong = O._mha(q[:, h], k[:, h % 2], v[:, h % 2], True)
            assert (got[:, h] - wrong).abs().max() > 1e-2


def test_model_head_map_tells_h_over_g_from_h_mod_g(tiny):
    """The full model at the oracle's h // g, and not at h % g (its weights
    differ per head, so the swap changes the logits)."""
    model, w = tiny
    ids = _prompt()[: 20]
    mel = _mel(3)
    audio = VM.encode_audio(model, mel[None])
    x = VM.prompt_embeddings(model, torch.tensor(ids), audio)[0]
    right = O.language_model(w, x, ORACLE_CFG)
    wrong = O.language_model(w, x, ORACLE_CFG, kv_head=lambda h, g: h % g)
    assert (right - wrong).abs().max() > 1e-2
    # the port's full pass: prefill into a cache, then one step at the last id
    cache = torch.zeros(2, 2, 1, 2, 32, 32)
    VM.prefill(model, audio, torch.tensor(ids[:-1]), cache, torch.tensor([0]))
    rope = VM.rope_tables(model.cfg, 32, "cpu")
    logits = VM.decode_step(model, torch.tensor([ids[-1]]), torch.tensor([len(ids) - 1]), cache, rope)
    # float32 on both sides, sums in another order over two layers: 1e-4
    torch.testing.assert_close(logits[0], right[-1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("offset", [0, 5, 31])
def test_rope_at_a_slots_offset(tiny, offset):
    model, _ = tiny
    x = torch.randn(3, 1, 32, generator=torch.Generator().manual_seed(offset))
    cos, sin = VM.rope_tables(model.cfg, 40, "cpu")
    got = VM.apply_rope(x, cos[offset], sin[offset])
    want = O.rope(x, torch.tensor([offset]), 1e8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if offset:  # a rotation, not the identity
        assert (got - x).abs().max() > 1e-3


def _prompt() -> list[int]:
    tok = VoxtralTokens(AUDIO_CFG.n_audio_ctx // 4, LANG, EOS)
    return tok.transcription_prompt("en")


def test_prefill_and_cached_decoding_through_the_batcher_match_the_full_pass(tiny, monkeypatch):
    """Three windows admitted at different ticks; every logit row the tick
    computed for a live slot is the oracle's at that position, over the
    prompt and the tokens served before it."""
    model, w = tiny
    prompt = _prompt()
    recorded = []  # (pos [S], logits [S, V]) of every decode step
    step = AB.decode_step

    def recording(model, tokens, pos, cache, rope):
        logits = step(model, tokens, pos, cache, rope)
        recorded.append((pos.clone(), tokens.clone(), logits.clone()))
        return logits

    mels = {seed: _mel(seed) for seed in (11, 12, 13)}
    budgets = {11: 9, 12: 6, 13: 7}
    # each window's slot, and the first decode step recorded after its
    # admission (a slot a window left may serve a later one)
    admitted = {}
    admit = AB.AudioLLMBatcher._admit_device

    def admit_recording(self, batch):
        admit(self, batch)
        for slot, mel, _budget, _future in batch:
            seed = next(k for k, v in mels.items() if v is mel)
            admitted[seed] = (slot, len(recorded))

    monkeypatch.setattr(AB, "decode_step", recording)
    monkeypatch.setattr(AB.AudioLLMBatcher, "_admit_device", admit_recording)
    monkeypatch.setattr(settings, "os_batch_steps_per_tick", 2)

    async def run():
        batcher = AB.AudioLLMBatcher(model, prompt, EOS, slots=3, max_new_tokens=12)
        try:
            async def after_ticks(seed: int, n: int) -> None:
                while seed not in admitted:  # admitted, then n ticks more
                    await asyncio.sleep(0.005)
                ticks = batcher.stats["ticks"]
                while batcher.stats["ticks"] < ticks + n:
                    await asyncio.sleep(0.005)

            first = asyncio.create_task(batcher.transcribe_window(mels[11], budgets[11]))
            await after_ticks(11, 1)
            second = asyncio.create_task(batcher.transcribe_window(mels[12], budgets[12]))
            await after_ticks(12, 1)
            third = asyncio.create_task(batcher.transcribe_window(mels[13], budgets[13]))
            out = await asyncio.wait_for(asyncio.gather(first, second, third), 120)
            return out, batcher.stats
        finally:
            await batcher.stop()

    served, stats = asyncio.run(run())
    assert stats["admissions"] == 3 and stats["prefill_positions"] == 3 * (len(prompt) - 1)
    p = len(prompt)
    checked = 0
    for seed, tokens in zip((11, 12, 13), served):
        assert 1 <= len(tokens) <= budgets[seed]
        full = O.forward(w, mels[seed], prompt + tokens, ORACLE_CFG)
        # the window's rows: one per position from the prompt's last on
        slot, first = admitted[seed]
        rows = {}
        for pos, fed, logits in recorded[first:]:
            at = int(pos[slot])
            if p - 1 <= at <= p - 1 + len(tokens) and at not in rows:
                expected = prompt[-1] if at == p - 1 else tokens[at - p]
                if int(fed[slot]) == expected:
                    rows[at] = logits[slot]
        # every served token's row, and the end token's where the window ended on it
        assert set(range(p - 1, p - 1 + len(tokens))) <= set(rows)
        for at, row in rows.items():
            # float32 throughout (cache included); the batched prefill and
            # the oracle's per-head loops sum in other orders: 1e-4
            torch.testing.assert_close(row, full[at], rtol=1e-4, atol=1e-4)
            checked += 1
        assert tokens == [int(full[at].argmax()) for at in range(p - 1, p - 1 + len(tokens))]
    assert checked >= 3


class _Tokens(VoxtralTokens):
    @staticmethod
    def decode(ids) -> str:
        return " ".join(str(int(i)) for i in ids)


class _Backend:
    """A backend holding a handed-in model entry, as the benchmark's is."""

    def __init__(self, entry: dict) -> None:
        self._models = {"vox": entry}

    def _ensure_model(self, model_id: str) -> dict:
        return self._models[model_id]


def test_the_pool_serves_voxtral_through_its_batcher_with_spans_and_stats(tiny):
    """``transcribe_pcm_batched`` picks the audio-LLM batcher by the model's
    family; an admission records ``batcher.admit`` > ``admit.encode``,
    ``admit.prefill`` (size: positions prefilled), and ``pool_stats`` shows
    ``prefill_positions``."""
    from open_speech_tpu_torch.runtime import batcher_pool, tracing

    model, _ = tiny
    tok = _Tokens(AUDIO_CFG.n_audio_ctx // 4, LANG, EOS)
    backend = _Backend({"model": model, "cfg": model.cfg, "tok": tok})
    pcm = np.random.default_rng(4).uniform(-0.3, 0.3, 8000).astype(np.float32)

    async def run():
        batcher_pool.reset_pool()
        tracing.start()
        try:
            out = await asyncio.wait_for(
                batcher_pool.transcribe_pcm_batched(backend, "vox", "en", pcm), 60)
            batcher = await batcher_pool.get_batcher(backend, "vox", "en")
            return out, batcher, batcher_pool.pool_stats()
        finally:
            recorded.extend(tracing.stop())
            await batcher_pool.shutdown_batchers()
            batcher_pool.reset_pool()

    recorded = []
    out, batcher, stats = asyncio.run(run())
    spans = recorded
    assert isinstance(batcher, AB.AudioLLMBatcher)
    ids = [int(t) for t in out["text"].split()]
    assert 1 <= len(ids) <= AB.AudioLLMBatcher.token_budget(0.5)
    admit = next(s for s in spans if s.name == "batcher.admit")
    children = {s.name: s for s in spans if s.parent == admit.id}
    assert admit.size == 1 and set(children) == {"admit.encode", "admit.prefill"}
    assert children["admit.prefill"].size == len(_prompt()) - 1
    assert stats["vox/en/transcribe"]["prefill_positions"] == len(_prompt()) - 1
