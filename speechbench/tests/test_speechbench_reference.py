"""The reference that decides ``correct``, held against the port at test-tiny
on the CPU, and the whole run judged: sound, and with the timed path broken
underneath in each way a served cell can break."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from speechbench import reference, traffic, weights
from speechbench.entries.stt_batched import port_name
from speechbench.tests.conftest import TINY, run_tiny

CFG = json.loads((TINY / "configs" / "test-tiny.json").read_text())


def _port_model(cfg, seed, dtype=torch.float32):
    from open_speech_tpu_torch.models.whisper.model import Whisper, WhisperConfig

    wcfg = WhisperConfig(cfg["num_mel_bins"], cfg["vocab_size"], cfg["max_source_positions"],
                         cfg["d_model"], cfg["encoder_attention_heads"], cfg["encoder_layers"],
                         cfg["max_target_positions"], cfg["d_model"],
                         cfg["decoder_attention_heads"], cfg["decoder_layers"],
                         cfg["assumed"]["n_langs"])
    model = Whisper.empty(wcfg, dtype, "cpu")
    targets = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        for name, t in weights.make(cfg, seed, "cpu").items():
            targets[port_name(name)].copy_(t)
    return model, wcfg


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_matches_the_port(n_mels):
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim

    pcm = traffic.clips(3)[1, :40_000]
    want = reference.log_mel(pcm, n_mels, 480_000)
    got = log_mel_spectrogram(pad_or_trim(torch.from_numpy(pcm), 480_000), n_mels=n_mels)
    assert got.shape == want.shape == (n_mels, 3000)
    assert np.abs(got.numpy() - want).max() < 2e-4


def test_model_matches_the_port_at_float32():
    from open_speech_tpu_torch.models.whisper.model import decoder_forward, encode

    model, wcfg = _port_model(CFG, 11)
    w = reference.Weights(weights.make(CFG, 11, "cpu"))
    n = CFG["max_source_positions"] * 2 * reference.HOP
    mel = torch.from_numpy(reference.log_mel(traffic.clips(11)[0, :n], CFG["num_mel_bins"], n))
    xa = reference.encode(w, mel, CFG)
    with torch.no_grad():
        port_xa = encode(model, mel[None], wcfg)[0]
        tokens = [300, 302, 301, 350, 7, 65, 351]
        port = decoder_forward(model, torch.tensor([tokens]), port_xa[None], wcfg)[0]
    assert (port_xa - xa).abs().max() < 1e-4
    assert (port - reference.decoder_logits(w, tokens, xa, CFG)).abs().max() < 1e-4


def test_weights_cover_the_port_model_and_repeat():
    a, b = weights.make(CFG, 5, "cpu"), weights.make(CFG, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.token_embedding.weight"],
                           weights.make(CFG, 6, "cpu")["decoder.token_embedding.weight"])
    model, _ = _port_model(CFG, 5)
    names = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    assert sorted(map(port_name, a)) == sorted(names)


SP = reference.special_tokens(384, 2)


def _logits(rows):
    return torch.randn(rows, 384, generator=torch.Generator().manual_seed(4)) * 2


def _greedy(logits):
    """Greedy tokens under the rules, built with the reference's own gap: the
    token at gap 0 among those it allows."""
    served = []
    for j in range(logits.shape[0]):
        best = min(range(384), key=lambda t: max(reference.token_gaps(
            logits[: j + 1], served + [t], SP, ended=False)))
        served.append(best)
    return served


def test_gap_is_zero_for_greedy_tokens_and_grows_when_one_is_altered():
    logits = _logits(6)
    served = _greedy(logits)
    assert served[0] >= SP["ts0"]  # the first token is a timestamp
    assert reference.token_gaps(logits, served, SP, ended=False) == [0.0] * 6
    altered = list(served)
    altered[3] = next(t for t in range(SP["eot"]) if t != served[3] and
                      max(reference.token_gaps(logits[:4], served[:3] + [t], SP, False)) > 0.5)
    assert max(reference.token_gaps(logits, altered, SP, ended=False)) > 0.5


def test_gap_is_infinite_for_a_barred_token_and_checks_the_end():
    logits = _logits(4)
    assert reference.token_gaps(logits, [5], SP, ended=False) == [math.inf]  # text first
    assert reference.token_gaps(logits, [SP["sot"]], SP, ended=False) == [math.inf]
    served = _greedy(logits[:3])
    gaps = reference.token_gaps(logits, served, SP, ended=True)
    assert len(gaps) == 4 and gaps[-1] > 0  # <|endoftext|> was not the reference's pick


def test_budget_rule():
    assert reference.token_budget(16000 * 2, 224) == 48  # 2 s: 36 -> 48
    assert reference.token_budget(16000 * 30, 224) == 224
    assert reference.token_budget(int(16000 * 1.5), 28) == 28


# ── the whole run, on the CPU at test-tiny ────────────────────────────


@pytest.mark.parametrize("cell", ["tiny-open", "tiny-closed"])
def test_sound_run_is_correct(tiny_spec, cell):
    out = run_tiny(tiny_spec, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 10 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"stt_audio_s_per_s", "stt_window_p95_ms", "setup_s"}


def _token_altered(monkeypatch):
    from open_speech_tpu_torch.runtime import batcher

    pick = batcher._ruled_argmax

    def altered(logits, step_idx, *a, **k):
        tok = pick(logits, step_idx, *a, **k)
        # one slot's fifth token, moved to the next id as it is produced
        return torch.where((step_idx == 4) & (torch.arange(tok.numel()) == 0), tok + 1, tok)

    monkeypatch.setattr(batcher, "_ruled_argmax", altered)


def _state_unchanged(monkeypatch):
    from open_speech_tpu_torch.runtime import batcher

    step = batcher._slot_step_body

    def unchanged(model, tokens, pos, self_kv, *a):
        logits, _ = step(model, tokens, pos, self_kv.clone(), *a)
        return logits, self_kv  # the self-KV written by the step is dropped

    monkeypatch.setattr(batcher, "_slot_step_body", unchanged)


def _half_batch(monkeypatch):
    from open_speech_tpu_torch.runtime import batcher

    enc = batcher.encode

    def half(model, mels, cfg):
        keep = -(-mels.shape[0] // 2)
        out = enc(model, mels[:keep], cfg)
        rest = out.mean(0, keepdim=True).expand(mels.shape[0] - keep, *out.shape[1:])
        return torch.cat([out, rest])  # the rest take the mean of the half encoded

    monkeypatch.setattr(batcher, "encode", half)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch])
def test_broken_timed_path_is_not_correct(tiny_spec, monkeypatch, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_spec, "tiny-closed")
    assert not out["correct"], out["checks"]
