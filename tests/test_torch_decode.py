"""Whisper decoding: the PyTorch port against the JAX package.

Same weights (random test-tiny carried over with ``params_from_jax_tree``,
and the trained ``tests/fixtures/test-tiny-eot`` read by each side's own
loader), same encoder states, same prompts. Temperature-0 greedy and beam
tokens must be equal; avg_logprob and no_speech_prob within 1e-4 (float32
on the CPU, different summation orders). The sampled path draws from a
torch generator, so its tokens differ from JAX's: it is checked for
determinism and for the timestamp rules instead.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.models.whisper import convert as JC
from open_speech_tpu.models.whisper import decode as JD
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu.models.whisper.tokenizer import get_tokenizer
from open_speech_tpu.ops.mel import log_mel_spectrogram
from open_speech_tpu_torch.models.whisper import convert as TC
from open_speech_tpu_torch.models.whisper import decode as TD
from open_speech_tpu_torch.models.whisper import model as TM

TOL = 1e-4
FIXTURES = Path(__file__).parent / "fixtures"
SR = 16000


def _beeps(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(1.2 * SR)  # one test-tiny window
    clip = rng.normal(0, 0.003, n)
    for i in range(k):
        dur = int(0.15 * SR)
        t = np.arange(dur) / SR
        start = i * (n // k)
        clip[start : start + dur] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
    return clip.astype(np.float32)


@pytest.fixture(scope="module", params=["random", "eot"])
def setup(request):
    """(jax params, torch model, cfg, special, enc_out [2, T, d])."""
    if request.param == "random":
        cfg = JM.PRESETS["test-tiny"]
        params = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
        model = TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TM.PRESETS["test-tiny"])
    else:
        params, cfg = JC.load_params(str(FIXTURES / "test-tiny-eot"), dtype=jnp.float32)
        model, _ = TC.load_params(str(FIXTURES / "test-tiny-eot"), dtype=torch.float32)
    audio = np.stack([_beeps(1, 3), _beeps(3, 4)])
    mel = log_mel_spectrogram(jnp.asarray(audio), n_mels=cfg.n_mels)
    enc = np.array(JM.encode(params, mel, cfg))
    sp = get_tokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs).special
    return params, model, TM.PRESETS["test-tiny"], cfg, sp, enc


def _prompts(sp) -> list[np.ndarray]:
    sot = sp.sot_sequence("en", "transcribe")
    prev = [sp.startofprev] + [40, 41, 42, 43, 44, 45, 46, 47]  # prefill P >= 8
    return [np.array([sot, sot], np.int32), np.array([prev + sot] * 2, np.int32)]


def _same(res_t, res_j):
    np.testing.assert_array_equal(res_t.tokens, np.asarray(res_j.tokens))
    np.testing.assert_array_equal(res_t.lengths, np.asarray(res_j.lengths))
    np.testing.assert_allclose(res_t.avg_logprob, res_j.avg_logprob, atol=TOL, rtol=0)
    np.testing.assert_allclose(res_t.no_speech_prob, res_j.no_speech_prob, atol=TOL, rtol=0)


@pytest.mark.parametrize("prompt_idx", [0, 1])
def test_greedy_matches_jax(setup, prompt_idx):
    params, model, tcfg, cfg, sp, enc = setup
    prompt = _prompts(sp)[prompt_idx]
    opts = dict(beam_size=1, max_new_tokens=12, suppress_tokens=(33, 34))
    res_j = JD.greedy_decode(params, cfg, sp, jnp.asarray(enc), prompt, JD.DecodeOptions(**opts))
    res_t = TD.greedy_decode(model, tcfg, sp, torch.from_numpy(enc), prompt, TD.DecodeOptions(**opts))
    _same(res_t, res_j)


@pytest.mark.parametrize("ancestry", [True, False])
def test_beam5_matches_jax(setup, ancestry):
    params, model, tcfg, cfg, sp, enc = setup
    prompt = _prompts(sp)[1]
    opts = dict(beam_size=5, max_new_tokens=12)
    res_j = JD.beam_decode(
        params, cfg, sp, jnp.asarray(enc), prompt, JD.DecodeOptions(**opts), ancestry=ancestry
    )
    res_t = TD.beam_decode(
        model, tcfg, sp, torch.from_numpy(enc), prompt, TD.DecodeOptions(**opts), ancestry=ancestry
    )
    _same(res_t, res_j)


def test_beam_ancestry_equals_gather(setup):
    _, model, tcfg, _, sp, enc = setup
    prompt = _prompts(sp)[0]
    opts = TD.DecodeOptions(beam_size=3, max_new_tokens=10)
    a = TD.beam_decode(model, tcfg, sp, torch.from_numpy(enc), prompt, opts, ancestry=True)
    g = TD.beam_decode(model, tcfg, sp, torch.from_numpy(enc), prompt, opts, ancestry=False)
    np.testing.assert_array_equal(a.tokens, g.tokens)
    np.testing.assert_allclose(a.avg_logprob, g.avg_logprob, atol=1e-6, rtol=0)


def test_detect_language_matches_jax(setup):
    params, model, tcfg, cfg, sp, enc = setup
    codes_j, probs_j = JD.detect_language(params, cfg, sp, jnp.asarray(enc))
    codes_t, probs_t = TD.detect_language(model, tcfg, sp, torch.from_numpy(enc))
    assert codes_t == codes_j
    np.testing.assert_allclose(probs_t, probs_j, atol=TOL, rtol=0)


def test_sampled_decode_is_seeded_and_keeps_the_rules(setup):
    _, model, tcfg, _, sp, enc = setup
    prompt = _prompts(sp)[0]
    opts = TD.DecodeOptions(beam_size=1, temperature=0.8, max_new_tokens=16)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return TD.greedy_decode(model, tcfg, sp, torch.from_numpy(enc), prompt, opts, generator=gen)

    a, b = run(800), run(800)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    ts = sp.timestamp_begin
    max_init = ts + 50
    for row, n in zip(a.tokens, a.lengths):
        toks = [int(t) for t in row[:n]]
        if not toks:
            continue
        assert ts <= toks[0] <= max_init, "a decode opens with a timestamp <= 1.0 s"
        stamps = [t for t in toks if t >= ts]
        assert stamps == sorted(stamps), "timestamps never go back"
        assert all(t < sp.eot or t >= ts for t in toks), "no special tokens sampled"
