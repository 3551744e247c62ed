"""The port's WeSpeaker ResNet34 embedder against the JAX package's, on the CPU.

``open_speech_tpu_torch/models/wespeaker.py`` against
``open_speech_tpu/models/wespeaker.py``: the kaldi mel banks exactly equal;
``kaldi_fbank`` within relative L2 2e-5 of JAX's and 1.5e-5 of a float64
numpy pipeline (the JAX test's rfft reference in float64: each package's
float32 fbank lies 0.6-1e-5 from it, the int16-scaled power spectrum
through a 512-point product, so the two are 2e-5 apart at most);
``wespeaker_embed`` within relative L2 1e-5 from the
committed fixture ``tests/fixtures/diarize/wespeaker.bin`` through each
package's converter and through ``wespeaker_params_from_jax``, and at full
width (``WeSpeakerConfig()``: ResNet34, m_channels 32) on the JAX test's
released-layout oracle with non-trivial BatchNorm statistics; the
``downsample`` key spelling, checkpoint discovery and the seeded init.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
from open_speech_tpu.models import wespeaker as JW
from open_speech_tpu_torch.models import wespeaker as TW
from tests.test_wespeaker import _oracle

FIXTURE = "tests/fixtures/diarize/wespeaker.bin"
TOL = 1e-5  # relative L2 of embeddings
TOL_FBANK = 2e-5  # relative L2 of fbank against JAX's
TOL_FBANK_F64 = 1.5e-5  # ... and against the float64 pipeline


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the host's cores, and with a full pool per worker the LSTMs' small CPU
    ops wait on each other's spinning threads (a 1 s test took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _windows(n: int, samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    voice = sum(np.sin(2 * np.pi * k * (120 + 200 * rng.uniform(size=(n, 1))) * t) / k for k in (1, 2, 3))
    return (0.2 * voice + 0.02 * rng.standard_normal((n, samples))).astype(np.float32)


def test_kaldi_mel_banks_equal_jax():
    for n_mels in (80, 40, 23):
        assert np.array_equal(TW._kaldi_mel_banks(n_mels), JW._kaldi_mel_banks(n_mels))


def _fbank_f64(audio: np.ndarray) -> np.ndarray:
    """kaldi fbank in float64 numpy, through numpy's rfft."""
    x = audio.astype(np.float64) * 32768.0
    idx = np.arange(1 + (x.shape[-1] - 400) // 160)[:, None] * 160 + np.arange(400)
    frames = x[..., idx] - x[..., idx].mean(axis=-1, keepdims=True)
    frames = frames - 0.97 * np.concatenate([frames[..., :1], frames[..., :-1]], axis=-1)
    frames = frames * (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 399)) ** 0.85
    mel = np.abs(np.fft.rfft(frames, 512, axis=-1)) ** 2 @ TW._kaldi_mel_banks(80).T.astype(np.float64)
    logmel = np.log(np.maximum(mel, 1.1920928955078125e-07))
    return logmel - logmel.mean(axis=-2, keepdims=True)


@pytest.mark.parametrize("samples", [24000, 16000, 4000])
def test_kaldi_fbank_matches_jax(samples):
    wave = _windows(3, samples, samples)
    want = np.asarray(JW.kaldi_fbank(wave))
    got = TW.kaldi_fbank(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (3, 1 + (samples - 400) // 160, 80)
    assert _rel_l2(got, want) < TOL_FBANK
    assert _rel_l2(got, _fbank_f64(wave)) < TOL_FBANK_F64
    one = TW.kaldi_fbank(torch.from_numpy(wave[:1, :400])).numpy()  # one frame: CMN leaves zeros
    assert one.shape == (1, 1, 80) and not one.any()


def test_kaldi_fbank_is_a_plain_rfft_of_the_povey_frame():
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    x = audio * 32768.0
    idx = np.arange(1 + (len(x) - 400) // 160)[:, None] * 160 + np.arange(400)
    frames = x[idx] - x[idx].mean(axis=-1, keepdims=True)
    frames = frames - 0.97 * np.concatenate([frames[:, :1], frames[:, :-1]], axis=-1)
    frames = frames * (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(400) / 399)) ** 0.85
    mel = np.abs(np.fft.rfft(frames, 512, axis=-1)) ** 2 @ TW._kaldi_mel_banks(80).T
    logmel = np.log(np.maximum(mel, 1.1920928955078125e-07))
    ref = logmel - logmel.mean(axis=0, keepdims=True)
    got = TW.kaldi_fbank(torch.from_numpy(audio)[None])[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("carry", ["convert_wespeaker", "params_from_jax"])
def test_fixture_embeddings_match_jax(carry):
    tree, jcfg = JW.convert_wespeaker(FIXTURE)
    if carry == "convert_wespeaker":
        model, cfg = TW.convert_wespeaker(FIXTURE, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    else:
        model = TW.wespeaker_params_from_jax(_numpy(tree), TW.WeSpeakerConfig(**dataclasses.asdict(jcfg)),
                                             device="cpu")
    fbank = np.asarray(JW.kaldi_fbank(_windows(4, 24000, 1)))
    want = np.asarray(JW.wespeaker_embed(tree, fbank))
    got = TW.wespeaker_embed(model, torch.tensor(fbank)).numpy()
    assert got.shape == want.shape == (4, 32)
    assert _rel_l2(got, want) < TOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("key", ["shortcut", "downsample"])
def test_full_width_oracle_embeddings_match_jax(key):
    """ResNet34 (m_channels 32, blocks 3/4/6/3, 256-d) from the JAX test's
    oracle state dict (stirred weights, BatchNorm running statistics moved
    off identity), on two 1.5 s windows."""
    m = _oracle(seed=2)
    sd = {k.replace(".shortcut.", f".{key}."): v.numpy() for k, v in m.state_dict().items()}
    tree, jcfg = JW.convert_wespeaker(sd)
    model, cfg = TW.convert_wespeaker(sd, device="cpu")
    assert cfg.num_blocks == (3, 4, 6, 3) and cfg.embed_dim == 256 and cfg == TW.WeSpeakerConfig()
    n = sum(t.numel() for t in model.state_dict().values())
    assert n == 6_634_336, n  # the JAX init's count at its default config
    fbank = np.asarray(JW.kaldi_fbank(_windows(2, 24000, 2)))
    want = np.asarray(JW.wespeaker_embed(tree, fbank))
    got = TW.wespeaker_embed(model, torch.tensor(fbank)).numpy()
    assert _rel_l2(got, want) < TOL
    with torch.no_grad():
        oracle = m(torch.tensor(fbank)).numpy()
    oracle /= np.linalg.norm(oracle, axis=-1, keepdims=True)
    np.testing.assert_allclose(got, oracle, atol=2e-4)


def test_random_init_is_seeded_and_embeds():
    cfg = TW.WeSpeakerConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=32)
    a = TW.init_wespeaker_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    b = TW.init_wespeaker_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    jax_shapes = sorted(np.shape(x) for x in jax.tree_util.tree_leaves(
        JW.init_wespeaker_params(jax.random.PRNGKey(0), JW.WeSpeakerConfig(8, 80, (1, 1, 1, 1), 32))))
    port_shapes = sorted(tuple(t.shape) for t in a.state_dict().values())
    assert len(port_shapes) == len(jax_shapes)
    e = TW.wespeaker_embed(a, torch.randn(3, 148, 80, generator=torch.Generator().manual_seed(1)))
    assert e.shape == (3, 32)
    np.testing.assert_allclose(e.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_find_checkpoint_env(tmp_path, monkeypatch):
    p = tmp_path / "ws.bin"
    p.write_bytes(b"x")
    monkeypatch.setenv("OS_WESPEAKER_CKPT_PATH", str(p))
    assert TW.find_wespeaker_checkpoint() == p == JW.find_wespeaker_checkpoint()
    monkeypatch.delenv("OS_WESPEAKER_CKPT_PATH")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert TW.find_wespeaker_checkpoint() is None
