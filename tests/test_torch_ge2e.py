"""The port's GE2E (resemblyzer) encoder against the JAX package's, on the CPU.

``open_speech_tpu_torch/models/ge2e.py`` against
``open_speech_tpu/models/ge2e.py``: ``ge2e_mel`` (batched in the port,
``jax.vmap`` in JAX) and ``ge2e_embed`` within relative L2 1e-5, from the
JAX test's resemblyzer-layout oracle through each package's converter and
through ``ge2e_params_from_jax``, and at full width (``GE2EConfig()``:
three LSTM layers of 256) on JAX's init; checkpoint discovery and the
seeded init.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
from open_speech_tpu.models import ge2e as JG
from open_speech_tpu_torch.models import ge2e as TG
from tests.test_ge2e import TorchVoiceEncoder

TOL = 1e-5  # relative L2 of mels and embeddings


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
    return (0.3 * np.sin(2 * np.pi * (150 + 400 * rng.uniform(size=(n, 1))) * t)
            + 0.02 * rng.standard_normal((n, samples))).astype(np.float32)


@pytest.mark.parametrize("samples", [24000, 16000, 1000])
def test_ge2e_mel_matches_jax(samples):
    wave = _windows(3, samples, samples)
    want = np.asarray(jax.vmap(JG.ge2e_mel)(wave))
    got = TG.ge2e_mel(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (3, samples // 160 + 1, 40)
    assert _rel_l2(got, want) < TOL
    one = TG.ge2e_mel(torch.from_numpy(wave[0])).numpy()  # one waveform, as JAX takes it
    assert one.shape == want.shape[1:] and _rel_l2(one, want[0]) < TOL


@pytest.mark.parametrize("carry", ["convert_ge2e", "params_from_jax"])
def test_oracle_embeddings_match_jax(carry):
    torch.manual_seed(5)
    oracle = TorchVoiceEncoder().eval()
    sd = {k: v.numpy() for k, v in oracle.state_dict().items()}
    tree, jcfg = JG.convert_ge2e(sd)
    if carry == "convert_ge2e":
        model, cfg = TG.convert_ge2e({"module." + k: v for k, v in sd.items()}, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    else:
        model = TG.ge2e_params_from_jax(_numpy(tree), TG.GE2EConfig(**dataclasses.asdict(jcfg)), device="cpu")
    mels = np.random.default_rng(0).standard_normal((4, 120, 40)).astype(np.float32)
    want = np.asarray(JG.ge2e_embed(tree, mels))
    got = TG.ge2e_embed(model, torch.tensor(mels)).numpy()
    assert _rel_l2(got, want) < TOL
    with torch.no_grad():
        np.testing.assert_allclose(got, oracle(torch.from_numpy(mels)).numpy(), atol=1e-5)


def test_full_width_embeddings_match_jax():
    tree = JG.init_ge2e_params(jax.random.PRNGKey(1))
    model = TG.ge2e_params_from_jax(_numpy(tree), TG.GE2EConfig(), device="cpu")
    n = sum(t.numel() for name, t in model.state_dict().items() if ".bias_hh_" not in name)
    assert n == 1_420_544  # the JAX init's count at its default config
    mels = np.asarray(jax.vmap(JG.ge2e_mel)(_windows(3, 24000, 9)))
    want = np.asarray(JG.ge2e_embed(tree, mels))
    got = TG.ge2e_embed(model, torch.tensor(mels)).numpy()
    assert got.shape == (3, 256)
    assert _rel_l2(got, want) < TOL


def test_random_init_is_seeded():
    a, b = TG.init_ge2e_params(device="cpu"), TG.init_ge2e_params(device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not a.lstm.bias_hh_l2.any() and a.lstm.weight_ih_l0.shape == (1024, 40)


def test_find_checkpoint_env(tmp_path, monkeypatch):
    p = tmp_path / "pretrained.pt"
    p.write_bytes(b"x")
    monkeypatch.setenv("OS_DIARIZER_CKPT_PATH", str(p))
    assert TG.find_ge2e_checkpoint() == p == JG.find_ge2e_checkpoint()
    monkeypatch.delenv("OS_DIARIZER_CKPT_PATH")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert TG.find_ge2e_checkpoint() is None
    bundled = tmp_path / ".cache" / "resemblyzer" / "pretrained.pt"
    bundled.parent.mkdir(parents=True)
    bundled.write_bytes(b"x")
    assert TG.find_ge2e_checkpoint() == bundled == JG.find_ge2e_checkpoint()
