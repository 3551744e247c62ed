"""The port's PyanNet segmentation against the JAX package's, on the CPU.

``open_speech_tpu_torch/models/segmentation.py`` against
``open_speech_tpu/models/segmentation.py``: the numpy host helpers
(``sinc_filters``, the powerset tables, ``n_frames``) exactly equal;
``segment_chunks`` log-probs within 1e-4 max abs of JAX's (jitted) from
the committed fixture ``tests/fixtures/diarize/segmentation.bin`` through
each package's converter and through ``segmentation_params_from_jax``, and
at full width (``SegmentationConfig()``: four BiLSTM layers of 128) on
JAX's ``PRNGKey(30)`` tree over one 10 s chunk; the converter's class
check, checkpoint discovery and the port's seeded random init.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
from open_speech_tpu.models import segmentation as JS
from open_speech_tpu_torch.models import segmentation as TS
from tests.test_segmentation import _oracle_state

FIXTURE = "tests/fixtures/diarize/segmentation.bin"
TOL = 1e-4  # max abs of log-probs


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


def _chunks(batch: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    tone = 0.3 * np.sin(2 * np.pi * (150 + 100 * rng.uniform(size=(batch, 1))) * t)
    return (tone + 0.05 * rng.standard_normal((batch, n))).astype(np.float32)


@pytest.mark.parametrize("pairs,kernel", [(40, 251), (8, 251), (5, 31)])
def test_sinc_filters_equal_jax(pairs, kernel):
    low, band = JS._default_sinc_init(pairs)
    assert np.array_equal(TS.sinc_filters(low, band, kernel), JS.sinc_filters(low, band, kernel))
    rng = np.random.default_rng(pairs)
    low, band = rng.uniform(-200, 4000, (pairs, 1)), rng.uniform(-100, 2000, (pairs, 1))
    assert np.array_equal(TS.sinc_filters(low, band, kernel), JS.sinc_filters(low, band, kernel))


def test_powerset_and_frame_counts_equal_jax():
    for speakers, overlap in ((3, 2), (4, 2), (3, 3), (2, 1)):
        assert TS.powerset_classes(speakers, overlap) == JS.powerset_classes(speakers, overlap)
    tcfg, jcfg = TS.SegmentationConfig(), JS.SegmentationConfig()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) and tcfg.n_classes == 7
    idx = np.random.default_rng(0).integers(0, 7, (3, 50))
    assert np.array_equal(TS.powerset_to_multilabel(idx, tcfg), JS.powerset_to_multilabel(idx, jcfg))
    for n in (400, 32000, 160000, 160001, 321234):
        assert TS.n_frames(n, tcfg) == JS.n_frames(n, jcfg)
    assert TS.n_frames(TS.CHUNK_SAMPLES) == 589


@pytest.mark.parametrize("carry", ["convert_segmentation", "params_from_jax"])
def test_fixture_log_probs_match_jax(carry):
    tree, jcfg = JS.convert_segmentation(FIXTURE)
    if carry == "convert_segmentation":
        model, cfg = TS.convert_segmentation(FIXTURE, device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    else:
        model = TS.segmentation_params_from_jax(_numpy(tree), TS.SegmentationConfig(**dataclasses.asdict(jcfg)),
                                                device="cpu")
    chunks = _chunks(3, 48000, 1)
    want = np.asarray(JS.segment_chunks(tree, chunks, jcfg))
    got = TS.segment_chunks(model, chunks).numpy()
    assert got.shape == want.shape == (3, JS.n_frames(48000, jcfg), 7)
    assert np.abs(got - want).max() < TOL
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_full_width_log_probs_match_jax():
    """pyannote/segmentation-3.0's geometry on one 10 s chunk."""
    tree = JS.init_segmentation_params(None)
    model = TS.segmentation_params_from_jax(_numpy(tree), TS.SegmentationConfig(), device="cpu")
    n = sum(t.numel() for name, t in model.state_dict().items() if ".bias_hh_" not in name)
    assert n + 80 == 1_489_249  # JAX's count also holds the 40 + 40 sinc band edges
    chunks = _chunks(1, TS.CHUNK_SAMPLES, 2)
    want = np.asarray(JS.segment_chunks(tree, chunks))
    got = TS.segment_chunks(model, chunks).numpy()
    assert got.shape == (1, 589, 7)
    assert np.abs(got - want).max() < TOL


def test_lstm_keeps_one_bias_per_direction():
    model, cfg = TS.convert_segmentation(FIXTURE, device="cpu")
    assert cfg.lstm_layers == 1 and cfg.conv_hidden == 12 and cfg.lstm_hidden == 16
    for sfx in ("l0", "l0_reverse"):
        assert not getattr(model.lstm, f"bias_hh_{sfx}").any()
    from open_speech_tpu_torch.models.ckptutil import load_state_dict

    src = load_state_dict(FIXTURE)
    np.testing.assert_array_equal(model.lstm.bias_ih_l0_reverse.numpy(),
                                  src["lstm.bias_ih_l0_reverse"] + src["lstm.bias_hh_l0_reverse"])


def test_convert_rejects_wrong_classes():
    m = _oracle_state(n_classes=5)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    with pytest.raises(ValueError, match="classes"):
        TS.convert_segmentation(sd, device="cpu")


def test_oracle_state_dict_converts_as_jax_converts():
    """A full-width released-layout state dict (the JAX test's oracle with
    the stirred weights) through both converters."""
    m = _oracle_state(seed=3)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    tree, jcfg = JS.convert_segmentation(sd)
    model, cfg = TS.convert_segmentation(sd, device="cpu")
    assert cfg.lstm_layers == 4 and cfg.n_sinc == 80
    wave = _chunks(2, 32000, 4)
    want = np.asarray(JS.segment_chunks(tree, wave, jcfg))
    assert np.abs(TS.segment_chunks(model, wave).numpy() - want).max() < TOL
    with torch.no_grad():
        oracle = m(torch.from_numpy(wave)[:, None]).numpy()
    assert np.abs(TS.segment_chunks(model, wave).numpy() - oracle).max() < TOL


def test_random_init_is_seeded_at_full_width():
    a = TS.init_segmentation_params(device="cpu")
    b = TS.init_segmentation_params(torch.Generator().manual_seed(30), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    out = TS.segment_chunks(a, np.zeros((1, TS.CHUNK_SAMPLES), np.float32))
    assert out.shape == (1, 589, 7) and torch.isfinite(out).all()


def test_find_checkpoint_env(tmp_path, monkeypatch):
    p = tmp_path / "seg.bin"
    p.write_bytes(b"x")
    monkeypatch.setenv("OS_SEGMENTATION_CKPT_PATH", str(p))
    assert TS.find_segmentation_checkpoint() == p == JS.find_segmentation_checkpoint()
    monkeypatch.setenv("OS_SEGMENTATION_CKPT_PATH", str(tmp_path / "missing"))
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert TS.find_segmentation_checkpoint() is None
    snap = tmp_path / "hub" / "models--pyannote--segmentation-3.0" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "pytorch_model.bin").write_bytes(b"x")
    assert TS.find_segmentation_checkpoint() == snap / "pytorch_model.bin" == JS.find_segmentation_checkpoint()
