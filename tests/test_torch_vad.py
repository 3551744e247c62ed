"""Silero VAD: the PyTorch port against the JAX package.

``vad_params_from_jax_tree`` carries the JAX pytree of
``init_vad_params(PRNGKey(3))`` into the port's ``SileroNet``, so both sides
run the same weights on the same numpy-seeded windows. float32 on the CPU;
probabilities and states within 1e-5 absolute (sigmoid/tanh outputs in
[0, 1]; the two sides sum products in different orders). The ONNX path is
checked on an initializer file written by the JAX package's
``write_onnx_initializers``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.models import onnx_io as JO
from open_speech_tpu.models.vad import silero as JS
from open_speech_tpu_torch.models import onnx_io as TO
from open_speech_tpu_torch.models.vad import silero as TS

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    params = JS.init_vad_params(jax.random.PRNGKey(3))
    return params, TS.vad_params_from_jax_tree(jax.tree.map(np.asarray, params))


def _windows(n, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (n, TS.WINDOW)).astype(np.float32)


def test_vad_step_matches_jax(pair):
    params, model = pair
    audio = _windows(3, 0)
    state = (np.random.default_rng(1).standard_normal((2, 3, 128)) * 0.1).astype(np.float32)
    pj, sj = JS.vad_step(params, jnp.asarray(audio), jnp.asarray(state))
    pt, st = TS.vad_step(model, torch.from_numpy(audio), torch.from_numpy(state))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL, rtol=0)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_vad_scan_exact_windows_matches_jax_bucketed_scan(pair, n):
    """The port scans exactly n windows; JAX pads to a power-of-two bucket
    and returns the state after window n-1. Same probabilities, same state."""
    params, model = pair
    windows = _windows(n, n)
    bucket = 1 << (n - 1).bit_length()
    padded = np.pad(windows, ((0, bucket - n), (0, 0)))
    s0 = np.zeros((2, 1, 128), np.float32)
    pj, sj = JS.vad_scan(params, jnp.asarray(padded), jnp.asarray(s0), jnp.int32(n))
    pt, st = TS.vad_scan(model, torch.from_numpy(windows), torch.from_numpy(s0))
    assert pt.shape == (n,)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj)[:n], atol=TOL, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL, rtol=0)


def test_stream_wrapper_matches_jax_across_chunks(pair):
    """Per-stream state carries across chunks; max probability per chunk."""
    params, model = pair
    jv, tv = JS.SileroVAD(params), TS.SileroVAD(model)
    rng = np.random.default_rng(4)
    for size in (1600, 1600, 700, 300, 2048):
        chunk = rng.uniform(-0.5, 0.5, size).astype(np.float32)
        assert abs(tv(chunk) - jv(chunk)) <= TOL
    np.testing.assert_allclose(tv._state.numpy(), jv._state, atol=TOL, rtol=0)
    assert tv.calls == 5
    tv.reset()
    assert not tv._state.any()


def test_speech_segments_match_jax(pair):
    params, model = pair
    rng = np.random.default_rng(5)
    pcm = (rng.uniform(-0.6, 0.6, 16000 * 2) * 32767).astype("<i2").tobytes()
    for threshold in (0.3, 0.5, 0.7):
        want = JS.SileroVAD(params).get_speech_segments(pcm, threshold, 64, 96)
        got = TS.SileroVAD(model).get_speech_segments(pcm, threshold, 64, 96)
        assert [(s.start_ms, s.end_ms) for s in got] == [(s.start_ms, s.end_ms) for s in want]


@pytest.mark.parametrize("seed", range(4))
def test_segments_from_probs_identical(seed):
    rng = np.random.default_rng(seed)
    probs = np.clip(np.cumsum(rng.normal(0, 0.2, 200)) * 0.1 + 0.5, 0, 1).astype(np.float32)
    kw = dict(threshold=0.5, window_ms=32, min_speech_ms=96, silence_ms=160, total_ms=6400)
    want = JS.segments_from_probs(probs, **kw)
    got = TS.segments_from_probs(probs, **kw)
    assert [(s.start_ms, s.end_ms) for s in got] == [(s.start_ms, s.end_ms) for s in want]


def _silero_tensors(seed: int) -> dict[str, np.ndarray]:
    """Initializers under the silero ONNX names, in torch layouts."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    out = {"_model.stft.forward_basis_buffer": r(258, 1, 256)}
    for i, (cin, cout) in enumerate(((129, 128), (128, 64), (64, 64), (64, 128))):
        out[f"_model.encoder.{i}.reparam_conv.weight"] = r(cout, cin, 3)
        out[f"_model.encoder.{i}.reparam_conv.bias"] = r(cout)
    out["_model.decoder.rnn.weight_ih"] = r(512, 128)
    out["_model.decoder.rnn.weight_hh"] = r(512, 128)
    out["_model.decoder.rnn.bias_ih"] = r(512)
    out["_model.decoder.rnn.bias_hh"] = r(512)
    out["_model.decoder.decoder.2.weight"] = r(1, 128, 1)
    out["_model.decoder.decoder.2.bias"] = r(1)
    return out


def test_convert_silero_onnx_matches_jax(tmp_path):
    tensors = _silero_tensors(6)
    path = tmp_path / "silero_vad.onnx"
    JO.write_onnx_initializers(tensors, path)
    raw = TO.read_onnx_initializers(path)
    assert sorted(raw) == sorted(tensors)
    for name, arr in tensors.items():
        np.testing.assert_array_equal(raw[name], arr)
    params = JS.convert_silero(path)
    model = TS.convert_silero(path)
    audio = _windows(4, 7)
    state = np.zeros((2, 4, 128), np.float32)
    pj, sj = JS.vad_step(params, jnp.asarray(audio), jnp.asarray(state))
    pt, st = TS.vad_step(model, torch.from_numpy(audio), torch.from_numpy(state))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL, rtol=0)
    # bytes in memory parse the same as the file
    assert sorted(TO.read_onnx_initializers(path.read_bytes())) == sorted(tensors)


def test_random_init_is_seeded_and_runs():
    a = TS.init_vad_params(torch.Generator().manual_seed(0))
    b = TS.init_vad_params(torch.Generator().manual_seed(0))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    probs, state = TS.vad_scan(a, torch.zeros(2, TS.WINDOW), torch.zeros(2, 1, 128))
    assert probs.shape == (2,) and state.shape == (2, 1, 128)
    assert torch.isfinite(probs).all()


def test_get_vad_model_takes_its_device_from_the_caller(monkeypatch, tmp_path):
    monkeypatch.setenv("OS_VAD_ONNX_PATH", str(tmp_path / "missing.onnx"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(TS, "_vad_models", {})
    vad = TS.get_vad_model("cpu")
    assert vad.session.device.type == "cpu"
    assert TS.get_vad_model(torch.device("cpu")) is vad  # one per device
    JO.write_onnx_initializers(_silero_tensors(8), tmp_path / "v.onnx")
    monkeypatch.setenv("OS_VAD_ONNX_PATH", str(tmp_path / "v.onnx"))
    monkeypatch.setattr(TS, "_vad_models", {})
    loaded = TS.get_vad_model("cpu")
    want = TS.convert_silero(tmp_path / "v.onnx")
    assert torch.equal(loaded.session.lstm_wi, want.lstm_wi)


@pytest.mark.parametrize("setting,stt_device,want", [
    ("default", "cpu", "cpu"),  # unset: the STT device
    ("", "cpu", "cpu"),
    ("cpu", "cuda", "cpu"),  # asked for the host: the host, whatever the STT device
    ("cpu", None, "cpu"),
])
def test_vad_device_follows_os_vad_device(monkeypatch, setting, stt_device, want):
    from open_speech_tpu_torch.config import Settings, settings

    assert Settings({}).os_vad_device == "default"
    assert Settings({"OS_VAD_DEVICE": "cpu"}).os_vad_device == "cpu"
    monkeypatch.setattr(settings, "os_vad_device", setting)
    monkeypatch.setattr(settings, "stt_device", "cpu")
    assert TS.vad_device(stt_device) == torch.device(want)


@pytest.mark.parametrize("setting,stt_device", [
    ("cuda:7", "cpu"),  # a card that is not there
    ("nope", "cpu"),  # no such device type
    ("default", "cuda"),  # the STT device is the card, and there is none: no fallback to the host
    ("cuda", "cpu"),
])
def test_an_absent_vad_device_raises(monkeypatch, tmp_path, setting, stt_device):
    from open_speech_tpu_torch.config import settings

    if torch.cuda.device_count() > 7 or (torch.cuda.is_available() and "nope" not in setting + stt_device):
        pytest.skip("this host has the device; the check is for hosts without it")
    monkeypatch.setattr(settings, "os_vad_device", setting)
    monkeypatch.setattr(TS, "_vad_models", {})
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="is not available"):
        TS.get_vad_model(stt_device)
    assert TS._vad_models == {}
