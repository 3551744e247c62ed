"""Kokoro weight conversion in the port (``models/kokoro/convert.py``,
``models/piper/convert.py:fold_weight_norms``) against the JAX package's
converter and the torch oracle (``tests/kokoro_oracle.py``: the KModel graph
at a reduced geometry, with the checkpoint's tensor names and weight-normed
convolutions).

``convert_kokoro`` on the oracle's checkpoint must give the JAX converter's
arrays exactly, once ``kokoro_from_jax_tree`` has mapped the JAX layouts
onto the port's, and the same inferred config. The converted model is then
held against the oracle itself, as the JAX package's own test holds its
model: 2e-5 for ALBERT and the text encoder, 3e-4 for F0/N, 2e-3 for audio,
equal frame counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from open_speech_tpu.models.kokoro.convert import convert_kokoro as jax_convert_kokoro
from open_speech_tpu.models.piper.convert import fold_weight_norms as jax_fold_weight_norms
from open_speech_tpu_torch.models.kokoro import model as TM
from open_speech_tpu_torch.models.kokoro.convert import (
    _flatten,
    convert_kokoro,
    convert_kokoro_file,
    convert_voice_pack,
    kokoro_from_jax_tree,
    select_voice_style,
)
from open_speech_tpu_torch.models.piper.convert import fold_weight_norms
from tests import kokoro_oracle as KO

P_MAX = 16
TOK_LEN = 11
# not in the tensor shapes (ALBERT shares one layer); as the JAX test sets them
OVERRIDES = dict(max_phonemes=P_MAX, max_frames=128, plbert_heads=KO.PL_HEADS,
                 plbert_layers=KO.PL_LAYERS, gen_hop=KO.HOP)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module, as in tests/test_torch_kokoro.py:
    six suite workers with a full pool each make the small CPU ops wait on
    each other's spinning threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle():
    torch.manual_seed(11)
    return KO.KModelS().eval()


@pytest.fixture(scope="module")
def nested(oracle):
    return oracle.nested_state_dict()


@pytest.fixture(scope="module")
def converted(nested):
    return convert_kokoro(nested, device="cpu", **OVERRIDES)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    tokens = np.zeros((1, P_MAX), np.int64)
    tokens[0, :TOK_LEN] = rng.integers(1, KO.N_SYMBOLS, TOK_LEN)
    ref_s = (rng.standard_normal((1, 2 * KO.STY)) * 0.3).astype(np.float32)
    return tokens, ref_s


def test_convert_matches_the_jax_converter(nested, converted):
    params, jcfg = jax_convert_kokoro(nested, **OVERRIDES)
    model, cfg = converted
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    carried = kokoro_from_jax_tree(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu").state_dict()
    ours = model.state_dict()
    assert ours.keys() == carried.keys()
    for name, t in ours.items():
        if "bias_hh_l0" in name:  # the JAX tree sums each LSTM's two biases
            assert not carried[name].any()
            ih = name.replace("bias_hh", "bias_ih")
            torch.testing.assert_close(ours[ih] + t, carried[ih], rtol=0, atol=0)
        elif "bias_ih_l0" not in name:
            torch.testing.assert_close(t, carried[name], rtol=0, atol=0, msg=name)


def test_convert_takes_tensors_files_and_wrapped_checkpoints(nested, converted, tmp_path):
    ref = converted[0].state_dict()
    as_tensors = {mod: {k: torch.from_numpy(v) for k, v in sd.items()} for mod, sd in nested.items()}
    model, _ = convert_kokoro(as_tensors, device="cpu", **OVERRIDES)
    path = tmp_path / "kokoro.pth"
    torch.save({"net": as_tensors}, path)
    from_file, cfg = convert_kokoro_file(path, device="cpu", **OVERRIDES)
    assert cfg == converted[1]
    for m in (model, from_file):
        for name, t in m.state_dict().items():
            torch.testing.assert_close(t, ref[name], rtol=0, atol=0)
    short = {mod: {k: v for k, v in sd.items() if k != "F0_proj.bias"}
             for mod, sd in nested.items()}
    with pytest.raises(KeyError, match="checkpoint has no tensor predictor.F0_proj.bias"):
        convert_kokoro(short, device="cpu", **OVERRIDES)


def test_voice_pack_and_style_row(tmp_path):
    pack = np.random.default_rng(0).standard_normal((510, 1, 2 * KO.STY)).astype(np.float32)
    path = tmp_path / "af_test.pt"
    torch.save(torch.from_numpy(pack), path)
    for src in (pack, torch.from_numpy(pack), path):
        arr = convert_voice_pack(src)
        assert arr.shape == (510, 2 * KO.STY) and arr.dtype == np.float32
        np.testing.assert_array_equal(arr, pack[:, 0])
    np.testing.assert_array_equal(select_voice_style(arr, TOK_LEN), arr[TOK_LEN - 1])
    np.testing.assert_array_equal(select_voice_style(arr, 0), arr[0])
    np.testing.assert_array_equal(select_voice_style(arr, 10_000), arr[-1])


def test_flatten_strips_dataparallel_prefixes():
    nested = {"predictor": {"module.lstm.weight_ih_l0": np.zeros((4, 2))}}
    assert "predictor.lstm.weight_ih_l0" in _flatten(nested)
    flat = {"predictor.module.lstm.weight_ih_l0": torch.zeros(4, 2)}
    assert "predictor.lstm.weight_ih_l0" in _flatten(flat)


@pytest.mark.parametrize("style", ["weight_g", "parametrizations"])
@pytest.mark.parametrize("layer", ["conv", "conv_transpose"])
def test_fold_weight_norms(style, layer):
    """Both key styles fold to the module's effective weight, and to the
    JAX package's fold exactly."""
    torch.manual_seed(3)
    mod = (torch.nn.Conv1d(4, 3, 5) if layer == "conv"
           else torch.nn.ConvTranspose1d(4, 3, 6, stride=2))
    if style == "weight_g":
        mod = torch.nn.utils.weight_norm(mod)
    else:
        mod = torch.nn.utils.parametrizations.weight_norm(mod)
    with torch.no_grad():  # a gain that differs per output slice
        for name, p in mod.named_parameters():
            if name in ("weight_g", "parametrizations.weight.original0"):
                p.mul_(torch.rand_like(p) + 0.5)
    sd = {f"x.{k}": v.detach().numpy() for k, v in mod.state_dict().items()}
    mod(torch.zeros(1, 4, 8))  # weight_g's hook recomputes .weight on a forward
    folded = fold_weight_norms(sd)
    assert set(folded) == {"x.weight", "x.bias"}
    np.testing.assert_allclose(folded["x.weight"], mod.weight.detach().numpy(), atol=1e-6)
    np.testing.assert_array_equal(folded["x.weight"], jax_fold_weight_norms(sd)["x.weight"])


def test_converted_model_matches_the_oracle(oracle, converted, inputs):
    """ALBERT, the text encoder, the frame count, F0/N and the audio of the
    converted model against the oracle's exact-length forward, as the JAX
    package's test does: ``max_frames`` set to the utterance's own frame
    count, the oracle's harmonic features injected."""
    model, cfg = converted
    tokens, ref_s = inputs
    mask = torch.zeros(1, P_MAX, 1)
    mask[0, :TOK_LEN] = 1.0
    tok = torch.from_numpy(tokens)
    lengths = torch.tensor([TOK_LEN])
    with torch.no_grad():
        want = oracle.bert(tok[:, :TOK_LEN], attention_mask=torch.ones(1, TOK_LEN,
                                                                       dtype=torch.long))
        got = TM.albert_encode(model, cfg, tok, mask)
        torch.testing.assert_close(got[:, :TOK_LEN], want.last_hidden_state, rtol=0, atol=2e-5)
        want = oracle.text_encoder(tok[:, :TOK_LEN], torch.zeros(1, TOK_LEN, dtype=torch.bool))
        got = TM.text_encode(model, cfg, tok, lengths, mask)
        torch.testing.assert_close(got[:, :TOK_LEN], want, rtol=0, atol=2e-5)

    args = (tok, lengths, torch.from_numpy(ref_s), torch.tensor([1.0]))
    _, n_frames = TM.encode_utterance(model, cfg, *args)
    total = int(n_frames[0])
    cfg2 = dataclasses.replace(cfg, max_frames=total)
    (asr, f0, n, s_dec), n_frames = TM.encode_utterance(model, cfg2, *args)
    rng = np.random.default_rng(17)
    nh = KO.HARMONICS + 1
    rand_phase = torch.from_numpy(np.concatenate(
        [np.zeros((1, 1)), rng.random((1, nh - 1))], axis=1).astype(np.float32))
    sine_noise = torch.from_numpy(
        rng.standard_normal((1, total * cfg2.samples_per_frame, nh)).astype(np.float32))
    t_audio, t_total, _, t_f0, t_n = oracle.forward_exact(
        tok[:, :TOK_LEN], torch.from_numpy(ref_s), torch.tensor([1.0]), rand_phase, sine_noise)
    assert t_total == total
    torch.testing.assert_close(f0, t_f0, rtol=0, atol=3e-4)
    torch.testing.assert_close(n, t_n, rtol=0, atol=3e-4)
    with torch.no_grad():
        f0_up = torch.nn.functional.interpolate(
            t_f0[:, None], scale_factor=KO.UPSAMPLE_TOTAL // 2, mode="nearest").transpose(1, 2)
        har = oracle.decoder.generator.m_source(f0_up, rand_phase, sine_noise)[:, :, 0]
        har_feat = torch.cat(oracle.decoder.generator.stft.transform(har), dim=1)
        x, _ = TM.decode_audio(model, cfg2, asr, f0, n, s_dec, n_frames)
        audio = TM.generate_waveform(model, cfg2, x, s_dec, f0, n_frames, rand_phase,
                                     sine_noise, har_feat=har_feat)
    m = min(audio.shape[1], t_audio.shape[1])
    torch.testing.assert_close(audio[:, :m], t_audio[:, :m], rtol=0, atol=2e-3)
