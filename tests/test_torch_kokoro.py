"""The port's Kokoro model (``open_speech_tpu_torch.models.kokoro``) and its
vocoder ops against the JAX package's, on the CPU.

One JAX parameter tree at ``TINY_CONFIG`` with the JAX tests' small buckets
(16 phonemes, 128 frames), laid out by ``init_kokoro_params``, is built once
and carried across with ``kokoro_from_jax_tree``. Its values come from a
numpy seed: random biases and gains, so one that lands in the wrong tensor
shows, and random normal weights, so a flipped or transposed kernel shows. The JAX side's outputs are computed once per
module. The random draws of the harmonic source differ between
``jax.random`` and ``torch.Generator``, so the parity tests inject the same
noise (and, where the +-pi phase branch on symmetric bins would decide,
the same harmonic features) into both.

Tolerances, no looser than the JAX package's own against its torch oracle
(``tests/test_kokoro_convert.py``): 2e-5 for ALBERT, the text encoder and
the duration encoder, 3e-4 for F0/N and the decoder's features, 1e-5 for the
harmonic source and its STFT, 2e-3 for audio.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_speech_tpu.models.kokoro import model as JM
from open_speech_tpu.ops import vocoder as JV
from open_speech_tpu_torch.models.kokoro import model as TM
from open_speech_tpu_torch.models.kokoro.convert import kokoro_from_jax_tree
from open_speech_tpu_torch.ops import vocoder as TV

CFG = dataclasses.replace(JM.TINY_CONFIG, max_phonemes=16, max_frames=128)
TCFG = TM.KokoroConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
LENGTHS = (11, 5)
SPEEDS = (1.0, 0.8)
TOL_TEXT, TOL_PROSODY, TOL_SOURCE, TOL_AUDIO = 2e-5, 3e-4, 1e-5, 2e-3
SPF2 = CFG.samples_per_frame // 2
HPX = SPF2 // CFG.gen_hop


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module. The suite runs six workers on
    the host's cores; with a full pool per worker, the many small CPU ops of
    the vocoder wait on each other's spinning threads (a 1.4 s test took
    minutes in a full run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chan(a) -> np.ndarray:
    """JAX [B, T, C] -> the port's [B, C, T]."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1))


@pytest.fixture(scope="module")
def tree():
    """The JAX model's parameter tree as ``init_kokoro_params`` lays it out
    (its structure from ``jax.eval_shape``, which compiles nothing), filled
    from a numpy seed: weights normal * fan_in^-0.5, embeddings normal *
    0.02 (the text encoder's * hidden^-0.5), biases 0.02 * normal, gains and
    snake alphas 1 + 0.05 * normal."""
    shapes = jax.eval_shape(lambda key: JM.init_kokoro_params(key, CFG), jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = next(k.key for k in reversed(path) if isinstance(k, jax.tree_util.DictKey))
        shape = leaf.shape
        z = rng.standard_normal(shape)
        if name == "b":
            z = 0.02 * z
        elif name in ("g", "a1", "a2"):
            z = 1.0 + 0.05 * z
        elif name in ("word_emb", "pos_emb", "type_emb"):
            z = 0.02 * z
        elif name == "emb":
            z = z * shape[1] ** -0.5
        else:  # linear and LSTM [in, out]; conv [K, C_in, C_out]
            z = z * (shape[0] if len(shape) == 2 else shape[0] * shape[1]) ** -0.5
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jit(fn, *static: int, **fixed):
    """A JAX stage compiled once (faster here than its op-by-op form)."""
    return jax.jit(functools.partial(fn, **fixed) if fixed else fn, static_argnums=static)


@pytest.fixture(scope="module")
def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def model(tree):
    return kokoro_from_jax_tree(tree, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    ph = np.zeros((len(LENGTHS), CFG.max_phonemes), np.int32)
    for i, n in enumerate(LENGTHS):
        ph[i, :n] = rng.integers(1, CFG.n_symbols, n)
    style = (rng.standard_normal((len(LENGTHS), CFG.voice_dim)) * 0.3).astype(np.float32)
    return ph, np.asarray(LENGTHS, np.int32), style, np.asarray(SPEEDS, np.float32)


def _phoneme_mask(lengths) -> np.ndarray:
    return (np.arange(CFG.max_phonemes)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)[..., None]


@pytest.fixture(scope="module")
def jax_encoded(jtree, inputs):
    ph, lengths, style, speed = inputs
    (asr, f0, n, s_dec), n_frames = JM.encode_utterance(
        jtree, CFG, *(jnp.asarray(a) for a in (ph, lengths, style, speed)))
    x, _ = _jit(JM.decode_audio, 1)(jtree, CFG, asr, f0, n, s_dec, n_frames)
    return {"asr": np.asarray(asr), "f0": np.asarray(f0), "n": np.asarray(n),
            "s_dec": np.asarray(s_dec), "n_frames": np.asarray(n_frames), "x": np.asarray(x)}


@pytest.fixture(scope="module")
def noise():
    """Injected harmonic-source draws and a voiced F0 curve (the random
    weights' own F0 sits below the 10 Hz voicing threshold)."""
    rng = np.random.default_rng(17)
    b, nh = len(LENGTHS), CFG.harmonics + 1
    rand_phase = np.concatenate([np.zeros((b, 1)), rng.random((b, nh - 1))], 1).astype(np.float32)
    s_total = CFG.max_frames * CFG.samples_per_frame
    sine_noise = rng.standard_normal((b, s_total, nh)).astype(np.float32)
    t = np.arange(2 * CFG.max_frames) / 80.0
    f0 = (120.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t))[None].repeat(b, 0)  # 80-160 Hz
    f0[:, 60:90] = 0.0  # an unvoiced stretch
    return rand_phase, sine_noise, f0.astype(np.float32)


@pytest.fixture(scope="module")
def har(jtree, noise, jax_encoded):
    """The JAX model's harmonic features of its own F0, JAX layout."""
    rand_phase, sine_noise, _ = noise
    return np.asarray(_jit(JM.har_features, 1)(jtree, CFG, jnp.asarray(jax_encoded["f0"]),
                                      jnp.asarray(rand_phase), jnp.asarray(sine_noise)))


# ── (a) vocoder ops ─────────────────────────────────────────────────────


@pytest.mark.parametrize("k,stride,dilation,pad,t", [
    (3, 1, 1, None, 40),   # 'same', the AdaIN blocks' convs
    (11, 1, 5, None, 40),  # dilated resblock conv
    (2, 1, 1, None, 33),   # even kernel: 'same' pads one more on the right
    (3, 2, 1, None, 64),   # the decoder's F0/N convs
    (12, 6, 1, 3, 121),    # the generator's strided noise conv
    (7, 1, 1, None, 400),  # past the JAX im2col path (t*k > 2048)
])
def test_conv1d(k, stride, dilation, pad, t):
    rng = np.random.default_rng(k * 100 + t)
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = JV.conv1d(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     stride=stride, dilation=dilation, pad=pad)
    got = TV.conv1d(_t(_chan(x)), _t(w.transpose(2, 1, 0)), _t(b), stride=stride,
                    dilation=dilation, pad=pad)
    np.testing.assert_allclose(_np(got), _chan(want), atol=1e-5)


@pytest.mark.parametrize("k,stride,groups", [(20, 10, 1), (12, 6, 1), (3, 2, 6)])
def test_conv_transpose1d(k, stride, groups):
    """Dense (the generator's upsamplers) and depthwise; the JAX tree holds
    both kernel-flipped, dense as [K, C_in, C_out], depthwise as [K, 1, C]."""
    rng = np.random.default_rng(k)
    c_out = 4 if groups == 1 else 6
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w_torch = rng.standard_normal((6, c_out // groups, k)).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    perm = (2, 0, 1) if groups == 1 else (2, 1, 0)
    w_jax = np.ascontiguousarray(w_torch.transpose(perm)[::-1])
    pad = 1 if groups > 1 else None
    want = JV.conv_transpose1d(jnp.asarray(x), {"w": jnp.asarray(w_jax), "b": jnp.asarray(b)},
                               stride, pad=pad, groups=groups)
    got = TV.conv_transpose1d(_t(_chan(x)), _t(w_torch), _t(b), stride, pad=pad, groups=groups)
    np.testing.assert_allclose(_np(got), _chan(want), atol=1e-5)


def test_layer_norm():
    rng = np.random.default_rng(1)
    x = (3.0 + rng.standard_normal((2, 7, 16))).astype(np.float32)
    g, b = rng.standard_normal((2, 16)).astype(np.float32)
    want = JV.layer_norm(jnp.asarray(x), {"g": jnp.asarray(g), "b": jnp.asarray(b)})
    np.testing.assert_allclose(_np(TV.layer_norm(_t(x), _t(g), _t(b))), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("budget", [200, 37, 29])
def test_compress_durations(budget):
    """Under budget the durations pass unchanged; over it the total lands
    exactly on the budget, with the JAX package's frames wherever a scaled
    end is not exactly on a half frame. On one (the port rounds the exact
    end half to even, the JAX package its float32 cumsum) they may differ
    by one frame."""
    rng = np.random.default_rng(2)
    dur = rng.integers(1, 9, (3, 12)).astype(np.float32)
    dur[2, 8:] = 0.0  # padding
    want = np.asarray(JV.compress_durations(jnp.asarray(dur), budget))
    got = _np(TV.compress_durations(_t(dur), budget))
    total = dur.sum(1, keepdims=True)
    if budget >= total.max():
        np.testing.assert_array_equal(got, dur)
        np.testing.assert_array_equal(want, dur)
        return
    exact = np.cumsum(dur.astype(np.float64), 1) * budget / total
    np.testing.assert_array_equal(np.cumsum(got, 1), np.round(exact))
    np.testing.assert_array_equal(got.sum(1), budget)
    tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-9
    assert (np.cumsum(got, 1) == np.cumsum(want, 1))[~tie].all()
    assert np.abs(np.cumsum(got, 1) - np.cumsum(want, 1))[tie].max(initial=0) <= 1


# ── (b) biLSTM ──────────────────────────────────────────────────────────


def test_bilstm_mixed_lengths(tree, jtree, model):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, CFG.max_phonemes, CFG.hidden + CFG.style_dim)).astype(np.float32)
    lengths = np.asarray([16, 7, 1], np.int32)
    want = _jit(JM.bilstm)(jtree["pred"]["lstm"], jnp.asarray(x), jnp.asarray(lengths))
    got = TM.bilstm(model.predictor.lstm, _t(x), _t(lengths))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL_TEXT)
    assert not _np(got)[1, 7:].any()


# ── (c) stages ──────────────────────────────────────────────────────────


def _stage_args(name, rng, inputs, jax_encoded):
    """(JAX args, port args, port output -> JAX layout, tolerance) of a stage."""
    ph, lengths, _, _ = inputs
    mask = _phoneme_mask(lengths)
    frames = jax_encoded["n_frames"]
    if name == "albert_encode":
        return (ph, mask), (_t(ph), _t(mask)), _np, TOL_TEXT
    if name == "text_encode":
        return (ph, lengths, mask), (_t(ph), _t(lengths), _t(mask)), _np, TOL_TEXT
    if name == "duration_encode":
        d_en = rng.standard_normal((2, CFG.max_phonemes, CFG.hidden)).astype(np.float32) * mask
        sty = rng.standard_normal((2, CFG.style_dim)).astype(np.float32) * 0.3
        return ((d_en, sty, lengths, mask), (_t(d_en), _t(sty), _t(lengths), _t(mask)), _np,
                TOL_TEXT)
    if name == "f0n_predict":
        en = rng.standard_normal((2, CFG.max_frames, CFG.hidden + CFG.style_dim)).astype(np.float32)
        sty = rng.standard_normal((2, CFG.style_dim)).astype(np.float32) * 0.3
        return ((en, sty, frames), (_t(en), _t(sty), _t(frames)),
                lambda out: np.stack([_np(o) for o in out]), TOL_PROSODY)
    assert name == "decode_audio"
    e = jax_encoded
    args = (e["asr"], e["f0"], e["n"], e["s_dec"], frames)
    return args, tuple(_t(a) for a in args), lambda out: _np(out[0]).transpose(0, 2, 1), TOL_PROSODY


@pytest.mark.parametrize("name", ["albert_encode", "text_encode", "duration_encode",
                                  "f0n_predict", "decode_audio"])
def test_stage_matches_jax(name, jtree, model, inputs, jax_encoded):
    jargs, targs, to_jax_layout, tol = _stage_args(name, np.random.default_rng(8), inputs,
                                                   jax_encoded)
    want = _jit(getattr(JM, name), 1)(jtree, CFG, *(jnp.asarray(a) for a in jargs))
    if name == "f0n_predict":
        want = np.stack([np.asarray(w) for w in want])
    elif name == "decode_audio":
        want = want[0]
    got = to_jax_layout(getattr(TM, name)(model, TCFG, *targs))
    np.testing.assert_allclose(got, np.asarray(want), atol=tol)


def test_upsampling_res_block(jtree, model):
    """The F0 head's upsampling block: nearest 2x shortcut plus the
    depthwise transposed conv (JAX: lhs-dilated conv over the flipped
    kernel; the port: conv_transpose1d with output_padding 1)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 20, CFG.hidden)).astype(np.float32)
    sty = rng.standard_normal((2, CFG.style_dim)).astype(np.float32) * 0.3
    mask = (np.arange(20)[None, :] < np.asarray([20, 13])[:, None]).astype(np.float32)
    want, wmask = _jit(JM._adain_res_blk, upsample=True)(
        jnp.asarray(x), jnp.asarray(sty), jtree["pred"]["F0"][1], jnp.asarray(mask[..., None]))
    got, gmask = TM._adain_res_blk(_t(_chan(x)), _t(sty), model.predictor.F0[1],
                                   _t(mask[:, None, :]))
    np.testing.assert_allclose(_np(got), _chan(want), atol=TOL_PROSODY)
    np.testing.assert_array_equal(_np(gmask)[:, 0], np.asarray(wmask)[..., 0])


# ── (d) encode_utterance ────────────────────────────────────────────────


def test_encode_utterance(model, inputs, jax_encoded):
    (asr, f0, n, s_dec), n_frames = TM.encode_utterance(model, TCFG, *(_t(a) for a in inputs))
    np.testing.assert_array_equal(_np(n_frames), jax_encoded["n_frames"])
    assert n_frames.dtype == torch.int32 and (_np(n_frames) < CFG.max_frames).all()
    np.testing.assert_allclose(_np(asr), jax_encoded["asr"], atol=TOL_TEXT)
    np.testing.assert_allclose(_np(f0), jax_encoded["f0"], atol=TOL_PROSODY)
    np.testing.assert_allclose(_np(n), jax_encoded["n"], atol=TOL_PROSODY)
    np.testing.assert_array_equal(_np(s_dec), jax_encoded["s_dec"])


# ── (e) harmonic source, STFT, iSTFT ────────────────────────────────────


@pytest.mark.parametrize("voicing", ["model", "voiced"])
def test_harmonic_source(jtree, model, noise, jax_encoded, voicing):
    """With the model's own F0 (the random weights' sits below the 10 Hz
    voicing threshold: the noise branch) the sources agree to 1e-5. With a
    voiced 80-160 Hz curve the sines' argument is the accumulated phase,
    thousands of radians, and float32 rounds it differently in the two
    resamplers: there the bound is 1e-5 plus two float32 ulps of the top
    harmonic's phase at each sample, through sine_amp and the merge weights."""
    rand_phase, sine_noise, f0 = noise
    if voicing == "model":
        f0 = jax_encoded["f0"]
    want = np.asarray(_jit(JM.harmonic_source, 1)(jtree, CFG, jnp.asarray(f0),
                                                  jnp.asarray(rand_phase), jnp.asarray(sine_noise)))
    got = _np(TM.harmonic_source(model, TCFG, _t(f0), _t(rand_phase), _t(sine_noise)))
    tol = np.full(got.shape, TOL_SOURCE)
    if voicing == "voiced":
        up = CFG.upsample_total // 2
        top = np.cumsum(np.repeat(f0, up, 1) * (CFG.harmonics + 1) / CFG.sample_rate, 1)
        merge = np.abs(np.asarray(jtree["dec"]["gen"]["src_linear"]["w"])).sum()
        tol += 2 * CFG.sine_amp * merge * np.spacing((2 * np.pi * top).astype(np.float32))
    else:
        assert (f0 < CFG.voiced_threshold).all()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_stft_magnitude_and_phase():
    """Magnitudes to 1e-5; phases equal up to the +-pi branch, and on the
    DC and Nyquist bins (exact zeros in an FFT) +pi, never -pi, where the
    real part is negative."""
    rng = np.random.default_rng(9)
    x = np.tanh(rng.standard_normal((2, 3000))).astype(np.float32)
    x[1] -= 0.5  # a negative DC term
    jm, jp = _jit(JM._stft_mag_phase, 1, 2)(jnp.asarray(x), CFG.gen_n_fft, CFG.gen_hop)
    tm, tp = TM._stft_mag_phase(_t(x), CFG.gen_n_fft, CFG.gen_hop)
    np.testing.assert_allclose(_np(tm), _chan(jm), atol=TOL_SOURCE)
    d = np.abs(_np(tp) - _chan(jp))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-4
    edges = _np(tp)[:, [0, -1], 1:-1]  # DC and Nyquist, the symmetric end frames aside
    assert (edges >= 0).all() and np.isclose(edges, np.pi).any()


def test_istft_with_dead_frames():
    rng = np.random.default_rng(10)
    n_bins, t = CFG.gen_n_fft // 2 + 1, 300
    mag = np.exp(rng.standard_normal((2, t, n_bins))).astype(np.float32)
    phase = np.sin(rng.standard_normal((2, t, n_bins))).astype(np.float32)
    live = (np.arange(t)[None, :] < np.asarray([t, 211])[:, None]).astype(np.float32)
    want = _jit(JM._istft, 2, 3)(jnp.asarray(mag), jnp.asarray(phase), CFG.gen_n_fft,
                                 CFG.gen_hop, jnp.asarray(live[..., None]))
    got = TM._istft(_t(_chan(mag)), _t(_chan(phase)), CFG.gen_n_fft, CFG.gen_hop,
                    _t(live[:, None, :]))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL_SOURCE)


# ── (f) generator and vocode ────────────────────────────────────────────


def test_generate_waveform_with_injected_features(jtree, model, jax_encoded, noise, har):
    rand_phase, sine_noise, _ = noise
    e = jax_encoded
    want = _jit(JM.generate_waveform, 1)(jtree, CFG, jnp.asarray(e["x"]), jnp.asarray(e["s_dec"]),
                                jnp.asarray(e["f0"]), jnp.asarray(e["n_frames"]),
                                jnp.asarray(rand_phase), jnp.asarray(sine_noise),
                                har_feat=jnp.asarray(har))
    got = TM.generate_waveform(model, TCFG, _t(_chan(e["x"])), _t(e["s_dec"]), _t(e["f0"]),
                               _t(e["n_frames"]), _t(rand_phase), _t(sine_noise),
                               har_feat=_t(_chan(har)))
    want = np.asarray(want)
    assert got.shape == want.shape == (2, CFG.max_frames * CFG.samples_per_frame)
    np.testing.assert_allclose(_np(got), want, atol=TOL_AUDIO)


def test_vocode_with_injected_noise(jtree, model, jax_encoded, noise, har, monkeypatch):
    """``vocode`` end to end with both sides' noise and harmonic features
    patched to the same arrays: the wiring (noise shape, decoder style,
    masks) must give the JAX model's audio."""
    rand_phase, sine_noise, _ = noise
    monkeypatch.setattr(JM, "_source_noise", lambda *a: (jnp.asarray(rand_phase),
                                                          jnp.asarray(sine_noise)))
    monkeypatch.setattr(JM, "har_features", lambda *a: jnp.asarray(har))
    monkeypatch.setattr(TM, "_source_noise", lambda *a: (_t(rand_phase), _t(sine_noise)))
    monkeypatch.setattr(TM, "har_features", lambda *a: _t(_chan(har)))
    e = jax_encoded
    g = (e["asr"], e["f0"], e["n"], e["s_dec"])
    want = _jit(JM.vocode.__wrapped__, 1)(jtree, CFG, tuple(jnp.asarray(a) for a in g),
                                          jnp.asarray(e["n_frames"]), jax.random.PRNGKey(0))
    got = TM.vocode(model, TCFG, tuple(_t(a) for a in g), _t(e["n_frames"]))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL_AUDIO)


# ── (g) generator blocks ────────────────────────────────────────────────


def test_generator_blocks_match_jax(jtree, model, jax_encoded, har):
    """The first block and an interior block on the same (padded) arrays as
    the JAX model's ``_vocode_block_first``/``_vocode_block_interior``."""
    nb, h = 64, 32
    e = jax_encoded
    frames = e["n_frames"]
    x_pad = np.pad(e["x"], ((0, 0), (h, nb + h), (0, 0)))
    har_pad = np.pad(har, ((0, 0), (h * HPX, (nb + h) * HPX + 1), (0, 0)))
    want = JM._vocode_block_first(
        jtree, CFG, jnp.asarray(e["x"]), jnp.asarray(har), jnp.asarray(e["s_dec"]),
        jnp.asarray(frames), nb=nb, h=h)
    got = TM._block_first(model, TCFG, _t(_chan(e["x"])), _t(_chan(har)), _t(e["s_dec"]),
                          _t(frames), nb, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL_AUDIO)
    want = JM._vocode_block_interior(
        jtree, CFG, jnp.asarray(x_pad), jnp.asarray(har_pad), jnp.asarray(e["s_dec"]),
        jnp.asarray(frames), jnp.int32(nb), nb=nb, h=h)
    got = TM._block_interior(model, TCFG, _t(_chan(x_pad)), _t(_chan(har_pad)),
                             _t(e["s_dec"]), _t(frames), nb, nb, h)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL_AUDIO)


# ── (h)-(j) the port's own contracts ────────────────────────────────────


@pytest.fixture(scope="module")
def encoded(model, inputs):
    return TM.encode_utterance(model, TCFG, *(_t(a) for a in inputs))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# a block that holds the whole utterance equals vocode but for summation
# order (TOL_AUDIO: both read the same harmonic features); across blocks the generator's AdaIN statistics are block-local
# (the documented approximation), bounded as the JAX package bounds its own
MULTI_BLOCK_REL_L2 = 0.5
# one +-pi choice on the reflected first frame's phases (see
# test_batched_rows_equal_solo_rows) moves 1-5% of a short utterance's
# energy through the generator's instance norms; this bound only catches
# divergence, the stages are held one by one
OWN_FEATURES_REL_L2 = 0.5


@pytest.mark.parametrize("block_frames", [64, 16, 512])
def test_streaming_blocks_against_vocode(model, encoded, block_frames):
    g, n_frames = encoded
    total = int(n_frames.max())
    full = _np(TM.vocode(model, TCFG, g, n_frames, _gen(1)))[:, : total * CFG.samples_per_frame]
    blocks = list(TM.vocode_streaming(model, TCFG, g, n_frames, _gen(1), block_frames=block_frames))
    joined = np.concatenate(blocks, axis=1)
    assert joined.shape == (2, total * CFG.samples_per_frame)
    assert all(b.shape[1] == min(block_frames, total - i * block_frames) * CFG.samples_per_frame
               for i, b in enumerate(blocks))
    if total <= block_frames:
        np.testing.assert_allclose(joined, full, atol=TOL_AUDIO)
    else:
        assert len(blocks) == -(-total // block_frames)
        err = np.linalg.norm(joined - full) / np.linalg.norm(full)
        assert err < MULTI_BLOCK_REL_L2
    assert TM.vocode_blocks is TM.vocode_streaming


def _stages(model, inputs, gens, har=None) -> dict:
    """encode -> decoder -> harmonic features -> generator (on ``har`` when
    given, else on its own features)."""
    g, n_frames = TM.encode_utterance(model, TCFG, *inputs)
    noise = TM._source_noise(gens, len(gens), CFG.harmonics + 1,
                             CFG.max_frames * CFG.samples_per_frame, torch.device("cpu"))
    with TM._inference():
        x, _ = TM.decode_audio(model, TCFG, *g[:3], g[3], n_frames)
        own = TM.har_features(model, TCFG, g[1], *noise)
        audio = TM.generate_waveform(model, TCFG, x, g[3], g[1], n_frames, *noise,
                                     har_feat=own if har is None else har)
    return {"n_frames": n_frames, "asr": g[0], "f0": g[1], "n": g[2], "x": x, "har": own,
            "audio": audio}


def _complex(har: torch.Tensor) -> np.ndarray:
    """Harmonic features as re/im: free of the phase's +-pi branch."""
    nb = CFG.gen_n_fft // 2 + 1
    mag, phase = _np(har[:, :nb]), _np(har[:, nb:])
    return np.stack([mag * np.cos(phase), mag * np.sin(phase)])


def test_batched_rows_equal_solo_rows(model, inputs):
    """Each row draws its noise from its own generator, so a row's audio
    does not depend on the batch it is in: every stage of a batch row equals
    the row's solo run, the generator on the solo run's harmonic features.
    ``synthesize_frames`` gives the stages' audio on its own features. The
    whole synthesis of a batch row against its solo run, each on its own
    features, is held only in relative L2: the first STFT frame of the
    harmonic source is a reflection, symmetric, so its phases' +-pi branch
    is rounding's choice."""
    args = tuple(_t(a) for a in inputs)
    solo = [_stages(model, tuple(a[i : i + 1] for a in args), [_gen(21 + i)])
            for i in range(len(LENGTHS))]
    batch = _stages(model, args, [_gen(21 + i) for i in range(len(LENGTHS))],
                    har=torch.cat([s["har"] for s in solo]))
    for i, one in enumerate(solo):
        assert int(batch["n_frames"][i]) == int(one["n_frames"][0])
        for key, tol in (("asr", TOL_TEXT), ("f0", TOL_PROSODY), ("n", TOL_PROSODY),
                         ("x", TOL_PROSODY), ("audio", TOL_AUDIO)):
            np.testing.assert_allclose(_np(batch[key][i]), _np(one[key][0]), atol=tol, err_msg=key)
        np.testing.assert_allclose(_complex(batch["har"][i : i + 1]), _complex(one["har"]),
                                   atol=TOL_SOURCE)
    audio, n_frames = TM.synthesize_frames(model, TCFG, *args, rng=[_gen(21), _gen(22)])
    own = _stages(model, args, [_gen(21 + i) for i in range(len(LENGTHS))])
    np.testing.assert_allclose(_np(audio), _np(own["audio"]), atol=TOL_AUDIO)
    for i in range(len(LENGTHS)):
        row, alone = _np(audio[i]), _np(TM.synthesize_frames(
            model, TCFG, *(a[i : i + 1] for a in args), rng=[_gen(21 + i)])[0][0])
        assert np.linalg.norm(row - alone) / np.linalg.norm(alone) < OWN_FEATURES_REL_L2
    assert not np.allclose(_np(audio[0]), _np(audio[1]))


def test_speed_scales_frame_count(model, inputs):
    ph, lengths, style, _ = (_t(a) for a in inputs)
    totals = [
        _np(TM.encode_utterance(model, TCFG, ph, lengths, style, torch.full((2,), s))[1])
        for s in (0.7, 1.0, 1.5)
    ]
    assert (totals[0] > totals[1]).all() and (totals[1] > totals[2]).all()


# ── (m) random init ─────────────────────────────────────────────────────


def test_init_gives_the_jax_trees_tensors(model):
    """``init_kokoro_params`` builds every tensor the JAX tree carries
    across, with its shape; weights are drawn, biases zero, gains one."""
    rand = TM.init_kokoro_params(_gen(0), TCFG, device="cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in rand.state_dict().items()} == want
    sd = rand.state_dict()
    assert not sd["decoder.generator.conv_post.bias"].any()
    assert (sd["decoder.generator.resblocks.0.alpha1.0"] == 1).all()
    w = sd["decoder.generator.ups.0.weight"]  # [C_in, C_out, K]
    assert abs(w.std().item() * (w.shape[0] * w.shape[2]) ** 0.5 - 1.0) < 0.05
    assert sum(p.numel() for p in rand.parameters()) == sum(
        p.numel() for p in model.parameters())


def test_cudnn_scope_restores_the_process_flag():
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with TM._CUDNN:
            assert torch.backends.cudnn.allow_tf32 is False
            with TM._CUDNN:
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_weights_default_to_the_card():
    """``tts_effective_device`` is ``tts_device`` or else ``stt_device``
    (``cuda``), and weights are made there unless the caller names a device:
    on a host without CUDA that raises, it does not fall back to the CPU."""
    from open_speech_tpu_torch.config import Settings

    assert Settings({}).tts_device is None
    assert Settings({}).tts_effective_device == "cuda"
    assert Settings({"STT_DEVICE": "cpu"}).tts_effective_device == "cpu"
    assert Settings({"STT_DEVICE": "cuda", "TTS_DEVICE": "cpu"}).tts_effective_device == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(AssertionError, match="CUDA"):
        TM.init_kokoro_params(_gen(0), TCFG)
    assert TM.init_kokoro_params(_gen(0), TCFG, device="cpu").device.type == "cpu"


def test_geometry_and_voice_vector_match_jax(monkeypatch):
    """``OS_KOKORO_GEOMETRY=tiny`` selects ``TINY_CONFIG``, anything else
    kokoro-82M's, as in the JAX package; the fallback voice vectors are the
    JAX package's, bit for bit."""
    for value in ("tiny", "TINY", "", "full"):
        monkeypatch.setenv("OS_KOKORO_GEOMETRY", value)
        assert dataclasses.asdict(TM.resolve_kokoro_config()) == dataclasses.asdict(
            JM.resolve_kokoro_config())
    assert TM.resolve_kokoro_config() == TM.KokoroConfig()
    assert TM.KokoroConfig().samples_per_frame == 600 and TM.SAMPLE_RATE == 24_000
    for name, dim in (("af_heart", 256), ("am_adam", 2 * CFG.style_dim)):
        np.testing.assert_array_equal(TM.voice_vector(name, dim), JM.voice_vector(name, dim))
