"""Piper (VITS) of the port, held against the JAX package on the CPU.

- **The vocoder ops** of this slice (``istft``, ``adain1d``, ``style_mod``,
  ``resblock1`` with its mask) against ``open_speech_tpu/ops/vocoder.py``
  on the same numpy inputs, weights carried across in each package's
  layout (1e-5); ``init_resblock1``'s shapes and spread.
- **The model, stage by stage**, at a small geometry with the full
  topology (two encoder layers, four duration flows, two coupling layers,
  two upsample stages with two resblock kernels), with and without a
  speaker embedding (``gin``). One JAX tree (``init_piper_params`` plus
  numpy-seeded values in every leaf it starts at zero: biases, the flow's
  ``post`` convolutions, the affine) is carried over with
  ``piper_params_from_jax``. Each stage gets the same inputs on both sides:
  the text encoder, the log durations (1e-5), the durations and
  ``n_frames`` (exact), the flow (1e-5), the decoder (1e-5), and
  ``synthesize_vits`` as a whole (n_frames exact, audio within 2e-5).
  The relative-position reshapes and the embedding slice are exact on
  integer-valued inputs; the spline inverse is held on bin edges and the
  tails.
- **The converters**: ``tests/test_piper_convert.py``'s piper_train-style
  oracle (weight_g/weight_v on the flow, parametrizations on the decoder)
  as a state dict, and as an ONNX file written by the JAX package's
  ``write_onnx_initializers``, through both packages' converters: the same
  config and voice metadata, and the same synthesis.
- **The batcher**: JAX's four batcher tests on the port (batched rows equal
  solo rows, noise follows the seed and not the slot, the backend's audio
  with the batcher on equals it off, ``stop`` fails pending jobs), and the
  port's batched rows against the JAX batcher's with JAX's row noise
  injected through ``_row_noise``.
- **The backend**: a converted voice under ``OS_PIPER_VOICES_DIR`` gives
  the JAX backend's PCM (JAX's row noise injected), batcher on and off;
  the registry, the sample rates, speaker selectors, unload.
- **The router**: every TTS id of the catalog resolves to the JAX router's
  backend name, or raises the named error of a backend the port has not
  ported (Pocket); nothing falls back to Kokoro in its place.

The ceilings: the two packages' log durations differ by at most 2.9e-6
here, while the nearest duration lies 3.6e-3 (one speaker) and 2.8e-2
(speakers) from an integer, so the ceilings agree for a reason; the test
fails by name if a seed puts a duration within 3e-5 of one (``_margin``).
"""

from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import open_speech_tpu.models.piper.convert as JC
import open_speech_tpu.models.piper.model as JM
import open_speech_tpu.ops.vocoder as JV
import open_speech_tpu.runtime.tts_batcher as JB
import open_speech_tpu_torch.models.piper.convert as TC
import open_speech_tpu_torch.models.piper.model as TM
import open_speech_tpu_torch.ops.vocoder as TV
import open_speech_tpu_torch.runtime.tts_batcher as TB
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.piper import PiperConfig, init_piper_params, piper_params_from_jax, synthesize_vits
from tests.test_piper_convert import P_MAX as O_P, SynthesizerT

TOL = 1e-5  # each stage, max abs
TOL_AUDIO = 2e-5  # the whole graph's audio, max abs (tanh output, |x| < 1)

JCFG = JM.PiperConfig(
    hidden=32, ffn_filter=64, n_layers=2, dp_filter=32, flow_layers=2,
    upsample_rates=(4, 4), upsample_kernels=(8, 8), upsample_initial=64,
    resblock_kernels=(3, 5), resblock_dilations=((1, 3), (1, 3)),
    max_phonemes=16, max_frames=64,
)
GEOMETRIES = {"single": JCFG, "speakers": dataclasses.replace(JCFG, n_speakers=3, gin=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops spin under the suite's xdist workers with a full
    intra-op pool each (see ``tests/test_torch_kokoro.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg) -> PiperConfig:
    return PiperConfig(**dataclasses.asdict(jcfg))


def _jax_tree(jcfg, seed: int) -> dict:
    """``init_piper_params`` with numpy-seeded values in the leaves it starts
    at zero, so every bias, the flows' ``post`` and the affine are live."""
    tree = jax.tree_util.tree_map(np.asarray, JM.init_piper_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or "['post']" in name or "['ea']" in name:
            return (x + rng.standard_normal(x.shape) * 0.1).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def pair(request):
    """(JAX cfg, port cfg, JAX params, port model) on one tree."""
    jcfg = GEOMETRIES[request.param]
    tree = _jax_tree(jcfg, 3)
    cfg = _port_cfg(jcfg)
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree), piper_params_from_jax(tree, cfg, device="cpu")


def _inputs(cfg, seed: int = 0):
    """Three rows (lengths 16, 11, 5), speeds 1.0/1.25/0.8, and the noise."""
    rng = np.random.default_rng(seed)
    b, p, f = 3, cfg.max_phonemes, cfg.max_frames
    lens = np.array([p, 11, 5], np.int64)
    tokens = np.zeros((b, p), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, cfg.n_phonemes, n)
    sid = np.arange(b, dtype=np.int64) % max(cfg.n_speakers, 1)
    speed = np.array([1.0, 1.25, 0.8], np.float32)
    dp = (rng.standard_normal((b, p, 2)) * cfg.noise_scale_w).astype(np.float32)
    z = rng.standard_normal((b, f, cfg.hidden)).astype(np.float32)
    return tokens, lens, sid, speed, dp, z


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _cf(a) -> torch.Tensor:
    """[B, T, C] numpy -> channel-first torch."""
    return _t(np.asarray(a).transpose(0, 2, 1))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0, err_msg=what)


def _margin(w: np.ndarray, mask: np.ndarray) -> float:
    """How far the valid durations lie from an integer (the ceiling's edge)."""
    frac = np.abs(w - np.round(w))[mask > 0]
    return float(frac.min()) if frac.size else 1.0


# ── vocoder ops ─────────────────────────────────────────────────────────


def test_istft_matches_jax():
    rng = np.random.default_rng(0)
    for n_fft, hop, t in ((20, 5, 12), (16, 12, 5)):  # hop > n_fft/2 zero-extends
        mag = rng.uniform(0, 2, (2, t, n_fft // 2 + 1)).astype(np.float32)
        phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
        want = JV.istft(jnp.asarray(mag), jnp.asarray(phase), n_fft, hop)
        got = TV.istft(_cf(mag), _cf(phase), n_fft, hop)
        assert got.shape == (2, t * hop)
        _close(got, want, TOL, f"n_fft {n_fft} hop {hop}")


def test_adain_and_style_mod_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)  # [B, T, C]
    style = rng.standard_normal((2, 4)).astype(np.float32)
    p = {"w": rng.standard_normal((4, 12)).astype(np.float32) * 0.3,
         "b": rng.standard_normal(12).astype(np.float32) * 0.1}
    w, b = _t(p["w"].T), _t(p["b"])
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    _close(TV.adain1d(_cf(x), _t(style), w, b), np.asarray(JV.adain1d(jnp.asarray(x), jnp.asarray(style), jp)
                                                           ).transpose(0, 2, 1), TOL)
    _close(TV.style_mod(_cf(x), _t(style), w, b), np.asarray(JV.style_mod(jnp.asarray(x), jnp.asarray(style), jp)
                                                             ).transpose(0, 2, 1), TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_resblock1_matches_jax(masked):
    """Weights from JAX's ``init_resblock1`` (biases filled) carried into a
    port block; the mask re-zeros the padding after every convolution."""
    rng = np.random.default_rng(2)
    dil = (1, 3, 5)
    jp = jax.tree_util.tree_map(np.asarray, JV.init_resblock1(jax.random.PRNGKey(0), 8, 5, dil))
    for leaf in jp.values():
        leaf["b"] = rng.standard_normal(8).astype(np.float32) * 0.1
    block = TV.resblock1_module(8, 5, dil)
    with torch.no_grad():
        for i in range(len(dil)):
            for conv, key in ((block.convs1[i], f"c1_{i}"), (block.convs2[i], f"c2_{i}")):
                conv.weight.copy_(_t(jp[key]["w"].transpose(2, 1, 0)))
                conv.bias.copy_(_t(jp[key]["b"]))
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    mask = (np.arange(40)[None, :, None] < np.array([40, 23])[:, None, None]).astype(np.float32)
    want = JV.resblock1(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, jp), dil,
                        mask=jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        got = TV.resblock1(_cf(x), block, dil, mask=_cf(mask) if masked else None)
    _close(got, np.asarray(want).transpose(0, 2, 1), TOL)


def test_init_resblock1_draws_the_jax_shapes_and_spread():
    block = TV.init_resblock1(torch.Generator().manual_seed(0), 64, 7, (1, 3, 5))
    want = JV.init_resblock1(jax.random.PRNGKey(0), 64, 7, (1, 3, 5))
    assert len(block.convs1) == len(block.convs2) == 3
    for i in range(3):
        for conv, key in ((block.convs1[i], f"c1_{i}"), (block.convs2[i], f"c2_{i}")):
            assert tuple(conv.weight.shape) == tuple(np.asarray(want[key]["w"]).transpose(2, 1, 0).shape)
            assert not conv.bias.any()
            assert abs(conv.weight.std().item() * (7 * 64) ** 0.5 - 1.0) < 0.05


# ── the model, stage by stage ──────────────────────────────────────────


@pytest.mark.parametrize("t", [1, 2, 5, 9])
def test_relative_position_reshapes_are_exact(t):
    """Integer-valued inputs: every element must land where JAX puts it."""
    rng = np.random.default_rng(t)
    rel = rng.integers(-1000, 1000, (2, 3, t, 2 * t - 1)).astype(np.float32)
    att = rng.integers(-1000, 1000, (2, 3, t, t)).astype(np.float32)
    emb = rng.integers(-1000, 1000, (9, 4)).astype(np.float32)
    assert torch.equal(TM._rel_to_abs(_t(rel)), _t(np.asarray(JM._rel_to_abs(jnp.asarray(rel)))))
    assert torch.equal(TM._abs_to_rel(_t(att)), _t(np.asarray(JM._abs_to_rel(jnp.asarray(att)))))
    assert torch.equal(TM._rel_embed(_t(emb), t, 4), _t(np.asarray(JM._rel_embed(jnp.asarray(emb), t, 4))))


def test_spline_inverse_matches_jax_at_bin_edges_and_tails():
    """Inputs on and beside every knot, and past both tails."""
    rng = np.random.default_rng(4)
    cfg = _port_cfg(JCFG)
    b, t, nb = 2, 64, cfg.dp_bins
    uw = rng.standard_normal((b, t, nb)).astype(np.float32)
    uh = rng.standard_normal((b, t, nb)).astype(np.float32)
    ud = rng.standard_normal((b, t, nb - 1)).astype(np.float32)
    # the knots of the height axis, where the bucket index changes
    h = np.exp(uh) / np.exp(uh).sum(-1, keepdims=True)
    knots = np.cumsum(1e-3 + (1 - 1e-3 * nb) * h, -1) * 2 * cfg.dp_tail - cfg.dp_tail
    x = rng.uniform(-6, 6, (b, t)).astype(np.float32)
    pick = rng.integers(0, nb, (b, t))
    on_knot = np.take_along_axis(knots, pick[..., None], -1)[..., 0].astype(np.float32)
    x[:, ::3] = on_knot[:, ::3]
    x[:, 1::3] = np.nextafter(on_knot[:, 1::3], np.float32(10))
    x[:, :2] = [[-7.0, 7.0], [-5.0, 5.0]]
    want = JM._rq_spline_inverse(*(jnp.asarray(a) for a in (x, uw, uh, ud)), JCFG)
    got = TM._rq_spline_inverse(*(_t(a) for a in (x, uw, uh, ud)), cfg)
    _close(got, want, TOL)
    assert np.isfinite(got.numpy()).all()


def _jit(fn):
    return jax.jit(fn, static_argnums=1)


def _both_stages(pair):
    """Each stage on both sides, every stage fed the JAX stage's inputs."""
    jcfg, cfg, jp, model = pair
    tokens, lens, sid, speed, dp, z = _inputs(cfg)
    mask = (np.arange(cfg.max_phonemes)[None, :] < lens[:, None]).astype(np.float32)
    jg = jp["emb_g"][jnp.asarray(sid)] if "emb_g" in jp else None
    out = {}
    x, m, logs = _jit(JM.text_encoder)(jp, jcfg, jnp.asarray(tokens), jnp.asarray(mask[..., None]))
    logw = _jit(JM.sdp_log_durations)(jp, jcfg, x, jnp.asarray(mask[..., None]), jg, jnp.asarray(dp))
    fmask = (np.arange(cfg.max_frames)[None, :] < np.array([50, 37, 64])[:, None]).astype(np.float32)[..., None]
    jz = _jit(JM.flow_inverse)(jp, jcfg, jnp.asarray(z), jnp.asarray(fmask), jg)
    audio = _jit(JM.generator)(jp, jcfg, jnp.asarray(z) * fmask, jg, jnp.asarray(fmask))
    out["jax"] = dict(x=x, m=m, logs=logs, logw=logw, z=jz, audio=audio)
    with torch.no_grad():
        tm = _t(mask)[:, None]
        g = TM.speaker_vector(model, _t(sid))
        tx, tmm, tlogs = TM.text_encoder(model, cfg, _t(tokens), tm)
        tlogw = TM.sdp_log_durations(model, cfg, _cf(np.asarray(x)), tm, g, _cf(dp))
        tz = TM.flow_inverse(model, cfg, _cf(z), _cf(fmask), g)
        taudio = TM.generator(model, cfg, _cf(z * fmask), g, _cf(fmask))
    out["port"] = dict(x=tx, m=tmm, logs=tlogs, logw=tlogw, z=tz, audio=taudio)
    return out, mask, speed


@pytest.fixture(scope="module")
def stages(pair):
    return _both_stages(pair)


@pytest.mark.parametrize("stage", ["x", "m", "logs", "logw", "z"])
def test_stage_matches_jax(stages, stage):
    out, _, _ = stages
    _close(out["port"][stage], np.asarray(out["jax"][stage]).transpose(0, 2, 1), TOL, stage)


def test_decoder_matches_jax(stages):
    out, _, _ = stages
    _close(out["port"]["audio"], out["jax"]["audio"], TOL)


def test_durations_and_n_frames_are_exact(stages):
    """The ceilings of both packages' durations, and their frame counts."""
    out, mask, speed = stages
    f_max = JCFG.max_frames
    jw = jnp.exp(out["jax"]["logw"][..., 0]) * jnp.asarray(mask) / jnp.asarray(speed)[:, None]
    margin = _margin(np.asarray(jw), mask)
    assert margin > 3e-5, f"a duration lies {margin} from an integer: within float error of the ceiling"
    jw_ceil = np.asarray(JV.compress_durations(jnp.ceil(jw), f_max))
    jn = np.clip(np.cumsum(jw_ceil, 1)[:, -1].astype(np.int64), 1, f_max)
    w_ceil, _, n_frames = TM.durations(out["port"]["logw"], _t(mask)[:, None], _t(speed), f_max)
    assert torch.equal(w_ceil, _t(jw_ceil))
    assert n_frames.tolist() == jn.tolist()


def test_synthesize_vits_matches_jax(pair):
    jcfg, cfg, jp, model = pair
    tokens, lens, sid, speed, dp, z = _inputs(cfg, seed=1)
    ja, jn = JM.synthesize_vits(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(sid),
                                jnp.asarray(speed), jax.random.PRNGKey(0),
                                dp_noise=jnp.asarray(dp), z_noise=jnp.asarray(z))
    ta, tn = synthesize_vits(model, cfg, _t(tokens), _t(lens), _t(sid), _t(speed),
                             dp_noise=_cf(dp), z_noise=_cf(z))
    assert tn.tolist() == np.asarray(jn).tolist()
    assert 0 < tn.min() and tn.max() <= cfg.max_frames
    _close(ta, ja, TOL_AUDIO)


def test_generator_padding_does_not_contaminate_valid_tail(pair):
    """A padded-bucket decoder run equals the exact-length run on the valid
    prefix (JAX's ``test_piper_convert`` case, on the port)."""
    _, cfg, _, model = pair
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((1, cfg.hidden, 9)).astype(np.float32))
    g = TM.speaker_vector(model, torch.tensor([1 % cfg.n_speakers]))
    with torch.no_grad():
        exact = TM.generator(model, cfg, z, g)
        fmask = (torch.arange(cfg.max_frames) < 9).float()[None, None]
        padded = TM.generator(model, cfg, torch.nn.functional.pad(z, (0, cfg.max_frames - 9)), g, fmask)
    spf = cfg.samples_per_frame
    torch.testing.assert_close(padded[:, : 9 * spf], exact, atol=2e-5, rtol=0)


def test_generated_noise_follows_the_generator(pair):
    _, cfg, _, model = pair
    tokens, lens, sid, speed, _, _ = _inputs(cfg)
    runs = [synthesize_vits(model, cfg, _t(tokens), _t(lens), _t(sid), _t(speed),
                            rng=torch.Generator().manual_seed(s))[0] for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# ── the converters ──────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def oracle():
    torch.manual_seed(3)
    return SynthesizerT().eval()


def _oracle_inputs(p: int, f: int, hidden: int):
    rng = np.random.default_rng(5)
    tokens = np.zeros((2, p), np.int64)
    lens = np.array([11, 7], np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, 40, n)
    return (tokens, lens, np.array([1, 2], np.int64), np.array([1.0, 1.25], np.float32),
            (rng.standard_normal((2, p, 2)) * 0.8).astype(np.float32),
            rng.standard_normal((2, f, hidden)).astype(np.float32))


def _same_synthesis(jp, jcfg, model, cfg) -> None:
    tokens, lens, sid, speed, dp, z = _oracle_inputs(cfg.max_phonemes, cfg.max_frames, cfg.hidden)
    ja, jn = JM.synthesize_vits(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(sid),
                                jnp.asarray(speed), jax.random.PRNGKey(0),
                                dp_noise=jnp.asarray(dp), z_noise=jnp.asarray(z))
    ta, tn = synthesize_vits(model, cfg, _t(tokens), _t(lens), _t(sid), _t(speed), dp_noise=_cf(dp), z_noise=_cf(z))
    assert tn.tolist() == np.asarray(jn).tolist()
    _close(ta, ja, TOL_AUDIO)


def test_state_dict_converts_as_the_jax_package_converts(oracle):
    sd = oracle.state_dict_numpy()
    assert any(k.endswith(".weight_g") for k in sd) and any(".parametrizations." in k for k in sd)
    jp, jcfg = JC.convert_piper_state_dict(sd, max_phonemes=O_P, max_frames=64)
    model, cfg = TC.convert_piper_state_dict({"model_g." + k: v for k, v in sd.items()}, device="cpu",
                                             max_phonemes=O_P, max_frames=64)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_speakers == 3 and cfg.gin == 8
    _same_synthesis(jp, jcfg, model, cfg)


def test_onnx_voice_converts_as_the_jax_package_converts(oracle, tmp_path):
    from open_speech_tpu.models.onnx_io import write_onnx_initializers

    path = tmp_path / "voice.onnx"
    write_onnx_initializers(oracle.state_dict_numpy(), path)
    (tmp_path / "voice.onnx.json").write_text(json.dumps({
        "audio": {"sample_rate": 16000}, "inference": {"noise_scale": 0.5, "noise_w": 0.6},
        "num_symbols": 40, "num_speakers": 3, "speaker_id_map": {"a": 0, "b": 2}}))
    jp, jcfg, jmeta = JC.convert_piper_onnx(path)
    model, cfg, meta = TC.convert_piper_onnx(path, device="cpu")
    assert meta == jmeta and meta["speaker_id_map"] == {"a": 0, "b": 2}
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.sample_rate, cfg.noise_scale, cfg.noise_scale_w) == (16000, 0.5, 0.6)
    _same_synthesis(jp, jcfg, model, cfg)


def test_an_anonymised_onnx_export_is_refused(tmp_path):
    from open_speech_tpu.models.onnx_io import write_onnx_initializers

    path = tmp_path / "voice.onnx"
    write_onnx_initializers({"onnx::Conv_1": np.zeros((2, 2), np.float32)}, path)
    with pytest.raises(ValueError, match="anonymized"):
        TC.convert_piper_onnx(path, device="cpu")


def test_random_init_has_the_converted_tree(oracle):
    """``init_piper_params`` makes the tensors a conversion makes, with the
    JAX package's spread, so random and converted voices share one path."""
    model, cfg = TC.convert_piper_state_dict(oracle.state_dict_numpy(), device="cpu")
    rand = init_piper_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: v.shape for k, v in rand.state_dict().items()} == {k: v.shape for k, v in model.state_dict().items()}
    sd = rand.state_dict()
    assert not sd["flow.flows.0.post.weight"].any() and not sd["dec.conv_pre.bias"].any()
    assert abs(sd["enc_p.emb.weight"].std().item() * cfg.hidden**0.5 - 1.0) < 0.05
    w = sd["dec.ups.0.weight"]  # [C_in, C_out, K]
    assert abs(w.std().item() * (w.shape[0] * w.shape[2]) ** 0.5 - 1.0) < 0.05


# ── the batcher ─────────────────────────────────────────────────────────


def _jax_row_noise(seed: int, cfg, device):
    """The JAX batcher's row noise (``runtime/tts_batcher.py:_piper_rows``),
    in the port's layout."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), np.uint32(seed))
    k1, k2 = jax.random.split(key)
    dp = jax.random.normal(k1, (cfg.max_phonemes, 2)) * cfg.noise_scale_w
    z = jax.random.normal(k2, (cfg.max_frames, cfg.hidden))
    return _t(np.asarray(dp).T).to(device), _t(np.asarray(z).T).to(device)


@pytest.fixture(scope="module")
def batch_pair():
    """The port's model and the JAX params at ``tests/test_piper_batcher.py``'s geometry."""
    jcfg = JM.PiperConfig(hidden=32, ffn_filter=64, n_layers=2, dp_filter=32, flow_layers=2,
                          upsample_rates=(4, 4), upsample_kernels=(8, 8), upsample_initial=64,
                          resblock_kernels=(3,), resblock_dilations=((1, 3),), max_phonemes=16, max_frames=64)
    tree = _jax_tree(jcfg, 3)
    cfg = _port_cfg(jcfg)
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree), piper_params_from_jax(tree, cfg, device="cpu")


def _solo(model, cfg, ids, speaker=0, speed=1.0, seed=0) -> np.ndarray:
    phon = torch.zeros((1, cfg.max_phonemes), dtype=torch.int64)
    phon[0, : len(ids)] = torch.tensor(ids)
    audio, n = TB._piper_rows(model, cfg, phon, torch.tensor([len(ids)]), torch.tensor([speaker]),
                              torch.tensor([speed]), [seed])
    return audio[0, : int(n[0]) * cfg.samples_per_frame].numpy()


JOBS = [([1, 2, 3, 4, 5], 0, 1.0, 0), ([6, 7, 8], 0, 1.25, 7), ([9, 10, 11, 12], 0, 0.8, 42)]


def _batched(b, jobs) -> list[np.ndarray]:
    results: list = [None] * len(jobs)
    errs: list = []

    def run(i):
        try:
            chunks = list(b.synthesize(*jobs[i]))
            results[i] = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errs and not any(th.is_alive() for th in threads), errs
    return results


def test_batched_rows_match_solo(batch_pair):
    _, cfg, _, model = batch_pair
    b = TB.PiperBatcher(model, cfg)
    try:
        refs = [_solo(model, cfg, *j) for j in JOBS]
        for got, ref in zip(_batched(b, JOBS), refs):
            assert got.shape == ref.shape and got.size > 0
            np.testing.assert_allclose(got, ref, atol=3e-5, rtol=1e-4)
    finally:
        b.stop()


def test_noise_is_per_seed_not_per_slot(batch_pair):
    _, cfg, _, model = batch_pair
    a, b, c = (_solo(model, cfg, [1, 2, 3], seed=s) for s in (5, 5, 6))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a[: len(c)], c[: len(a)])


def test_batched_rows_match_the_jax_batcher(batch_pair, monkeypatch):
    """The same three jobs through both packages' batchers, JAX's row noise
    injected into the port's."""
    jcfg, cfg, jp, model = batch_pair
    monkeypatch.setattr(TB, "_row_noise", _jax_row_noise)
    jb, tb = JB.PiperBatcher(jp, jcfg), TB.PiperBatcher(model, cfg)
    try:
        for got, want in zip(_batched(tb, JOBS), _batched(jb, JOBS)):
            assert got.shape == want.shape and got.size > 0
            np.testing.assert_allclose(got, want, atol=TOL_AUDIO, rtol=0)
    finally:
        jb.stop()
        tb.stop()


def test_stop_fails_pending(batch_pair):
    _, cfg, _, model = batch_pair
    b = TB.PiperBatcher(model, cfg)
    list(b.synthesize([1, 2], 0, 1.0, 0))
    b.stop()
    with pytest.raises(RuntimeError):
        list(b.synthesize([1, 2], 0, 1.0, 0))


# ── the backend ─────────────────────────────────────────────────────────

VOICE = "piper/en_US-lessac-medium"
TEXT = "Hello there. Call me back later."  # every id under the oracle's 40 symbols


@pytest.fixture
def voices_dir(oracle, tmp_path, monkeypatch):
    """The oracle as ``en_US-lessac-medium.onnx`` with its sidecar (no
    phoneme map: the built-in ids fit its 40 symbols), for both packages."""
    from open_speech_tpu.models.onnx_io import write_onnx_initializers

    write_onnx_initializers(oracle.state_dict_numpy(), tmp_path / "en_US-lessac-medium.onnx")
    (tmp_path / "en_US-lessac-medium.onnx.json").write_text(json.dumps({
        "audio": {"sample_rate": 16000}, "inference": {"noise_scale": 0.5, "noise_w": 0.6, "length_scale": 1.1},
        "num_symbols": 40, "num_speakers": 3, "speaker_id_map": {"amy": 2}}))
    monkeypatch.setenv("OS_PIPER_VOICES_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("batcher", [False, True])
def test_backend_pcm_matches_the_jax_backend(voices_dir, monkeypatch, batcher):
    from open_speech_tpu.tts.backends.piper_jax import PiperBackend as JPiper
    from open_speech_tpu_torch.tts.backends.piper_torch import PiperBackend

    monkeypatch.setattr(TB, "_row_noise", _jax_row_noise)
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_tts_batcher_enabled", batcher)
    jbe, tbe = JPiper(device="cpu"), PiperBackend(device="cpu")
    try:
        want = list(jbe.synthesize(TEXT, VOICE + "#amy", speed=1.2))
        got = list(tbe.synthesize(TEXT, VOICE + "#amy", speed=1.2))
        assert [c.shape for c in got] == [c.shape for c in want] and len(got) == 2
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=TOL_AUDIO, rtol=0)
        assert tbe.get_sample_rate(VOICE) == jbe.get_sample_rate(VOICE) == 16000
        assert tbe._resolve_speaker(tbe._models[VOICE][2], tbe._models[VOICE][1], "amy") == 2
    finally:
        jbe.unload_model(VOICE)
        tbe.unload_model(VOICE)
    assert not tbe.is_model_loaded(VOICE)
    assert ("piper", id(tbe), VOICE) not in TB._batchers  # unload released the batcher


def test_backend_batcher_toggle_equivalence(monkeypatch):
    """A registry voice with random weights: the batcher on equals it off."""
    from open_speech_tpu_torch.tts.backends.piper_torch import PiperBackend

    be = PiperBackend(device="cpu")
    be._cfg = _port_cfg(dataclasses.replace(JCFG, max_phonemes=128, max_frames=512))
    be.load_model("piper/en_US-lessac-low")
    monkeypatch.setattr(torch_settings, "os_tts_batcher_enabled", False)
    off = np.concatenate(list(be.synthesize("Hello there.", "piper/en_US-lessac-low")))
    monkeypatch.setattr(torch_settings, "os_tts_batcher_enabled", True)
    on = np.concatenate(list(be.synthesize("Hello there.", "piper/en_US-lessac-low")))
    np.testing.assert_allclose(on, off, atol=3e-5, rtol=1e-4)
    assert be.get_sample_rate("piper/en_US-lessac-low") == 22050  # the running config's rate
    be.unload_model("piper/en_US-lessac-low")
    assert ("piper", id(be), "piper/en_US-lessac-low") not in TB._batchers


def test_backend_surface_matches_the_jax_backend():
    from open_speech_tpu.tts.backends import piper_jax as J
    from open_speech_tpu_torch.tts.backends import piper_torch as T

    assert T.PIPER_VOICES == J.PIPER_VOICES and T.DEFAULT_VOICE == J.DEFAULT_VOICE
    jbe, tbe = J.PiperBackend(device="cpu"), T.PiperBackend(device="cpu")
    assert [dataclasses.asdict(v) for v in tbe.list_voices()] == [dataclasses.asdict(v) for v in jbe.list_voices()]
    assert tbe.capabilities == jbe.capabilities and tbe.single_speaker and tbe.name == jbe.name
    for mid in ("piper", "", "en_US-amy-medium", "piper-en_US-amy-medium", "piper/en_GB-alan-low"):
        assert tbe._canonical(mid) == jbe._canonical(mid)
        assert tbe.get_sample_rate(mid) == jbe.get_sample_rate(mid)
    with pytest.raises(ValueError, match="Unknown piper voice"):
        tbe.load_model("piper/xx_XX-nobody-low")
    cfg = PiperConfig(n_speakers=4)
    assert tbe._resolve_speaker({"speaker_id_map": {"x": 6}}, cfg, "x") == 2
    assert tbe._resolve_speaker({}, cfg, "5") == 1 and tbe._resolve_speaker({}, PiperConfig(), "5") == 0
    with pytest.raises(ValueError, match="Unknown speaker"):
        tbe._resolve_speaker({}, cfg, "nobody")


# ── the router ──────────────────────────────────────────────────────────


def test_every_catalog_tts_id_resolves_as_the_jax_router_does():
    from open_speech_tpu.tts.router import TTSRouter as JRouter
    from open_speech_tpu_torch.runtime.registry import get_known_models
    from open_speech_tpu_torch.tts.router import NOT_PORTED, TTSRouter

    jr, tr = JRouter(device="cpu"), TTSRouter(device="cpu")
    ids = [m["id"] for m in get_known_models() if m["type"] == "tts"]
    assert "pocket-tts" in ids and "kokoro" in ids and sum(i.startswith("piper/") for i in ids) > 10
    refused = []
    for mid in ids + ["piper", "kokoro/v1", "pocket-tts/x", "nope"]:
        want = jr.get_backend(mid).name
        if want in NOT_PORTED:
            with pytest.raises(NotImplementedError, match=r"ROADMAP\.md module item 1$"):
                tr.get_backend(mid)
            refused.append(mid)
        else:
            assert tr.get_backend(mid).name == want, mid
    assert refused == ["pocket-tts", "pocket-tts/x"]


def test_router_gives_single_speaker_backends_the_model_id(monkeypatch):
    from open_speech_tpu_torch.tts.router import TTSRouter

    tr = TTSRouter(device="cpu")
    seen = []

    class Fake:
        name, sample_rate, single_speaker = "fake", 16000, True

        def synthesize(self, text, voice, speed=1.0, lang_code=None):
            seen.append(voice)
            return iter(())

        def load_model(self, model_id):
            pass

    tr.register_backend("fake", Fake())
    list(tr.synthesize("hi", "fake/voice-a", "ignored"))
    monkeypatch.setattr(Fake, "single_speaker", False)
    list(tr.synthesize("hi", "fake/voice-a", "kept"))
    assert seen == ["fake/voice-a", "kept"] and "fake" in tr.list_backends()
