"""Whisper model: the PyTorch port against the JAX package on test-tiny.

``params_from_jax_tree`` carries the JAX pytree of
``init_params(PRNGKey(0), PRESETS["test-tiny"], float32)`` into the port's
modules, so both sides run the same weights on the same numpy-seeded
inputs. float32 on the CPU; tolerance 1e-4 absolute (logits and states are
O(1)-O(10); the two sides sum products in different orders).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.models.whisper import convert as JC
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu_torch.models.whisper import convert as TC
from open_speech_tpu_torch.models.whisper import model as TM

TOL = 1e-4
FIXTURES = Path(__file__).parent / "fixtures"
CFG = JM.PRESETS["test-tiny"]
TCFG = TM.PRESETS["test-tiny"]


@pytest.fixture(scope="module")
def pair():
    params = JM.init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    model = TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG)
    return params, model


@pytest.fixture(scope="module")
def enc(pair):
    params, _ = pair
    mel = np.random.default_rng(0).standard_normal((2, CFG.n_mels, 2 * CFG.n_audio_ctx))
    return np.array(JM.encode(params, jnp.asarray(mel, jnp.float32), CFG))


def test_config_and_presets_are_a_copy():
    assert {k: tuple(vars(v).values()) for k, v in TM.PRESETS.items()} == {
        k: tuple(vars(v).values()) for k, v in JM.PRESETS.items()
    }
    np.testing.assert_array_equal(TM.sinusoids(60, 64), JM.sinusoids(60, 64))


def test_encode_matches_jax(pair, enc):
    params, model = pair
    mel = np.random.default_rng(0).standard_normal((2, CFG.n_mels, 2 * CFG.n_audio_ctx))
    out = TM.encode(model, torch.from_numpy(mel.astype(np.float32)), TCFG).numpy()
    assert out.shape == (2, CFG.n_audio_ctx, CFG.n_audio_state)
    np.testing.assert_allclose(out, enc, atol=TOL, rtol=0)


def test_decoder_forward_and_cross_kv_match_jax(pair, enc):
    params, model = pair
    tokens = np.random.default_rng(1).integers(0, CFG.n_vocab, (2, 7)).astype(np.int32)
    ref = np.asarray(JM.decoder_forward(params, jnp.asarray(tokens), jnp.asarray(enc), CFG))
    out = TM.decoder_forward(
        model, torch.from_numpy(tokens).long(), torch.from_numpy(enc), TCFG
    ).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    ckv_ref = np.asarray(JM.precompute_cross_kv(params, jnp.asarray(enc), CFG))
    ckv = TM.precompute_cross_kv(model, torch.from_numpy(enc), TCFG).numpy()
    assert ckv.shape == ckv_ref.shape  # [L, 2, B, H, T_enc, Dh]
    np.testing.assert_allclose(ckv, ckv_ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("beam,ancestry", [(1, False), (3, False), (3, True)])
def test_decode_step_matches_jax(pair, enc, beam, ancestry):
    params, model = pair
    rng = np.random.default_rng(beam + ancestry)
    b, t_max, pos = 2, 16, 5
    tokens = rng.integers(0, CFG.n_vocab, (b * beam, 1)).astype(np.int32)
    dh = CFG.n_text_state // CFG.n_text_head
    kv = rng.standard_normal(
        (CFG.n_text_layer, 2, b * beam, CFG.n_text_head, t_max, dh)
    ).astype(np.float32)
    row_map = None
    if ancestry:
        row_map = (
            np.repeat(np.arange(b) * beam, beam)[:, None]
            + rng.integers(0, beam, (b * beam, t_max))
        ).astype(np.int32)
    ckv_j = JM.precompute_cross_kv(params, jnp.asarray(enc), CFG)
    logits_j, kv_j = JM.decode_step(
        params, jnp.asarray(tokens), jnp.int32(pos), jnp.asarray(kv), ckv_j, CFG,
        beam=beam, row_map=None if row_map is None else jnp.asarray(row_map),
    )
    kv_t = torch.from_numpy(kv.copy())
    logits_t, kv_out = TM.decode_step(
        model, torch.from_numpy(tokens).long(), pos, kv_t,
        TM.precompute_cross_kv(model, torch.from_numpy(enc), TCFG), TCFG,
        beam=beam, row_map=None if row_map is None else torch.from_numpy(row_map).long(),
    )
    assert kv_out is kv_t  # written in place
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(kv_out.numpy(), np.asarray(kv_j), atol=TOL, rtol=0)


def test_cross_attend_beam_needs_one_query():
    ckv = torch.zeros(2, 1, 2, 5, 32)
    with pytest.raises(ValueError, match="q_len 1"):
        TM.cross_attend(torch.zeros(3, 2, 2, 32), ckv, 1, beam=3)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-eot"])
def test_safetensors_reader_and_checkpoint_load_match(name):
    from safetensors.numpy import load_file

    path = FIXTURES / name / "model.safetensors"
    ours, ref = TC.load_safetensors(str(path)), load_file(str(path))
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype and ours[key].shape == ref[key].shape
        np.testing.assert_array_equal(ours[key], ref[key])
    # the whole HF-layout conversion: same encoder states as the JAX loader
    params, cfg = JC.load_params(str(FIXTURES / name), dtype=jnp.float32)
    model, tcfg = TC.load_params(str(FIXTURES / name), dtype=torch.float32)
    assert tuple(vars(tcfg).values()) == tuple(vars(cfg).values())
    mel = np.random.default_rng(2).standard_normal((1, cfg.n_mels, 2 * cfg.n_audio_ctx))
    np.testing.assert_allclose(
        TM.encode(model, torch.from_numpy(mel.astype(np.float32)), tcfg).numpy(),
        np.asarray(JM.encode(params, jnp.asarray(mel, jnp.float32), cfg)),
        atol=TOL, rtol=0,
    )


def test_random_init_is_seeded_and_shaped():
    gen = torch.Generator().manual_seed(0)
    a = TM.init_params(gen, TCFG)
    b = TM.init_params(torch.Generator().manual_seed(0), TCFG)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    bf = TM.init_params(torch.Generator().manual_seed(0), TCFG, torch.bfloat16)
    assert bf.decoder.tok_emb.dtype == torch.bfloat16
    assert bf.encoder.ln_post.weight.dtype == torch.float32  # layer norms stay f32
    assert torch.equal(bf.encoder.pos.float(), torch.from_numpy(TM.sinusoids(60, 64)).bfloat16().float())
