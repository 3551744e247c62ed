"""Pocket TTS of the port (``open_speech_tpu_torch/models/pocket``, the
backend), held against the JAX package on the CPU.

One set of weights at the backend's tiny preset (``TEST_TINY_LM`` with
max_ctx 512, ``MIMI_TEST_TINY``; ``tests/torch_pocket_common.py``) is
carried over with ``pocket_params_from_jax``; the same numpy-seeded inputs
go through both packages:

- **The LM**, function by function: the RMS norm, RoPE (shared and
  per-row positions), the gated MLP, ``embed_step``, ``temporal_prefill``
  (per-row start), ``temporal_step`` (per-row positions),
  ``depformer_forward``, ``depformer_sample`` (greedy tokens equal JAX's)
  and ``lm_forward``, each within ``TOL``; a bucket-padded prefill leaves
  the caches an exact one leaves, and a row with length 0 keeps its cache
  bit for bit.
- **Mimi**: the causal conv (zero and edge padding, strides, dilation)
  and transposed conv (dense and depthwise), the SEANet encoder and
  decoder, the windowed transformer, the split RVQ, ``mimi_encode`` (codes
  equal wherever the RVQ distance margin exceeds ``RVQ_MARGIN``: every code
  here) and ``mimi_decode``; the streamed decode equals the whole one past
  the transformer's window (``t_context=6``, eviction), per-row resets
  included (the port's ``MimiStreamingDecoder`` against JAX's is held in
  the generation test, where both models decode their frames with it).
- **The converters** on ``tests/pocket_oracle.py``'s state dicts: the
  port's trees equal ``pocket_params_from_jax`` of JAX's converter bit for
  bit, from ``.safetensors`` (float32 and bf16) and ``.pt`` files, and a
  release directory with ``config.json`` loads the same model in both.
- **Generation**: ``generate_stream``'s frames (the tokens fed to the
  decoder) equal JAX's exactly, with and without a cloned voice; the PCM
  within ``TOL_PCM``; an exhausted context yields nothing in both.
- **The backend**: capabilities, voices and the synthetic prompts' bytes
  equal JAX's; the LRU prompt cache; a cached ``PromptState`` is unchanged
  after two sequential and two concurrent requests on its voice.

The JAX side runs eagerly here, but for Mimi's stages and the models'
own jitted steps.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import open_speech_tpu.models.pocket.convert as JC
import open_speech_tpu.models.pocket.lm as JL
import open_speech_tpu.models.pocket.mimi as JMi
import open_speech_tpu.models.pocket.model as JMo
import open_speech_tpu_torch.models.pocket.convert as TC
import open_speech_tpu_torch.models.pocket.lm as TL
import open_speech_tpu_torch.models.pocket.mimi as TMi
import open_speech_tpu_torch.models.pocket.model as TMo
from open_speech_tpu_torch.models.pocket import pocket_params_from_jax

from tests.torch_pocket_common import JLM, JMC, TLM, TMC, jax_trees, models, one_thread

TOL = 1e-5  # every float tensor of the LM and of Mimi's stages, max abs
TOL_PCM = 2e-5  # decoded audio, max abs (|pcm| < 1 here)
RVQ_MARGIN = 1e-4  # codes must agree where the nearest two codewords are this far apart

_one_thread = pytest.fixture(scope="module", autouse=True)(one_thread)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX PocketTTS, port PocketTTS) on one set of weights."""
    return models()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


# ── the LM ──────────────────────────────────────────────────────────────


def test_norm_rope_mlp_and_embedding_match_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, JLM.d_model)).astype(np.float32)
    p0 = jax.tree.map(lambda a: a[0], jm.lm_params["layers"])
    tp0 = TL._at(tm.lm_params["layers"], 0)
    _close(TL._rms(_t(x), tp0["ln1"]), JL._rms(jnp.asarray(x), p0["ln1"]), what="rms")
    _close(TL._gated_mlp(_t(x), tp0), JL._gated_mlp(jnp.asarray(x), p0), what="gated mlp")
    q = rng.standard_normal((3, 2, 5, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 5, 16)).astype(np.float32)
    shared = np.arange(5) + 7
    rows = np.stack([np.arange(5) + s for s in (0, 100, 511)])
    for pos in (shared, rows):
        tq, tk = TL._rope(_t(q), _t(k), _t(pos), 16)
        jq, jk = JL._rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 16)
        _close(tq, jq, what="rope q")
        _close(tk, jk, what="rope k")
    text = rng.integers(0, JLM.text_card + 1, 3)
    audio = rng.integers(0, JLM.card + 1, (3, JLM.n_q))
    _close(TL.embed_step(tm.lm_params, TLM, _t(text), _t(audio)),
           JL.embed_step(jm.lm_params, JLM, jnp.asarray(text), jnp.asarray(audio)), what="embed_step")


def _prefill_inputs(rng, b, t):
    return rng.standard_normal((b, t, JLM.d_model)).astype(np.float32)


def _warm_caches(rng, b):
    """Caches holding a random prompt of 20 positions per row."""
    shape = (JLM.n_layers, b, JLM.n_heads, JLM.max_ctx, JLM.head_dim)
    k = np.zeros(shape, np.float32)
    v = np.zeros(shape, np.float32)
    k[:, :, :, :20] = rng.standard_normal(k[:, :, :, :20].shape)
    v[:, :, :, :20] = rng.standard_normal(v[:, :, :, :20].shape)
    return k, v


def test_temporal_prefill_and_step_match_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(1)
    x = _prefill_inputs(rng, 2, 9)
    k, v = _warm_caches(rng, 2)
    start = np.array([20, 13])
    jh, (jk, jv) = JL.temporal_prefill(jm.lm_params, JLM, jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v)),
                                       jnp.asarray(start, jnp.int32))
    with torch.inference_mode():
        th, (tk, tv) = TL.temporal_prefill(tm.lm_params, TLM, _t(x), (_t(k), _t(v)), _t(start))
    _close(th, jh, what="prefill hidden")
    _close(tk, jk, what="prefill k cache")
    _close(tv, jv, what="prefill v cache")
    # one step per row at its own position, on the prefilled caches
    xs = rng.standard_normal((2, JLM.d_model)).astype(np.float32)
    pos = start + 9
    jh, (jk2, jv2) = JL.temporal_step(jm.lm_params, JLM, jnp.asarray(xs), (jk, jv), jnp.asarray(pos, jnp.int32))
    with torch.inference_mode():
        th, (tk2, tv2) = TL.temporal_step(tm.lm_params, TLM, _t(xs), (tk, tv), _t(pos))
    _close(th, jh, what="step hidden")
    _close(tk2, jk2, what="step k cache")
    _close(tv2, jv2, what="step v cache")


def test_padded_prefill_equals_exact_and_length_zero_rows_keep_their_cache(pair):
    """Row 0 prefills 5 valid steps of a 16-step bucket, row 1 has length 0.
    The caches equal an exact 5-step prefill of row 0 (and JAX's padded
    prefill); row 1's cache is untouched, bit for bit."""
    jm, tm = pair
    rng = np.random.default_rng(2)
    x = _prefill_inputs(rng, 2, 16)
    k, v = _warm_caches(rng, 2)
    start, length = np.array([20, 7]), np.array([5, 0])
    with torch.inference_mode():
        tk, tv = _t(k), _t(v)
        TL.temporal_prefill(tm.lm_params, TLM, _t(x), (tk, tv), _t(start), length=_t(length))
        ek, ev = _t(k[:, :1]), _t(v[:, :1])
        eh, _ = TL.temporal_prefill(tm.lm_params, TLM, _t(x[:1, :5]), (ek, ev), 20)
    _close(tk[:, :1], ek, tol=1e-6, what="padded vs exact k")
    _close(tv[:, :1], ev, tol=1e-6, what="padded vs exact v")
    assert torch.equal(tk[:, 1], _t(k[:, 1])) and torch.equal(tv[:, 1], _t(v[:, 1]))
    _, (jk, jv) = JL.temporal_prefill(jm.lm_params, JLM, jnp.asarray(x), (jnp.asarray(k), jnp.asarray(v)),
                                      jnp.asarray(start, jnp.int32), length=jnp.asarray(length, jnp.int32))
    _close(tk, jk, what="padded k vs JAX")
    _close(tv, jv, what="padded v vs JAX")


def test_depformer_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(3)
    h = rng.standard_normal((4, JLM.d_model)).astype(np.float32)
    text = rng.integers(0, JLM.text_card + 1, 4)
    audio = rng.integers(0, JLM.card, (4, JLM.n_q))
    with torch.inference_mode():
        tl = TL.depformer_forward(tm.lm_params, TLM, _t(h), _t(text), _t(audio))
        logits: list = []
        toks = TL.depformer_sample(tm.lm_params, TLM, _t(h), _t(text), logits_out=logits)
    _close(tl, JL.depformer_forward(jm.lm_params, JLM, jnp.asarray(h), jnp.asarray(text), jnp.asarray(audio)),
           what="depformer_forward")
    jt = JL.depformer_sample(jm.lm_params, JLM, jnp.asarray(h), jnp.asarray(text), jax.random.PRNGKey(0),
                             jnp.float32(0.0))
    margin = min(float(torch.topk(lg, 2).values.diff(dim=-1).abs().min()) for lg in logits)
    assert margin > 1e-4, f"a greedy decision within {margin:.2e} of a tie"
    assert np.array_equal(toks.numpy(), np.asarray(jt))
    # the incremental stages equal the teacher-forced pass on their own tokens
    with torch.inference_mode():
        forced = TL.depformer_forward(tm.lm_params, TLM, _t(h), _t(text), toks)
    _close(torch.stack(logits, 1), forced, what="incremental vs teacher-forced")
    # sampled: a torch.Generator makes it deterministic; tokens in range
    with torch.inference_mode():
        a, b = (TL.depformer_sample(tm.lm_params, TLM, _t(h), _t(text), 1.0, torch.Generator().manual_seed(5))
                for _ in range(2))
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < JLM.card


def test_lm_forward_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(4)
    text = rng.integers(0, JLM.text_card, (2, 11))
    audio = rng.integers(0, JLM.card + 1, (2, JLM.n_q, 11))
    jt, ja, (jk, _) = JL.lm_forward(jm.lm_params, JLM, jnp.asarray(text, jnp.int32), jnp.asarray(audio, jnp.int32))
    with torch.inference_mode():
        tt, ta, (tk, _) = TL.lm_forward(tm.lm_params, TLM, _t(text), _t(audio))
    _close(tt, jt, what="text logits")
    _close(ta, ja, what="audio logits")
    _close(tk, jk, what="caches")


# ── Mimi ────────────────────────────────────────────────────────────────


def _btc(x):  # port [B, C, T] -> JAX [B, T, C]
    return x.transpose(1, 2)


@pytest.mark.parametrize("stride,dilation,mode", [(1, 1, "constant"), (1, 3, "constant"), (4, 1, "constant"),
                                                  (2, 1, "edge")])
def test_causal_conv_matches_jax(stride, dilation, mode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 23, 6)).astype(np.float32)
    p = {"w": rng.standard_normal((2 * stride if stride > 1 else 3, 6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    want = JMi.causal_conv(jnp.asarray(x), jax.tree.map(jnp.asarray, p), stride, dilation, mode)
    tp = TC._jax_conv(p)
    got = TMi.causal_conv(_t(x).transpose(1, 2), {k: _t(v) for k, v in tp.items()}, stride, dilation, mode)
    _close(_btc(got), want, what="causal_conv")


@pytest.mark.parametrize("depthwise", [False, True])
def test_causal_convtr_matches_jax(depthwise):
    rng = np.random.default_rng(6)
    c_in, c_out, k, stride = (6, 6, 4, 2) if depthwise else (6, 3, 8, 4)
    x = rng.standard_normal((2, 9, c_in)).astype(np.float32)
    p = {"w": rng.standard_normal((k, 1 if depthwise else c_in, c_out)).astype(np.float32),
         "b": rng.standard_normal(c_out).astype(np.float32)}
    want = JMi.causal_convtr(jnp.asarray(x), jax.tree.map(jnp.asarray, p), stride)
    tp = TC._jax_convtr(p)
    got = TMi.causal_convtr(_t(x).transpose(1, 2), {k: _t(v) for k, v in tp.items()}, stride)
    _close(_btc(got), want, what="causal_convtr")


def test_mimi_stages_match_jax(pair):
    jm, tm = pair
    jp, tp = jm.mimi_params, tm.mimi_params
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal((2, JMC.samples_per_frame * 9)) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, 13, JMC.dimension)).astype(np.float32)
    q = rng.standard_normal((2, 7, JMC.dimension)).astype(np.float32)
    jit = functools.partial(jax.jit, static_argnums=1)
    with torch.inference_mode():
        lat = TMi.seanet_encode(tp["encoder"], TMC, _t(pcm))
        got = TMi.mimi_transformer(tp["enc_t"], TMC, _t(x))
        dec = TMi.seanet_decode(tp["decoder"], TMC, _t(x).transpose(1, 2))
        codes = TMi._rvq_encode(tp["quantizer"]["rest"], _t(q), JMC.n_q - 1)
        latent = TMi._rvq_decode(tp["quantizer"]["rest"], codes)
    _close(_btc(lat), jit(JMi.seanet_encode)(jp["encoder"], JMC, jnp.asarray(pcm)), what="seanet encode")
    _close(got, jit(JMi.mimi_transformer)(jp["enc_t"], JMC, jnp.asarray(x)), what="transformer")
    _close(dec, jit(JMi.seanet_decode)(jp["decoder"], JMC, jnp.asarray(x)), what="seanet decode")
    jcodes = jax.jit(JMi._rvq_encode, static_argnums=2)(jp["quantizer"]["rest"], jnp.asarray(q), JMC.n_q - 1)
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    _close(latent, jax.jit(JMi._rvq_decode)(jp["quantizer"]["rest"], jnp.asarray(codes.numpy())),
           what="rvq decode")


def test_mimi_encode_and_decode_match_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(8)
    pcm = (rng.standard_normal((1, JMC.samples_per_frame * 17)) * 0.2).astype(np.float32)
    margins: list = []
    with torch.inference_mode():
        codes = TMi.mimi_encode(tm.mimi_params, TMC, _t(pcm), margins)
    jcodes = np.asarray(JMi.mimi_encode(jm.mimi_params, JMC, jnp.asarray(pcm)))
    margin = torch.stack([m[0] for m in margins])  # [n_q, F]
    decided = (margin > RVQ_MARGIN).numpy()
    assert codes.shape == jcodes.shape and decided.all(), float(margin.min())
    assert np.array_equal(codes.numpy()[0][decided], jcodes[0][decided])
    toks = rng.integers(0, JMC.card, (2, JMC.n_q, 11))
    with torch.inference_mode():
        got = TMi.mimi_decode(tm.mimi_params, TMC, _t(toks))
    _close(got, JMi.mimi_decode(jm.mimi_params, JMC, jnp.asarray(toks)), TOL_PCM, "mimi_decode")


def test_streamed_decode_equals_whole_past_the_window(pair):
    """t_context=6: the K/V window evicts; batch 2, blocks of 4 fed in
    pieces of 7, against the port's and JAX's whole decode."""
    jm, tm = pair
    cfg_j = dataclasses.replace(JMC, t_context=6)
    cfg_t = dataclasses.replace(TMC, t_context=6)
    jp, tp = jm.mimi_params, tm.mimi_params
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg_j.card, (2, cfg_j.n_q, 29))
    with torch.inference_mode():
        whole = TMi.mimi_decode(tp, cfg_t, _t(toks)).numpy()
    _close(whole, JMi.mimi_decode(jp, cfg_j, jnp.asarray(toks, jnp.int32)), TOL_PCM, "whole vs JAX")
    dec = TMi.MimiStreamingDecoder(tp, cfg_t, block_frames=4)
    stream = np.concatenate([dec.feed(toks[:, :, i: i + 7]) for i in range(0, 29, 7)], axis=1)
    _close(stream, whole, 1e-5, "streamed vs whole")
    # a reset row restarts its stream; the other row keeps its own
    with torch.inference_mode():
        state = TMi.init_mimi_stream_state(tp, cfg_t, batch=2)
        first, state = TMi.mimi_decode_step(tp, cfg_t, _t(toks[:, :, :4]), state)
        state = TMi.zero_mimi_stream_rows(state, torch.tensor([True, False]))
        again, _ = TMi.mimi_decode_step(tp, cfg_t, _t(toks[:, :, 4:8]), state)
        fresh, _ = TMi.mimi_decode_step(tp, cfg_t, _t(toks[:1, :, 4:8]),
                                        TMi.init_mimi_stream_state(tp, cfg_t, batch=1))
    _close(again[0], fresh[0], 1e-6, "reset row vs a fresh stream")
    _close(again[1], whole[1, 4 * cfg_t.samples_per_frame: 8 * cfg_t.samples_per_frame], 1e-5, "kept row")


# ── the converters ──────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def oracle_states():
    from tests.pocket_oracle import OracleLM, hf_mimi_to_moshi_state, oracle_lm_state_dict, tiny_hf_mimi
    from tests.test_pocket_convert import ORACLE_LM_CFG

    torch.manual_seed(7)
    return hf_mimi_to_moshi_state(tiny_hf_mimi()), oracle_lm_state_dict(OracleLM(ORACLE_LM_CFG).eval())


def _same_tree(got: TL.ParamTree, want: TL.ParamTree):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_converters_equal_the_jax_converters(oracle_states):
    mimi_state, lm_state = oracle_states
    jmimi, jcfg = JC.convert_mimi(mimi_state)
    tmimi, tcfg = TC.convert_mimi(mimi_state, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jlm, jlcfg = JC.convert_pocket_lm(lm_state, n_heads=2, dep_heads=2)
    tlm, tlcfg = TC.convert_pocket_lm(lm_state, n_heads=2, dep_heads=2, device="cpu")
    assert dataclasses.asdict(tlcfg) == dataclasses.asdict(jlcfg)
    assert dataclasses.asdict(TC.lm_config_from_state_dict(lm_state, warn_on_guess=False)) == \
        dataclasses.asdict(JC.lm_config_from_state_dict(lm_state, warn_on_guess=False))
    want_lm, want_mimi = pocket_params_from_jax(_np_tree(jlm), _np_tree(jmimi), device="cpu")
    _same_tree(tlm, want_lm)
    _same_tree(tmimi, want_mimi)


def _save_release(folder, mimi_state, lm_state, *, bf16=False, pt=False, config=None):
    import json

    from safetensors.torch import save_file

    def tensors(state):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}
        return {k: v.to(torch.bfloat16) if bf16 and v.is_floating_point() else v for k, v in out.items()}

    folder.mkdir()
    save_file(tensors(mimi_state), str(folder / "mimi-tiny.safetensors"))
    if pt:
        torch.save({"model": tensors(lm_state)}, str(folder / "model.pt"))
    else:
        save_file(tensors(lm_state), str(folder / "model.safetensors"))
    if config is not None:
        (folder / "config.json").write_text(json.dumps(config))
    return folder


@pytest.mark.parametrize("kind", ["safetensors", "bf16", "pt-bf16"])
def test_read_state_and_load_checkpoint_equal_jax(tmp_path, oracle_states, kind):
    """Both loaders on one release directory: the same state (bf16 widened
    to float32 exactly), configs, trees and greedy audio."""
    mimi_state, lm_state = oracle_states
    config = {"num_heads": 2, "depformer_num_heads": 2, "context": 96, "delays": [0, 1, 1, 1],
              "existing_text_padding_id": 3}
    folder = _save_release(tmp_path / kind, mimi_state, lm_state, bf16=kind != "safetensors",
                           pt=kind == "pt-bf16", config=config)
    lm_file = folder / ("model.pt" if kind == "pt-bf16" else "model.safetensors")
    got, want = TC._read_state(lm_file), JC._read_state(lm_file)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == np.float32 and np.array_equal(got[key], np.asarray(want[key], np.float32)), key
    jm, tm = JC.load_checkpoint(folder), TC.load_checkpoint(folder, device="cpu")
    assert dataclasses.asdict(tm.lm_cfg) == dataclasses.asdict(jm.lm_cfg)
    assert tm.lm_cfg.max_ctx == 96 and tm.lm_cfg.acoustic_delay == 1 and tm.lm_cfg.text_pad_id == 3
    want_lm, want_mimi = pocket_params_from_jax(_np_tree(jm.lm_params), _np_tree(jm.mimi_params), device="cpu")
    _same_tree(tm.lm_params, want_lm)
    _same_tree(tm.mimi_params, want_mimi)


def test_weights_default_to_the_card(tmp_path, oracle_states, monkeypatch):
    """The inits, the converters, the loader and the JAX carry-over make
    their weights on ``tts_effective_device`` (``cuda``) unless the caller
    names a device: on a host without CUDA each raises, none falls back to
    the CPU."""
    from open_speech_tpu_torch.config import settings

    monkeypatch.setattr(settings, "stt_device", "cuda")
    monkeypatch.setattr(settings, "tts_device", None)
    mimi_state, lm_state = oracle_states
    folder = _save_release(tmp_path / "release", mimi_state, lm_state,
                           config={"num_heads": 2, "depformer_num_heads": 2})
    lm_tree, mimi_tree = jax_trees()
    calls = {
        "init_pocket_lm_params": lambda **kw: TL.init_pocket_lm_params(torch.Generator().manual_seed(0), TLM, **kw),
        "init_mimi_params": lambda **kw: TMi.init_mimi_params(torch.Generator().manual_seed(0), TMC, **kw),
        "convert_mimi": lambda **kw: TC.convert_mimi(mimi_state, **kw)[0],
        "convert_pocket_lm": lambda **kw: TC.convert_pocket_lm(lm_state, n_heads=2, dep_heads=2, **kw)[0],
        "load_checkpoint": lambda **kw: TC.load_checkpoint(folder, **kw).lm_params,
        "pocket_params_from_jax": lambda **kw: pocket_params_from_jax(lm_tree, mimi_tree, **kw)[1],
        "random_init": lambda **kw: TMo.PocketTTS.random_init(torch.Generator().manual_seed(0), **kw).mimi_params,
    }
    for name, call in calls.items():
        assert call(device="cpu").device.type == "cpu", name
        if torch.cuda.is_available():
            continue
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()


# ── generation ──────────────────────────────────────────────────────────


class _Frames:
    """A ``MimiStreamingDecoder`` stand-in's log: the frames each decoder
    of one package was fed."""

    def __init__(self, monkeypatch, module):
        log = self.frames = []
        real = module.MimiStreamingDecoder

        class Logged(real):
            def feed(self, tokens):
                log.append(np.asarray(tokens).copy())
                return super().feed(tokens)

        monkeypatch.setattr(module, "MimiStreamingDecoder", Logged)

    @property
    def all(self) -> np.ndarray:
        return np.concatenate(self.frames, axis=2)


@pytest.mark.parametrize("voice", [None, "cloned"])
def test_generate_stream_tokens_equal_jax(pair, monkeypatch, voice):
    jm, tm = pair
    if voice:
        pcm = np.sin(np.linspace(0, 80.0, 5 * JMC.samples_per_frame)).astype(np.float32)
        jstate, tstate = jm.state_for_audio_prompt(pcm), tm.state_for_audio_prompt(pcm)
        assert tstate.length == jstate.length
        _close(tstate.k_cache, jstate.k_cache, what="prompt k cache")
    else:
        jstate = tstate = None
    jf, tf = _Frames(monkeypatch, JMo), _Frames(monkeypatch, TMo)
    text = "the quick brown fox"
    want = np.concatenate(list(jm.generate_stream(text, jstate, max_frames=9)))
    got = np.concatenate(list(tm.generate_stream(text, tstate, max_frames=9)))
    assert [f.shape for f in tf.frames] == [f.shape for f in jf.frames] and tf.all.shape[2] == 9
    assert np.array_equal(tf.all, jf.all)
    _close(got, want, TOL_PCM, "pcm")


def test_exhausted_context_yields_nothing_in_both(pair):
    jm, tm = pair
    jfull = JMo.PromptState(*JL.init_caches(JLM, 1), length=JLM.max_ctx - 2)
    tfull = TMo.PromptState(*TL.init_caches(TLM, 1), length=TLM.max_ctx - 2)
    assert jm.generate("hello there", jfull).shape == (0,) == tm.generate("hello there", tfull).shape


# ── the backend ─────────────────────────────────────────────────────────


def test_backend_surface_equals_jax():
    from open_speech_tpu.tts.backends import pocket_tts as JP
    from open_speech_tpu_torch.tts.backends import pocket_tts as TP

    jb, tb = JP.PocketTTSBackend(device="cpu"), TP.PocketTTSBackend(device="cpu")
    assert tb.capabilities == jb.capabilities and TP.SPEAKERS == JP.SPEAKERS
    assert [v.__dict__ for v in tb.list_voices()] == [v.__dict__ for v in jb.list_voices()]
    for seed_text in TP.SPEAKERS + ["deep calm voice", ""]:
        for rate in (24000, 16000):
            assert TP._synthetic_prompt(seed_text, rate).tobytes() == JP._synthetic_prompt(seed_text, rate).tobytes()
    assert TP.preset_configs("base") == (TL.PocketLMConfig(), TMi.MimiConfig())
    lm_cfg, mimi_cfg = TP.preset_configs("tiny")
    assert dataclasses.asdict(lm_cfg) == dataclasses.asdict(JLM) and mimi_cfg == TMC


def _backend(tm):
    from open_speech_tpu_torch.tts.backends.pocket_tts import PocketTTSBackend

    b = PocketTTSBackend(device="cpu")
    b._model = tm
    return b


def test_backend_prompt_cache_is_lru_and_never_written(pair, monkeypatch):
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.tts.backends import pocket_tts as TP

    monkeypatch.setattr(settings, "os_tts_batcher_enabled", False)
    _, tm = pair
    b = _backend(tm)
    first = np.concatenate(list(b.synthesize("one voice", "pocket/alice")))
    state = b._prompt_cache["alice"]
    k0, v0 = state.k_cache.clone(), state.v_cache.clone()
    again = np.concatenate(list(b.synthesize("one voice", "pocket/alice")))
    assert np.array_equal(first, again)
    out: list = [None, None]

    def run(i):
        out[i] = np.concatenate(list(b.synthesize("one voice", "pocket/alice")))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert all(np.array_equal(o, first) for o in out)
    assert b._prompt_cache["alice"] is state
    assert torch.equal(state.k_cache, k0) and torch.equal(state.v_cache, v0)
    # LRU: a hit moves alice to the back, so a full cache evicts bob first
    monkeypatch.setattr(TP, "_PROMPT_CACHE_MAX", 3)
    for name in ("bob", "carol"):
        b._speaker_state(name)
    b._speaker_state("alice")
    b._speaker_state("dave")
    assert list(b._prompt_cache) == ["carol", "alice", "dave"]
