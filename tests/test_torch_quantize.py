"""int8 compute (``STT_COMPUTE_TYPE=int8``): the PyTorch port against the JAX
package, on the CPU.

Packs: ``quantize_tensor`` and every pack of ``quantize_whisper_params``
equal JAX's bit for bit (q and s), from float32 and bf16 weights, half
steps and an all-zero channel included. The JAX package makes its packs
under jit, so the oracle is ``quantize_tensor`` under ``jax.jit``.

Compute on the same packs (JAX's carried across with
``params_from_jax_tree``): at a float32 base, encoder states, teacher-forced
logits and ``decode_step`` logits within 1e-4 absolute of JAX run op by op
(O(1)-O(10) values; summation order differs) and within 2e-2 of jitted JAX
(XLA's excess precision skips the bf16 rounding of the embedding product),
the int8 cross-KV scales within 1e-5 relative and its codes within one step
(a K/V value on a half step may round either way); at the backend's bf16
base, within 5e-2 absolute (bf16 keeps 8 bits; every linear rounds its
product).

Served paths at int8 (bf16 base) on the trained fixture
``tests/fixtures/test-tiny-eot``: greedy and beam-5 tokens through the
backends, batched long-form, and a streaming session's events (incremental
encoder on, and through the continuous batcher, whose cross pool stays
dense) must equal JAX's.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_streaming as S
import torch

from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.models.whisper import batched as JBd
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu.models.whisper import quantize as JQ
from open_speech_tpu.models.whisper.tokenizer import get_tokenizer as jax_tokenizer
from open_speech_tpu.models.whisper.transcribe import TranscribeOptions as JaxOptions
from open_speech_tpu.ops import attention as JA
from open_speech_tpu.ops import audio as jcodec
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.whisper import batched as TBd
from open_speech_tpu_torch.models.whisper import convert as TC
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.models.whisper import quantize as TQ
from open_speech_tpu_torch.models.whisper.tokenizer import get_tokenizer as torch_tokenizer
from open_speech_tpu_torch.models.whisper.transcribe import TranscribeOptions
from open_speech_tpu_torch.ops import attention as TA

TOL_F32 = 1e-4
TOL_EXCESS = 2e-2
TOL_BF16 = 5e-2
CFG = JM.PRESETS["test-tiny"]
TCFG = TM.PRESETS["test-tiny"]
FIXTURE = Path(__file__).parent / "fixtures" / "test-tiny-eot"
SR = 16000
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_jax_quantize = jax.jit(JQ.quantize_tensor, static_argnames="axis")
_LINEARS = [("attn", p) for p in "qkvo"] + [("cross", p) for p in "qkvo"] + [
    ("mlp_in", None), ("mlp_out", None)]


# ── the packs ──────────────────────────────────────────────────────────


def _weights(dtype: str) -> np.ndarray:
    """[96, 64] seeded weights: rows 0-3 hold values on exact half steps of
    their scale, row 5 is all zeros (the 1e-8 floor)."""
    w = np.random.default_rng(0).standard_normal((96, 64)).astype(np.float32) * 0.05
    jdt = DTYPES[dtype][0]
    amax = np.float32(127 / 128)  # exactly representable in bf16
    for r in range(4):
        w[r, 0] = amax
        scale = np.float32(amax * np.float32(TQ._INV_127))
        w[r, 1:12] = (np.arange(11) + 0.5 + 7 * r) * scale * (-1) ** r
    w[5] = 0.0
    return np.array(jnp.asarray(w, jdt).astype(jnp.float32))


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_tensor_matches_jax(dtype, axis):
    jdt, tdt = DTYPES[dtype]
    w = _weights(dtype)
    if axis == -2:
        w = np.ascontiguousarray(w.T)
    want = _jax_quantize(jnp.asarray(w, jdt), axis=axis)
    got = TQ.quantize_tensor(torch.from_numpy(w).to(tdt), axis=axis)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    ratio = w / got["s"].numpy()
    assert (np.abs(ratio - np.round(ratio)) == 0.5).sum() >= 8, "no half steps to round"
    zero = got["s"].numpy().reshape(-1)[5] if axis == -1 else got["s"].numpy()[0, 5]
    assert zero == np.float32(1e-8)
    deq = TQ.dequantize(got)
    assert deq.dtype == torch.bfloat16 and deq.shape == w.shape


@pytest.fixture(scope="module", params=list(DTYPES))
def packed(request):
    """(dtype, JAX dense params, JAX packs, the port's model quantized by itself)."""
    jdt, tdt = DTYPES[request.param]
    params = JM.init_params(jax.random.PRNGKey(0), CFG, jdt)
    qparams = JQ.quantize_whisper_params(params)
    model = TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG, tdt)
    nbytes = TQ.model_nbytes(model)
    TQ.quantize_whisper_params(model)
    return request.param, params, qparams, model, nbytes


def test_quantize_whisper_params_equals_jax_packs(packed):
    dtype, params, qparams, model, nbytes = packed
    for side in ("encoder", "decoder"):
        jblocks = qparams[side]["blocks"]
        for i, blk in enumerate(getattr(model, side).blocks):
            for name, proj in _LINEARS:
                if name == "cross" and side == "encoder":
                    continue
                lin = getattr(blk, name) if proj is None else getattr(getattr(blk, name), proj)
                jp = jblocks[name] if proj is None else jblocks[name][proj]
                assert isinstance(lin, TM.QuantLinear) and TQ.is_quantized(lin)
                np.testing.assert_array_equal(lin.q.numpy(), np.asarray(jp["w"]["q"][i]).T)
                np.testing.assert_array_equal(lin.s.numpy(), np.asarray(jp["w"]["s"][i])[0])
                if "b" in jp:
                    np.testing.assert_array_equal(
                        lin.bias.float().numpy(), np.asarray(jp["b"][i], np.float32))
                else:
                    assert lin.bias is None
    emb = model.decoder.tok_emb
    assert isinstance(emb, TM.QuantEmbedding)
    np.testing.assert_array_equal(emb.q.numpy(), np.asarray(qparams["decoder"]["tok_emb"]["q"]))
    np.testing.assert_array_equal(emb.s.numpy(), np.asarray(qparams["decoder"]["tok_emb"]["s"]))
    # convolutions, layer norms and positions keep their dtype and values
    assert not any(isinstance(m, torch.nn.Linear) for m in model.modules())
    assert model.encoder.conv1.weight.dtype == DTYPES[dtype][1]
    assert model.encoder.ln_post.weight.dtype == torch.float32
    np.testing.assert_array_equal(
        model.decoder.pos_emb.float().numpy(),
        np.asarray(qparams["decoder"]["pos_emb"], np.float32))
    ratio = TQ.dequant_size_ratio(nbytes, model)
    want = JQ.dequant_size_ratio(params, qparams)
    assert ratio == pytest.approx(want, rel=1e-3)  # the port's bytes are JAX's
    assert ratio < (0.45 if dtype == "float32" else 0.7)


def test_params_from_jax_tree_carries_int8_packs(packed):
    """JAX's packs carried across give the port's own packs back exactly."""
    dtype, _params, qparams, model, _ = packed
    carried = TC.params_from_jax_tree(jax.tree.map(np.asarray, qparams), TCFG, DTYPES[dtype][1])
    got = dict(carried.named_buffers()) | dict(carried.named_parameters())
    want = dict(model.named_buffers()) | dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, tensor in want.items():
        assert got[name].dtype == tensor.dtype, name
        assert torch.equal(got[name], tensor), name
    assert [type(m) for m in carried.modules()] == [type(m) for m in model.modules()]


# ── compute on the same packs ─────────────────────────────────────────


def _carried(dtype: str):
    jdt, tdt = DTYPES[dtype]
    params = JQ.quantize_whisper_params(JM.init_params(jax.random.PRNGKey(0), CFG, jdt))
    return params, TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG, tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_forward_matches_jax(dtype):
    """encode, decoder_forward, the cross-KV packs and decode_step (plain
    and with beams folded into the cross query) on JAX's packs.

    At the float32 base the port is held to 1e-4 against JAX run op by op
    (``jax.disable_jit``), where every op rounds to its dtype as the source
    says, and to 2e-2 against jitted JAX: XLA keeps the bf16 embedding
    product in float32 before it meets the float32 positions (excess
    precision), the port rounds it to bf16 as the source says."""
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    jdt, tdt = DTYPES[dtype]
    params, model = _carried(dtype)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    enc_j = JM.encode(params, jnp.asarray(mel), CFG)
    _close(TM.encode(model, torch.from_numpy(mel), TCFG).float(), enc_j, tol)
    enc = np.asarray(enc_j, np.float32)  # one encoder output for both decoders
    enc_jx, enc_tx = jnp.asarray(enc, jdt), torch.from_numpy(enc).to(tdt)
    tokens = rng.integers(0, CFG.n_vocab, (2, 7)).astype(np.int32)
    out = TM.decoder_forward(model, torch.from_numpy(tokens).long(), enc_tx, TCFG)
    _close(out, JM.decoder_forward(params, jnp.asarray(tokens), enc_jx, CFG),
           tol if dtype == "bfloat16" else TOL_EXCESS)
    if dtype == "float32":
        with jax.disable_jit():
            _close(out, JM.decoder_forward(params, jnp.asarray(tokens), enc_jx, CFG), tol)

    ckv_j = JM.precompute_cross_kv(params, enc_jx, CFG)
    ckv_t = TM.precompute_cross_kv(model, enc_tx, TCFG)
    assert set(ckv_t) == {"k", "k_s", "v", "v_s"}
    for key in ("k", "v"):
        q_j, q_t = np.asarray(ckv_j[key]), ckv_t[key].numpy()
        assert q_t.dtype == np.int8 and q_t.shape == q_j.shape  # [L, B, H, T_enc, Dh]
        steps = np.abs(q_t.astype(np.int32) - q_j)
        assert steps.max() <= (1 if dtype == "float32" else 8) and (steps == 0).mean() > 0.95
        s_j, s_t = np.asarray(ckv_j[key + "_s"]), ckv_t[key + "_s"].numpy()
        assert s_t.shape == q_t.shape[:-1] + (1,)
        np.testing.assert_allclose(s_t, s_j, rtol=1e-5 if dtype == "float32" else 2e-2)

    b, t_max, pos = 2, 16, 5
    dh = CFG.n_text_state // CFG.n_text_head
    # the port reads JAX's packs too, so only the step's own arithmetic differs
    ckv_jt = {key: torch.from_numpy(np.asarray(val)) for key, val in ckv_j.items()}
    for beam in (1, 3):
        tok = rng.integers(0, CFG.n_vocab, (b * beam, 1)).astype(np.int32)
        kv = rng.standard_normal((CFG.n_text_layer, 2, b * beam, CFG.n_text_head, t_max, dh))
        lt, kv_t = TM.decode_step(model, torch.from_numpy(tok).long(), pos,
                                  torch.from_numpy(kv).to(tdt), ckv_jt, TCFG, beam=beam)
        lj, kv_j = JM.decode_step(params, jnp.asarray(tok), jnp.int32(pos),
                                  jnp.asarray(kv, jdt), ckv_j, CFG, beam=beam)
        _close(lt, lj, tol if dtype == "bfloat16" else TOL_EXCESS)
        _close(kv_t.float(), kv_j, tol if dtype == "bfloat16" else TOL_EXCESS)
        if dtype == "float32" and beam > 1:
            with jax.disable_jit():
                lj, kv_j = JM.decode_step(params, jnp.asarray(tok), jnp.int32(pos),
                                          jnp.asarray(kv, jdt), ckv_j, CFG, beam=beam)
            _close(lt, lj, tol)
            _close(kv_t, kv_j, tol)


def test_decode_attention_scales_match_jax():
    """The scaled branch on int8 caches: logits * k_scale, probs * v_scale,
    the V product in float32; with the beams folded into the query axis."""
    rng = np.random.default_rng(2)
    b, h, t, d = 2, 3, 20, 16
    for t_q in (1, 4):
        q = rng.standard_normal((b, h, t_q, d)).astype(np.float32)
        k = rng.integers(-127, 128, (b, h, t, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, h, t, d)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (b, h, t, 1)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (b, h, t, 1)).astype(np.float32)
        length = np.array([7, 20], np.int32)
        want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(length), k_scale=jnp.asarray(ks),
                                   v_scale=jnp.asarray(vs))
        got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(length).long(), k_scale=torch.from_numpy(ks),
                                  v_scale=torch.from_numpy(vs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_cross_kv_dispatch_and_default_length():
    """precompute_cross_kv gives packs only for an int8 model; the dense
    helper gives [L, 2, B, H, T, Dh] for either; cross_attend's default
    length is the pack's T_enc."""
    params, model = _carried("float32")
    dense = TC.params_from_jax_tree(
        jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), CFG, jnp.float32)), TCFG)
    enc = torch.randn(1, CFG.n_audio_ctx, CFG.n_audio_state, generator=torch.Generator().manual_seed(3))
    assert isinstance(TM.precompute_cross_kv(dense, enc, TCFG), torch.Tensor)
    packs = TM.precompute_cross_kv(model, enc, TCFG)
    assert isinstance(packs, dict)
    full = TM.precompute_cross_kv_dense(model, enc, TCFG)
    assert full.shape == (CFG.n_text_layer, 2, 1, CFG.n_text_head, CFG.n_audio_ctx,
                          CFG.n_text_state // CFG.n_text_head)
    qc = torch.randn(1, CFG.n_text_head, 1, CFG.n_text_state // CFG.n_text_head)
    layer = TM.cross_layer(packs, 1)
    assert layer["k"].shape == packs["k"].shape[1:]
    default = TM.cross_attend(qc, layer, 1)
    explicit = TM.cross_attend(qc, layer, 1, torch.tensor([CFG.n_audio_ctx]))
    assert torch.equal(default, explicit)


# ── the served paths at int8 (bf16 base) ─────────────────────────────


@pytest.fixture(scope="module")
def backends():
    """JAX's and the port's backends at STT_COMPUTE_TYPE=int8 on the fixture."""
    from open_speech_tpu.backends.jax_whisper import JaxWhisperBackend
    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend

    saved = [(s, name, getattr(s, name)) for s in (jax_settings, torch_settings)
             for name in ("stt_model_dir", "os_precompile_on_load", "stt_compute_type")]
    for s in (jax_settings, torch_settings):
        s.stt_model_dir = str(FIXTURE.parent)
        s.os_precompile_on_load = False
        s.stt_compute_type = "int8"
    try:
        jb, tb = JaxWhisperBackend(), TorchWhisperBackend(device="cpu")
        jb.load_model("test-tiny-eot")
        tb.load_model("test-tiny-eot")
        yield jb, tb
    finally:
        for s, name, value in saved:
            setattr(s, name, value)


def test_backend_loads_int8_packs_of_the_bf16_weights(backends):
    jb, tb = backends
    model = tb._models["test-tiny-eot"]["model"]
    qparams = jb._models["test-tiny-eot"]["params"]
    assert tb.loaded_models()[0].compute_type == "int8"
    assert model.decoder.blocks[0].attn.q.q.dtype == torch.int8
    carried = TC.params_from_jax_tree(jax.tree.map(np.asarray, qparams), TCFG, torch.bfloat16)
    for (name, got), (_, want) in zip(model.named_buffers(), carried.named_buffers()):
        assert torch.equal(got, want), name


@pytest.mark.parametrize("beam", [1, 5])
def test_backend_int8_tokens_match_jax(backends, beam):
    jb, tb = backends
    for k in (1, 3):
        wav = jcodec.write_wav(S._beeps(1.2, k, 11 + k), SR)
        kw = dict(language="en", beam_size=beam, fallback=False, response_format="verbose_json")
        ref, out = jb.transcribe(wav, "test-tiny-eot", **kw), tb.transcribe(wav, "test-tiny-eot", **kw)
        toks = [[t for s in body["segments"] for t in s["tokens"]] for body in (out, ref)]
        assert toks[0] == toks[1] and toks[0], (k, toks)
        assert out["text"] == ref["text"]


def test_batched_longform_int8_matches_jax(backends):
    jb, tb = backends
    je, te = jb._models["test-tiny-eot"], tb._models["test-tiny-eot"]
    rng = np.random.default_rng(5)
    audio = np.concatenate([S._beeps(1.2, int(k), 30 + i)
                            for i, k in enumerate(rng.integers(1, 4, 5))])
    kw = dict(language="en", beam_size=5, temperature=(0.0,), max_new_tokens=12)
    want = JBd.transcribe_batched(je["params"], je["cfg"], je["tok"], audio, JaxOptions(**kw),
                                  max_batch=4)
    got = TBd.transcribe_batched(te["model"], te["cfg"], te["tok"], audio,
                                 TranscribeOptions(**kw), max_batch=4)
    assert [(s.seek, s.start, s.end, s.tokens) for s in got[0]] == [
        (s.seek, s.start, s.end, list(s.tokens)) for s in want[0]]
    assert got[0]


@pytest.fixture(scope="module")
def int8_entries(backends):
    jb, tb = backends
    je, te = jb._models["test-tiny-eot"], tb._models["test-tiny-eot"]
    return (
        {"params": je["params"], "cfg": je["cfg"],
         "tok": jax_tokenizer(str(FIXTURE), n_vocab=CFG.n_vocab, n_langs=CFG.n_langs)},
        {"model": te["model"], "cfg": te["cfg"],
         "tok": torch_tokenizer(str(FIXTURE), n_vocab=TCFG.n_vocab, n_langs=TCFG.n_langs)},
    )


@pytest.fixture
def stream_settings(monkeypatch):
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_stream_incremental", True)
        monkeypatch.setattr(s, "os_batcher_enabled", False)
        monkeypatch.setattr(s, "os_stream_chunk_ms", 100)


def test_session_events_int8_match_jax(monkeypatch, int8_entries, stream_settings):
    """Incremental encoder on: interims over int8 block encodes, the final
    over the incremental states."""
    audio = np.concatenate([S._beeps(0.5, 3, 1), S._beeps(0.5, 2, 2)])
    jev, tev, _, _, session = S._run_both(monkeypatch, int8_entries,
                                          S._frames(S._pcm16(audio), 3200))
    assert tev == jev
    assert ("transcript", False, False) in S._kinds(tev)
    assert session._inc_encoder.tail_encodes > 0 and not session._inc_broken


def test_session_via_batcher_int8_matches_jax(monkeypatch, int8_entries, stream_settings):
    """Through the continuous batcher (incremental encoder off): the same
    events as JAX's, every pass through the pool, whose cross-KV stays one
    dense bf16 tensor."""
    import open_speech_tpu.runtime.batcher_pool as JBP
    import open_speech_tpu_torch.runtime.batcher_pool as TBP
    from open_speech_tpu_torch.runtime import batcher as TB

    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_batcher_enabled", True)
        monkeypatch.setattr(s, "os_stream_incremental", False)
    pools = []
    real = TB.ContinuousBatcher._admit_device

    def admit(self, batch):
        real(self, batch)
        pools.append(self._cross_kv)

    monkeypatch.setattr(TB.ContinuousBatcher, "_admit_device", admit)
    audio = np.concatenate([S._beeps(0.5, 3, 8), S._beeps(0.5, 2, 9)])
    for pool in (JBP, TBP):
        pool.reset_pool()
    try:
        jev, tev, _, tr, session = S._run_both(monkeypatch, int8_entries,
                                               S._frames(S._pcm16(audio), 3200))
    finally:
        for pool in (JBP, TBP):
            pool.reset_pool()
    assert tev == jev and tr.calls == [] and session._inc_encoder is None
    assert len(pools) == session._transcription_count > 1
    assert all(isinstance(p, torch.Tensor) and p.dtype == torch.bfloat16 for p in pools)
