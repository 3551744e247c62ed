"""Speculative greedy decoding: the PyTorch port against its own greedy
decode and against the JAX package, on the CPU.

Target and draft are random test-tiny weights (``init_params`` with
PRNGKey 0 and 7, float32) carried across with ``params_from_jax_tree``: a
random draft disagrees with the target almost always, the adversarial case
for the accept/correct bookkeeping. The speculative tokens and lengths
must equal ``greedy_decode``'s exactly, and the rounds and accepted counts
JAX's exactly; avg_logprob within 5e-3 of greedy's (a verify pass scores a
[G+1, d] chunk where greedy runs single steps: the JAX package's own
tolerance) and 1e-4 of JAX's; no_speech_prob within 1e-5.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.models.whisper import FallbackTokenizer
from open_speech_tpu.models.whisper import decode as JD
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu.models.whisper import quantize as JQ
from open_speech_tpu.models.whisper import speculative as JS
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.whisper import convert as TC
from open_speech_tpu_torch.models.whisper import decode as TD
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.models.whisper import speculative as TS
from open_speech_tpu_torch.models.whisper import transcribe as TT
from open_speech_tpu_torch.ops import audio as codec

CFG = JM.PRESETS["test-tiny"]
TCFG = TM.PRESETS["test-tiny"]
FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def setup():
    """(JAX target, JAX draft, port target, port draft, special, encoder
    states of each on one mel (numpy then torch), prompt)."""
    t_params = JM.init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    d_params = JM.init_params(jax.random.PRNGKey(7), CFG, jnp.float32)
    t_model = TC.params_from_jax_tree(jax.tree.map(np.asarray, t_params), TCFG)
    d_model = TC.params_from_jax_tree(jax.tree.map(np.asarray, d_params), TCFG)
    tok = FallbackTokenizer(n_vocab=CFG.n_vocab, n_langs=CFG.n_langs)
    mel = np.random.default_rng(1).standard_normal(
        (1, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    enc = np.array(JM.encode(t_params, jnp.asarray(mel), CFG))
    d_enc = np.array(JM.encode(d_params, jnp.asarray(mel), CFG))
    prompt = np.asarray([tok.special.sot_sequence("en")], np.int32)
    return dict(jt=t_params, jd=d_params, tt=t_model, td=d_model, tok=tok,
                enc=enc, d_enc=d_enc, prompt=prompt)


def _opts(tok, **kw):
    return dict(dict(max_new_tokens=48, timestamps=True,
                     suppress_tokens=tuple(tok.non_speech_tokens)), **kw)


def _spec(s, opts, gamma, target="tt", draft="td", enc="enc", d_enc="d_enc", prompt=None):
    return TS.speculative_greedy_decode(
        s[target], TCFG, s[draft], TCFG, s["tok"].special, torch.from_numpy(s[enc]),
        torch.from_numpy(s[d_enc]), s["prompt"] if prompt is None else prompt,
        TD.DecodeOptions(**opts), gamma=gamma)


@pytest.mark.parametrize("timestamps", [True, False])
@pytest.mark.parametrize("gamma", [1, 4])
def test_exact_match_with_adversarial_draft(setup, timestamps, gamma):
    s = setup
    opts = _opts(s["tok"], timestamps=timestamps)
    ref = TD.greedy_decode(s["tt"], TCFG, s["tok"].special, torch.from_numpy(s["enc"]),
                           s["prompt"], TD.DecodeOptions(**opts))
    spec = _spec(s, opts, gamma)
    np.testing.assert_array_equal(spec.tokens, ref.tokens)
    np.testing.assert_array_equal(spec.lengths, ref.lengths)
    np.testing.assert_allclose(spec.avg_logprob, ref.avg_logprob, atol=5e-3)
    np.testing.assert_allclose(spec.no_speech_prob, ref.no_speech_prob, atol=1e-5)
    assert ref.spec_rounds is None and spec.spec_rounds >= 1
    # JAX on the same weights: the same tokens, rounds and acceptances
    want = JS.speculative_greedy_decode(
        s["jt"], CFG, s["jd"], CFG, s["tok"].special, jnp.asarray(s["enc"]),
        jnp.asarray(s["d_enc"]), s["prompt"], JD.DecodeOptions(**opts), gamma=gamma)
    np.testing.assert_array_equal(spec.tokens, want.tokens)
    assert (spec.spec_rounds, spec.spec_accepted) == (want.spec_rounds, want.spec_accepted)
    np.testing.assert_allclose(spec.avg_logprob, want.avg_logprob, atol=1e-4)
    np.testing.assert_allclose(spec.no_speech_prob, want.no_speech_prob, atol=1e-5)


def test_self_draft_accepts_everything(setup):
    """Draft == target: every proposal verifies, so each round emits
    gamma + 1 tokens until the eot."""
    s, gamma = setup, 4
    opts = _opts(s["tok"])
    ref = TD.greedy_decode(s["tt"], TCFG, s["tok"].special, torch.from_numpy(s["enc"]),
                           s["prompt"], TD.DecodeOptions(**opts))
    spec = _spec(s, opts, gamma, draft="tt", d_enc="enc")
    np.testing.assert_array_equal(spec.tokens, ref.tokens)
    emitted = int(ref.lengths[0]) + int((ref.tokens[0] == s["tok"].special.eot).any())
    assert spec.spec_rounds == -(-emitted // (gamma + 1))
    assert spec.spec_accepted == spec.spec_rounds * gamma


def test_rejects_batched_sampled_and_vocab_mismatch(setup):
    s = setup
    two = np.repeat(s["prompt"], 2, axis=0)
    with pytest.raises(ValueError, match="single-stream"):
        _spec(s, _opts(s["tok"]), 4, prompt=two)
    with pytest.raises(ValueError, match="temperature"):
        _spec(s, _opts(s["tok"], temperature=0.4), 4)
    with pytest.raises(ValueError, match="vocab mismatch"):
        TS.speculative_greedy_decode(
            s["tt"], TCFG, s["td"], replace(TCFG, n_vocab=TCFG.n_vocab + 1), s["tok"].special,
            torch.from_numpy(s["enc"]), torch.from_numpy(s["d_enc"]), s["prompt"])


def _random_pos_emb(s) -> tuple[dict, TM.Whisper]:
    """The target with a random position table (init leaves it at zeros,
    which would hide a shifted slice), on both sides."""
    pe = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (CFG.n_text_ctx, CFG.n_text_state)))
    params = dict(s["jt"], decoder=dict(s["jt"]["decoder"], pos_emb=jnp.asarray(pe)))
    return params, TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG)


def test_exact_match_at_context_edge(setup):
    """A decode driven to n_text_ctx: the last verify chunks run past the
    position table (the draft proposes there: its step reads the table's
    last row, as JAX's clamped slice does), and their live slots stay exact.
    EOT is suppressed so that the decode reaches the edge."""
    s = setup
    _params, model = _random_pos_emb(s)
    prev = np.random.default_rng(5).integers(1, 200, 17).astype(np.int32)
    prompt = np.concatenate([[s["tok"].special.startofprev], prev, s["prompt"][0]])[None]
    opts = _opts(s["tok"], max_new_tokens=CFG.n_text_ctx,
                 suppress_tokens=tuple(s["tok"].non_speech_tokens) + (s["tok"].special.eot,))
    ref = TD.greedy_decode(model, TCFG, s["tok"].special, torch.from_numpy(s["enc"]),
                           prompt.astype(np.int32), TD.DecodeOptions(**opts))
    assert int(ref.lengths[0]) == CFG.n_text_ctx - prompt.shape[1] - 1
    spec = TS.speculative_greedy_decode(
        model, TCFG, s["td"], TCFG, s["tok"].special, torch.from_numpy(s["enc"]),
        torch.from_numpy(s["d_enc"]), prompt.astype(np.int32), TD.DecodeOptions(**opts), gamma=4)
    np.testing.assert_array_equal(spec.tokens, ref.tokens)
    np.testing.assert_array_equal(spec.lengths, ref.lengths)


def test_verify_chunk_matches_sequential_at_crossing(setup):
    """The slot logits of a verify chunk whose tail crosses n_text_ctx equal
    sequential decode_step's (and JAX's chunk) on the live slots: the
    padded table keeps their position rows unshifted. 2e-4 absolute, the
    JAX package's own bound."""
    s = setup
    params, model = _random_pos_emb(s)
    enc = torch.from_numpy(s["enc"])
    ckv = TM.precompute_cross_kv(model, enc, TCFG)
    rng = np.random.default_rng(5)
    g1 = 5
    prompt_len = CFG.n_text_ctx - g1 + 2  # two slots overhang the table
    prompt = torch.from_numpy(rng.integers(1, 200, (1, prompt_len))).long()
    toks = torch.from_numpy(rng.integers(1, 200, (g1,))).long()
    cache = prompt_len + 2 * g1
    kv = TM.init_self_kv(TCFG, 1, cache)
    TD._prefill(model, prompt, ckv, kv, TCFG)
    seq = torch.stack([TM.decode_step(model, toks[j].view(1, 1), prompt_len + j, kv, ckv, TCFG)[0]
                       for j in range(g1)], 1)  # [1, G, V]
    kv2 = TM.init_self_kv(TCFG, 1, cache)
    TD._prefill(model, prompt, ckv, kv2, TCFG)
    pe = model.decoder.pos_emb
    pe_pad = torch.cat([pe, pe.new_zeros(g1, pe.shape[1])])
    chunk, kv_out = TS._verify_chunk(model, toks[None], prompt_len, kv2, ckv, TCFG, pe_pad)
    assert kv_out is kv2 and chunk.shape == (1, g1, CFG.n_vocab)
    live = CFG.n_text_ctx - prompt_len
    np.testing.assert_allclose(chunk[:, :live].numpy(), seq[:, :live].numpy(), atol=2e-4)

    ckv_j = JM.precompute_cross_kv(params, jnp.asarray(s["enc"]), CFG)
    kv_j = JM.init_self_kv(CFG, 1, cache, jnp.float32)
    _, kv_j = JD._prefill(params, jnp.asarray(prompt.numpy(), jnp.int32), ckv_j, kv_j, CFG)
    pe_j = jnp.concatenate([params["decoder"]["pos_emb"], jnp.zeros((g1, CFG.n_text_state))])
    want, _ = jax.jit(JS._verify_chunk, static_argnums=(5,))(
        params, jnp.asarray(toks.numpy()[None], jnp.int32), prompt_len, kv_j, ckv_j,
        CFG.n_text_head, None, pe_j)
    np.testing.assert_allclose(chunk.numpy(), np.asarray(want), atol=1e-4)


def test_decode_step_past_the_table_reads_its_last_row(setup):
    """decode_step at a position past n_text_ctx reads the last position
    row, as JAX's clamped dynamic_slice does (an unclamped slice is empty
    and broadcasts silently)."""
    s = setup
    params, model = _random_pos_emb(s)
    enc = torch.from_numpy(s["enc"])
    dh = CFG.n_text_state // CFG.n_text_head
    kv = np.random.default_rng(6).standard_normal(
        (CFG.n_text_layer, 2, 1, CFG.n_text_head, CFG.n_text_ctx + 8, dh)).astype(np.float32)
    tok = np.array([[7]], np.int32)
    pos = CFG.n_text_ctx + 3
    want, _ = JM.decode_step(params, jnp.asarray(tok), jnp.int32(pos), jnp.asarray(kv),
                             JM.precompute_cross_kv(params, jnp.asarray(s["enc"]), CFG), CFG)
    got, _ = TM.decode_step(model, torch.from_numpy(tok).long(), pos, torch.from_numpy(kv),
                            TM.precompute_cross_kv(model, enc, TCFG), TCFG)
    assert got.shape == (1, CFG.n_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_int8_target_and_draft_match_greedy_and_jax(setup):
    """int8 target and draft (float32 base, JAX's packs carried across):
    the speculative tokens are the int8 target's greedy tokens, and the
    rounds and acceptances are JAX's."""
    s, gamma = setup, 3
    packs = [JQ.quantize_whisper_params(s[key]) for key in ("jt", "jd")]
    target, draft = (TC.params_from_jax_tree(jax.tree.map(np.asarray, p), TCFG) for p in packs)
    assert isinstance(target.decoder.tok_emb, TM.QuantEmbedding)
    mel = jnp.asarray(np.random.default_rng(1).standard_normal(
        (1, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32))
    enc, d_enc = (np.array(JM.encode(p, mel, CFG)) for p in packs)
    opts = _opts(s["tok"])
    ref = TD.greedy_decode(target, TCFG, s["tok"].special, torch.from_numpy(enc), s["prompt"],
                           TD.DecodeOptions(**opts))
    spec = TS.speculative_greedy_decode(
        target, TCFG, draft, TCFG, s["tok"].special, torch.from_numpy(enc),
        torch.from_numpy(d_enc), s["prompt"], TD.DecodeOptions(**opts), gamma=gamma)
    np.testing.assert_array_equal(spec.tokens, ref.tokens)
    np.testing.assert_array_equal(spec.lengths, ref.lengths)
    assert int(ref.lengths[0]) > 4
    want = JS.speculative_greedy_decode(
        packs[0], CFG, packs[1], CFG, s["tok"].special, jnp.asarray(enc), jnp.asarray(d_enc),
        s["prompt"], JD.DecodeOptions(**opts), gamma=gamma)
    np.testing.assert_array_equal(spec.tokens, want.tokens)
    assert (spec.spec_rounds, spec.spec_accepted) == (want.spec_rounds, want.spec_accepted)


# ── the fallback loop and the backend ─────────────────────────────────


def _count_spec_calls(monkeypatch) -> list:
    """The gamma of every speculative decode the fallback loop starts."""
    calls, real = [], TT.speculative_greedy_decode

    def counted(*args, **kw):
        calls.append(kw["gamma"])
        return real(*args, **kw)

    monkeypatch.setattr(TT, "speculative_greedy_decode", counted)
    return calls


def test_fallback_speculates_only_at_temperature_zero(setup, monkeypatch):
    """With a draft, the t=0 attempt is speculative; the sampled fallback
    attempts run the plain sampled greedy decode."""
    s = setup
    spec_calls = _count_spec_calls(monkeypatch)
    greedy_temps = []
    real_greedy = TT.greedy_decode
    monkeypatch.setattr(TT, "greedy_decode", lambda *a, **kw: greedy_temps.append(a[5].temperature)
                        or real_greedy(*a, **kw))
    opts = TT.TranscribeOptions(language="en", beam_size=1, temperature=(0.0, 0.5, 1.0),
                                logprob_threshold=1.0, max_new_tokens=8)  # every gate fails
    res = TT._decode_with_fallback(
        s["tt"], TCFG, s["tok"], torch.from_numpy(s["enc"]), s["prompt"], opts,
        draft={"model": s["td"], "cfg": TCFG, "gamma": 2}, d_enc_out=torch.from_numpy(s["d_enc"]))
    assert spec_calls == [2] and greedy_temps == [0.5, 1.0] and res.temperature == 1.0


@pytest.fixture
def spec_backend(monkeypatch):
    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend

    monkeypatch.setattr(torch_settings, "stt_model_dir", str(FIXTURES))
    monkeypatch.setattr(torch_settings, "os_precompile_on_load", False)
    return TorchWhisperBackend(device="cpu", compute_type="float32")


def test_backend_spec_wiring_matches_plain(spec_backend, monkeypatch):
    """OS_SPEC_DRAFT_MODEL routes batch-1 greedy REST decodes through the
    speculative decode (the draft random from seed 0: no checkpoint) and
    the response is unchanged; beam 5 and sampled-only requests never
    speculate."""
    backend = spec_backend
    calls = _count_spec_calls(monkeypatch)
    wav = codec.write_wav(
        np.random.default_rng(0).uniform(-0.2, 0.2, 2 * 16000).astype(np.float32), 16000)
    kw = dict(language="en", response_format="verbose_json", fallback=False, beam_size=1)
    monkeypatch.setattr(torch_settings, "os_spec_draft_model", "")
    plain = backend.transcribe(wav, "test-tiny", **kw)
    assert calls == []
    monkeypatch.setattr(torch_settings, "os_spec_draft_model", "test-tiny-draft")
    monkeypatch.setattr(torch_settings, "os_spec_gamma", 3)
    spec = backend.transcribe(wav, "test-tiny", **kw)
    assert calls == [3, 3]  # two windows
    assert spec["text"] == plain["text"] and len(spec["segments"]) == len(plain["segments"])
    for got, want in zip(spec["segments"], plain["segments"]):
        assert (got["tokens"], got["start"], got["end"]) == (want["tokens"], want["start"],
                                                             want["end"])
        assert got["avg_logprob"] == pytest.approx(want["avg_logprob"], abs=5e-3)
    assert backend.is_model_loaded("test-tiny-draft")
    backend.transcribe(wav, "test-tiny", **dict(kw, beam_size=5))
    backend.transcribe(wav, "test-tiny", temperature=0.5, **kw)
    backend.transcribe(wav, "test-tiny-draft", **kw)  # the draft as the target
    assert calls == [3, 3]


def test_backend_drops_a_bad_draft(spec_backend, monkeypatch, caplog):
    """A draft that fails to load is logged and the request decodes
    without it; a draft of another vocabulary is refused with a warning."""
    backend = spec_backend
    calls = _count_spec_calls(monkeypatch)
    wav = codec.write_wav(np.zeros(16000, np.float32), 16000)
    kw = dict(language="en", fallback=False, beam_size=1)
    plain = backend.transcribe(wav, "test-tiny", **kw)
    monkeypatch.setattr(torch_settings, "os_spec_draft_model", "whisper-no-such-model")
    with caplog.at_level("ERROR"):
        assert backend.transcribe(wav, "test-tiny", **kw) == plain
    assert "failed to load" in caplog.text
    monkeypatch.setitem(TM.PRESETS, "test-tiny-v400", replace(TCFG, n_vocab=400))
    monkeypatch.setattr(torch_settings, "os_spec_draft_model", "test-tiny-v400")
    with caplog.at_level("WARNING"):
        assert backend.transcribe(wav, "test-tiny", **kw) == plain
    assert "vocab mismatch" in caplog.text and calls == []
