"""The continuous batcher: the PyTorch port against the JAX package, on the CPU.

Weights: random test-tiny (``init_params(PRNGKey(0))`` carried over with
``params_from_jax_tree``) and the trained fixture ``tests/fixtures/
test-tiny-eot`` (each side's own loader), float32, bf16 KV pools on both
sides (the batchers' default). Mel windows come from numpy seeds.

- ``_apply_rules`` with a [B] vector of mixed steps equals the JAX rules
  within 1e-5 (float32 logits; -1e30 entries equal), and a vector of equal
  steps equals the scalar form exactly.
- The port's batcher gives the JAX batcher's tokens per window, exactly,
  and a lone window gives the port's B=1 ``greedy_decode`` tokens.
- The port's counterparts of ``tests/test_batcher.py``'s behaviours:
  multiplexing, determinism, slot reuse past the pool, the budget clamp, a
  bad admission failing only its request, a failed tick recovering, and
  give-up failing the queue.
- The pool: one batcher per (model, language, task), stale batchers
  retired after a reload, ``transcribe_pcm_batched`` text equal to JAX's.
"""

from __future__ import annotations

import asyncio
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.models.whisper import FallbackTokenizer as JaxFallbackTokenizer
from open_speech_tpu.models.whisper import convert as JC
from open_speech_tpu.models.whisper import decode as JD
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu.models.whisper.tokenizer import get_tokenizer as jax_tokenizer
from open_speech_tpu.ops.mel import log_mel_spectrogram as jax_mel
from open_speech_tpu.runtime import batcher as JB
from open_speech_tpu.runtime import batcher_pool as JP
from open_speech_tpu_torch.models.whisper import FallbackTokenizer
from open_speech_tpu_torch.models.whisper import convert as TC
from open_speech_tpu_torch.models.whisper import decode as TD
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.models.whisper.tokenizer import get_tokenizer as torch_tokenizer
from open_speech_tpu_torch.runtime import batcher as TB
from open_speech_tpu_torch.runtime import batcher_pool as TP

FIXTURE = Path(__file__).parent / "fixtures" / "test-tiny-eot"
TCFG = TM.PRESETS["test-tiny"]


@pytest.fixture(scope="module", params=["random", "eot"])
def pair(request):
    """(jax params, jax cfg, jax tokenizer, torch model, torch tokenizer)."""
    if request.param == "random":
        cfg = JM.PRESETS["test-tiny"]
        params = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
        model = TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG)
        jtok = JaxFallbackTokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
        ttok = FallbackTokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
    else:
        params, cfg = JC.load_params(str(FIXTURE), dtype=jnp.float32)
        model, _ = TC.load_params(str(FIXTURE), dtype=torch.float32)
        jtok = jax_tokenizer(str(FIXTURE), n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
        ttok = torch_tokenizer(str(FIXTURE), n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
    return params, cfg, jtok, model, ttok


@pytest.fixture(scope="module")
def tiny():
    """The random test-tiny model alone, for the port's own behaviours."""
    params = JM.init_params(jax.random.PRNGKey(0), JM.PRESETS["test-tiny"], jnp.float32)
    model = TC.params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG)
    return model, FallbackTokenizer(n_vocab=TCFG.n_vocab, n_langs=TCFG.n_langs).special


def _audio(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.3, 0.3, TCFG.n_audio_ctx * 2 * 160).astype(np.float32)


def _mel(seed: int) -> np.ndarray:
    return np.asarray(jax_mel(jnp.asarray(_audio(seed)), n_mels=TCFG.n_mels))


def _run(coro):
    return asyncio.run(coro)


async def _serve(batcher, windows, **kw):
    """Submit every window at once; stop the batcher whatever happens."""
    batcher.start()
    try:
        return await asyncio.wait_for(
            asyncio.gather(*(batcher.transcribe_window(w, **kw) for w in windows),
                           return_exceptions=True),
            120,
        )
    finally:
        await batcher.stop()


# ── the rules with a vector of steps ──────────────────────────────────


@pytest.mark.parametrize("timestamps", [True, False])
def test_apply_rules_vector_steps_match_jax(timestamps):
    sp = FallbackTokenizer(n_vocab=TCFG.n_vocab, n_langs=TCFG.n_langs).special
    rng = np.random.default_rng(7)
    b, v = 8, TCFG.n_vocab
    steps = np.array([0, 1, 2, 3, 0, 5, 1, 2], np.int32)
    ts = sp.timestamp_begin
    logits = rng.normal(0, 3, (b, v)).astype(np.float32)
    last = rng.choice([ts + 4, ts + 9, 40, sp.eot], b).astype(np.int32)
    penult = rng.choice([ts + 2, ts + 9, 41, 42], b).astype(np.int32)
    max_ts = np.where(rng.random(b) < 0.5, ts + 9, ts - 1).astype(np.int32)
    opts = TD.DecodeOptions(timestamps=timestamps, suppress_tokens=(5, 6))
    suppress = TD._suppress_mask(v, sp, opts)
    kw = dict(special=sp, timestamps=timestamps, max_initial_ts_tok=ts + 50,
              blank_tokens=TD._blank_tokens(sp, opts))
    want = np.asarray(JD._apply_rules(
        jnp.asarray(logits), step_idx=jnp.asarray(steps), last=jnp.asarray(last),
        penult=jnp.asarray(penult), max_ts=jnp.asarray(max_ts),
        suppress=jnp.asarray(suppress), **kw))
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))  # noqa: E731
    got = TD._apply_rules(
        torch.from_numpy(logits), step_idx=t(steps), last=t(last), penult=t(penult),
        max_ts=t(max_ts), suppress=torch.from_numpy(suppress), **kw).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # every row at one step: the vector form equals the scalar form exactly
    for step in (0, 1, 2, 4):
        args = dict(last=t(last), penult=t(penult), max_ts=t(max_ts),
                    suppress=torch.from_numpy(suppress), **kw)
        scalar = TD._apply_rules(torch.from_numpy(logits), step_idx=step, **args)
        vector = TD._apply_rules(torch.from_numpy(logits), step_idx=t([step] * b), **args)
        assert torch.equal(scalar, vector)


# ── parity with the JAX batcher and with greedy decoding ──────────────


def test_batcher_matches_jax_and_greedy(pair):
    """Three concurrent windows: the JAX batcher's tokens, exactly. A lone
    window: the port's B=1 greedy tokens (the JAX test's claim)."""
    params, cfg, jtok, model, ttok = pair
    windows = [_mel(s) for s in (3, 7, 11)]
    kw = dict(slots=4, max_new_tokens=8, suppress_tokens=tuple(ttok.non_speech_tokens))
    want = _run(_serve(JB.ContinuousBatcher(params, cfg, jtok.special, **kw), windows))
    got = _run(_serve(TB.ContinuousBatcher(model, TCFG, ttok.special, **kw), windows))
    assert got == want and all(isinstance(g, list) for g in got)

    sp = ttok.special
    (solo,) = _run(_serve(TB.ContinuousBatcher(model, TCFG, sp, **kw), windows[:1]))
    enc = TM.encode(model, torch.tensor(windows[0])[None], TCFG)
    ref = TD.greedy_decode(
        model, TCFG, sp, enc, np.array([sp.sot_sequence("en", "transcribe")], np.int32),
        TD.DecodeOptions(max_new_tokens=8, suppress_tokens=kw["suppress_tokens"]),
    )
    assert solo == [int(t) for t in ref.tokens[0][: int(ref.lengths[0])]]


async def _serve_staggered(batcher, windows, after_ticks):
    """Submit ``windows[i]`` once the batcher has run ``after_ticks[i]``
    ticks, so later admissions land while earlier slots are mid-decode."""
    batcher.start()
    try:
        async def staggered():
            futures = []
            for w, ticks in zip(windows, after_ticks):
                while batcher.stats["ticks"] < ticks:
                    await asyncio.sleep(0.001)
                futures.append(asyncio.ensure_future(batcher.transcribe_window(w)))
            return await asyncio.gather(*futures)

        return await asyncio.wait_for(staggered(), 120)
    finally:
        await batcher.stop()


def test_staggered_admissions_keep_each_windows_tokens(pair):
    """Two slots, five windows admitted while other slots are mid-decode:
    each admission's prompt feed steps every slot, and a slot mid-decode
    must come out of it unchanged. Every window gives the JAX batcher's
    tokens under the same schedule and the port's B=1 greedy tokens."""
    params, cfg, jtok, model, ttok = pair
    sp = ttok.special
    windows = [_mel(s) for s in (3, 7, 11, 13, 17)]
    after_ticks = [0, 1, 2, 2, 2]
    kw = dict(slots=2, max_new_tokens=12, suppress_tokens=tuple(ttok.non_speech_tokens))
    jb = JB.ContinuousBatcher(params, cfg, jtok.special, **kw)
    tb = TB.ContinuousBatcher(model, TCFG, sp, **kw)
    want = _run(_serve_staggered(jb, windows, after_ticks))
    got = _run(_serve_staggered(tb, windows, after_ticks))
    assert tb.stats["completed"] == len(windows) and tb.stats["peak_occupancy"] == 2
    assert got == want

    prompt = np.array([sp.sot_sequence("en", "transcribe")], np.int32)
    opts = TD.DecodeOptions(max_new_tokens=12, suppress_tokens=kw["suppress_tokens"])
    for w, toks in zip(windows, got):
        ref = TD.greedy_decode(model, TCFG, sp, TM.encode(model, torch.tensor(w)[None], TCFG),
                               prompt, opts)
        assert toks == [int(t) for t in ref.tokens[0][: int(ref.lengths[0])]]


# ── the port's own behaviours (tests/test_batcher.py's) ───────────────


@pytest.mark.parametrize("slots,n,budget", [(4, 6, 6), (2, 5, 4)], ids=["multiplex", "reuse"])
def test_concurrent_windows_multiplex_and_slots_reuse(tiny, slots, n, budget):
    """Six windows on four slots, five on two: all complete, the slots
    were shared, every slot retires, and each result holds at most its
    budget of valid tokens."""
    model, sp = tiny
    b = TB.ContinuousBatcher(model, TCFG, sp, slots=slots, max_new_tokens=budget)
    results = _run(_serve(b, [_mel(i) for i in range(n)]))
    assert b.stats["completed"] == n and b.occupancy == 0
    assert b.stats["peak_occupancy"] == min(slots, n)
    assert b.stats["tokens"] == sum(len(r) for r in results)
    for toks in results:
        assert len(toks) <= budget and all(0 <= t < TCFG.n_vocab for t in toks)


def test_batcher_deterministic_across_runs(tiny):
    model, sp = tiny

    def crowd():
        b = TB.ContinuousBatcher(model, TCFG, sp, slots=4, max_new_tokens=6)
        return _run(_serve(b, [_mel(i) for i in (3, 7, 11)]))

    assert crowd() == crowd()


def test_oversized_budget_clamped_to_pool_capacity(tiny):
    model, sp = tiny
    b = TB.ContinuousBatcher(model, TCFG, sp, slots=1, max_new_tokens=4)
    (out,) = _run(_serve(b, [_mel(0)], max_new_tokens=10_000))
    prompt = len(sp.sot_sequence("en", "transcribe"))
    assert b._cache_len == 32  # n_text_ctx caps the 64-bucket
    assert len(out) <= b._cache_len - prompt - 1


def test_bad_admission_fails_only_that_request(tiny):
    model, sp = tiny

    async def go():
        b = TB.ContinuousBatcher(model, TCFG, sp, slots=4, max_new_tokens=8)
        b.start()
        try:
            good = asyncio.create_task(b.transcribe_window(_mel(1)))
            bad = asyncio.create_task(b.transcribe_window(_mel(2)[:, :7]))
            done = await asyncio.wait_for(asyncio.gather(good, bad, return_exceptions=True), 60)
            after = await asyncio.wait_for(b.transcribe_window(_mel(3)), 60)
        finally:
            await b.stop()
        return done, after

    (good, bad), after = _run(go())
    assert isinstance(good, list) and isinstance(bad, ValueError)
    assert isinstance(after, list)


def test_admission_device_failure_fails_only_the_admitted(tiny, monkeypatch):
    """An encode that raises fails the requests it was admitting; the
    batcher serves the next one."""
    model, sp = tiny
    real, boom = TB.encode, {"n": 1}

    def flaky_encode(*args, **kw):
        if boom["n"]:
            boom["n"] -= 1
            raise RuntimeError("injected encode error")
        return real(*args, **kw)

    monkeypatch.setattr(TB, "encode", flaky_encode)
    b = TB.ContinuousBatcher(model, TCFG, sp, slots=2, max_new_tokens=4)

    async def go():
        b.start()
        try:
            first = await asyncio.gather(b.transcribe_window(_mel(4)), return_exceptions=True)
            return first[0], await asyncio.wait_for(b.transcribe_window(_mel(5)), 60)
        finally:
            await b.stop()

    first, second = _run(go())
    assert isinstance(first, RuntimeError) and isinstance(second, list)
    assert b.occupancy == 0


def test_tick_failure_recovers_and_serves_again(tiny, monkeypatch):
    """A failed tick fails the in-flight request, resets the self-KV pool
    (after _fail_all) and serves the next request."""
    model, sp = tiny
    real, boom = TB._slot_decode_block, {"n": 1}

    def flaky_block(*args, **kwargs):
        if boom["n"]:
            boom["n"] -= 1
            raise RuntimeError("injected device error")
        return real(*args, **kwargs)

    monkeypatch.setattr(TB, "_slot_decode_block", flaky_block)
    b = TB.ContinuousBatcher(model, TCFG, sp, slots=2, max_new_tokens=8)
    pool = b._self_kv

    async def go():
        b.start()
        try:
            first = await asyncio.gather(b.transcribe_window(_mel(4)), return_exceptions=True)
            return first[0], await asyncio.wait_for(b.transcribe_window(_mel(5)), 60)
        finally:
            await b.stop()

    first, second = _run(go())
    assert isinstance(first, RuntimeError) and isinstance(second, list)
    assert b._self_kv is not pool  # a fresh pool after the failure
    # the recovered batcher still decodes what a fresh one does
    assert second == _run(_serve(
        TB.ContinuousBatcher(model, TCFG, sp, slots=2, max_new_tokens=8), [_mel(5)]))[0]


@pytest.mark.parametrize("pool_rebuild_fails", [False, True])
def test_giveup_fails_queued_requests(tiny, monkeypatch, pool_rebuild_fails):
    """Repeated tick failures, or one whose KV pool cannot be rebuilt (a
    lost device), end the scheduler and fail every queued request."""
    model, sp = tiny

    def always_boom(*args, **kwargs):
        raise RuntimeError("persistent device error")

    monkeypatch.setattr(TB, "_slot_decode_block", always_boom)
    b = TB.ContinuousBatcher(model, TCFG, sp, slots=1, max_new_tokens=8)
    if pool_rebuild_fails:
        monkeypatch.setattr(b, "_reset_pools", always_boom)
    results = _run(_serve(b, [_mel(6), _mel(7), _mel(8)]))
    assert all(isinstance(r, RuntimeError) for r in results), results
    assert b._task is None


def test_tick_state_is_copied_before_dispatch(tiny, monkeypatch):
    """The host state handed to a tick is a copy: mutating the scheduler's
    arrays after dispatch cannot reach the tensors the block reads."""
    model, sp = tiny
    seen = []
    real = TB._slot_decode_block

    def spy(model_, tokens, pos, *args, **kw):
        before = pos.clone()
        b._pos[:] = 10_000  # the scheduler writes while the block runs
        seen.append(torch.equal(pos, before))
        return real(model_, tokens, pos, *args, **kw)

    monkeypatch.setattr(TB, "_slot_decode_block", spy)
    b = TB.ContinuousBatcher(model, TCFG, sp, slots=2, max_new_tokens=4)
    (out,) = _run(_serve(b, [_mel(9)]))
    assert seen and all(seen) and isinstance(out, list)


# ── the pool ──────────────────────────────────────────────────────────


class _Backend:
    def __init__(self, entry):
        self._models = {"m": entry}

    def _ensure_model(self, model_id):
        return self._models[model_id]


def test_pool_keys_reload_and_retire(tiny, monkeypatch):
    model, _ = tiny
    tok = FallbackTokenizer(n_vocab=TCFG.n_vocab, n_langs=TCFG.n_langs)
    backend = _Backend({"model": model, "cfg": TCFG, "tok": tok})
    monkeypatch.setattr(TP.settings, "os_batch_max_sessions", 2)
    TP.reset_pool()

    async def go():
        en = await TP.get_batcher(backend, "m", "en")
        assert await TP.get_batcher(backend, "m", None) is en  # None means en
        de = await TP.get_batcher(backend, "m", "de")
        assert de is not en and en.n_slots == 2 and en.max_new_tokens == 224
        stats = TP.pool_stats()
        assert set(stats) == {"m/en/transcribe", "m/de/transcribe"}
        assert stats["m/en/transcribe"]["slots"] == 2
        # a reload makes a new model object: the old batchers are stale
        backend._models["m"] = dict(backend._models["m"], model=copy.deepcopy(model))
        fresh = await TP.get_batcher(backend, "m", "en")
        assert fresh is not en and fresh.model is backend._models["m"]["model"]
        assert await TP.retire_stale(backend) == 1  # "de" was still on the old model
        assert set(TP.pool_stats()) == {"m/en/transcribe"}
        await asyncio.sleep(0.3)  # the drain tasks stop the idle stale batchers
        assert en._task is None and de._task is None and not TP._retiring
        await TP.shutdown_batchers()
        assert TP.pool_stats() == {} and fresh._task is None

    _run(go())
    TP.reset_pool()


def test_transcribe_pcm_batched_matches_jax(pair, monkeypatch):
    """The shared entry's text (mel framing, duration budget, decode) for
    1.0 s and a window-overflowing 2.0 s of the same PCM."""
    params, cfg, jtok, model, ttok = pair
    jback = type("B", (), {"_models": {"m": {"params": params, "cfg": cfg, "tok": jtok}},
                           "_ensure_model": lambda self, m: self._models[m]})()
    tback = _Backend({"model": model, "cfg": TCFG, "tok": ttok})
    pcm = np.random.default_rng(5).uniform(-0.3, 0.3, 32000).astype(np.float32)
    out = {}
    for name, pool, backend in (("jax", JP, jback), ("torch", TP, tback)):
        pool.reset_pool()

        async def go(pool=pool, backend=backend):
            try:
                return [await pool.transcribe_pcm_batched(backend, "m", "en", pcm[:n])
                        for n in (16000, 32000)]
            finally:
                await pool.shutdown_batchers()

        out[name] = _run(go())
    assert out["torch"] == out["jax"]
    assert all(isinstance(r["text"], str) for r in out["torch"])
