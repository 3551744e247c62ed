"""The port's TTS batcher and the options it sets in ``vocode_streaming``,
against the JAX package, on the CPU.

- ``vocode_streaming(first_block_frames=, wire=)`` gives the JAX model's
  blocks: the first block spans ``2 * first_block_frames`` x-frames, the
  halo is ``min(2 * HALO_FRAMES, nb, nb1)``, interior blocks start at
  ``nb1``; ``wire="i16"`` equals JAX's int16 wire after the cast (both
  truncate toward zero).
- The backend with ``OS_TTS_BATCHER_ENABLED`` gives the JAX backend's chunk
  sizes exactly (16-frame first block, 32-frame blocks) and its audio
  within ``TOL_AUDIO`` (harmonic features injected into both,
  ``tests/torch_tts_common.py``); a batch of four gives the JAX batcher's
  rows; a row batched with three others equals the same request alone.
- The scheduler: the idle fast path and the gather cap, ``stop`` ends the
  thread and drops the model, a replaced model stops the old batcher, a
  failing batch delivers its exception to every job, and the load's
  warmup batch.
"""

from __future__ import annotations

import queue
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.models.kokoro import model as JM
from open_speech_tpu.runtime import tts_batcher as JB
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.kokoro import model as TM
from open_speech_tpu_torch.models.kokoro.convert import kokoro_from_jax_tree
from open_speech_tpu_torch.runtime import tts_batcher as TB
from open_speech_tpu_torch.text.g2p import split_sentences
from open_speech_tpu_torch.tts.backends.kokoro_backend import KokoroBackend
from tests.torch_tts_common import (
    CFG,
    REAL_TORCH_HAR,
    TCFG,
    TEXT,
    TOL_AUDIO,
    inject_har,
    injected_har,
    jax_backend,
    jax_tree,
    one_torch_thread,
    torch_backend,
)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)
SPF = CFG.samples_per_frame
# a row on its own harmonic features against its solo run: the first STFT
# frame's +-pi branch is rounding's choice (tests/test_torch_kokoro.py)
OWN_FEATURES_REL_L2 = 0.5


@pytest.fixture(scope="module")
def tree():
    return jax_tree(CFG)


@pytest.fixture(scope="module")
def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def model(tree):
    return kokoro_from_jax_tree(tree, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def injected(jtree):
    """The harmonic features injected into both packages for the module."""
    har = injected_har(jtree)
    with pytest.MonkeyPatch.context() as mp:
        inject_har(mp, har)
        yield


@pytest.fixture
def batcher_on(monkeypatch):
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "os_tts_batcher_enabled", True)
    yield
    for mod in (JB, TB):
        threads = [b._thread for b in mod._batchers.values() if b._thread is not None]
        mod.reset_tts_batchers()
        for thread in threads:
            thread.join(timeout=60)


def _jobs(backend, specs):
    """(ids, style, speed) per (sentence, voice, speed)."""
    out = []
    for text, voice, speed in specs:
        ids = backend._encode_text(text, "en-us")
        out.append((ids, backend._style_for(voice, len(ids) - 2), speed))
    return out


ROWS = [
    ("The quick brown fox jumps over the lazy dog.", "af_heart", 1.0),
    ("Short one.", "am_adam", 1.0),
    ("It was 42 degrees outside, said Dr. Smith!", "af_bella(2)+af_sky(1)", 0.8),
    ("A fourth request in the same batch.", "bf_emma", 1.3),
]


def _run(batcher, jobs) -> list[list[np.ndarray]]:
    """One batch, run on this thread: each job's chunks."""
    sinks = [queue.Queue() for _ in jobs]
    batcher._run_batch([(*job, sink) for job, sink in zip(jobs, sinks)])
    rows = []
    for sink in sinks:
        rows.append([])
        while (item := sink.get_nowait()) is not None:
            rows[-1].append(item)
    return rows


def _same_rows(got, want, atol=TOL_AUDIO):
    for g_row, w_row in zip(got, want, strict=True):
        assert [c.shape for c in g_row] == [c.shape for c in w_row]
        for g, w in zip(g_row, w_row):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=atol)


# ── vocode_streaming's batcher options ──────────────────────────────────


def test_wire_matches_jax():
    x = np.concatenate([np.linspace(-1.2, 1.2, 101),
                        np.random.default_rng(0).uniform(-1, 1, 999)]).astype(np.float32)[None]
    want = JM._unwire(np.asarray(JM._wire(jnp.asarray(x), True)))
    got = TM._to_host(torch.from_numpy(x), "i16")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TM._to_host(torch.from_numpy(x), "f32"), x)


@pytest.mark.parametrize("block,first,wire", [(32, 16, "i16"), (24, 8, "f32")])
def test_vocode_streaming_options_match_jax(jtree, model, block, first, wire):
    """On the JAX model's encoded utterance, the port's blocks equal JAX's:
    sizes exactly, samples within TOL_AUDIO."""
    ids = torch_backend(model)._encode_text(ROWS[0][0], "en-us")
    ph = np.zeros((1, CFG.max_phonemes), np.int32)
    ph[0, : len(ids)] = ids
    style = TM.voice_vector("af_heart", CFG.voice_dim)[None]
    g, n_frames = JM.encode_utterance(jtree, CFG, jnp.asarray(ph), jnp.asarray([len(ids)], jnp.int32),
                                      jnp.asarray(style), jnp.ones((1,), jnp.float32))
    want = list(JM.vocode_streaming(jtree, CFG, g, n_frames, rng=jax.random.PRNGKey(1),
                                    block_frames=block, first_block_frames=first, wire=wire))
    g_t = tuple(torch.from_numpy(np.array(a)) for a in g)
    got = list(TM.vocode_streaming(model, TCFG, g_t, torch.from_numpy(np.array(n_frames)),
                                   block_frames=block, first_block_frames=first, wire=wire))
    total = int(n_frames[0]) * SPF
    assert got[0].shape[1] == min(first * SPF, total) and sum(b.shape[1] for b in got) == total
    assert len(got) > 2
    _same_rows([[b[0] for b in got]], [[b[0] for b in want]])


@pytest.mark.parametrize("first", [8, 16, 24, None])
def test_first_block_sizing(model, first):
    ids = list(range(1, 31))
    ph = torch.zeros((1, TCFG.max_phonemes), dtype=torch.int64)
    ph[0, :30] = torch.tensor(ids)
    style = torch.from_numpy(TM.voice_vector("af_sky", TCFG.voice_dim)[None])
    g, n_frames = TM.encode_utterance(model, TCFG, ph, torch.tensor([30]), style, torch.ones(1))
    blocks = list(TM.vocode_streaming(model, TCFG, g, n_frames, block_frames=24,
                                      first_block_frames=first))
    total = int(n_frames[0]) * SPF
    assert blocks[0].shape[1] == min((first or 24) * SPF, total)
    assert sum(b.shape[1] for b in blocks) == total
    assert all(b.shape[1] == 24 * SPF for b in blocks[1:-1])
    # a block wider than the bucket: one render of the whole utterance, as vocode
    whole = list(TM.vocode_streaming(model, TCFG, g, n_frames, block_frames=4 * TCFG.max_frames,
                                     first_block_frames=first, wire="i16"))
    assert len(whole) == 1 and whole[0].shape == (1, total)
    np.testing.assert_array_equal(whole[0], TM.vocode(model, TCFG, g, n_frames)[:, :total].numpy())


# ── the batcher against the JAX batcher ─────────────────────────────────


def test_backend_through_batcher_matches_jax(batcher_on, jtree, model):
    """The sentences of TEXT through each backend's batcher: the same chunks (first
    block 16 frames, then 32-frame blocks)."""
    want = list(jax_backend(jtree).synthesize(TEXT, "af_heart"))
    got = list(torch_backend(model).synthesize(TEXT, "af_heart"))
    assert len(want) > 4 and want[0].shape == (16 * SPF,) and want[1].shape == (32 * SPF,)
    _same_rows([got], [want])
    n = len(split_sentences(TEXT))  # one job, and one batch, per sentence
    assert [(s["jobs"], s["batches"]) for s in TB.tts_batcher_stats().values()] == [(n, n)]


def test_batch_of_four_matches_jax_and_solo_rows(jtree, model):
    """A batch of four (different lengths, voices, speeds) gives the JAX
    batcher's rows (JAX pads it to its bucket of four); each row equals the
    same request alone."""
    jobs = _jobs(torch_backend(model), ROWS)
    port = TB.TTSBatcher(model, TCFG)
    got = _run(port, jobs)
    want = _run(JB.TTSBatcher(jtree, CFG), jobs)
    _same_rows(got, want)
    assert len({sum(c.size for c in row) for row in got}) >= 3  # lengths differ
    _same_rows(got, [_run(port, [job])[0] for job in jobs])
    assert port.stats == {"batches": 5, "jobs": 8, "peak_batch": 4}


def test_batched_row_on_own_features_close_to_solo(monkeypatch, model):
    """Without the injection each row runs on its own harmonic features:
    the chunk sizes are the solo run's exactly, the audio close to it."""
    monkeypatch.setattr(TM, "har_features", REAL_TORCH_HAR)
    jobs = _jobs(torch_backend(model), ROWS)
    port = TB.TTSBatcher(model, TCFG)
    batch = _run(port, jobs)
    for row, job in zip(batch, jobs):
        alone = _run(port, [job])[0]
        assert [c.shape for c in row] == [c.shape for c in alone]
        a, b = np.concatenate(row), np.concatenate(alone)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < OWN_FEATURES_REL_L2


# ── the scheduler ───────────────────────────────────────────────────────


def test_gather_fast_path_and_cap():
    """An idle arrival launches at once; a burst gathers, at most MAX_BATCH."""
    b = TB.TTSBatcher(None, TCFG)
    b._queue.put("a")
    t0 = time.monotonic()
    assert b._gather() == ["a"] and time.monotonic() - t0 < TB.GATHER_WINDOW_S
    for i in range(TB.MAX_BATCH + 6):
        b._queue.put(i)
    b._last_batch_end = time.monotonic()
    assert b._gather() == list(range(TB.MAX_BATCH))
    assert b._gather() == list(range(TB.MAX_BATCH, TB.MAX_BATCH + 6))


def test_stop_ends_thread_and_drops_the_model(model):
    b = TB.TTSBatcher(model, TCFG)
    style = np.zeros(TCFG.voice_dim, np.float32)
    assert list(b.synthesize(list(range(1, 9)), style, 1.0))
    thread = b._thread
    b.stop()
    thread.join(timeout=30)
    assert not thread.is_alive() and b.model is None
    with pytest.raises(RuntimeError, match="stopped"):
        next(iter(b.synthesize([1], style, 1.0)))


def test_replacing_the_model_stops_the_old_batcher():
    backend = SimpleNamespace(_model=object(), _cfg=TCFG)
    try:
        b1 = TB.get_tts_batcher(backend)
        assert TB.get_tts_batcher(backend) is b1
        backend._model = object()  # a reload
        b2 = TB.get_tts_batcher(backend)
        assert b2 is not b1 and b1._stopping and b2.model is backend._model
    finally:
        TB.reset_tts_batchers()
    assert b2._stopping and TB.tts_batcher_stats() == {}


def test_failing_batch_delivers_its_error_to_every_job(monkeypatch):
    b = TB.TTSBatcher(object(), TCFG)
    entered = threading.Event()
    release = threading.Event()

    def failing(jobs):
        entered.set()
        release.wait(10)
        raise RuntimeError(f"batch of {len(jobs)} failed")

    monkeypatch.setattr(b, "_run_batch", failing)
    style = np.zeros(TCFG.voice_dim, np.float32)
    results = [None] * 4

    def worker(i):
        try:
            list(b.synthesize([1, 2], style, 1.0))
        except RuntimeError as e:
            results[i] = str(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    threads[0].start()
    assert entered.wait(10)  # the first job's batch is running
    for t in threads[1:]:
        t.start()
    deadline = time.monotonic() + 10
    while b._queue.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    release.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert results == ["batch of 1 failed"] + ["batch of 3 failed"] * 3
    thread = b._thread
    b.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_load_warms_the_batcher_and_the_card_is_the_default(monkeypatch, caplog):
    """``load_model`` (random weights seeded 7, warning) runs the warmup
    synthesis and, with the batcher on, one batch of the largest precompile
    bucket's rows. Without a device the backend is for the card, and on a
    host without CUDA its load raises."""
    monkeypatch.setenv("OS_KOKORO_GEOMETRY", "tiny")
    monkeypatch.setenv("OS_KOKORO_CKPT_PATH", "/nonexistent")
    monkeypatch.setattr(torch_settings, "os_tts_batcher_enabled", True)
    monkeypatch.setattr(torch_settings, "os_tts_precompile_buckets", "1,3")
    backend = KokoroBackend(device="cpu")
    monkeypatch.setattr(backend, "_find_checkpoint", lambda: None)
    try:
        backend.load_model("kokoro")
        assert backend.is_model_loaded("kokoro") and backend._cfg == TM.TINY_CONFIG
        assert "random weights" in caplog.text
        stats = list(TB.tts_batcher_stats().values())
        assert stats == [{"batches": 2, "jobs": 4, "peak_batch": 3}]  # warmup, then 3 rows
        assert [m.device for m in backend.loaded_models()] == ["cpu"]
    finally:
        TB.reset_tts_batchers()
    if torch.cuda.is_available():
        return
    card = KokoroBackend()
    assert card.device == torch.device(torch_settings.tts_effective_device) == torch.device("cuda")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        card.load_model("kokoro")
    assert card._model is None


def test_many_threads_each_get_their_own_rows(monkeypatch):
    """Stress: 32 request threads (more than the cores), 5 jobs each, with a
    short switch interval: every job gets exactly its own chunks, in order,
    and the scheduler counts every job."""
    import sys

    b = TB.TTSBatcher(object(), TCFG)

    def echo(jobs):  # a batch that hands each job its own id back, twice
        for ids, _style, _speed, out in jobs:
            out.put(np.full(3, ids[0], np.float32))
            out.put(np.full(2, ids[0], np.float32))
            out.put(None)
        b._count(jobs)

    monkeypatch.setattr(b, "_run_batch", echo)
    style = np.zeros(TCFG.voice_dim, np.float32)
    bad = []

    def worker(t):
        for k in range(5):
            tag = 1000 * t + k
            got = [c.tolist() for c in b.synthesize([tag], style, 1.0)]
            if got != [[tag] * 3, [tag] * 2]:
                bad.append((tag, got))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert bad == [] and b.stats["jobs"] == 160 and b.stats["peak_batch"] > 1
    thread = b._thread
    b.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()
