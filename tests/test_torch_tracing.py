"""The port's host spans and batcher counters (``runtime/tracing.py``), on the CPU.

A random test-tiny model (``init_params`` from a seeded generator, float32)
behind the shared batcher pool serves PCM windows through
``transcribe_pcm_batched``, all submitted at once, with the recorder off
and on. Checked: the recorder off keeps nothing and serves the same tokens;
on, each window's spans, the admissions' sizes, the tick's phases nested on
one thread, the counters against the spans; a profiler ``record_function``
range opened inside a span lands inside it, within 1 ms, on the trace's
clock (``ts`` in microseconds from ``baseTimeNanoseconds``); a profiler
alone does not turn recording on; the cap counts what it drops.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import threading

import numpy as np
import pytest
import torch

from open_speech_tpu_torch.models.whisper import FallbackTokenizer
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.runtime import batcher_pool as TP
from open_speech_tpu_torch.runtime import tracing

TCFG = TM.PRESETS["test-tiny"]
WINDOWS = 7


class _Backend:
    def __init__(self, entry):
        self._models = {"m": entry}

    def _ensure_model(self, model_id):
        return self._models[model_id]


@pytest.fixture(scope="module")
def backend():
    model = TM.init_params(torch.Generator().manual_seed(0), TCFG)
    tok = FallbackTokenizer(n_vocab=TCFG.n_vocab, n_langs=TCFG.n_langs)
    return _Backend({"model": model, "cfg": TCFG, "tok": tok})


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.stop()
    yield
    tracing.stop()


def _serve(backend, monkeypatch, record: bool):
    """Texts of WINDOWS windows submitted at once, the recorded spans and the
    batcher's stats."""
    monkeypatch.setattr(TP.settings, "os_batch_max_sessions", 3)
    rng = np.random.default_rng(11)
    pcms = [rng.uniform(-0.3, 0.3, int(16000 * (0.4 + 0.2 * i))).astype(np.float32)
            for i in range(WINDOWS)]
    TP.reset_pool()

    async def go():
        try:
            texts = await asyncio.wait_for(asyncio.gather(
                *(TP.transcribe_pcm_batched(backend, "m", "en", p) for p in pcms)), 120)
            return texts, await TP.get_batcher(backend, "m", "en")
        finally:
            await TP.shutdown_batchers()

    if record:
        tracing.start()
    # read after asyncio.run, which waits for the executor: the last tick
    # wakes its caller before it counts itself and ends its span
    texts, batcher = asyncio.run(go())
    return [t["text"] for t in texts], tracing.stop(), dict(batcher.stats)


@pytest.fixture(scope="module")
def runs(backend):
    mp = pytest.MonkeyPatch()
    try:
        off = _serve(backend, mp, False)
        on = _serve(backend, mp, True)
    finally:
        mp.undo()
        TP.reset_pool()
    return off, on


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_keeps_nothing_and_serves_the_same_tokens(runs):
    (texts_off, spans_off, stats_off), (texts_on, spans_on, stats_on) = runs
    assert spans_off == [] and spans_on
    assert texts_off == texts_on and any(texts_on)
    assert stats_off["tokens"] == stats_on["tokens"] > 0


def _window_ids(spans):
    return sorted(s.ids[0] for s in _named(spans, "stt.mel"))


def test_every_window_has_one_mel_and_one_queue_span(runs):
    spans = runs[1][1]
    ids = _window_ids(spans)
    assert len(ids) == WINDOWS == len(set(ids))
    assert sorted(s.ids[0] for s in _named(spans, "batcher.queue")) == ids
    mels = {s.ids[0]: s for s in _named(spans, "stt.mel")}
    for s in _named(spans, "batcher.queue"):  # the mel is made before the window is queued
        assert len(s.ids) == 1 and mels[s.ids[0]].end_ns <= s.start_ns <= s.end_ns


def test_a_wrapped_batcher_call_keeps_its_window_id(backend, monkeypatch):
    """A caller that wraps ``transcribe_window`` with its own signature (as
    ``chip_smoke.py``'s S3 does) still serves with the recorder on, and the
    queue spans still carry the ids of the windows' mel spans."""
    real = TP.ContinuousBatcher.transcribe_window
    calls = []

    async def counted(self, mel, max_new_tokens=None):
        calls.append(max_new_tokens)
        return await real(self, mel, max_new_tokens=max_new_tokens)

    monkeypatch.setattr(TP.ContinuousBatcher, "transcribe_window", counted)
    try:
        texts, spans, _ = _serve(backend, monkeypatch, True)
    finally:
        TP.reset_pool()
    assert len(calls) == len(texts) == WINDOWS
    ids = _window_ids(spans)
    assert len(set(ids)) == WINDOWS
    assert sorted(s.ids[0] for s in _named(spans, "batcher.queue")) == ids


def test_admissions_list_their_windows(runs):
    spans, stats = runs[1][1], runs[1][2]
    admits = _named(spans, "batcher.admit")
    assert admits and all(a.size == len(a.ids) >= 1 for a in admits)
    assert sum(a.size for a in admits) == WINDOWS
    assert sorted(i for a in admits for i in a.ids) == _window_ids(spans)
    waits = {s.ids[0]: s for s in _named(spans, "batcher.queue")}
    for a in admits:  # a window's wait ends before its admission starts
        assert all(waits[i].end_ns <= a.start_ns for i in a.ids)
    assert max(a.size for a in admits) <= 3  # the slots
    for a in admits:
        encode, feed = [s for s in spans if s.parent == a.id]
        assert (encode.name, feed.name) == ("admit.encode", "admit.feed")
        assert a.start_ns <= encode.start_ns <= encode.end_ns <= feed.start_ns <= feed.end_ns <= a.end_ns
        assert encode.tid == feed.tid == a.tid and encode.ids == feed.ids == a.ids


def test_tick_phases_nest_on_one_thread(runs):
    spans = runs[1][1]
    ticks = _named(spans, "batcher.tick")
    assert ticks
    for t in ticks:
        parts = sorted((s for s in spans if s.parent == t.id), key=lambda s: s.start_ns)
        assert [s.name for s in parts] == ["tick.enqueue", "tick.sync", "tick.drain"]
        assert all(s.tid == t.tid for s in parts)
        edges = [t.start_ns] + [x for s in parts for x in (s.start_ns, s.end_ns)] + [t.end_ns]
        assert edges == sorted(edges)


def test_counters_match_the_spans(runs):
    spans, stats = runs[1][1], runs[1][2]
    admits = _named(spans, "batcher.admit")
    assert stats["admissions"] == len(admits)
    assert stats["admitted"] == sum(a.size for a in admits) == stats["completed"] == WINDOWS
    ticks = _named(spans, "batcher.tick")
    assert stats["ticks"] == len(ticks)
    assert stats["tokens"] == sum(t.size for t in ticks)
    assert runs[0][2]["admissions"] >= 1  # counted with the recorder off too


def test_a_span_lands_on_its_profiler_event_after_the_base_conversion(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    tracing.start()
    try:
        span = tracing.begin("probe")
        with record_function("probe"):
            torch.ones(64).sum()
        tracing.end(span)
    finally:
        assert tracing.stop() == [span]
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    [ev] = [e for e in trace["traceEvents"] if e.get("name") == "probe"]
    # the range, opened inside the span, lands inside it on the trace's clock
    start = base + ev["ts"] * 1e3
    assert span.start_ns - 1e6 <= start <= start + ev["dur"] * 1e3 <= span.end_ns + 1e6
    assert ev["tid"] == span.tid
    [mine] = tracing.chrome_events([span], base, 0)
    assert mine["ts"] <= ev["ts"] + 1e3 and mine["tid"] == ev["tid"]
    assert not tracing.on()


def test_a_profiler_alone_does_not_turn_recording_on():
    """A profiler started on a thread of its own (as the benchmark's is)
    leaves the recorder off on every thread: a traced run of the program
    pays for no span unless ``start()`` ran."""
    from torch.profiler import ProfilerActivity, profile

    pool = concurrent.futures.ThreadPoolExecutor(1)
    prof = profile(activities=[ProfilerActivity.CPU])
    seen = []
    try:
        pool.submit(prof.start).result(30)
        other = threading.Thread(target=lambda: seen.append(tracing.on()))
        other.start()
        other.join(30)
        seen.append(tracing.on())
    finally:
        pool.submit(prof.stop).result(30)
        pool.shutdown()
    assert seen == [False, False]
    tracing.start()
    assert tracing.stop() == []


def test_the_cap_counts_drops_and_a_span_across_a_stop_is_not_kept():
    tracing.start(cap=3)
    for i in range(5):
        tracing.end(tracing.begin(f"s{i}"))
    open_span = tracing.begin("across")
    assert [s.name for s in tracing.stop()] == ["s0", "s1", "s2"]
    assert tracing.dropped() == 2
    tracing.start()
    tracing.end(open_span)
    assert tracing.stop() == [] and tracing.dropped() == 0
