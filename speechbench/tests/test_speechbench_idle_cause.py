"""The idle gaps' host causes (``idle_cause.py``) on a hand-made Chrome trace
and hand-made program spans, and the benchmark's own runs, which leave the
program's span recorder off."""

from __future__ import annotations

from dataclasses import dataclass

import pytest

from speechbench import idle_cause
from speechbench.tests.conftest import run_tiny

BASE = 10**18  # the hand-made trace's baseTimeNanoseconds


@dataclass
class _Span:
    name: str
    start_ns: int
    end_ns: int
    tid: int = 11
    parent: int = 0
    id: int = 0
    ids: tuple = ()
    size: int | None = None

    @property
    def ident(self) -> int:  # pthread_self as small as the runtime events' tid
        return self.tid


def _at(us: float) -> int:
    """A hand-made trace's ``ts`` (microseconds) as a span's realtime ns."""
    return BASE + int(us * 1e3)


@pytest.mark.parametrize("cell", ["tiny-open", "tiny-closed"])
def test_the_benchmark_runs_leave_the_recorder_off(tiny_spec, monkeypatch, cell):
    from open_speech_tpu_torch.runtime import tracing

    opened = []
    begin = tracing.begin
    monkeypatch.setattr(tracing, "begin", lambda *a, **k: opened.append(a[0]) or begin(*a, **k))
    out = run_tiny(tiny_spec, cell, trace=True)
    assert out["correct"], out["checks"]
    assert opened == [] and not tracing.on()


def _chrome():
    """One tick (pinned copy in at 100 us, result out at 450-460) on thread
    11, a mel on thread 12, a kernel after the tick launched by thread 13
    outside any span; the profiled window 0-1000 us."""
    dev = [("Memcpy HtoD (Pinned -> Device)", 100, 10, 1), ("gemv", 200, 50, 2),
           ("gemm", 400, 20, 3), ("Memcpy DtoH (Device -> Pageable)", 450, 10, 4),
           ("encoder", 800, 50, 5)]
    # (thread, start, correlation, duration): gemv's launch call begins before the gap
    # it ends and returns inside it, so the host was still launching
    # (the result's copy to the host returns when it is done, at 460)
    calls = [(11, 95, 1, 5), (11, 105, 2, 50), (11, 170, 3, 4), (11, 430, 4, 30), (13, 790, 5, 4)]
    events = [{"ph": "X", "cat": "kernel" if "Memcpy" not in n else "gpu_memcpy", "name": n,
               "ts": ts, "dur": dur, "pid": 0, "tid": 7, "args": {"correlation": c}}
              for n, ts, dur, c in dev]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": dur,
                "pid": 1, "tid": tid, "args": {"correlation": c}} for tid, ts, c, dur in calls]
    events.append({"ph": "X", "cat": "user_annotation", "name": "PyTorch Profiler (0)",
                   "ts": 0, "dur": 1000, "pid": 1, "tid": 1})
    spans = [_Span("batcher.tick", _at(85), _at(475), 11, 0, 1),
             _Span("tick.enqueue", _at(90), _at(180), 11, 1, 2),
             _Span("tick.sync", _at(180), _at(470), 11, 1, 3),
             _Span("stt.mel", _at(105), _at(300), 12, 0, 4),
             _Span("batcher.queue", _at(0), _at(1000), 10, 0, 99)]
    return {"traceEvents": events, "baseTimeNanoseconds": BASE}, spans


def test_idle_gaps_are_put_down_to_the_host():
    data, spans = _chrome()
    named = idle_cause.attribute(idle_cause.load(data, 1e-3), spans)
    got = [(n, round((b - a) * 1e6)) for n, a, b in named]
    assert got == [
        ("between ticks: no span", 100),
        ("in a tick: tick.enqueue | stt.mel", 90),  # still launching, inside the enqueue
        ("in a tick: device wait | stt.mel", 150),  # launched (call returned) before the gap
        ("in a tick: tick.sync", 30),
        ("between ticks: no span | tick.sync", 340),  # thread 13, in no span
        ("between ticks: no span", 150),  # nothing ends it
    ]


def test_idle_by_span_sums_to_the_idle_time():
    data, spans = _chrome()
    report = idle_cause.analyse(data, spans, 1e-3)
    raw = idle_cause.load(data, 1e-3)
    idle = 1e-3 - raw.trace.busy_s()
    assert sum(s for _, s in report["idle_by_span"]) == pytest.approx(idle) == pytest.approx(860e-6)
    assert report["idle_by_span"][0] == ["between ticks: no span | tick.sync", pytest.approx(340e-6)]
    assert report["idle_by_span"][1] == ["between ticks: no span", pytest.approx(250e-6)]


def test_runtime_event_threads_are_pthread_ids_cut_to_32_bits():
    assert idle_cause.runtime_tid(140276503470848) == 1423383808  # read off a card's trace
    assert idle_cause.runtime_tid(140262407919296) == 1660933824
    assert idle_cause.runtime_tid(1660933824) == 1660933824


def test_the_device_clock_is_moved_onto_the_launches():
    data, spans = _chrome()

    def causes(raw):
        return [(n, round((b - a) * 1e6, 3)) for n, a, b in idle_cause.attribute(raw, spans)]

    want = causes(idle_cause.load(data, 1e-3))
    for ev in data["traceEvents"]:
        if ev["cat"] in ("kernel", "gpu_memcpy"):
            ev["ts"] += 700  # the device's timestamps 0.7 ms late
    raw = idle_cause.load(data, 1e-3)
    assert raw.skew == [(pytest.approx(460e-6), pytest.approx(700e-6))]
    assert causes(raw) == want


def test_the_clock_check_and_the_joined_feed():
    data, spans = _chrome()
    raw = idle_cause.load(data, 1e-3)
    clock = idle_cause.clock_check(raw, spans)
    assert clock["ticks_checked"] == 1 and clock["within_tolerance"] == 1
    assert clock["first_launch_lead_median_s"] == pytest.approx(5e-6)
    assert clock["launch_after_span_max_s"] == pytest.approx(-6e-6)
    assert clock["launch_start_after_span_max_s"] == pytest.approx(-10e-6)
    feed = [_Span("admit.feed", _at(100), _at(180), 11, 0, 5)]
    [got] = idle_cause.feeds(raw, feed)  # gemv's 50 us and gemm's 20
    assert got["joined_ms"] == pytest.approx(0.07)
    assert (got["steps"], got["launches"], got["missing"]) == (0, 2, 0)
