"""The benchmark's own spans around calls into the program, and the reading
of the profiler's device trace.

Spans: ``instrument`` wraps the continuous batcher's ``_admit_device`` (the
encoder and the prompt feed of the windows it admits) and ``_tick`` (its
decode steps, ending in the tick's one host sync). Both run on executor
threads, and never at once. Each span keeps its host clock interval and its
size: windows admitted, or tokens the tick appended.

Device trace: ``torch.profiler`` over a sub-window, exported as a Chrome
trace and read on the device's own timeline, with no reference to the host
clock (the trace's host timestamps did not line up with the spans' from run
to run). The batcher's work is one stream in order: a tick opens with the
copy of its state from pinned memory and closes with the copy of its result
to the host, and what runs between two ticks is the next admission (and the
requests' mel front ends). K1's launches carry their shape in their grid
(query blocks, heads, windows).
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Span:
    name: str  # "admit" or "tick"
    start: float  # perf_counter seconds
    end: float
    size: int  # windows admitted, or tokens appended


def instrument(batcher_cls, spans: list[Span]):
    """Record a span per ``_admit_device`` and ``_tick`` call of every
    batcher of ``batcher_cls``. Returns the function that undoes it."""
    admit, tick = batcher_cls._admit_device, batcher_cls._tick

    @functools.wraps(admit)
    def _admit_device(self, batch):
        t0 = time.perf_counter()
        try:
            return admit(self, batch)
        finally:
            spans.append(Span("admit", t0, time.perf_counter(), len(batch)))

    @functools.wraps(tick)
    def _tick(self):
        t0, tokens = time.perf_counter(), self.stats["tokens"]
        try:
            return tick(self)
        finally:
            spans.append(Span("tick", t0, time.perf_counter(), self.stats["tokens"] - tokens))

    batcher_cls._admit_device, batcher_cls._tick = _admit_device, _tick

    def undo() -> None:
        batcher_cls._admit_device, batcher_cls._tick = admit, tick

    return undo


@dataclass
class DeviceOp:
    name: str
    start: float  # seconds on the trace's clock
    dur: float  # seconds
    grid: tuple | None = None  # a kernel's launch grid

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class DeviceTrace:
    window_s: float  # the profiled window's length on the host clock
    ops: list[DeviceOp] = field(default_factory=list)  # in order of start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device activity, merged."""
        merged: list[list[float]] = []
        for o in self.ops:
            if merged and o.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], o.end)
            elif o.dur > 0:
                merged.append([o.start, o.end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return min(self.window_s, sum(b - a for a, b in self.busy_intervals()))

    def ticks(self) -> list[tuple[float, float]]:
        """The batcher's ticks seen whole: from a state copy out of pinned
        memory to the next copy to the host."""
        out, opened = [], None
        for o in self.ops:
            if "HtoD" in o.name and "Pinned" in o.name:
                opened = o.start
            elif "DtoH" in o.name and opened is not None:
                out.append((opened, o.end))
                opened = None
        return out

    def between_ticks(self) -> list[tuple[float, float]]:
        """What runs between two ticks seen whole: an admission, mel front ends."""
        ticks = self.ticks()
        return [(a[1], b[0]) for a, b in zip(ticks, ticks[1:])]

    def ops_in(self, interval: tuple[float, float]) -> list[DeviceOp]:
        a, b = interval
        return [o for o in self.ops if a <= o.start and o.end <= b]


def parse_chrome_trace(path: str, window_s: float) -> DeviceTrace:
    """The device ops of a profiler Chrome trace, in order of start."""
    with open(path) as f:
        data = json.load(f)
    ops = []
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            grid = (ev.get("args") or {}).get("grid")
            ops.append(DeviceOp(ev.get("name", ev["cat"]), float(ev["ts"]) / 1e6,
                                float(ev.get("dur", 0)) / 1e6, tuple(grid) if grid else None))
    ops.sort(key=lambda o: o.start)
    return DeviceTrace(window_s, ops)


class Profiler:
    """``torch.profiler`` over CPU and CUDA, started and stopped on one thread
    of its own (the profiler's results belong to the thread that started
    it); ``read`` gives the stopped profile's ``DeviceTrace``."""

    def __init__(self) -> None:
        import concurrent.futures

        self.thread = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="profiler")
        self._prof = None
        self._start = self._end = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._start = time.perf_counter()

    def stop(self) -> None:
        self._end = time.perf_counter()
        self._prof.stop()

    def read(self) -> DeviceTrace:
        """The stopped profile's device trace (export and parse: seconds of
        host work, so after the window)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return parse_chrome_trace(path, self._end - self._start)
        finally:
            os.remove(path)
            self._prof = None
            self.thread.shutdown()


def idle_gaps(trace: DeviceTrace, top: int = 10) -> list[list]:
    """The longest stretches with nothing on the device, each named by the
    batcher work around it on the device's timeline."""
    busy = trace.busy_intervals()
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    ticks = trace.ticks()
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inside = any(s <= a and b <= e for s, e in ticks)
        named.append(["in a tick" if inside else "between ticks", b - a])
    return named


def top_device_ops(trace: DeviceTrace, top: int = 10) -> list[list]:
    totals: dict[str, float] = {}
    for o in trace.ops:
        totals[o.name[:120]] = totals.get(o.name[:120], 0.0) + o.dur
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]
