"""Every idle gap of a traced run put down to what the host was doing, and
the check that the program's spans and the device trace share one clock.

    python -m speechbench.idle_cause --workload <cell> --seed <n> --seconds <s> [--out <file>]

runs the cell once as ``run.py --trace 1`` does, with the program's span
recorder (``open_speech_tpu_torch/runtime/tracing.py``) on from set-up to the
end, keeps the profiler's raw Chrome trace (its CUDA runtime events and
correlation ids, which ``trace.DeviceTrace`` drops), and prints the run's
result line, then one line of JSON: ``idle_by_span`` (the idle seconds of the traced window
summed by name, largest first), ``idle_by_cause`` (the same without the
other threads' part), the longest gaps with their causes, the
clock check, the prompt feed's device time joined through the correlation
ids, and the mean tick and enqueue under the profiler. ``--out`` writes the same JSON to a file.

A gap (no kernel, copy or fill on the device) is named first as
``trace.idle_gaps`` names it, "in a tick" or "between ticks", then by the
op that ends it: "device wait" when the call that launched that op had
returned before the gap began (the op was queued and the device waited),
else the innermost program span open at the gap's start on the thread
that launched it ("no span" if none), then the spans other threads
were in during the gap, as in ``in a tick: tick.enqueue | stt.mel x3``.
A window's wait in the batcher's queue (``batcher.queue``) is no thread's
work and names no gap. The device's ops are first moved onto the
runtime events' clock (``_skew``), which is the spans' clock.
"""

from __future__ import annotations

import argparse
import asyncio
import bisect
import json
import statistics
import sys
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from speechbench import trace as tracing
from speechbench.trace import DEVICE_CATS, DeviceOp, DeviceTrace

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WAITING = ("batcher.queue",)
CLOCK_TOLERANCE_S = 0.5e-3
DTOH_PAGEABLE = "Memcpy DtoH (Device -> Pageable"
HTOD_PAGEABLE = "Memcpy HtoD (Pageable"
HTOD_PINNED = "Memcpy HtoD (Pinned"


@dataclass
class Raw:
    """A profiler Chrome trace on its own clock, in seconds: the device ops in
    order of start, moved onto the runtime events' clock (``skew``), each
    op's correlation id, the runtime calls by correlation id (thread, start,
    end, name) and the profiled window."""

    trace: DeviceTrace
    correlation: list
    launches: dict = field(default_factory=dict)
    window: tuple[float, float] = (0.0, 0.0)
    base_ns: int = 0
    skew: list = field(default_factory=list)  # (host time, device minus host) seconds


def load(data: dict, window_s: float) -> Raw:
    ops, launches, window = [], {}, None
    for ev in data.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        ts, dur = float(ev["ts"]) / 1e6, float(ev.get("dur", 0)) / 1e6
        if ev.get("cat") in DEVICE_CATS:
            grid = args.get("grid")
            ops.append((DeviceOp(ev.get("name", ev["cat"]), ts, dur, tuple(grid) if grid else None),
                        args.get("correlation")))
        elif ev.get("cat") in RUNTIME_CATS and "correlation" in args:
            launches[args["correlation"]] = (ev.get("tid"), ts, ts + dur, ev.get("name", ""))
        elif str(ev.get("name", "")).startswith("PyTorch Profiler"):
            window = (ts, ts + dur)
    ops.sort(key=lambda oc: oc[0].start)
    skew = _skew(ops, launches)
    if skew:
        late = np.interp([op.start for op, _ in ops], [t for t, _ in skew], [d for _, d in skew])
        for (op, _), d in zip(ops, late):
            op.start -= float(d)
    ops.sort(key=lambda oc: oc[0].start)
    trace = DeviceTrace(window_s, [o for o, _ in ops])
    if window is None:
        window = (trace.ops[0].start, max(o.end for o in trace.ops)) if trace.ops else (0.0, 0.0)
    return Raw(trace, [c for _, c in ops], launches, window,
               int(data.get("baseTimeNanoseconds", 0)), skew)


def _skew(ops: list, launches: dict) -> list[tuple[float, float]]:
    """How late the device's timestamps run against the runtime events', at
    each tick's copy of its result to the host: (that call's return, the
    copy's end less the return). A copy into pageable memory returns only
    once it is done, so the two ends meet on one clock. On the card the two
    clocks met at a trace's start and then drifted apart at a steady rate,
    -0.7 to +1.3 ms a second, another in each run, while the runtime events
    kept to the program's spans; ``load`` interpolates between the ticks."""
    out = []
    for op, corr in ops:
        launch = launches.get(corr)
        if launch is not None and op.name.startswith(DTOH_PAGEABLE):
            out.append((launch[2], op.end - launch[2]))
    return sorted(out)


def runtime_tid(ident: int) -> int:
    """The ``tid`` a CUDA runtime event of the thread whose ``pthread_self``
    is ``ident`` carries: that value cut to a signed 32-bit integer, without
    its sign (read off the card's traces)."""
    low = ident & 0xFFFFFFFF
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


def _on_clock(spans: list, base_ns: int) -> list[tuple]:
    """(thread, start, end, name, parent, id) of each span, in trace seconds,
    the thread as the trace's runtime events name it."""
    return [(runtime_tid(s.ident), (s.start_ns - base_ns) / 1e9, (s.end_ns - base_ns) / 1e9,
             s.name, s.parent, s.id) for s in spans]


class _Threads:
    """The work spans of each thread, in order of start. A thread's spans
    nest (a child inside its parent) or follow one another, so the span
    open at a moment is the last one started by then or one of its
    ancestors."""

    def __init__(self, work: list[tuple]) -> None:
        self.by_tid: dict = {}
        for w in sorted(work, key=lambda w: w[1]):
            self.by_tid.setdefault(w[0], []).append(w)
        self.by_id = {w[5]: w for w in work}

    def innermost(self, tid, at: float) -> tuple | None:
        mine = self.by_tid.get(tid, [])
        k = bisect.bisect_right(mine, at, key=lambda w: w[1]) - 1
        w = mine[k] if k >= 0 else None
        while w is not None and w[2] <= at:
            parent = self.by_id.get(w[4])
            w = parent if parent is not None and parent[0] == tid else None
        return w

    def during(self, tid, a: float, b: float) -> tuple | None:
        """The innermost span open at ``a``, else the last one started before ``b``."""
        w = self.innermost(tid, a)
        if w is not None:
            return w
        mine = self.by_tid.get(tid, [])
        k = bisect.bisect_left(mine, b, key=lambda w: w[1]) - 1
        return mine[k] if k >= 0 and mine[k][1] > a else None


def gaps(raw: Raw) -> list[tuple[float, float]]:
    """The stretches of the profiled window with nothing on the device."""
    busy = raw.trace.busy_intervals()
    lo, hi = raw.window
    if not busy:
        return [(lo, hi)] if hi > lo else []
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def attribute(raw: Raw, spans: list) -> list[tuple[str, float, float]]:
    """Each gap of the profiled window as (cause, start, end)."""
    threads = _Threads([w for w in _on_clock(spans, raw.base_ns) if w[3] not in WAITING])
    ticks = raw.trace.ticks()
    tick_starts = [s for s, _ in ticks]
    ops = raw.trace.ops
    out = []
    for a, b in gaps(raw):
        k = bisect.bisect_right(tick_starts, a) - 1
        where = "in a tick" if k >= 0 and b <= ticks[k][1] else "between ticks"
        i = bisect.bisect_left(ops, b, key=lambda o: o.start)
        launch = raw.launches.get(raw.correlation[i]) if i < len(ops) else None
        tid = launch[0] if launch is not None else None
        if launch is not None and launch[2] < a:
            cause = "device wait"
        else:
            span = threads.innermost(tid, a) if tid is not None else max(
                (w for w in (threads.innermost(t, a) for t in threads.by_tid) if w is not None),
                key=lambda w: w[1], default=None)
            cause = span[3] if span is not None else "no span"
        others = Counter()
        for t in threads.by_tid:
            w = threads.during(t, a, b) if t != tid else None
            if w is not None:
                others[w[3]] += 1
        name = f"{where}: {cause}"
        if others:
            name += " | " + " ".join(n if c == 1 else f"{n} x{c}" for n, c in sorted(others.items()))
        out.append((name, a, b))
    return out


def idle_by_span(named: list[tuple[str, float, float]]) -> list[list]:
    totals: Counter = Counter()
    for name, a, b in named:
        totals[name] += b - a
    return [[n, s] for n, s in totals.most_common()]


def _nearest(starts: list[float], at: float) -> int | None:
    k = bisect.bisect_left(starts, at)
    near = [i for i in (k - 1, k) if 0 <= i < len(starts)]
    return min(near, key=lambda i: abs(starts[i] - at)) if near else None


def clock_check(raw: Raw, spans: list) -> dict:
    """For each ``tick.enqueue`` inside the profiled window: how far the
    tick's launches lie outside it on the trace's clock. A tick's launches are its thread's
    runtime calls from the state copy out of pinned memory (the one nearest
    the span's start) up to the copy of its result to the host, which opens
    ``tick.sync``; the device ops they correlate with tell them apart."""
    lo, hi = raw.window
    enqueues = [w for w in _on_clock(spans, raw.base_ns)
                if w[3] == "tick.enqueue" and lo <= w[1] and w[2] <= hi]
    out: dict = {"runtime_events": len(raw.launches), "tick_enqueues": len(enqueues)}
    by_corr = {c: o for o, c in zip(raw.trace.ops, raw.correlation) if c is not None}
    calls: dict = {}
    for corr, (tid, start, end, call) in raw.launches.items():
        op = by_corr.get(corr)
        calls.setdefault(tid, []).append((start, end, op.name if op is not None else "", call))
    pinned: dict = {}
    for tid, mine in calls.items():
        mine.sort()
        pinned[tid] = [i for i, c in enumerate(mine) if c[2].startswith(HTOD_PINNED)]
    early, late, late_start, lead, outside = [], [], [], [], []
    for tid, start, end, *_ in enqueues:
        mine, pins = calls.get(tid, []), pinned.get(tid, [])
        k = _nearest([mine[i][0] for i in pins], start)
        if k is None:
            continue
        opened = pins[k]
        closed = next((i for i in range(opened, len(mine)) if "DtoH" in mine[i][2]), None)
        if closed is None:
            continue
        launched = [c for c in mine[opened:closed] if c[2]]  # the calls that put work on the device
        early.append(start - launched[0][0])
        late.append(max(c[1] for c in launched) - end)
        late_start.append(max(c[0] for c in launched) - end)
        lead.append(launched[0][0] - start)
        outside += [(c[3], c[0] - end, c[1] - end) for c in launched
                    if c[1] - end > CLOCK_TOLERANCE_S or start - c[0] > CLOCK_TOLERANCE_S][:3]
    if early:
        out.update(ticks_checked=len(early), launch_before_span_max_s=max(early),
                   launch_after_span_max_s=max(late), launch_start_after_span_max_s=max(late_start),
                   first_launch_lead_median_s=statistics.median(lead),
                   within_tolerance=sum(e <= CLOCK_TOLERANCE_S and l <= CLOCK_TOLERANCE_S
                                        for e, l in zip(early, late)),
                   outside=outside[:9])
    return out


def feeds(raw: Raw, spans: list) -> list[dict]:
    """Each ``admit.feed`` inside the profiled window: its host time, the
    device time of the ops its thread launched during it (joined through
    the correlation ids), its decode steps, and the launches whose device
    op the trace lacks."""
    lo, hi = raw.window
    by_corr = {c: o for o, c in zip(raw.trace.ops, raw.correlation) if c is not None}
    calls: dict = {}
    for corr, (tid, start, _, name) in raw.launches.items():
        if "Launch" in name or "Memcpy" in name or "Memset" in name:
            calls.setdefault(tid, []).append((start, corr))
    for v in calls.values():
        v.sort()
    out = []
    for tid, start, end, name, *_ in _on_clock(spans, raw.base_ns):
        if name != "admit.feed" or not (lo <= start and end <= hi):
            continue
        mine = calls.get(tid, [])
        inside = mine[bisect.bisect_left(mine, (start,)):bisect.bisect_right(mine, (end, float("inf")))]
        joined = [by_corr[c] for _, c in inside if c in by_corr]
        # a step copies its tokens and its positions to the device
        steps = sum(o.name.startswith(HTOD_PAGEABLE) for o in joined) // 2
        out.append({"host_ms": 1e3 * (end - start), "joined_ms": 1e3 * sum(o.dur for o in joined),
                    "steps": steps, "launches": len(inside), "missing": len(inside) - len(joined)})
    return out


def _mean_ms(raw: Raw, spans: list, name: str) -> float | None:
    """The mean host time of the spans named ``name`` inside the profiled window."""
    lo, hi = raw.window
    times = [b - a for _, a, b, n, *_ in _on_clock(spans, raw.base_ns) if n == name and lo <= a and b <= hi]
    return 1e3 * statistics.fmean(times) if times else None


def analyse(data: dict, spans: list, window_s: float) -> dict:
    raw = load(data, window_s)
    lo, hi = (raw.base_ns + 1e9 * t for t in raw.window)
    spans = [s for s in spans if s.end_ns > lo and s.start_ns < hi]
    named = attribute(raw, spans)
    by_span = idle_by_span(named)
    idle = sum(b - a for _, a, b in named)
    by_cause: Counter = Counter()
    for name, seconds in by_span:
        by_cause[name.split(" | ")[0]] += seconds
    waits = [b - a for n, a, b in named if n.split(" | ")[0].endswith("device wait")]
    return {
        "idle_by_span": by_span,
        "device_wait_gaps": [len(waits), statistics.fmean(waits) if waits else None],
        "idle_by_cause": by_cause.most_common(),
        "idle_gaps": [[n, b - a] for n, a, b in sorted(named, key=lambda g: g[1] - g[2])[:10]],
        "idle_s": idle,
        "trace_window_s": raw.window[1] - raw.window[0],
        "host_window_s": window_s,
        "busy_s": raw.trace.busy_s(),
        "base_ns": raw.base_ns,
        "skew_s": raw.skew,
        "clock": clock_check(raw, spans),
        "feeds": feeds(raw, spans),
        "spans": Counter(s.name for s in spans),
        "tick_ms_profiled": _mean_ms(raw, spans, "batcher.tick"),
        "enqueue_ms_profiled": _mean_ms(raw, spans, "tick.enqueue"),
    }


def main(argv: list[str] | None = None) -> int:
    from open_speech_tpu_torch.runtime import tracing as recorder
    from speechbench.run import run_cell
    from speechbench.spec import Spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    kept: dict = {}
    parse = tracing.parse_chrome_trace

    def keep(path: str, window_s: float):
        with open(path) as f:
            kept["data"], kept["window_s"] = json.load(f), window_s
        return parse(path, window_s)

    tracing.parse_chrome_trace = keep
    recorder.start()
    try:
        result = asyncio.run(run_cell(Spec.load(), args.workload, args.seed, args.seconds, True))
    finally:
        tracing.parse_chrome_trace = parse
        spans = recorder.stop()
    report = analyse(kept["data"], spans, kept["window_s"])
    report["spans_dropped"] = recorder.dropped()
    print(json.dumps(result), flush=True)
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"result": result, "report": report}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
