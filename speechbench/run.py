"""Runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python -m speechbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, weights from the seed, the batcher and the
cell's own admission sizes) ends when the first timed request is sent; that
moment, counted from the process's start, is ``setup_s``. The window then
runs the cell's traffic for ``--seconds``; requests still in flight at its
close are waited for (a minute at most) and count in the latency tail. With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer ones, and the profiler covers the window's last
``trace_s`` seconds (spans and counters are read over the part before it).
Then the program is freed, the reference judges a sample of the windows,
and the compared numbers are printed beside their limits, last, on standard
error and in the line.

``--control fp8`` judges, in the program's place, the reference's own fp8
copy at the same positions of the same sampled windows (one precision below
the configuration's bf16): the control that a sound limit must fail. The
program's own reading is printed beside it. The benchmark's own runs never
pass it.

Exit codes: 0 with a result; 2 when the card or the cards the cell asks for
are missing, or when the process ends up holding a module of JAX or of the
JAX package (no result is printed then).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass

from speechbench import flops, trace as tracing, traffic as traffic_gen
from speechbench.clock import note, since_process_start
from speechbench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "open_speech_tpu")
STRAGGLER_S = 60.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``open_speech_tpu_torch`` is neither)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Run:
    """What one run recorded; each metric module reads what it needs."""

    cell: dict
    config: dict
    traffic: dict
    seconds: float
    t0: float  # the window's open, perf_counter seconds
    counted_until: float  # spans and counters are read in [t0, counted_until]
    setup_s: float
    requests: list  # traffic.Request, every one sent, the pre-roll's too
    spans: list  # trace.Span of the window
    steps_per_tick: int
    slots: int
    prompt_len: int
    peaks: dict | None
    trace: tracing.DeviceTrace | None = None

    @property
    def t_end(self) -> float:
        return self.t0 + self.seconds

    def counted_spans(self, name: str) -> list:
        return [s for s in self.spans
                if s.name == name and self.t0 <= s.start and s.end <= self.counted_until]

    def start_of(self, req) -> float:
        """When a request counts from: its call, or in an open loop the
        moment it was due."""
        return req.due_at if self.traffic["loop"] == "open" else req.sent

    def in_window(self, req) -> bool:
        return self.t0 <= self.start_of(req) < self.t_end

    def latency_s(self, req) -> float:
        return req.done - self.start_of(req)


async def _one(entry, req) -> None:
    try:
        req.served = await entry.call(req)
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        req.error = f"{type(e).__name__}: {e}"
    finally:
        req.done = time.perf_counter()


async def _open_loop(entry, plan, ts: float, tasks: list) -> None:
    for req in plan.requests:
        req.due_at = ts + req.due
        wait = req.due_at - time.perf_counter()
        if wait > 0:
            await asyncio.sleep(wait)
        req.sent = time.perf_counter()
        tasks.append(asyncio.create_task(_one(entry, req)))


async def _session(entry, reqs, start_at: float, end: float, think: float) -> None:
    """One caller of a closed loop; each request is due when the last one's
    transcript came back and ``think`` passed."""
    due = start_at
    for req in reqs:
        await asyncio.sleep(max(0.0, due - time.perf_counter()))
        if time.perf_counter() >= end:
            return
        req.due_at, req.sent = due, time.perf_counter()
        await _one(entry, req)
        due = req.done + think


async def _profile(prof: tracing.Profiler, at: float, end: float) -> None:
    loop = asyncio.get_running_loop()
    await asyncio.sleep(max(0.0, at - time.perf_counter()))
    await loop.run_in_executor(prof.thread, prof.start)
    await asyncio.sleep(max(0.0, end - time.perf_counter()))
    await loop.run_in_executor(prof.thread, prof.stop)


async def drive(entry, plan, traffic: dict, ts: float, seconds: float,
                prof: tracing.Profiler | None = None) -> tuple[float, float]:
    """Sends ``plan``'s requests through ``entry`` from ``ts``: the pre-roll,
    then a window of ``seconds``, and waits for what is in flight at its
    close (a minute at most). With ``prof``, profiles the window's last
    ``trace_s`` seconds. Returns the window's open and the end of the part
    of it that spans and counters are read over: its close, or the
    profiler's start."""
    t0 = ts + plan.preroll_s
    end = t0 + seconds
    tasks: list[asyncio.Task] = []
    drivers = []
    if plan.loop == "open":
        drivers.append(asyncio.create_task(_open_loop(entry, plan, ts, tasks)))
    else:
        think = float(traffic.get("think_s", 0))
        drivers += [asyncio.create_task(_session(entry, reqs, ts + start, end, think))
                    for reqs, start in zip(plan.sessions, plan.starts)]
    counted_until = end
    if prof is not None:
        counted_until = max(t0, end - float(traffic["trace_s"]))
        drivers.append(asyncio.create_task(_profile(prof, counted_until, end)))
    await asyncio.wait(drivers, timeout=end + STRAGGLER_S - time.perf_counter())
    pending = [t for t in tasks if not t.done()]
    if pending:
        await asyncio.wait(pending, timeout=max(0.0, end + STRAGGLER_S - time.perf_counter()))
    late = [t for t in drivers + tasks if not t.done()]
    for t in late:
        t.cancel()
    await asyncio.gather(*late, return_exceptions=True)
    entry.synchronize()
    return t0, counted_until


async def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float, trace: bool,
                   device: str = "cuda", control: str | None = None) -> dict:
    """One run of a cell; returns the result line as a dict."""
    cell = spec.cell(cell_name)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    checks = spec.checks(cell_name)
    note(f"{cell_name}: seed {seed}, {seconds} s, trace {int(trace)}")
    entry = spec.entry(traffic["entry"]).Entry(config, traffic, seed, device)
    note("program set up")
    spans: list[tracing.Span] = []
    undo = tracing.instrument(entry.batcher_cls, spans)
    # a device trace comes from the card alone: no CPU number under a device metric
    prof = tracing.Profiler() if trace and device.startswith("cuda") else None
    try:
        await entry.warm()
        note("warmed")
        if prof is not None:  # the profiler's own start-up belongs to set-up
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(prof.thread, prof.start)
            entry.synchronize()
            await loop.run_in_executor(prof.thread, prof.stop)
        plan = traffic_gen.plan(traffic, seed, seconds)
        entry.reset_memory_peak()
        spans.clear()
        setup_s = since_process_start() + plan.preroll_s
        note(f"sending: the window opens in {plan.preroll_s} s")
        t0, counted_until = await drive(entry, plan, traffic, time.perf_counter(), seconds, prof)
        note("window closed, stragglers in")
        memory_peak = entry.memory_peak_bytes()
        device_trace = prof.read() if prof is not None else None
        if device_trace is not None:
            note(f"trace: {len(device_trace.ops)} device ops, {len(device_trace.ticks())} "
                 f"whole ticks in {device_trace.window_s:.3f} s")
        sent = [r for r in plan.all_requests() if r.sent is not None]
        run = Run(cell, config, traffic, seconds, t0, counted_until, setup_s, sent,
                  [s for s in spans if s.start >= t0], entry.steps_per_tick,
                  int(traffic["slots"]), len(entry.prompt), flops.peak(device_kind(device)),
                  device_trace)
        metrics = {}
        for m in spec.metrics(cell_name, trace):
            value = spec.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    finally:
        undo()
        await entry.close()
    note("metrics read, program freed")
    finished = [r for r in sent if r.served is not None]
    numbers = entry.check(finished, int(checks["sample"]), control)
    note("reference checked")
    failed = len(sent) - len(finished)
    numbers["failed"] = failed
    compared = {name: {"value": numbers[name], "limit": limit}
                for name, limit in checks["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": device_kind(device), "count": int(cell["chips"]),
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(sent), "failed": failed,
              "metrics": metrics, "device": dev}
    if device_trace is not None:
        dev["busy_s"] = device_trace.busy_s()
        dev["window_s"] = device_trace.window_s
        result["breakdown"] = {"device_ops": tracing.top_device_ops(device_trace),
                               "idle_gaps": tracing.idle_gaps(device_trace)}
    errors = sorted({r.error for r in sent if r.error})
    if errors:
        print("request errors: " + "; ".join(errors[:5]), file=sys.stderr)
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in compared.items()}
    return result


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def device_kind(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8",), default=None)
    args = p.parse_args(argv)
    spec = Spec.load()
    cell = spec.cell(args.workload)
    import torch

    note(f"torch {torch.__version__} imported")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = asyncio.run(run_cell(spec, args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", args.control))
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was imported: {', '.join(bad[:20])}", file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
