"""Serving metrics (no reference counterpart — SURVEY §5 calls this out).

The reference has no tracing/metrics beyond ad-hoc log lines; this module
adds the production surface: request counters, STT real-time-factor, TTS
time-to-first-audio percentiles, streaming session gauges — exposed as
Prometheus text at /metrics and JSON at /api/stats.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class _Histogram:
    """Fixed-window reservoir for percentile summaries."""

    def __init__(self, max_samples: int = 2048):
        self._samples: list[float] = []
        self._max = max_samples
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if len(self._samples) >= self._max:
            self._samples.pop(0)
        self._samples.append(value)

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        data = sorted(self._samples)
        idx = min(len(data) - 1, int(q / 100.0 * len(data)))
        return data[idx]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.started_at = time.time()
        self.counters: dict[str, int] = defaultdict(int)
        self.gauges: dict[str, float] = defaultdict(float)
        self.histograms: dict[str, _Histogram] = defaultdict(_Histogram)

    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self.counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self.histograms[name].observe(value)

    def record_stt(self, audio_seconds: float, wall_seconds: float) -> None:
        self.inc("stt_requests_total")
        self.observe("stt_wall_seconds", wall_seconds)
        self.observe("stt_audio_seconds", audio_seconds)
        if wall_seconds > 0:
            self.observe("stt_rtfx", audio_seconds / wall_seconds)

    def record_tts(
        self, ttfa_seconds: float, audio_seconds: float, wall_seconds: float
    ) -> None:
        self.inc("tts_requests_total")
        self.observe("tts_ttfa_seconds", ttfa_seconds)
        if wall_seconds > 0 and audio_seconds > 0:
            self.observe("tts_rtfx", audio_seconds / wall_seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_seconds": round(time.time() - self.started_at, 1),
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {
                    k: h.summary() for k, h in self.histograms.items()
                },
            }

    def prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, histogram summaries)."""
        lines: list[str] = []
        snap = self.snapshot()
        for name, value in snap["counters"].items():
            lines.append(f"# TYPE open_speech_{name} counter")
            lines.append(f"open_speech_{name} {value}")
        typed: set[str] = set()
        for name, value in snap["gauges"].items():
            base = name.split("{", 1)[0]  # labeled gauges share one TYPE line
            if base not in typed:
                typed.add(base)
                lines.append(f"# TYPE open_speech_{base} gauge")
            lines.append(f"open_speech_{name} {value}")
        for name, summary in snap["histograms"].items():
            base = f"open_speech_{name}"
            lines.append(f"# TYPE {base} summary")
            for q in ("p50", "p90", "p99"):
                lines.append(
                    f"{base}{{quantile=\"0.{q[1:]}\"}} {summary[q]:.6f}"
                )
            lines.append(f"{base}_count {summary['count']}")
            lines.append(f"{base}_sum {summary['mean'] * summary['count']:.6f}")
        lines.append(
            f"open_speech_uptime_seconds {snap['uptime_seconds']}"
        )
        return "\n".join(lines) + "\n"


metrics = Metrics()
