"""The process's own clock: seconds since it started, and timed notes on
standard error, so a run's log shows where its set-up went."""

from __future__ import annotations

import os
import sys
import time

_IMPORTED_AT = time.perf_counter()


def since_process_start() -> float:
    """Seconds since this process started, by the kernel's clock of it."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


def note(msg: str) -> None:
    print(f"[{since_process_start():8.3f} s] {msg}", file=sys.stderr, flush=True)
