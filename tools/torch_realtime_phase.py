#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` (the realtime socket and Wyoming) alone on the card.

    python3 tools/torch_realtime_phase.py

Checks the device, builds the kernels, loads whisper-large-v3-turbo as
phase 4 does (random weights from seed 0, bf16, warmup) and kokoro-82M as
phase 11 does, and runs ``chip_smoke.phase_realtime``: every check and line
of phase 12, then the phase's seconds and its flash launches. Needs CUDA.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as c
    from open_speech_tpu_torch.runtime.router import BackendRouter

    if not torch.cuda.is_available():
        print("torch_realtime_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    c.phase_build()
    t0 = time.perf_counter()
    router = BackendRouter()
    router.load_model(c.MAIN_MODEL)
    torch.cuda.synchronize()
    c.log(f"loaded {c.MAIN_MODEL} in {time.perf_counter() - t0:.2f} s")
    tts = c.load_kokoro()
    t0 = time.perf_counter()
    launches = c.phase_realtime(router, tts)
    c.log(f"phase 12 seconds: {time.perf_counter() - t0:.1f}; launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
