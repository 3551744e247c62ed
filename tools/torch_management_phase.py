#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` (model management, the lifecycle and the
serving metrics) alone on the card.

    python3 tools/torch_management_phase.py

Checks the device, builds the kernels, loads kokoro-82M as phase 11 does,
and runs ``chip_smoke.phase_management``: every check and line of phase 13
(it loads whisper-large-v3-turbo itself), then the phase's seconds and its
flash launches. Needs CUDA.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as c

    if not torch.cuda.is_available():
        print("torch_management_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    c.phase_build()
    tts = c.load_kokoro()
    t0 = time.perf_counter()
    launches = c.phase_management(tts)
    c.log(f"phase 13 seconds: {time.perf_counter() - t0:.1f}; launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
