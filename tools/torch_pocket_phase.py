#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (Pocket TTS) alone on the card.

    python3 tools/torch_pocket_phase.py

Checks the device and runs ``chip_smoke.phase_pocket``: every check and
line of phase 15 (15a the full-width model card against CPU and its
timings, 15b the slot-pool batcher, 15c the served routes and the load and
unload routes), then the phase's seconds. Phase 15 launches none of the
port's hand kernels, so nothing is built. Needs CUDA.
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
        print("torch_pocket_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    t0 = time.perf_counter()
    c.phase_pocket()
    c.log(f"phase 15 seconds: {time.perf_counter() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
