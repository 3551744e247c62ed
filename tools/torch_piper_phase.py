#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (Piper and the speech effects chain) alone
on the card.

    python3 tools/torch_piper_phase.py

Checks the device and runs ``chip_smoke.phase_piper``: every check and line
of phase 14 (14a the piper-medium model card against CPU, a row's wall and
RTFx, the batcher at 4 and 16 rows, a profiled synthesis; 14b the served
voice: speech, streamed TTFA, Wyoming, the load and unload routes, Pocket's
named error; 14c the five effects and a chain against the CPU, ms per
effect, a served request with effects), then the phase's seconds. Phase 14
launches none of the port's hand kernels, so nothing is built. Needs CUDA.
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
        print("torch_piper_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    t0 = time.perf_counter()
    c.phase_piper()
    c.log(f"phase 14 seconds: {time.perf_counter() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
