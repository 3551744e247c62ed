#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` (fine-tuning through K1's backward) alone
on the card.

    python3 tools/torch_train_phase.py

Checks the device, builds the kernels from ``kernels/csrc`` and runs
``chip_smoke.phase_train``: 18a the three backward kernels against
``flash_attention_backward_reference`` with their times, 18b test-tiny
card against CPU, 18c the full-width whisper-large-v3-turbo step (walls,
peak memory, launches, kernel-routed against plain-routed gradients), 18d
the same step with float32 params through the float32 kernels; then the
backward kernels' JSON entries (bf16 and float32), 18c's and 18d's
launches and the phase's seconds.
Needs CUDA (~70 s of command time).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as c

    if not torch.cuda.is_available():
        print("torch_train_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    c.phase_build()
    t0 = time.perf_counter()
    entries, launches = c.phase_train()
    c.log(json.dumps({"kernels": entries, "launches": launches}))
    c.log(f"phase 18 seconds: {time.perf_counter() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
