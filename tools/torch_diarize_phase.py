#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` (speaker diarization) alone on the card.

    python3 tools/torch_diarize_phase.py

Checks the device, loads whisper-large-v3-turbo (random weights, bf16) on
a ``BackendRouter`` as phase 4 does (16c serves it), and runs
``chip_smoke.phase_diarize``: every check and line of phase 16 (16a card
against CPU stage by stage and whole, 16b timings at 60 s and 10 min,
16c the served diarized transcription), then the phase's seconds. Phase
16's diarizer launches none of the port's hand kernels; 16c's
transcription launches K1, so the kernels are built first. Needs CUDA.
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
        print("torch_diarize_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    c.phase_build()
    from open_speech_tpu_torch.runtime.router import BackendRouter

    router = BackendRouter()  # settings defaults: cuda, bfloat16, beam 5
    router.load_model(c.MAIN_MODEL)
    t0 = time.perf_counter()
    launches = c.phase_diarize(router)
    c.log(f"phase 16 seconds: {time.perf_counter() - t0:.1f}; served launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
