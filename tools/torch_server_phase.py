#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` (the server) alone on the card.

    python3 tools/torch_server_phase.py              # phases 1-2, the turbo router, phase 11
    python3 tools/torch_server_phase.py --speech 3   # only 11a's speech measurement, 3 times

The first form checks the device, builds the kernels, loads
whisper-large-v3-turbo as phase 4 does (random weights from seed 0, bf16,
warmup) and runs ``chip_smoke.phase_server``: every check and line of phase
11. The second loads kokoro-82M and serves it (``create_app`` with an STT
router that loads nothing) and repeats the streamed PCM speech measurement
of 11a (a first served request, then direct and served in turns), so the
first request on an executor thread can be told from the steady state.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--speech", type=int, default=0, metavar="REPEATS",
                        help="run only the speech measurement, this many times")
    args = parser.parse_args()

    import torch

    import chip_smoke as c
    from open_speech_tpu_torch.runtime.router import BackendRouter

    if not torch.cuda.is_available():
        print("torch_server_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    if args.speech:
        from open_speech_tpu_torch.tts.router import TTSRouter

        tts = TTSRouter()
        tts.load_model("kokoro")
        with c._Served(BackendRouter(), tts) as served:
            for _ in range(args.speech):
                c._server_speech(tts, served.port)
        return 0
    c.phase_build()
    t0 = time.perf_counter()
    router = BackendRouter()
    router.load_model(c.MAIN_MODEL)
    torch.cuda.synchronize()
    c.log(f"loaded {c.MAIN_MODEL} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    c.log(f"phase 11 launches {c.phase_server(router)} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
