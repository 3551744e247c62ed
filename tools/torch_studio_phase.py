#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (the Studio) alone on the card.

    python3 tools/torch_studio_phase.py

Checks the device, builds the kernels (17a's transcription launches K1),
loads whisper-large-v3-turbo (random weights, bf16) on a ``BackendRouter``
as phase 4 does and kokoro-82M on a ``TTSRouter`` as phase 11 does, and
runs ``chip_smoke.phase_studio`` (17a history and the TTS cache, 17b the
conversation render card against direct and CPU, 17c the composer, 17e
the web UI). Then 17d, which ``chip_smoke.py`` runs inside phase 15c:
``pocket-tts`` at full width (``OS_POCKET_PRESET=base``) behind
``create_app``, the clone route with a reference part, then the same
request through the voice library. Studio paths live in a temporary
directory. Needs CUDA.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as c

    if not torch.cuda.is_available():
        print("torch_studio_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    c.phase_build()
    c.studio_dirs()
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter
    from open_speech_tpu_torch.tts.router import TTSRouter

    router = BackendRouter()  # settings defaults: cuda, bfloat16, beam 5
    router.load_model(c.MAIN_MODEL)
    tts = c.load_kokoro()
    t0 = time.perf_counter()
    launches = c.phase_studio(router, tts)
    c.log(f"phase 17 seconds: {time.perf_counter() - t0:.1f}; 17a's served launches {launches}")
    del router
    tts.unload_model("kokoro")

    os.environ["OS_POCKET_PRESET"] = "base"
    pocket = TTSRouter()
    t0 = time.perf_counter()
    pocket.load_model("pocket-tts")
    c.log(f"studio 17d: pocket-tts (base, random weights) loaded in {time.perf_counter() - t0:.3f} s")
    ref = codec.write_wav(c._speechlike(3.0, 61, 16000), 16000)
    with c._Served(BackendRouter(device="cuda:0"), pocket) as served:
        payload, headers = c._multipart({"input": c.POCKET_TEXT, "model": "pocket-tts",
                                         "response_format": "wav", "transcript": "a tone"}, ref,
                                        "reference_audio", "ref.wav")
        status, _, wav = c._http(served.port, "POST", "/v1/audio/speech/clone", payload, headers)
        if status != 200:
            raise AssertionError(f"studio 17d clone with reference_audio: {status} {wav[:200]!r}")
        c._studio_clone(served.port, ref, wav)
    pocket.unload_model("pocket-tts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
