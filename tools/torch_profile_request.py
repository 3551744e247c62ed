#!/usr/bin/env python3
"""Where one REST transcription spends its time on the card (PyTorch port).

    python3 tools/torch_profile_request.py [--seconds 30] [--model whisper-large-v3-turbo]

Loads the model through ``open_speech_tpu_torch``'s router with the REST
defaults (bf16, beam 5, temperature fallback; random weights from seed 0
when no checkpoint is on disk) and runs one request to warm up. Then:

  1. the same request with each stage of the path wrapped in a timer that
     synchronizes the card before and after it: wall seconds and calls per
     stage (stages nest: detect_language and beam_decode contain _prefill);
  2. ``torch.profiler`` over a short sample of the same work (one encode,
     one beam-5 decode of 16 steps): device-busy time (the sum of kernel
     times: one stream, so they do not overlap), the idle share, and the
     kernels that take the most device time.

Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (module, function) timed as stages
STAGES = [
    ("open_speech_tpu_torch.models.whisper.transcribe", "log_mel_spectrogram"),
    ("open_speech_tpu_torch.models.whisper.transcribe", "encode"),
    ("open_speech_tpu_torch.models.whisper.transcribe", "detect_language"),
    ("open_speech_tpu_torch.models.whisper.transcribe", "beam_decode"),
    ("open_speech_tpu_torch.models.whisper.transcribe", "greedy_decode"),
    ("open_speech_tpu_torch.models.whisper.decode", "_prefill"),
    ("open_speech_tpu_torch.models.whisper.decode", "decode_step"),
]


def _time_stages(totals: dict) -> None:
    import torch

    for mod_name, fn_name in STAGES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def wrapped(*args, _fn=fn, _name=fn_name, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[_name][0] += 1
            totals[_name][1] += time.perf_counter() - t0
            return out

        setattr(mod, fn_name, wrapped)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--model", default="whisper-large-v3-turbo")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_request: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())

    from open_speech_tpu_torch.models.whisper import decode as D
    from open_speech_tpu_torch.models.whisper import model as M
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
    from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response

    router = BackendRouter()
    router.load_model(args.model)
    entry = router.get_backend(args.model)._models[args.model]
    model, cfg, sp = entry["model"], entry["cfg"], entry["tok"].special
    rng = np.random.default_rng(0)
    t = np.arange(int(args.seconds * 16000)) / 16000
    clip = 0.2 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 1.7 * t) > 0)
    audio = (clip + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    wav = codec.write_wav(audio, 16000)

    def request():
        out = transcription_response(router, wav, model=args.model,
                                     response_format="verbose_json")
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    request()  # warm: allocator growth, cuBLAS handles
    print(f"warm request: wall_s {time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    request()
    wall = time.perf_counter() - t0
    print(f"model {args.model} audio_s {args.seconds} wall_s {wall:.3f} "
          f"rtfx {args.seconds / wall:.3f} (no stage timers)")

    totals: dict = defaultdict(lambda: [0, 0.0])
    _time_stages(totals)
    t0 = time.perf_counter()
    request()
    wall_t = time.perf_counter() - t0
    print(f"with stage timers: wall_s {wall_t:.3f}")
    for name, (calls, secs) in sorted(totals.items(), key=lambda kv: -kv[1][1]):
        print(f"  {name:20s} calls {calls:6d} s {secs:8.3f} per_call_ms {1e3 * secs / calls:9.3f}")

    # profiler sample: one encode and a 16-step beam-5 decode
    fpw = cfg.n_audio_ctx * 2  # one window of mel frames
    mel = log_mel_spectrogram(torch.from_numpy(audio[: fpw * 160]).cuda(), n_mels=cfg.n_mels)
    mel = torch.nn.functional.pad(mel, (0, fpw - mel.shape[-1]))[None]
    prompt = np.array([sp.sot_sequence("en", "transcribe")], np.int32)
    opts = D.DecodeOptions(beam_size=5, max_new_tokens=16)
    for _ in range(2):
        enc_out = M.encode(model, mel, cfg)
        D.beam_decode(model, cfg, sp, enc_out, prompt, opts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc_out = M.encode(model, mel, cfg)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        D.beam_decode(model, cfg, sp, enc_out, prompt, opts)
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
    # kernel events only: op-level events (aten::*) repeat their kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profiled sample (encode {t_enc:.4f} s + 16-step beam-5 decode): wall_s {t_all:.4f} "
          f"device_busy_s {busy:.4f} idle_share {1 - busy / t_all:.4f}")
    print(f"top {args.top} kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[: args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
