#!/usr/bin/env python3
"""Times the port's flash kernels (K1, K2) on the card for one checkout.

    python3 tools/torch_flash_bench.py [--root DIR] [--label NAME]

Imports ``open_speech_tpu_torch`` from the checkout at DIR (default: this
one), builds its kernels from source and prints each kernel's registers and
spills (from ``nvcc -Xptxas -v``), then one JSON line:

  - K1 bf16 at the whisper encoder shape [1,20,1500,1500,64];
  - K2 bf16 at the streaming block [1,20,128,1500,64] at lengths 128, 256,
    700 and 1500 (the wrapper's time: K2's split kernel and its combine);
  - ``F.scaled_dot_product_attention`` on the same inputs (K2: on the valid
    prefix), as a yardstick;
  - the wrapper's host microseconds per call (median and least of 5 x 1000
    calls, no sync) for a beam-5 prefill [5,20,3,3,64] (K1) and the
    streaming block at length 700 (K2);
  - one streaming block encode (``StreamingWhisperEncoder._encode_block``,
    whisper-large-v3-turbo, random bf16 weights from seed 0, 32 K2 calls):
    wall ms per call with a sync after it, median and least of 20, for a
    committed block at position 0 and the clamped tail block at 1372.

``--host-only`` prints only the host numbers, from kernels already built:
the host is shared and its speed drifts between processes, so a comparison
of host costs alternates the two checkouts over several processes.

Kernel times are ``chip_smoke.py``'s ``cuda_ms``: CUDA-event means over 20
back-to-back calls after warmup, host gaps included (``*_ms``), and with the
queue held full so that only device time counts (``*_device_ms``).
Comparing two checkouts: run this once for each in one call (parent,
change, change, parent). Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def block_encode_ms(reps: int = 20) -> dict:
    """Wall ms of one streaming block encode at full width, committed and
    tail, median and least of ``reps`` calls with a sync after each."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.whisper import PRESETS, init_params
    from open_speech_tpu_torch.models.whisper.streaming import StreamingWhisperEncoder

    cfg = PRESETS["large-v3-turbo"]
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, torch.bfloat16)
    enc = StreamingWhisperEncoder(model, cfg)
    pcm = 0.1 * np.random.default_rng(0).standard_normal(29 * 16000)
    enc.append_audio(pcm.astype(np.float32))  # commits 11 blocks
    res = {}
    for name, p0 in (("committed", 0), ("tail", cfg.n_audio_ctx - enc.block_pos)):
        enc._encode_block(p0)
        torch.cuda.synchronize()
        per_call = []
        for _ in range(reps):
            t0 = time.perf_counter()
            enc._encode_block(p0)
            torch.cuda.synchronize()
            per_call.append(time.perf_counter() - t0)
        res[f"block_encode_ms_{name}"] = 1e3 * statistics.median(per_call)
        res[f"block_encode_ms_{name}_least"] = 1e3 * min(per_call)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO), help="checkout whose package is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--host-only", action="store_true",
                    help="only the host times (wrapper us per call, block encode ms), "
                         "on kernels already built")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_bench: needs a CUDA device", file=sys.stderr)
        return 1
    C = _chip_smoke()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from open_speech_tpu_torch.kernels import build
    from open_speech_tpu_torch.ops import attention as A

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"{args.label}: {A.__file__} on {smi}")
    for k in C.ptxas_kernels(build.build(force=not args.host_only).get("flash_attention", "")):
        print(f"  registers {k['registers']:3d} smem {k['smem_bytes']} B "
              f"spills {k['spill_bytes']} B  {k['name']}")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def timed(key: str, fn) -> None:
        res[f"{key}_ms"] = C.cuda_ms(fn)
        res[f"{key}_device_ms"] = C.cuda_ms(fn, held=True)

    res = {"label": args.label, "device": smi}
    q, k, v = randn(1, 20, 1500, 64), randn(1, 20, 1500, 64), randn(1, 20, 1500, 64)
    q2, kc, vc = randn(1, 20, 128, 64), randn(1, 20, 1500, 64), randn(1, 20, 1500, 64)
    if not args.host_only:
        timed("k1", lambda: A.flash_attention(q, k, v))
        timed("k1_sdpa", lambda: F.scaled_dot_product_attention(q, k, v))
    for n in () if args.host_only else (128, 256, 700, 1500):
        lens = torch.tensor([n], dtype=torch.int32, device="cuda")
        kp, vp = kc[:, :, :n], vc[:, :, :n]
        timed(f"k2_{n}", lambda: A.flash_attention(q2, kc, vc, kv_length=lens))
        timed(f"k2_sdpa_{n}", lambda: F.scaled_dot_product_attention(q2, kp, vp))
    qp = randn(5, 20, 3, 64)
    res["k1_host_us"], res["k1_host_us_least"] = C.host_us(
        lambda: A.flash_attention(qp, qp, qp, causal=True))
    lens = torch.tensor([700], dtype=torch.int32, device="cuda")
    res["k2_host_us"], res["k2_host_us_least"] = C.host_us(
        lambda: A.flash_attention(q2, kc, vc, kv_length=lens))
    res.update(block_encode_ms())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
