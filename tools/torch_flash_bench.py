#!/usr/bin/env python3
"""Times the port's flash kernels (K1, K2) on the card for one checkout.

    python3 tools/torch_flash_bench.py [--root DIR] [--label NAME] [--f32-only]

Imports ``open_speech_tpu_torch`` from the checkout at DIR (default: this
one), builds its kernels from source and prints each kernel's registers and
spills (from ``nvcc -Xptxas -v``), then one JSON line:

  - K1 bf16 at the whisper encoder shape [1,20,1500,1500,64];
  - K2 bf16 at the streaming block [1,20,128,1500,64] at lengths 128, 256,
    700 and 1500 (the wrapper's time: K2's split kernel and its combine);
  - ``F.scaled_dot_product_attention`` on the same inputs (K2: on the valid
    prefix), as a yardstick;
  - the same in float32 (``STT_COMPUTE_TYPE=float32``, fine-tuning with
    float32 params): K1 and K2 at those shapes, each beside its plain
    version, SDPA on the same float32 inputs (the SDPA backend it took is
    named) and both bounds, the CUDA-core one (67 TFLOP/s) and the split
    one (three TF32 products per float32 product at 495 TFLOP/s);
  - the wrapper's host microseconds per call (median and least of 5 x 1000
    calls, no sync) for a beam-5 prefill [5,20,3,3,64] (K1) and the
    streaming block at length 700 (K2);
  - one streaming block encode (``StreamingWhisperEncoder._encode_block``,
    whisper-large-v3-turbo, random bf16 weights from seed 0, 32 K2 calls):
    wall ms per call with a sync after it, median and least of 20, for a
    committed block at position 0 and the clamped tail block at 1372.

``--f32-only`` prints only the float32 lines. ``--host-only`` prints only the host numbers, from kernels already built:
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


def sdpa_backend(*args, **kwargs) -> str:
    """The backend ``F.scaled_dot_product_attention`` takes for these
    arguments: the first of PyTorch's priority order that accepts them
    when it is the only one allowed."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        order = [SDPBackend(int(b)) for b in torch._C._get_sdp_priority_order()]
    except (AttributeError, TypeError, ValueError):
        order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]
    for backend in order:
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns why
                F.scaled_dot_product_attention(*args, **kwargs)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def f32_times(C, A, gen) -> dict:
    """K1 at the encoder shape and K2 at the streaming block's four lengths
    in float32: the wrapper per call and in device time, the plain version,
    SDPA on the same inputs (K2: the valid prefix) and both bounds."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    res = {}

    def timed(key: str, fn, plain=None) -> None:
        res[f"{key}_ms"] = C.cuda_ms(fn)
        res[f"{key}_device_ms"] = C.cuda_ms(fn, held=True)
        if plain is not None:
            res[f"{key}_plain_ms"] = C.cuda_ms(plain, iters=5, warmup=1)

    def bounds(key: str, *shape, lengths=None) -> None:
        for route in ("cuda_core", "split"):
            ms, by = C._flash_bound_ms(*shape, 4, lengths, split=route == "split")
            res[f"{key}_bound_{route}_ms"], res[f"{key}_bound_{route}_by"] = ms, by

    q, k, v = randn(1, 20, 1500, 64), randn(1, 20, 1500, 64), randn(1, 20, 1500, 64)
    timed("k1_f32", lambda: A.flash_attention(q, k, v), lambda: A.flash_attention_reference(q, k, v))
    timed("k1_f32_sdpa", lambda: F.scaled_dot_product_attention(q, k, v))
    res["k1_f32_sdpa_backend"] = sdpa_backend(q, k, v)
    bounds("k1_f32", 1, 20, 1500, 1500, 64, False)
    q2, kc, vc = randn(1, 20, 128, 64), randn(1, 20, 1500, 64), randn(1, 20, 1500, 64)
    for n in (128, 256, 700, 1500):
        lens = torch.tensor([n], dtype=torch.int32, device="cuda")
        kp, vp = kc[:, :, :n], vc[:, :, :n]
        timed(f"k2_f32_{n}", lambda: A.flash_attention(q2, kc, vc, kv_length=lens),
              lambda: A.flash_attention_varlen_reference(q2, kc, vc, lens))
        timed(f"k2_f32_sdpa_{n}", lambda: F.scaled_dot_product_attention(q2, kp, vp))
        res[f"k2_f32_sdpa_{n}_backend"] = sdpa_backend(q2, kp, vp)
        bounds(f"k2_f32_{n}", 1, 20, 128, 1500, 64, False, lengths=[n])
    res["allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO), help="checkout whose package is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--host-only", action="store_true",
                    help="only the host times (wrapper us per call, block encode ms), "
                         "on kernels already built")
    ap.add_argument("--f32-only", action="store_true", help="only the float32 lines")
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
    if args.f32_only:
        res.update(f32_times(C, A, gen))
        print(json.dumps(res))
        return 0
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
    if not args.host_only:
        res.update(f32_times(C, A, gen))
    res.update(block_encode_ms())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
