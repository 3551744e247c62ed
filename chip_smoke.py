#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``open_speech_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

  1. device: CUDA with capability (9, 0); prints the card's name and power
     limit as nvidia-smi reports them.
  2. build: compiles the port's CUDA kernels from ``kernels/csrc`` with nvcc
     and prints each kernel's registers, shared memory and spills; fails if
     a bf16 kernel spills.
  3. kernels: each kernel (K1 flash attention, K2 length-masked flash
     attention and its split-combine pass) against its plain PyTorch version
     on the card, at the shapes the served paths give it, in bf16 and f32;
     times at the whisper encoder shape and the streaming block shape
     (kernel, plain version, the PyTorch library call as a yardstick, and
     the card's lower bound for the same work), rates and shares of the
     bound, K2's split count and blocks, and the wrapper's host time per
     call.
     K1 also runs at the batch widths of the batch modes: the encoder at 8
     and 16 windows and a 16-row prompted prefill.
  4. REST path: whisper-large-v3-turbo (random weights from seed 0, bf16)
     through the port's router with the REST defaults (beam 5, temperature
     fallback), at full width, loaded with ``OS_STT_BATCHED_LONGFORM`` on;
     counts K1 launches per request. The sequential requests are at most
     two windows long; then one 460 s upload (16 chunks, one batch of 16)
     takes the batched long-form path, its RTFx beside the sequential ones.
  5. streaming path: the same loaded model behind ``/v1/audio/stream``
     sessions (``server/streaming.py:streaming_endpoint``, an in-process
     client socket): S1 29 s of 16 kHz PCM16 paced in real time, language
     auto-detect, VAD off, interims on; S2 6 s of 8 kHz mu-law with the VAD
     on. Counts K2 launches against the encoder's block encodes and fails if
     the incremental path fell back to the executor. S3: eight concurrent
     sessions of 8 s paced PCM16 through the continuous batcher
     (``OS_BATCHER_ENABLED``, incremental encoder off); every pass must go
     through the batcher, and each tick may sync with the host once (CUDA's
     sync debug mode counts the syncs of ticks run on this thread).
  6. fixture: the trained tiny checkpoint ``tests/fixtures/test-tiny-eot``
     in float32 on the card against the CPU; REST tokens, streaming session
     events, the batcher's tokens (and B=1 greedy's) and a 75 s batched
     long-form request must be equal.
  7. Kokoro: kokoro-82M at its full geometry (random weights from a seed,
     float32) synthesizes as the JAX backend does per sentence
     (``encode_utterance``, then ``vocode_blocks``). K-a times one
     120-phoneme utterance (encode, first block, whole); K-b holds the card
     against the CPU on the same weights and host-drawn noise (and reports
     TF32's error and time beside the float32 kept); K-c holds four rows of
     one batch against their solo runs; K-d holds the streamed blocks
     against one-shot ``vocode``; K-e profiles one utterance. Kokoro
     launches none of the port's hand kernels.

The last two lines of standard output are the kernels' JSON line and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import re
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, *, held: bool = False) -> float:
    """Mean time per call of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls after warmup. The span includes the host's time
    between launches where the card waits for it, so a call whose host side
    outlasts its kernels reads its host time. With ``held`` a sleep kernel
    holds the card while the host queues the calls, so the span is the
    kernels' device time only."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if held:
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 1000, rounds: int = 5) -> tuple[float, float]:
    """Host microseconds per call of ``fn``: the median and the least over
    ``rounds`` runs of ``calls`` calls without a sync in between (the host
    is shared, so runs spread; the least is the call's own cost)."""
    import statistics

    import torch

    fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(per_call), 1e6 * min(per_call)


# ── phase 1: device ──────────────────────────────────────────────────────


def phase_device() -> dict:
    import torch

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"need a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "smi": smi}


# ── phase 2: build ───────────────────────────────────────────────────────


def ptxas_kernels(text: str) -> list[dict]:
    """Each entry function of ``nvcc -Xptxas -v`` output: its mangled name
    (``...14flash_fwd_bf16ILi64ELb0E...`` is ``flash_fwd_bf16<64, false>``),
    registers, static shared memory and spill bytes (stores + loads)."""
    kernels, entry = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = {"name": m.group(1), "spill_bytes": 0}
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            entry.update(registers=int(m.group(1)), smem_bytes=int(smem.group(1)) if smem else 0)
            kernels.append(entry)
            entry = None
    return kernels


def phase_build() -> None:
    from open_speech_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(force=True)  # from the checkout's sources
    log(f"build: {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    smem_bytes = build.load("flash_attention").os_flash_attention_smem_bytes
    for stem, text in logs.items():
        kernels = ptxas_kernels(text)
        for k in kernels:
            dyn = ""
            if t := re.search(r"14flash_fwd_bf16ILi(\d+)E", k["name"]):
                dyn = f" + dynamic {smem_bytes(int(t.group(1)))} B"
            log(f"  {stem}: registers {k['registers']:3d} smem {k['smem_bytes']} B{dyn} "
                f"spills {k['spill_bytes']} B  {k['name']}")
        spilled = [k["name"] for k in kernels if "_bf16" in k["name"] and k["spill_bytes"]]
        if not kernels or spilled:
            raise AssertionError(f"{stem}: bf16 kernels that spill: {spilled} "
                                 f"({len(kernels)} kernels read from ptxas)")


# ── phase 3: kernels against their plain versions ────────────────────────

# (B, H, Tq, Tk, D, causal): the encoder, the decoder prefill at the prompt
# lengths the seek loop makes (and beam 5 x 36), rectangular causal both
# ways, a causal diagonal one row into a second 64-row block, cross
# attention one row past two 64-row blocks, test-tiny
FLASH_SHAPES = [
    (1, 20, 1500, 1500, 64, False),
    (1, 2, 1500, 1500, 64, False),
    (1, 20, 1, 1, 64, True),
    (1, 20, 3, 3, 64, True),
    (1, 20, 12, 12, 64, True),
    (1, 20, 140, 140, 64, True),
    (5, 20, 36, 36, 64, True),
    (2, 4, 37, 100, 64, True),
    (2, 4, 100, 37, 64, True),
    (1, 2, 65, 65, 64, True),
    (1, 3, 129, 1500, 64, False),
    (1, 2, 60, 60, 32, False),
    (1, 2, 60, 60, 32, True),
]
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _limit(name: str, ref) -> float:
    """Largest max-abs error a kernel may show against its plain version:
    bf16 relative to the output's own scale (2e-2 of max|ref|, so a dropped
    kv tile or a mis-scaled row fails even where outputs are small), f32
    absolute (it differs only in summation order)."""
    if name == "bfloat16":
        return TOL[name] * ref.abs().max().item()
    return TOL[name]


# K2, (B, H, Tq, Tk, D, causal, kv lengths): the streaming block against
# the 1500-position caches at four lengths, then at lengths around its
# 128-key tiles and split boundaries, length 0 beside a ragged one
# (non-causal and causal), the test-tiny block
VARLEN_SHAPES = [
    (1, 20, 128, 1500, 64, False, (128,)),
    (1, 20, 128, 1500, 64, False, (256,)),
    (1, 20, 128, 1500, 64, False, (700,)),
    (1, 20, 128, 1500, 64, False, (1500,)),
    *((1, 4, 128, 1500, 64, False, (n,))
      for n in (1, 63, 64, 65, 127, 128, 129, 255, 256, 1499, 1500)),
    (2, 4, 37, 100, 64, False, (0, 53)),
    (2, 4, 37, 100, 64, True, (0, 53)),
    (1, 2, 60, 60, 32, False, (17,)),
]


def _flash_bound_ms(b, h, t_q, t_k, d, causal, itemsize, lengths=None) -> tuple[float, str]:
    """Least time for the call: visible (q, k) pairs at the peak rate for
    the dtype vs each input read once and the output written once. With
    ``lengths`` (K2) only each example's valid kv prefix is read and seen."""
    flops = nbytes = 0
    for n in lengths if lengths is not None else [t_k] * b:
        if causal:
            visible = sum(min(max(i + t_k - t_q + 1, 0), t_k, n) for i in range(t_q))
        else:
            visible = t_q * n
        flops += 4 * h * visible * d
        nbytes += h * (2 * t_q + 2 * n) * d * itemsize + (4 if lengths is not None else 0)
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from open_speech_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = 0.0
    for b, h, t_q, t_k, d, causal in FLASH_SHAPES:
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q = torch.randn(b, h, t_q, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, h, t_k, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, t_k, d, generator=gen, device="cuda").to(dtype)
            out = A.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ref = A.flash_attention_reference(
                q.float(), k.float(), v.float(), causal=causal
            )
            err = (out.float() - ref).abs().max().item()
            limit = _limit(name, ref)
            if not (out.shape == q.shape and out.dtype == dtype and err <= limit):
                raise AssertionError(
                    f"flash_attention {name} [{b},{h},{t_q},{t_k},{d}] causal={causal}: "
                    f"max_abs_err {err:.3e} > {limit:.3e}"
                )
            if t_q > t_k and causal:  # rows left of the first key are zeros
                n_zero = t_q - t_k
                if out[:, :, :n_zero].abs().max().item() != 0.0:
                    raise AssertionError("flash_attention: zero-key rows are not zero")
            worst = max(worst, err)
            log(f"flash_attention {name:8s} [{b},{h},{t_q},{t_k},{d}] causal={int(causal)} "
                f"max_abs_err {err:.3e} (tol {limit:.3e})")

    # times at the encoder shape, bf16 (the served path): blocks of one
    # warpgroup (64 rows), two blocks per SM; device_ms with the queue held
    b, h, t, d = 1, 20, 1500, 64
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kernel_ms = cuda_ms(lambda: A.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: A.flash_attention_reference(q, k, v), iters=10)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    device_ms = cuda_ms(lambda: A.flash_attention(q, k, v), held=True)
    library_device_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), held=True)
    bound_ms, bound_by = _flash_bound_ms(b, h, t, t, d, False, 2)
    blocks = -(-t // A.BLOCK_Q) * h * b
    log(f"flash_attention bf16 [1,20,1500,64]: kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) "
        f"TFLOP/s {4 * b * h * t * t * d / kernel_ms / 1e9:.1f} share_of_bound "
        f"{bound_ms / kernel_ms:.4f} blocks {blocks} waves {blocks / (2 * A.N_SMS):.2f}; "
        f"device_ms (queue held) kernel {device_ms:.4f} library {library_device_ms:.4f}")
    qp = torch.randn(5, 20, 3, d, generator=gen, device="cuda").to(torch.bfloat16)
    med, least = host_us(lambda: A.flash_attention(qp, qp, qp, causal=True))
    log(f"flash_attention bf16 [5,20,3,3,64] causal (a beam-5 prefill): host_us per call "
        f"{med:.2f} median, {least:.2f} least (5 x 1000 calls, no sync)")
    worst = max(worst, _phase_kernels_batched(gen))
    k1 = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "open_speech_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "open_speech_tpu/ops/attention.py:256",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    return [k1, _phase_kernels_varlen(gen), _phase_kernels_combine(gen)]


# K1 at the batch modes' widths (bf16): the encoder over 8 and 16 windows
# (B*H = 160 and 320 heads in the kernel's 3-D tensor maps), the prompted
# prefill of a 16-row batch (1 + 32 + 3 tokens)
BATCHED_SHAPES = [
    (8, 20, 1500, 1500, 64, False),
    (16, 20, 1500, 1500, 64, False),
    (16, 20, 36, 36, 64, True),
]


def _phase_kernels_batched(gen) -> float:
    """K1 against its plain version at the batched shapes, then its times
    there: per call, device (queue held), SDPA's, the bound and its share.
    Returns the largest error."""
    import torch
    import torch.nn.functional as F

    from open_speech_tpu_torch.ops import attention as A

    worst = 0.0
    for b, h, t_q, t_k, d, causal in BATCHED_SHAPES:
        q = torch.randn(b, h, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, h, t_k, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out = A.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = A.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
        err = (out.float() - ref).abs().max().item()
        limit = _limit("bfloat16", ref)
        tag = f"flash_attention bf16 [{b},{h},{t_q},{t_k},{d}] causal={int(causal)}"
        del ref
        if not (out.shape == q.shape and err <= limit):
            raise AssertionError(f"{tag}: max_abs_err {err:.3e} > {limit:.3e}")
        worst = max(worst, err)
        kernel_ms = cuda_ms(lambda: A.flash_attention(q, k, v, causal=causal))
        device_ms = cuda_ms(lambda: A.flash_attention(q, k, v, causal=causal), held=True)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        library_device_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), held=True)
        plain_ms = cuda_ms(lambda: A.flash_attention_reference(q, k, v, causal=causal),
                           iters=3, warmup=1)
        bound_ms, bound_by = _flash_bound_ms(b, h, t_q, t_k, d, causal, 2)
        blocks = -(-t_q // A.BLOCK_Q) * h * b
        log(f"{tag} max_abs_err {err:.3e} (tol {limit:.3e}): kernel_ms {kernel_ms:.4f} "
            f"device_ms {device_ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} library_device_ms "
            f"{library_device_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) share_of_bound "
            f"{bound_ms / kernel_ms:.4f} (device {bound_ms / device_ms:.4f}) blocks {blocks}")
    return worst


def _phase_kernels_varlen(gen) -> dict:
    """K2 against its plain version, then its times at the streaming block."""
    import torch
    import torch.nn.functional as F

    from open_speech_tpu_torch.ops import attention as A

    worst = 0.0
    for b, h, t_q, t_k, d, causal, lens in VARLEN_SHAPES:
        kv_length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q = torch.randn(b, h, t_q, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, h, t_k, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, t_k, d, generator=gen, device="cuda").to(dtype)
            out = A.flash_attention(q, k, v, causal=causal, kv_length=kv_length)
            torch.cuda.synchronize()
            ref = A.flash_attention_varlen_reference(
                q.float(), k.float(), v.float(), kv_length, causal=causal
            )
            err = (out.float() - ref).abs().max().item()
            tag = f"flash_attention_varlen {name} [{b},{h},{t_q},{t_k},{d}] causal={int(causal)} lens={list(lens)}"
            limit = _limit(name, ref)
            if not (out.shape == q.shape and out.dtype == dtype and err <= limit):
                raise AssertionError(f"{tag}: max_abs_err {err:.3e} > {limit:.3e}")
            for i, n in enumerate(lens):
                if n == 0 and out[i].abs().max().item() != 0.0:
                    raise AssertionError(f"{tag}: the length-0 example is not zero")
            worst = max(worst, err)
            log(f"{tag} max_abs_err {err:.3e} (tol {limit:.3e})")

    # times at the streaming block shape, bf16 (the served path), from the
    # length of the first block to the full window; the kernel's time is
    # the wrapper's (the split kernel, then the combine); device_ms with the
    # queue held
    b, h, t_q, t_k, d = 1, 20, 128, 1500, 64
    q = torch.randn(b, h, t_q, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, h, t_k, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    splits, per = A.plan_splits(b, h, t_q, t_k)
    blocks = -(-t_q // A.BLOCK_Q) * h * b * splits
    times = {}
    for n in (128, 256, 700, 1500):
        lens = torch.tensor([n], dtype=torch.int32, device="cuda")
        kp, vp = k[:, :, :n], v[:, :, :n]
        times[n] = (
            cuda_ms(lambda: A.flash_attention(q, k, v, kv_length=lens)),
            cuda_ms(lambda: A.flash_attention_varlen_reference(q, k, v, lens), iters=10),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, kp, vp)),
            *_flash_bound_ms(b, h, t_q, t_k, d, False, 2, [n]),
        )
        kernel_ms, bound_ms = times[n][0], times[n][3]
        device_ms = cuda_ms(lambda: A.flash_attention(q, k, v, kv_length=lens), held=True)
        library_device_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kp, vp), held=True)
        nbytes = h * (2 * t_q + 2 * n) * d * 2 + 4
        log(f"flash_attention_varlen bf16 [1,20,128,1500,64] length {n}: kernel_ms {kernel_ms:.4f} "
            f"plain_ms {times[n][1]:.4f} library_ms {times[n][2]:.4f} "
            f"bound_ms {bound_ms:.4f} ({times[n][4]}) GB/s {nbytes / kernel_ms / 1e6:.1f} "
            f"share_of_bound {bound_ms / kernel_ms:.4f} splits {splits} x {per} tiles "
            f"blocks {blocks}; device_ms (queue held) kernel {device_ms:.4f} "
            f"library {library_device_ms:.4f}")
    lens = torch.tensor([700], dtype=torch.int32, device="cuda")
    med, least = host_us(lambda: A.flash_attention(q, k, v, kv_length=lens))
    log(f"flash_attention_varlen bf16 [1,20,128,1500,64] length 700: host_us per call "
        f"{med:.2f} median, {least:.2f} least (5 x 1000 calls, no sync; the split kernel "
        "and the combine)")
    kernel_ms, plain_ms, library_ms, bound_ms, bound_by = times[1500]
    return {
        "name": "flash_attention_varlen",
        "route": "cuda",
        "source": "open_speech_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "open_speech_tpu/ops/attention.py:271",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _phase_kernels_combine(gen) -> dict:
    """K2's combine pass against its plain version on random partials at
    the streaming block's split shape, one split with no key; its times."""
    import torch

    from open_speech_tpu_torch.ops import attention as A

    b, h, t_q, d = 1, 20, 128, 64
    s, _ = A.plan_splits(b, h, t_q, 1500)
    o_part = torch.randn(b, s, h, t_q, d, generator=gen, device="cuda")
    m_part = 4 * torch.randn(b, s, h, t_q, generator=gen, device="cuda")
    l_part = torch.rand(b, s, h, t_q, generator=gen, device="cuda") + 0.5
    o_part[:, -1], m_part[:, -1], l_part[:, -1] = 0.0, float("-inf"), 0.0  # past the length
    out = A.flash_combine(o_part, m_part, l_part)
    torch.cuda.synchronize()
    ref = A.flash_combine_reference(o_part, m_part, l_part)
    err = (out.float() - ref).abs().max().item()
    limit = _limit("bfloat16", ref)
    if not (out.shape == (b, h, t_q, d) and err <= limit):
        raise AssertionError(f"flash_combine [{b},{s},{h},{t_q},{d}]: max_abs_err {err:.3e} > {limit:.3e}")
    kernel_ms = cuda_ms(lambda: A.flash_combine(o_part, m_part, l_part))
    plain_ms = cuda_ms(lambda: A.flash_combine_reference(o_part, m_part, l_part), iters=10)
    device_ms = cuda_ms(lambda: A.flash_combine(o_part, m_part, l_part), held=True)
    nbytes = b * s * h * t_q * (d + 2) * 4 + b * h * t_q * d * 2
    bound_ms = 1e3 * nbytes / H100_BYTES_PER_S
    log(f"flash_combine [{b},{s},{h},{t_q},{d}] max_abs_err {err:.3e} (tol {limit:.3e}) "
        f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} (bytes); "
        f"device_ms (queue held) {device_ms:.4f}")
    return {
        "name": "flash_combine",
        "route": "cuda",
        "source": "open_speech_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "open_speech_tpu/ops/attention.py:271",
        "launches": 0,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    device = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches, router, seq_rtfx = phase_main()
    launches["flash_attention"] += phase_rest_batched(router, seq_rtfx)
    streaming = phase_streaming(router)
    launches["flash_attention"] += streaming.pop("flash_attention")  # S3's admissions
    launches.update(streaming)
    phase_fixture()
    from open_speech_tpu_torch.ops import attention as A

    before = dict(A.launches)
    phase_kokoro()
    if dict(A.launches) != before:  # Kokoro has no hand kernel on its path
        raise AssertionError(f"kokoro launched the flash kernels: {before} -> {dict(A.launches)}")
    for entry in kernels:  # K1 from REST (both paths) and S3, K2 and its combine from S1/S2
        entry["launches"] = launches.get(entry["name"], 0)
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} was not launched on its path")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


# ── phase 4: the main path at full width ─────────────────────────────────

MAIN_MODEL = "whisper-large-v3-turbo"
SR = 16000
PROMPT = "the quick brown fox jumps over the lazy dog while the band plays on"
VERBOSE_KEYS = {"task", "language", "duration", "text", "segments"}
SEGMENT_KEYS = {"id", "seek", "start", "end", "text", "tokens", "temperature",
                "avg_logprob", "compression_ratio", "no_speech_prob"}


def _speechlike(seconds: float, seed: int):
    """Deterministic test signal: gated harmonic tones over noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 120 + 60 * np.sin(2 * np.pi * 0.3 * t)
    voice = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / SR) / h for h in (1, 2, 3, 4))
    gate = (np.sin(2 * np.pi * 1.7 * t) > -0.2).astype(np.float64)
    return (0.2 * voice * gate + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


class _EncodeCounter:
    """Counts windows (encode calls) and the kernel launches inside them."""

    def __init__(self, transcribe_module, launches: dict) -> None:
        self.mod, self.launches = transcribe_module, launches
        self.windows = 0
        self.encoder_launches = 0

    def __enter__(self):
        real = self.real = self.mod.encode

        def encode(*args, **kwargs):
            before = self.launches["flash_attention"]
            out = real(*args, **kwargs)
            self.windows += 1
            self.encoder_launches += self.launches["flash_attention"] - before
            return out

        self.mod.encode = encode
        return self

    def __exit__(self, *exc):
        self.mod.encode = self.real


def _check_body(name: str, body, response_format: str, seconds: float) -> None:
    import math

    if response_format == "json":
        if set(body) != {"text"} or not isinstance(body["text"], str):
            raise AssertionError(f"{name}: json body {body!r}")
    elif response_format == "verbose_json":
        if set(body) != VERBOSE_KEYS or body["duration"] != seconds:
            raise AssertionError(f"{name}: verbose_json keys {sorted(body)}")
        for seg in body["segments"]:
            if set(seg) != SEGMENT_KEYS or not all(
                math.isfinite(seg[k]) for k in ("start", "end", "avg_logprob",
                                                "compression_ratio", "no_speech_prob")
            ):
                raise AssertionError(f"{name}: segment {seg!r}")
        log(f"main {name}: {len(body['segments'])} segment(s), language {body['language']}")
    elif not isinstance(body, str):
        raise AssertionError(f"{name}: srt body {type(body)}")


def phase_main() -> tuple[dict, object, dict]:
    import torch

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.whisper import transcribe as T
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import (
        BackendRouter,
        transcription_response,
        translation_response,
    )

    # on before the load, as a deployment sets it: the warmup then also
    # drives the batched rung (phase 4b); uploads of at most two windows
    # stay on the sequential path
    settings.os_stt_batched_longform = True
    t0 = time.perf_counter()
    router = BackendRouter()  # settings defaults: cuda, bfloat16, beam 5
    router.load_model(MAIN_MODEL)  # random init from seed 0 + warmup
    torch.cuda.synchronize()
    log(f"main: loaded {MAIN_MODEL} (random weights, bf16) with warmup (batched rung "
        f"{settings.os_stt_batch_windows} included) in {time.perf_counter() - t0:.2f} s")
    cfg = router.get_backend(MAIN_MODEL)._models[MAIN_MODEL]["cfg"]
    requests = [
        ("a transcribe 5 s json", 5.0, 1, dict(response_format="json")),
        ("b transcribe 45 s verbose_json + prompt", 45.0, 2,
         dict(response_format="verbose_json", prompt=PROMPT)),
        ("c translate 10 s srt", 10.0, 3, dict(response_format="srt")),
    ]
    total, rtfx = {"flash_attention": 0}, {}
    for name, seconds, seed, kw in requests:
        wav = codec.write_wav(_speechlike(seconds, seed), SR)
        A.launches["flash_attention"] = 0  # count this request only
        with _EncodeCounter(T, A.launches) as enc:
            t1 = time.perf_counter()
            if name.startswith("c"):
                body = translation_response(router, wav, model=MAIN_MODEL, **kw)
            else:
                body = transcription_response(router, wav, model=MAIN_MODEL, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        n = A.launches["flash_attention"]
        total["flash_attention"] += n
        prefill = n - enc.encoder_launches
        rtfx[name] = seconds / wall
        log(f"main {name}: wall_s {wall:.3f} audio_s {seconds} rtfx {seconds / wall:.3f} "
            f"windows {enc.windows} flash_launches {n} (encoder {enc.encoder_launches}, "
            f"prefill {prefill})")
        if enc.windows < 1 or enc.encoder_launches != cfg.n_audio_layer * enc.windows:
            raise AssertionError(f"{name}: want {cfg.n_audio_layer} encoder launches per window")
        if prefill <= 0 or prefill % cfg.n_text_layer:
            raise AssertionError(f"{name}: causal prefill launches {prefill}")
        _check_body(name, body, kw["response_format"], seconds)
    return total, router, rtfx


# ── phase 4b: batched long-form REST at full width ───────────────────────

BATCHED_SECONDS = 460.0  # 16 chunks of 27-30 s: one batch of 16 windows


def phase_rest_batched(router, seq_rtfx: dict) -> int:
    """One 460 s upload through the router with the REST defaults and
    OS_STT_BATCHED_LONGFORM on: cut at quiet points, encoded and decoded as
    one batch. Returns its K1 launches."""
    import torch

    from open_speech_tpu_torch.models.whisper import batched as Bd
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import transcription_response

    cfg = router.get_backend(MAIN_MODEL)._models[MAIN_MODEL]["cfg"]
    wav = codec.write_wav(_speechlike(BATCHED_SECONDS, 6), SR)
    chunks, buckets, encoder_launches = [], [], [0]
    real_chunks, real_encode = Bd.chunk_boundaries, Bd.encode

    def counted_chunks(*args, **kw):
        chunks.append(real_chunks(*args, **kw))
        return chunks[-1]

    def counted_encode(model, mel, cfg_):
        before = A.launches["flash_attention"]
        out = real_encode(model, mel, cfg_)
        buckets.append(int(mel.shape[0]))
        encoder_launches[0] += A.launches["flash_attention"] - before
        return out

    A.launches["flash_attention"] = 0
    Bd.chunk_boundaries, Bd.encode = counted_chunks, counted_encode
    try:
        t0 = time.perf_counter()
        body = transcription_response(router, wav, model=MAIN_MODEL,
                                      response_format="verbose_json")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Bd.chunk_boundaries, Bd.encode = real_chunks, real_encode
    n = A.launches["flash_attention"]
    name = f"d transcribe {BATCHED_SECONDS:.0f} s verbose_json, batched long-form"
    _check_body(name, body, "verbose_json", BATCHED_SECONDS)
    if len(chunks) != 1 or buckets != [16] or len(chunks[0]) != 16:
        raise AssertionError(f"{name}: chunks {[len(c) for c in chunks]}, buckets {buckets}")
    if encoder_launches[0] != cfg.n_audio_layer or n <= encoder_launches[0]:
        raise AssertionError(f"{name}: K1 launches {n}, encoder {encoder_launches[0]}")
    seq = " ".join(f"{k[0]} {v:.3f}" for k, v in seq_rtfx.items())
    log(f"main {name}: wall_s {wall:.3f} audio_s {BATCHED_SECONDS} "
        f"rtfx {BATCHED_SECONDS / wall:.3f} (sequential requests a-c in this call: {seq}) "
        f"chunks {len(chunks[0])} buckets {buckets} flash_launches {n} "
        f"(encoder {encoder_launches[0]}, prefill {n - encoder_launches[0]}) "
        f"segments {len(body['segments'])} temperatures "
        f"{sorted({s['temperature'] for s in body['segments']})}")
    return n


# ── phase 5: the streaming path at full width ───────────────────────────

STREAM_SECONDS = 29.0  # > 28.2 s: the commits pass n_audio_ctx - 128, so the
#                        last interims run the clamped last block
TELEPHONY_SECONDS = 6.0
FRAME_S = 0.1  # the client's frame: 100 ms, one session chunk


class _WordTokenizer:
    """A synthetic vocabulary for random weights: text token i reads as the
    word "t<i>". Without vocab files the fallback tokenizer prints only byte
    tokens (< 256), which random weights almost never pick, so every
    transcript would be empty and a session would emit no transcript event.
    Token ids, and so every decode, are unchanged."""

    non_speech_tokens: list[int] = []

    def __init__(self, tok) -> None:
        self.special, self.n_vocab = tok.special, tok.n_vocab

    def encode(self, text: str) -> list[int]:
        return [int(w[1:]) for w in text.split() if w[:1] == "t" and w[1:].isdigit()]

    def decode(self, ids) -> str:
        return "".join(f" t{i}" for i in ids if i < self.special.eot)


class _ClientWS:
    """The client's side of a ``/v1/audio/stream`` socket, in process.

    Yields BINARY ``frames`` then a stop message. ``pace`` sends each frame
    at its real-time offset; ``sync`` instead holds each message until the
    session's interim in flight has finished. Records every server event
    with its arrival time. ``timed`` times each interim pass from the newest
    chunk it covers to its end (``passes``), and to its transcript event
    when it sends one (``turnaround``).
    """

    def __init__(self, frames, *, pace: bool, sync: bool = False, timed: bool = False) -> None:
        self.frames, self.pace, self.sync, self.timed = frames, pace, sync, timed
        self.events: list[tuple[float, dict]] = []
        self.session = None
        self.stop_at = None
        self.error = None  # the session swallows what its socket raises
        self.newest_chunk = 0.0
        self.turnaround: list[float] = []
        self.passes: list[float] = []

    def _time_interims(self, session) -> None:
        schedule, transcribe = session._schedule_interim, session._transcribe_utterance

        def timed_schedule():
            self.newest_chunk = time.perf_counter()
            schedule()

        async def timed_transcribe():
            t_chunk, n = self.newest_chunk, len(self.events)
            await transcribe()
            self.passes.append(time.perf_counter() - t_chunk)
            self.turnaround.extend(
                [t - t_chunk for t, e in self.events[n:] if e["type"] == "transcript"][:1]
            )

        session._schedule_interim, session._transcribe_utterance = timed_schedule, timed_transcribe

    async def send_str(self, text: str) -> None:
        self.events.append((time.perf_counter(), json.loads(text)))

    async def close(self, **kw) -> None:
        raise AssertionError(f"the endpoint refused the session: {kw}")

    def __aiter__(self):
        return self._messages()

    async def _messages(self):
        from open_speech_tpu_torch.server import streaming as S

        try:
            self.session = next(s for s in S._active_sessions.values() if s.ws is self)
            if self.timed:
                self._time_interims(self.session)
        except Exception as e:
            self.error = e
            raise
        t0 = time.perf_counter()
        for i, frame in enumerate(self.frames):
            if self.pace:
                await asyncio.sleep(max(0.0, t0 + i * FRAME_S - time.perf_counter()))
            if self.sync and self.session._interim_task is not None:
                await asyncio.wait([self.session._interim_task])
            yield S.Message(S.MsgType.BINARY, frame)
        self.stop_at = time.perf_counter()
        yield S.Message(S.MsgType.TEXT, json.dumps({"type": "stop"}))

    def of_type(self, kind: str) -> list[dict]:
        return [e for _, e in self.events if e["type"] == kind]


def _check_session_bounds(name: str, ws: _ClientWS) -> None:
    if ws.error is not None:
        raise AssertionError(f"{name}: the client side failed") from ws.error
    kinds = [e["type"] for _, e in ws.events]
    if not kinds or kinds[0] != "session.begin" or kinds[-1] != "session.end":
        raise AssertionError(f"{name}: events {kinds[:3]} ... {kinds[-3:]}")
    if ws.events[-1][1]["errors"] != 0 or ws.of_type("error"):
        raise AssertionError(f"{name}: errors {ws.of_type('error')} / {ws.events[-1][1]}")


def _pcm16_frames(seconds: float, seed: int) -> list[bytes]:
    """Speech-like 16 kHz PCM16 in 100 ms frames."""
    from open_speech_tpu_torch.ops import audio as codec

    pcm = codec.float_to_pcm16(_speechlike(seconds, seed))
    step = int(SR * FRAME_S) * 2
    return [pcm[i : i + step] for i in range(0, len(pcm), step)]


def _p50_max(values: list[float]) -> str:
    values = sorted(values)
    return f"p50 {values[len(values) // 2]:.4f} max {values[-1]:.4f}" if values else "none"


def phase_streaming(router) -> dict:
    backend = router.get_backend(MAIN_MODEL)
    entry = backend._ensure_model(MAIN_MODEL)
    real_tok = entry["tok"]
    entry["tok"] = _WordTokenizer(real_tok)
    executor_calls = []
    real_transcribe = router.transcribe
    router.transcribe = lambda **kw: executor_calls.append(kw) or real_transcribe(**kw)
    try:
        s1 = _stream_s1(router, entry, executor_calls)
        s2 = _stream_s2(router)
        s3 = _stream_s3(router, executor_calls)
        _batcher_sync_probe(entry)
    finally:
        entry["tok"] = real_tok
        router.transcribe = real_transcribe
    return {"flash_attention_varlen": s1[0] + s2[0], "flash_combine": s1[1] + s2[1],
            "flash_attention": s3}


def _stream_s1(router, entry: dict, executor_calls: list) -> tuple[int, int]:
    """29 s of 16 kHz PCM16, paced; auto-detect, VAD off, interims on."""
    import torch

    from open_speech_tpu_torch.models.whisper import streaming as St
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.server.streaming import streaming_endpoint

    cfg = entry["cfg"]
    frames = _pcm16_frames(STREAM_SECONDS, 4)

    # K2's device time: CUDA events around each launch (on the launching
    # thread's stream; they add no sync)
    k2_events, flash = [], St.flash_attention

    def timed_flash(q, k, v, **kw):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = flash(q, k, v, **kw)
        ev[1].record()
        k2_events.append(ev)
        return out

    # the most committed positions an interim or the final started from:
    # past n_audio_ctx - block_pos, its tail is the clamped last block
    interim_states, most_committed = St.StreamingWhisperEncoder.interim_states, [0]

    def counted_interim_states(enc):
        most_committed[0] = max(most_committed[0], enc._committed)
        return interim_states(enc)

    ws = _ClientWS(frames, pace=True, timed=True)
    for key in A.launches:
        A.launches[key] = 0  # count this session only
    St.flash_attention, St.StreamingWhisperEncoder.interim_states = timed_flash, counted_interim_states
    try:
        t0 = time.perf_counter()
        asyncio.run(streaming_endpoint(ws, router, model=MAIN_MODEL, language=None,
                                       sample_rate=SR, interim_results=True, vad=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        St.flash_attention, St.StreamingWhisperEncoder.interim_states = flash, interim_states
    n_k2, n_k1 = A.launches["flash_attention_varlen"], A.launches["flash_attention"]
    n_combine = A.launches["flash_combine"]
    session, enc = ws.session, ws.session._inc_encoder

    _check_session_bounds("S1", ws)
    transcripts = ws.of_type("transcript")
    interims = [e for e in transcripts if not e["is_final"]]
    finals = [e for e in transcripts if e["speech_final"]]
    final_at = next(t for t, e in ws.events if e.get("speech_final"))
    if not interims or len(finals) != 1:
        raise AssertionError(f"S1: {len(interims)} interims, {len(finals)} finals")
    if session._inc_failures or session._inc_broken or executor_calls:
        raise AssertionError(
            f"S1: the incremental path fell back (failures {session._inc_failures}, "
            f"broken {session._inc_broken}, executor calls {len(executor_calls)})"
        )
    blocks = enc.block_encodes + enc.tail_encodes
    if n_k2 != cfg.n_audio_layer * blocks or n_k1 <= 0 or len(k2_events) != n_k2:
        raise AssertionError(f"S1: K2 launches {n_k2} for {blocks} block encodes; K1 {n_k1}")
    if n_combine != n_k2:  # every block runs split: [1,20,128,1500] plans 4 splits
        raise AssertionError(f"S1: {n_combine} combine launches for {n_k2} K2 launches")
    if most_committed[0] <= cfg.n_audio_ctx - enc.block_pos:
        raise AssertionError(f"S1: committed {most_committed[0]}: no clamped last block")
    if not isinstance(session._detected_language, str):
        raise AssertionError("S1: language detection did not pin a language")

    k2_s = sum(a.elapsed_time(b) for a, b in k2_events) / 1e3
    turnaround, passes = sorted(ws.turnaround), sorted(ws.passes)
    log(f"stream S1 16 kHz pcm16 {STREAM_SECONDS} s paced: wall_s {wall:.3f} "
        f"language {session._detected_language} events {len(ws.events)} "
        f"interims {len(interims)} confirmed {len(transcripts) - len(interims) - len(finals)} "
        f"interim_passes {len(passes)} coalesced {session._interims_coalesced}")
    log(f"stream S1 interim turnaround (newest chunk -> transcript event, {len(turnaround)} "
        f"passes with an event) s: p50 {turnaround[len(turnaround) // 2]:.4f} "
        f"max {turnaround[-1]:.4f}; every pass (newest chunk -> pass end) s: "
        f"p50 {passes[len(passes) // 2]:.4f} max {passes[-1]:.4f}; "
        f"final latency after stop s {final_at - ws.stop_at:.4f}")
    log(f"stream S1 K2 launches {n_k2} = {cfg.n_audio_layer} x ({enc.block_encodes} committed + "
        f"{enc.tail_encodes} tail block encodes), combine launches {n_combine}, "
        f"device s {k2_s:.4f} (split kernel + combine) "
        f"({k2_s / wall:.4f} of the session wall); K1 launches {n_k1}; "
        f"most committed positions at an interim {most_committed[0]}")
    _profile_interim(entry, b"".join(frames), session._detected_language)
    return n_k2, n_combine


def _profile_interim(entry: dict, pcm: bytes, language: str) -> None:
    """One interim pass as the session runs it at the end of S1 (the
    clamped tail block over 1408 committed positions, then a greedy decode
    at its budget), on this thread under torch.profiler: device busy time,
    idle share and K2's share of the device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from open_speech_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
    from open_speech_tpu_torch.models.whisper.streaming import (
        StreamingWhisperEncoder,
        interim_budget,
    )
    from open_speech_tpu_torch.ops.audio import pcm16_to_float

    model, cfg, sp = entry["model"], entry["cfg"], entry["tok"].special
    enc = StreamingWhisperEncoder(model, cfg)
    enc.append_audio(pcm16_to_float(pcm))
    prompt = np.asarray([sp.sot_sequence(language, "transcribe", timestamps=False)], np.int32)

    def one_pass() -> int:
        states, bucket = enc.interim_states()
        opts = DecodeOptions(language=language, timestamps=False, beam_size=1,
                             max_new_tokens=interim_budget(bucket, 0), suppress_blank=True)
        res = greedy_decode(model, cfg, sp, states, prompt, opts,
                            enc_len=np.asarray([enc.real_positions], np.int32))
        return int(res.lengths[0])

    one_pass()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_tokens = one_pass()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: op-level events (aten::*) repeat their kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    k2 = sum(e.self_device_time_total for e in kernels
             if ("flash_fwd" in e.key and "true>" in e.key) or "flash_combine" in e.key) / 1e6
    if busy <= 0:
        raise AssertionError("interim profile: no device time in the trace")
    log(f"stream S1 profiled interim pass (committed {enc._committed}, tail from "
        f"{cfg.n_audio_ctx - enc.block_pos}, {n_tokens} tokens): wall_s {wall:.4f} "
        f"device_busy_s {busy:.4f} idle_share {1 - busy / wall:.4f} K2_s {k2:.6f} "
        f"K2_share_of_device {k2 / busy:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")


def _stream_s2(router) -> tuple[int, int]:
    """6 s of 8 kHz mu-law, paced; language en, VAD on (the default)."""
    import numpy as np

    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.server.streaming import streaming_endpoint

    audio = _speechlike(TELEPHONY_SECONDS, 5)[::2]  # 8 kHz
    codes = codec.ulaw_encode((audio * 32767).astype(np.int16)).tobytes()
    step = int(8000 * FRAME_S)
    frames = [codes[i : i + step] for i in range(0, len(codes), step)]
    ws = _ClientWS(frames, pace=True)
    for key in A.launches:
        A.launches[key] = 0  # count this session only
    asyncio.run(streaming_endpoint(ws, router, model=MAIN_MODEL, language="en",
                                   sample_rate=8000, encoding="mulaw", interim_results=True))
    n_k2, n_combine = A.launches["flash_attention_varlen"], A.launches["flash_combine"]
    _check_session_bounds("S2", ws)
    session = ws.session
    if session.vad_state is None or session.vad_state.calls != len(frames):
        calls = session.vad_state.calls if session.vad_state else None
        raise AssertionError(f"S2: VAD ran {calls} times for {len(frames)} chunks")
    speech = len([e for e in ws.of_type("vad") if e["state"] == "speech_start"])
    log(f"stream S2 8 kHz mulaw {TELEPHONY_SECONDS} s, VAD on (random weights): "
        f"vad_calls {session.vad_state.calls} speech_starts {speech} "
        f"transcripts {len(ws.of_type('transcript'))} K2 launches {n_k2} combine {n_combine} "
        f"vad_device {session.vad_state.session.device}")
    return n_k2, n_combine


S3_SESSIONS = 8
S3_SECONDS = 8.0


def _stream_s3(router, executor_calls: list) -> int:
    """Eight concurrent sessions of 8 s paced PCM16 through the continuous
    batcher: OS_BATCHER_ENABLED on, incremental encoder off, language en,
    VAD off, interims on. Returns the K1 launches (admission encodes)."""
    import torch

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.runtime import batcher as Bt
    from open_speech_tpu_torch.runtime import batcher_pool as P
    from open_speech_tpu_torch.server import streaming as S

    counts, tick_s = {"windows": 0, "passes": 0}, []
    real_window, real_tick, real_pcm = (
        Bt.ContinuousBatcher.transcribe_window, Bt.ContinuousBatcher._tick,
        S.transcribe_pcm_batched)

    async def counted_window(self, mel, max_new_tokens=None):
        counts["windows"] += 1
        return await real_window(self, mel, max_new_tokens)

    def timed_tick(self):  # on the executor thread; its one sync ends it
        t0 = time.perf_counter()
        real_tick(self)
        tick_s.append(time.perf_counter() - t0)

    async def counted_pcm(*args, **kw):
        counts["passes"] += 1
        return await real_pcm(*args, **kw)

    wss = [_ClientWS(_pcm16_frames(S3_SECONDS, 30 + i), pace=True, timed=True)
           for i in range(S3_SESSIONS)]

    async def serve_all():
        try:
            await asyncio.gather(*(
                S.streaming_endpoint(ws, router, model=MAIN_MODEL, language="en",
                                     sample_rate=SR, interim_results=True, vad=False)
                for ws in wss))
            return P.pool_stats()
        finally:
            await P.shutdown_batchers()

    settings.os_batcher_enabled, settings.os_stream_incremental = True, False
    Bt.ContinuousBatcher.transcribe_window, Bt.ContinuousBatcher._tick = counted_window, timed_tick
    S.transcribe_pcm_batched = counted_pcm
    P.reset_pool()
    for key in A.launches:
        A.launches[key] = 0  # count this phase only
    try:
        t0 = time.perf_counter()
        stats = asyncio.run(serve_all())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        settings.os_batcher_enabled, settings.os_stream_incremental = False, True
        Bt.ContinuousBatcher.transcribe_window, Bt.ContinuousBatcher._tick = real_window, real_tick
        S.transcribe_pcm_batched = real_pcm
    n_k1 = A.launches["flash_attention"]

    finals_at = []
    for i, ws in enumerate(wss):
        _check_session_bounds(f"S3 session {i}", ws)
        if len([e for e in ws.of_type("transcript") if e["speech_final"]]) != 1:
            raise AssertionError(f"S3 session {i}: no single final transcript")
        finals_at.append(next(t for t, e in ws.events if e.get("speech_final")) - ws.stop_at)
    transcriptions = sum(ws.session._transcription_count for ws in wss)
    if len(stats) != 1:
        raise AssertionError(f"S3: batchers {sorted(stats)}, want one shared batcher")
    (b,) = stats.values()
    if executor_calls or counts["passes"] != transcriptions or transcriptions == 0:
        raise AssertionError(
            f"S3: {transcriptions} transcriptions, {counts['passes']} through the batcher, "
            f"{len(executor_calls)} executor fallbacks")
    if b["completed"] != counts["windows"] or counts["windows"] != transcriptions:
        raise AssertionError(f"S3: completed {b['completed']} of {counts['windows']} submitted")
    if b["peak_occupancy"] < 2 or len(tick_s) != b["ticks"] or n_k1 <= 0:
        raise AssertionError(f"S3: peak occupancy {b['peak_occupancy']}, ticks {b['ticks']} "
                             f"({len(tick_s)} timed), K1 launches {n_k1}")
    turnaround = [t for ws in wss for t in ws.turnaround]
    passes = [t for ws in wss for t in ws.passes]
    log(f"stream S3 {S3_SESSIONS} sessions x {S3_SECONDS} s pcm16 paced through the continuous "
        f"batcher ({b['slots']} slots, K {settings.os_batch_steps_per_tick}): wall_s {wall:.3f} "
        f"transcriptions {transcriptions} (all through the batcher, executor fallbacks 0) "
        f"completed {b['completed']} ticks {b['ticks']} peak_occupancy {b['peak_occupancy']} "
        f"tokens {b['tokens']} tokens_per_tick {b['tokens'] / max(b['ticks'], 1):.3f} "
        f"K1 launches {n_k1}")
    log(f"stream S3 tick ms: {_p50_max([1e3 * t for t in tick_s])}; interim turnaround "
        f"(newest chunk -> transcript event, {len(turnaround)} passes) s: "
        f"{_p50_max(turnaround)}; every pass s: {_p50_max(passes)}; final latency after "
        f"stop s: {_p50_max(finals_at)}")
    return n_k1


def _count_syncs(fn) -> list[str]:
    """Run ``fn`` under CUDA's sync debug mode; the source line (path:line:
    text) of each host sync it made."""
    import linecache
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename}:{w.lineno}: {linecache.getline(w.filename, w.lineno).strip()}"
            for w in caught if "synchroniz" in str(w.message)]


def _batcher_sync_probe(entry: dict) -> None:
    """Four ticks of an 8-slot batcher at full occupancy, run on this
    thread under CUDA's sync debug mode: each must sync with the host
    exactly once, where it reads back the packed result. Garbage from the
    earlier phases is collected first (and its syncs reported apart): a
    finalizer that a collection runs inside a tick is not the tick's."""
    import gc

    import torch

    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
    from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

    model, cfg, sp = entry["model"], entry["cfg"], entry["tok"].special
    b = ContinuousBatcher(model, cfg, sp, slots=8, max_new_tokens=224)
    audio = torch.from_numpy(_speechlike(30.0, 7)).cuda()
    mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)

    async def probe():
        loop = asyncio.get_running_loop()
        b._admit_device([(i, mel, 224, loop.create_future()) for i in range(8)])
        torch.cuda.synchronize()
        in_gc = _count_syncs(gc.collect)
        times, syncs = [], []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            syncs.append(_count_syncs(b._tick))
            times.append(time.perf_counter() - t0)
        return in_gc, syncs, times

    in_gc, syncs, times = asyncio.run(probe())
    log(f"stream S3 sync probe: collecting the earlier phases' garbage synced "
        f"{len(in_gc)} time(s) {in_gc}")
    if [len(s) for s in syncs] != [1] * len(syncs) or b.occupancy != 8:
        raise AssertionError(f"batcher ticks synced at {syncs} (want 1 each), "
                             f"occupancy {b.occupancy}")
    log(f"stream S3 sync probe: {len(syncs)} ticks at occupancy 8, host syncs per tick "
        f"{[len(s) for s in syncs]} at {syncs[0]}; tick ms "
        f"{' '.join(f'{1e3 * t:.3f}' for t in times)}")


# ── phase 6: the trained fixture, card against CPU ───────────────────────


def _beeps(k: int, rng):
    import numpy as np

    window = int(1.2 * SR)  # one test-tiny window
    clip = rng.normal(0, 0.003, window)
    for i in range(k):
        dur = int(0.15 * SR)
        t = np.arange(dur) / SR
        start = i * (window // k)
        clip[start : start + dur] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(dur)
    return clip.astype(np.float32)


def _first_difference(a: list[int], b: list[int]) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def phase_fixture() -> None:
    from pathlib import Path

    import numpy as np
    import torch

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.whisper.model import decoder_forward
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter

    settings.stt_model_dir = str(Path(__file__).resolve().parent / "tests" / "fixtures")
    model_id = "test-tiny-eot"
    routers = {dev: BackendRouter(device=dev, compute_type="float32")  # TF32 off
               for dev in ("cuda", "cpu")}
    for router in routers.values():
        router.load_model(model_id)
    card, host = (routers[dev].get_backend(model_id) for dev in ("cuda", "cpu"))
    rng = np.random.default_rng(11)  # the clips of tests/test_eot_ckpt.py
    clips = {k: _beeps(k, rng) for k in (1, 3)}
    for k, clip in clips.items():
        for beam in (1, 5):
            wav = codec.write_wav(clip, SR)
            kw = dict(language="en", beam_size=beam, fallback=False,
                      response_format="verbose_json")
            out_c, out_h = card.transcribe(wav, model_id, **kw), host.transcribe(wav, model_id, **kw)
            toks_c = [t for s in out_c["segments"] for t in s["tokens"]]
            toks_h = [t for s in out_h["segments"] for t in s["tokens"]]
            log(f"fixture beeps k={k} beam={beam}: {len(toks_c)} tokens on cuda, "
                f"{len(toks_h)} on cpu, equal={toks_c == toks_h}")
            if toks_c != toks_h:
                i = _first_difference(toks_c, toks_h)
                entry = host._models[model_id]
                sp = entry["tok"].special
                prefix = sp.sot_sequence("en", "transcribe") + toks_h[:i]
                from open_speech_tpu_torch.models.whisper.model import encode
                from open_speech_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim

                cfg = entry["cfg"]
                fpw = cfg.n_audio_ctx * 2  # as the seek loop pads and slices
                padded = pad_or_trim(torch.from_numpy(clip), 2 * fpw * 160)
                mel = log_mel_spectrogram(padded, n_mels=cfg.n_mels)[:, :fpw]
                enc_out = encode(entry["model"], mel[None], cfg)
                logits = decoder_forward(entry["model"], torch.tensor([prefix]), enc_out, cfg)[0, -1]
                top2 = torch.topk(logits, 2).values
                raise AssertionError(
                    f"fixture k={k} beam={beam}: tokens differ at step {i} "
                    f"(cuda {toks_c[i:i + 3]} vs cpu {toks_h[i:i + 3]}); "
                    f"top-2 logit margin there {float(top2[0] - top2[1]):.3e}"
                )

    _fixture_streaming(routers, model_id)
    _fixture_batcher(routers, model_id)
    _fixture_batched_longform(routers, model_id)


def _fixture_batcher(routers: dict, model_id: str) -> None:
    """Three concurrent windows through the continuous batcher on the card
    and on the CPU (the same mel windows): equal tokens, and each equal to
    the card's B=1 greedy decode of its window."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
    from open_speech_tpu_torch.models.whisper.model import encode
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
    from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

    rng = np.random.default_rng(41)
    entries = {dev: r.get_backend(model_id)._ensure_model(model_id) for dev, r in routers.items()}
    cfg, tok = entries["cpu"]["cfg"], entries["cpu"]["tok"]
    suppress = tuple(tok.non_speech_tokens)
    mels = [log_mel_spectrogram(torch.from_numpy(_beeps(k, rng)), n_mels=cfg.n_mels)
            for k in (1, 2, 3)]

    async def serve(model):
        b = ContinuousBatcher(model, cfg, tok.special, slots=4, max_new_tokens=24,
                              suppress_tokens=suppress)
        b.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(b.transcribe_window(m) for m in mels)), 120)
        finally:
            await b.stop()

    got = {dev: asyncio.run(serve(e["model"])) for dev, e in entries.items()}
    card = entries["cuda"]["model"]
    prompt = np.asarray([tok.special.sot_sequence("en", "transcribe")], np.int32)
    greedy = []
    for m in mels:
        res = greedy_decode(card, cfg, tok.special, encode(card, m[None].cuda(), cfg), prompt,
                            DecodeOptions(max_new_tokens=24, suppress_tokens=suppress))
        greedy.append([int(t) for t in res.tokens[0][: int(res.lengths[0])]])
    log(f"fixture batcher, 3 windows: tokens per window {[len(t) for t in got['cuda']]} on "
        f"cuda, equal to cpu={got['cuda'] == got['cpu']}, to cuda B=1 greedy="
        f"{got['cuda'] == greedy}")
    if got["cuda"] != got["cpu"] or got["cuda"] != greedy or not any(got["cpu"]):
        raise AssertionError(f"fixture batcher: cuda {got['cuda']} cpu {got['cpu']} "
                             f"greedy {greedy}")


def _fixture_batched_longform(routers: dict, model_id: str) -> None:
    """A 75 s upload (63 test-tiny windows: four batches of up to 16)
    through each backend with OS_STT_BATCHED_LONGFORM on, beam 5, no
    fallback: the card's segments equal the CPU's."""
    import numpy as np

    from open_speech_tpu_torch.backends import torch_whisper as TW
    from open_speech_tpu_torch.ops import audio as codec

    rng = np.random.default_rng(51)
    wav = codec.write_wav(np.concatenate([_beeps(int(k), rng) for k in rng.integers(1, 4, 63)]),
                          SR)
    calls, real = [], TW.transcribe_batched
    TW.transcribe_batched = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        bodies = {dev: r.get_backend(model_id).transcribe(
                      wav, model_id, language="en", beam_size=5, fallback=False,
                      response_format="verbose_json")
                  for dev, r in routers.items()}
    finally:
        TW.transcribe_batched = real
    key = {dev: [(s["seek"], s["start"], s["end"], s["tokens"]) for s in b["segments"]]
           for dev, b in bodies.items()}
    log(f"fixture batched long-form 75.6 s: {len(key['cuda'])} segments on cuda, "
        f"{len(key['cpu'])} on cpu, equal={key['cuda'] == key['cpu']}")
    if calls != [1, 1] or key["cuda"] != key["cpu"] or not key["cpu"]:
        raise AssertionError(f"fixture batched long-form: batched calls {len(calls)}, "
                             f"segments differ or none")


def _fixture_streaming(routers: dict, model_id: str) -> None:
    """The streaming session on the card (K2 in float32) against the CPU:
    VAD off, language en, interims driven one at a time, the same PCM; the
    event lists (minus the session id) must be equal. 1.0 s finalizes over
    the incremental states; 2.0 s overflows the 1.2 s window and finalizes
    on the executor path."""
    import numpy as np

    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.server.streaming import streaming_endpoint

    rng = np.random.default_rng(21)
    for seconds in (1.0, 2.0):
        clip = np.concatenate([_beeps(3, rng)[: int(SR * seconds / 2)],
                               _beeps(2, rng)[: int(SR * seconds / 2)]])
        pcm = codec.float_to_pcm16(clip)
        frames = [pcm[i : i + 3200] for i in range(0, len(pcm), 3200)]
        events = {}
        for dev, router in routers.items():
            before = A.launches["flash_attention_varlen"]
            ws = _ClientWS(frames, pace=False, sync=True)
            asyncio.run(streaming_endpoint(ws, router, model=model_id, language="en",
                                           sample_rate=SR, interim_results=True, vad=False))
            _check_session_bounds(f"fixture stream {dev}", ws)
            events[dev] = [{k: v for k, v in e.items() if k != "session_id"} for _, e in ws.events]
            launched = A.launches["flash_attention_varlen"] - before
            if (launched > 0) != (dev == "cuda"):
                raise AssertionError(f"fixture stream {dev}: {launched} K2 launches")
        n = len([e for e in events["cpu"] if e["type"] == "transcript"])
        log(f"fixture stream {seconds} s: {len(events['cuda'])} events on cuda, "
            f"{len(events['cpu'])} on cpu ({n} transcripts), equal={events['cuda'] == events['cpu']}")
        if events["cuda"] != events["cpu"] or n == 0:
            diff = next((i for i, (a, b) in enumerate(zip(events["cuda"], events["cpu"]))
                         if a != b), None)
            raise AssertionError(f"fixture stream {seconds} s: events differ at {diff}: "
                                 f"{events['cuda'][diff:diff + 2]} vs {events['cpu'][diff:diff + 2]}"
                                 if diff is not None else f"fixture stream {seconds} s: {n} transcripts")


# ── phase 7: Kokoro synthesis at full width ──────────────────────────────

KOKORO_PHONEMES = 120
KOKORO_BATCH = (120, 14, 9, 4)  # phonemes per row of K-c
# Card against CPU (K-b), batch rows against solo runs (K-c), streamed
# blocks against one-shot vocode (K-d): float32 everywhere, so outputs
# differ only in summation order. Each stage is held to the CPU parity
# tests' tolerance against the JAX model (tests/test_torch_kokoro.py),
# relative to the output's scale where that exceeds 1 (the random weights'
# exp() spectrum makes loud audio): the text features, F0/N, the decoder's
# output x, the harmonic features as re/im, and the generator's audio on the
# same harmonic features. The whole synthesis on each side's own features
# is held only in relative L2: the first STFT frame of the harmonic source is
# a reflection, symmetric, so its phases' +-pi branch is rounding's choice,
# and one such choice moves 1-5% of a short utterance's energy through the
# generator's instance norms (tests/test_torch_kokoro.py:OWN_FEATURES_REL_L2).
KOKORO_TOL = {"asr": 2e-5, "f0": 3e-4, "n": 3e-4, "x": 3e-4, "har": 1e-5, "audio": 2e-3}
KOKORO_OWN_FEATURES_REL_L2 = 0.5
KOKORO_MULTI_BLOCK_REL_L2 = 0.5  # tests/test_torch_kokoro.py:MULTI_BLOCK_REL_L2


def _kokoro_inputs(cfg, lengths, seed: int, device: str):
    """Phoneme ids drawn from ``seed``, ``voice_vector("af_heart")``, speed 1."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.kokoro import voice_vector

    rng = np.random.default_rng(seed)
    ph = np.zeros((len(lengths), cfg.max_phonemes), np.int64)
    for i, n in enumerate(lengths):
        ph[i, :n] = rng.integers(1, cfg.n_symbols, n)
    style = np.repeat(voice_vector("af_heart", cfg.voice_dim)[None], len(lengths), 0)
    return (torch.from_numpy(ph).to(device), torch.tensor(lengths, device=device),
            torch.from_numpy(style).to(device), torch.ones(len(lengths), device=device))


def _within(name: str, got, want, key: str) -> float:
    """Max |got - want|, raising past KOKORO_TOL[key] * max(1, max|want|)."""
    import torch

    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or not finite")
    err = (got - want).abs().max().item()
    limit = KOKORO_TOL[key] * max(1.0, want.abs().max().item())
    if err > limit:
        raise AssertionError(f"{name}: max |diff| {err:.3e} over {limit:.3e}")
    return err


def phase_kokoro() -> None:
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.kokoro import model as K

    cfg = K.KokoroConfig()
    spf = cfg.samples_per_frame
    model = K.init_kokoro_params(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda")
    log(f"kokoro: kokoro-82M geometry (PL-BERT 12 x 768, hidden 512, dec_mid 1024, upsample "
        f"(10, 6), n_fft 20, hop 5, 24 kHz; buckets {cfg.max_phonemes} phonemes, {cfg.max_frames} "
        f"frames), random weights from seed 7, float32: "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    args = _kokoro_inputs(cfg, (KOKORO_PHONEMES,), 8, "cuda")

    # K-a: one utterance as the backend runs a sentence; the second run counts
    def utterance():
        t0 = time.perf_counter()
        g, n_frames = K.encode_utterance(model, cfg, *args)
        torch.cuda.synchronize()
        t_enc = time.perf_counter()
        blocks = K.vocode_blocks(model, cfg, g, n_frames,
                                 rng=torch.Generator(device="cuda").manual_seed(1))
        first = next(blocks)  # a host array: the card has finished it
        t_first = time.perf_counter()
        audio = np.concatenate([first, *blocks], axis=1)
        t_end = time.perf_counter()
        return g, n_frames, audio, (t_enc - t0, t_first - t0, t_end - t0)

    for _ in range(2):
        g, n_frames, audio, (enc_s, first_s, wall_s) = utterance()
    frames = int(n_frames[0])
    seconds = frames * spf / cfg.sample_rate
    if audio.shape != (1, frames * spf) or not np.isfinite(audio).all():
        raise AssertionError(f"kokoro K-a: audio {audio.shape} for {frames} frames, or not finite")
    log(f"kokoro K-a: {KOKORO_PHONEMES} phonemes -> n_frames {frames} (random-weight durations "
        f"~{cfg.max_dur // 2} frames per phoneme, compressed to the {cfg.max_frames}-frame bucket), "
        f"{seconds:.2f} s of audio; encode_ms {1e3 * enc_s:.3f} first_block_ms {1e3 * first_s:.3f} "
        f"(encode + first 64-frame block, on the host) wall_ms {1e3 * wall_s:.3f} "
        f"RTFx {seconds / wall_s:.2f}; max|audio| {np.abs(audio).max():.4g}")

    _kokoro_card_vs_cpu(K, cfg, model, args)
    _kokoro_batch(K, cfg, model)
    _kokoro_streaming(K, cfg, model, g, n_frames)
    _kokoro_profile(K, cfg, model, args)


def _rel_l2(name: str, got, want, bound: float) -> float:
    """||got - want|| / ||want||, raising past ``bound``."""
    import torch

    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or not finite")
    rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
    if not rel <= bound:
        raise AssertionError(f"{name}: relative L2 {rel:.3e} over {bound}")
    return rel


def _kokoro_stages(K, cfg, m, args, gens, har=None) -> dict:
    """encode -> decoder -> harmonic features -> generator, on m's device,
    with noise from ``gens`` (per row) and the generator on ``har`` when
    given, else on its own features. The harmonic features come back as
    re/im (free of the phase's +-pi branch) under "har_c"."""
    import torch

    dev = m.device
    g, n_frames = K.encode_utterance(m, cfg, *(a.to(dev) for a in args))
    noise = K._source_noise(gens, len(gens), cfg.harmonics + 1,
                            cfg.max_frames * cfg.samples_per_frame, dev)
    with K._inference():
        x, _ = K.decode_audio(m, cfg, *g[:3], g[3], n_frames)
        own = K.har_features(m, cfg, g[1], *noise)
        audio = K.generate_waveform(m, cfg, x, g[3], g[1], n_frames, *noise,
                                    har_feat=own if har is None else har.to(dev))
    nb = cfg.gen_n_fft // 2 + 1
    mag, phase = own[:, :nb], own[:, nb:]
    return {"n_frames": n_frames.tolist(), "asr": g[0], "f0": g[1], "n": g[2], "x": x,
            "har": own, "har_c": torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], 1),
            "audio": audio}


def _compare_stages(name: str, got: dict, want: dict, rows=None) -> dict:
    """Every stage of ``got`` (rows ``rows`` of it) against ``want``; returns
    the max |diff| of each."""
    if got["n_frames"][slice(*rows) if rows else slice(None)] != want["n_frames"]:
        raise AssertionError(f"{name}: n_frames {got['n_frames']} vs {want['n_frames']}")
    errs = {}
    for key in ("asr", "f0", "n", "x", "har_c", "audio"):
        a = got[key][slice(*rows)] if rows else got[key]
        errs[key] = _within(f"{name} {key}", a, want[key], "har" if key == "har_c" else key)
    return errs


def _kokoro_card_vs_cpu(K, cfg, model, args) -> None:
    """K-b: the same weights and the same host-drawn noise on both devices,
    stage by stage (the card's generator on the CPU's harmonic features) and
    whole (each on its own features); then the card with TF32 allowed in
    cuDNN, for its error and time."""
    import torch

    cpu_model = K.KModel.empty(cfg, "cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_args = tuple(a.cpu() for a in args)

    def gens():
        return [torch.Generator().manual_seed(3)]  # host draws, moved to the model's device

    host = _kokoro_stages(K, cfg, cpu_model, cpu_args, gens())

    def whole(m, a, sync):
        t0 = time.perf_counter()
        g, n_frames = K.encode_utterance(m, cfg, *a)
        audio = K.vocode(m, cfg, g, n_frames, rng=gens())
        sync()
        return audio, time.perf_counter() - t0

    def card_run() -> tuple[dict, float, float]:
        stages = _kokoro_stages(K, cfg, model, args, gens(), har=host["har"])
        whole(model, args, torch.cuda.synchronize)
        audio, wall = whole(model, args, torch.cuda.synchronize)
        rel = (torch.linalg.norm(audio.cpu() - host_audio) / torch.linalg.norm(host_audio)).item()
        return stages, wall, rel

    host_audio, host_wall = whole(cpu_model, cpu_args, lambda: None)
    card, card_wall, card_rel = card_run()
    errs = _compare_stages("kokoro K-b card vs CPU", card, host)
    if not card_rel <= KOKORO_OWN_FEATURES_REL_L2:
        raise AssertionError(f"kokoro K-b whole synthesis: relative L2 {card_rel:.3e}")
    real = K._CUDNN
    try:
        K._CUDNN = K._CudnnScope(allow_tf32=True)
        tf32, tf32_wall, tf32_rel = card_run()
    finally:
        K._CUDNN = real
    tf32_errs = {key: (tf32[key].float().cpu() - host[key]).abs().max().item()
                 for key in ("asr", "f0", "n", "x", "har_c", "audio")}

    def show(e: dict) -> str:
        return " ".join(f"{k}_err {v:.3e}" for k, v in e.items())

    log(f"kokoro K-b card vs CPU (n_frames {host['n_frames'][0]} both; float32, TF32 off in "
        f"cuDNN): {show(errs)} (audio on the CPU's harmonic features; scale max|audio| "
        f"{host['audio'].abs().max().item():.4g}, max|x| {host['x'].abs().max().item():.4g}); "
        f"whole synthesis on own features rel_L2 {card_rel:.3e}; encode+vocode card_ms "
        f"{1e3 * card_wall:.3f} cpu_ms {1e3 * host_wall:.3f}")
    log(f"kokoro K-b with TF32 allowed in cuDNN (not kept): {show(tf32_errs)}; whole synthesis "
        f"rel_L2 {tf32_rel:.3e}; encode+vocode card_ms {1e3 * tf32_wall:.3f}")


def _kokoro_batch(K, cfg, model) -> None:
    """K-c: four rows of different lengths, each with its own generator,
    against each row's solo run: every stage (the batch's generator on the
    solo runs' harmonic features), then the whole synthesis
    (``synthesize_frames``) on each side's own features."""
    import torch

    args = _kokoro_inputs(cfg, KOKORO_BATCH, 9, "cuda")
    seeds = list(range(11, 11 + len(KOKORO_BATCH)))

    def gens(ss):
        return [torch.Generator(device="cuda").manual_seed(s) for s in ss]

    solo = [_kokoro_stages(K, cfg, model, tuple(a[i : i + 1] for a in args), gens([s]))
            for i, s in enumerate(seeds)]
    batch = _kokoro_stages(K, cfg, model, args, gens(seeds),
                           har=torch.cat([one["har"] for one in solo]))
    own = _kokoro_stages(K, cfg, model, args, gens(seeds))
    worst = {}
    for i, one in enumerate(solo):
        for key, err in _compare_stages(f"kokoro K-c row {i}", batch, one, (i, i + 1)).items():
            worst[key] = max(worst.get(key, 0.0), err)
    K.synthesize_frames(model, cfg, *args, rng=gens(seeds))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, n_frames = K.synthesize_frames(model, cfg, *args, rng=gens(seeds))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    _within("kokoro K-c synthesize_frames vs its stages", audio, own["audio"], "audio")
    solo_s, rels = 0.0, []
    for i, s in enumerate(seeds):
        t0 = time.perf_counter()
        alone, _ = K.synthesize_frames(model, cfg, *(a[i : i + 1] for a in args), rng=gens([s]))
        torch.cuda.synchronize()
        solo_s += time.perf_counter() - t0
        rels.append(_rel_l2(f"kokoro K-c row {i} whole synthesis", audio[i], alone[0],
                            KOKORO_OWN_FEATURES_REL_L2))
    log(f"kokoro K-c batch of {len(KOKORO_BATCH)} ({list(KOKORO_BATCH)} phonemes -> n_frames "
        f"{n_frames.tolist()}): rows vs solo "
        + " ".join(f"{k}_err {v:.3e}" for k, v in worst.items())
        + f"; whole synthesis rel_L2 max {max(rels):.3e}; batch_ms {1e3 * batch_s:.3f} "
        f"solo_sum_ms {1e3 * solo_s:.3f}")


def _kokoro_streaming(K, cfg, model, g, n_frames) -> None:
    """K-d: the streamed blocks cover n_frames x 600 samples; they equal
    ``vocode`` where the utterance fits one block, and stay within the CPU
    test's bound where it does not."""
    import numpy as np
    import torch

    spf = cfg.samples_per_frame
    short = _kokoro_inputs(cfg, (2,), 10, "cuda")
    cases = [("one block", *K.encode_utterance(model, cfg, *short)), ("multi-block", g, n_frames)]
    for name, gg, nf in cases:
        frames = int(nf[0])
        full = K.vocode(model, cfg, gg, nf, rng=torch.Generator(device="cuda").manual_seed(5))
        full = full[:, : frames * spf].cpu().numpy()
        blocks = list(K.vocode_streaming(model, cfg, gg, nf,
                                         rng=torch.Generator(device="cuda").manual_seed(5)))
        joined = np.concatenate(blocks, axis=1)
        if joined.shape != (1, frames * spf):
            raise AssertionError(f"kokoro K-d {name}: {joined.shape[1]} samples for {frames} frames")
        if frames <= 64:  # vocode_streaming's block
            err = _within(f"kokoro K-d {name}", joined, full, "audio")
            detail = f"max_err {err:.3e} vs vocode"
        else:
            rel = float(np.linalg.norm(joined - full) / np.linalg.norm(full))
            if not rel < KOKORO_MULTI_BLOCK_REL_L2:
                raise AssertionError(f"kokoro K-d {name}: relative L2 {rel:.3f} vs vocode")
            detail = f"rel_L2 {rel:.4f} vs vocode (bound {KOKORO_MULTI_BLOCK_REL_L2})"
        log(f"kokoro K-d {name}: n_frames {frames}, {len(blocks)} blocks, "
            f"{joined.shape[1]} samples = n_frames x {spf}; {detail}")


def _kokoro_profile(K, cfg, model, args) -> None:
    """K-e: one utterance (encode, then every block) under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def once():
        g, n_frames = K.encode_utterance(model, cfg, *args)
        for _ in K.vocode_blocks(model, cfg, g, n_frames,
                                 rng=torch.Generator(device="cuda").manual_seed(1)):
            pass

    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy <= 0:
        raise AssertionError("kokoro profile: no device time in the trace")
    launches = sum(e.count for e in kernels)
    log(f"kokoro K-e profiled utterance: wall_s {wall:.4f} device_busy_s {busy:.4f} "
        f"idle_share {1 - busy / wall:.4f} kernel launches {launches}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
