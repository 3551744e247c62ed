#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``open_speech_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

  1. device: CUDA with capability (9, 0); prints the card's name and power
     limit as nvidia-smi reports them.
  2. build: compiles the port's CUDA kernels from ``kernels/csrc`` with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the served path gives it, in bf16 and f32; times at the
     whisper encoder shape (kernel, plain version, the PyTorch library call
     as a yardstick, and the card's lower bound for the same work).
  4. main path: whisper-large-v3-turbo (random weights from seed 0, bf16)
     through the port's router with the REST defaults (beam 5, temperature
     fallback), at full width; counts kernel launches per request.
  5. fixture: the trained tiny checkpoint ``tests/fixtures/test-tiny-eot``
     in float32 on the card against the CPU; tokens must be equal.

The last two lines of standard output are the kernels' JSON line and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_build() -> None:
    from open_speech_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(force=True)  # from the checkout's sources
    log(f"build: {len(logs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for stem, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {stem}: {line.strip()}")


# ── phase 3: kernels against their plain versions ────────────────────────

# (B, H, Tq, Tk, D, causal): the encoder, the decoder prefill at the prompt
# lengths the seek loop makes, rectangular causal both ways, test-tiny
FLASH_SHAPES = [
    (1, 20, 1500, 1500, 64, False),
    (1, 20, 1, 1, 64, True),
    (1, 20, 3, 3, 64, True),
    (1, 20, 12, 12, 64, True),
    (1, 20, 140, 140, 64, True),
    (2, 4, 37, 100, 64, True),
    (2, 4, 100, 37, 64, True),
    (1, 2, 60, 60, 32, False),
    (1, 2, 60, 60, 32, True),
]
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _flash_bound_ms(b, h, t_q, t_k, d, causal, itemsize) -> tuple[float, str]:
    """Least time for the call: visible (q, k) pairs at the peak rate for
    the dtype vs each input read once and the output written once."""
    if causal:
        visible = sum(min(max(i + t_k - t_q + 1, 0), t_k) for i in range(t_q))
    else:
        visible = t_q * t_k
    flops = 4 * b * h * visible * d
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_F32_FLOPS
    nbytes = b * h * (2 * t_q + 2 * t_k) * d * itemsize
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels() -> dict:
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
            if not (out.shape == q.shape and out.dtype == dtype and err <= TOL[name]):
                raise AssertionError(
                    f"flash_attention {name} [{b},{h},{t_q},{t_k},{d}] causal={causal}: "
                    f"max_abs_err {err:.3e} > {TOL[name]:.0e}"
                )
            if t_q > t_k and causal:  # rows left of the first key are zeros
                n_zero = t_q - t_k
                if out[:, :, :n_zero].abs().max().item() != 0.0:
                    raise AssertionError("flash_attention: zero-key rows are not zero")
            worst = max(worst, err)
            log(f"flash_attention {name:8s} [{b},{h},{t_q},{t_k},{d}] causal={int(causal)} "
                f"max_abs_err {err:.3e} (tol {TOL[name]:.0e})")

    # times at the encoder shape, bf16 (the served path)
    b, h, t, d = 1, 20, 1500, 64
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kernel_ms = cuda_ms(lambda: A.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: A.flash_attention_reference(q, k, v), iters=10)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound_ms, bound_by = _flash_bound_ms(b, h, t, t, d, False, 2)
    log(f"flash_attention bf16 [1,20,1500,64]: kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
    return {
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    device = phase_device()
    phase_build()
    kernels = [phase_kernels()]
    launches = phase_main()
    phase_fixture()
    for entry in kernels:
        entry["launches"] = launches.get(entry["name"], 0)
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} was not launched on the main path")
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


def phase_main() -> dict:
    import math

    import torch

    from open_speech_tpu_torch.models.whisper import transcribe as T
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import (
        BackendRouter,
        transcription_response,
        translation_response,
    )

    t0 = time.perf_counter()
    router = BackendRouter()  # settings defaults: cuda, bfloat16, beam 5
    router.load_model(MAIN_MODEL)  # random init from seed 0 + warmup
    torch.cuda.synchronize()
    log(f"main: loaded {MAIN_MODEL} (random weights, bf16) with warmup in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = router.get_backend(MAIN_MODEL)._models[MAIN_MODEL]["cfg"]
    requests = [
        ("a transcribe 5 s json", 5.0, 1, dict(response_format="json")),
        ("b transcribe 45 s verbose_json + prompt", 45.0, 2,
         dict(response_format="verbose_json", prompt=PROMPT)),
        ("c translate 10 s srt", 10.0, 3, dict(response_format="srt")),
    ]
    total = {"flash_attention": 0}
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
        log(f"main {name}: wall_s {wall:.3f} audio_s {seconds} rtfx {seconds / wall:.3f} "
            f"windows {enc.windows} flash_launches {n} (encoder {enc.encoder_launches}, "
            f"prefill {prefill})")
        if enc.windows < 1 or enc.encoder_launches != cfg.n_audio_layer * enc.windows:
            raise AssertionError(f"{name}: want {cfg.n_audio_layer} encoder launches per window")
        if prefill <= 0 or prefill % cfg.n_text_layer:
            raise AssertionError(f"{name}: causal prefill launches {prefill}")
        if kw["response_format"] == "json":
            if set(body) != {"text"} or not isinstance(body["text"], str):
                raise AssertionError(f"{name}: json body {body!r}")
        elif kw["response_format"] == "verbose_json":
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
    return total


# ── phase 5: the trained fixture, card against CPU ───────────────────────


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

    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.whisper.model import decoder_forward
    from open_speech_tpu_torch.ops import audio as codec

    settings.stt_model_dir = str(Path(__file__).resolve().parent / "tests" / "fixtures")
    model_id = "test-tiny-eot"
    card = TorchWhisperBackend(device="cuda", compute_type="float32")  # TF32 off
    host = TorchWhisperBackend(device="cpu", compute_type="float32")
    card.load_model(model_id)
    host.load_model(model_id)
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


if __name__ == "__main__":
    sys.exit(main())
