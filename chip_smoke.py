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
  8. Kokoro serving: the same geometry behind ``TTSRouter`` and
     ``speech_response`` (the body of ``POST /v1/audio/speech``), loaded
     with the TTS batcher on (its warmup batch included). T-a: a
     two-sentence request, one-shot WAV and streamed PCM (first chunk, wall,
     RTFx, G2P ms per sentence). T-b: 1, 4 and 16 concurrent streamed
     requests through the batcher and 16 without it (first chunk p50 and
     max, wall, batches, peak memory). T-c: a row of a batch of four
     against the same request alone, and the served WAV against
     ``vocode_blocks`` called directly. T-d: phases 7 and 8 launch none of
     the flash kernels. T-e: one batch of 16 sentences under torch.profiler.
  9. int8 compute (``STT_COMPUTE_TYPE=int8``): Q-a loads
     whisper-large-v3-turbo again at int8 (the same seed-0 weights, packed
     at load, then warmed up) and runs request a of phase 4 on the bf16
     and the int8 model in turns: wall, RTFx, encode ms per window,
     ``decode_step`` ms per call, K1 launches (must be equal), resident and
     peak card memory. Q-b: ``test-tiny-eot`` packed at a float32 base,
     card against CPU (REST greedy and beam 5, a streaming session with K2,
     three windows through the batcher: must be equal); then the backend
     at int8 (bf16 base), card against CPU (printed).
 10. speculative decoding (``OS_SPEC_DRAFT_MODEL``): Sp-a ``test-tiny-eot``
     at float32 with the draft ``test-tiny-draft``, gamma 4: card tokens
     equal plain greedy's and the CPU's, through the speculative decode.
     Sp-b: whisper-large-v3 with distil-large-v3 as its draft (random,
     bf16), one 5 s upload with and without the draft: wall, tokens,
     rounds, accepted, host syncs per round (must be 1), K1 launches, and
     the first bf16 divergence from plain greedy with its top-2 margin.
     Sp-c: the target as its own draft against ``greedy_decode``.
 11. the server (``server/app.py`` on the port's HTTP/WebSocket shell): 11a
     serves phase 4's router and a kokoro-82M ``TTSRouter`` from this process
     on 127.0.0.1 (TLS off) and drives it with a stdlib client: requests a
     and c of phase 4 as multipart POSTs (the body and the K1 launches must
     equal the direct call's; /health must answer while c runs), the
     two-sentence streamed PCM speech request (chunked; TTFA beside the
     direct first chunk), and a ~10 s paced ``/v1/audio/stream`` session
     over a masked-frame client (K2 and combine launches = 32 x block
     encodes; interim turnaround, final latency). 11b runs ``python -m
     open_speech_tpu_torch.server`` with the fixture preloaded on the card:
     the clips' text must equal the CPU's, and SIGTERM must end it with
     exit 0.
 12. realtime and Wyoming (``server/realtime/``, ``server/wyoming/``) on
     phase 4's router and phase 11's kokoro-82M ``TTSRouter`` through
     ``create_app``: R-a two turns of 5 s 24 kHz PCM16 appends, a commit and
     a two-sentence response over a ``realtime`` socket (transcript and K1
     launches equal to ``_run_stt``'s, decoded deltas equal to the direct
     synthesis' bytes; commit latency, first delta, wall); R-b a
     ``response.cancel`` after the first delta (deltas after it, time to the
     cancelled ``response.done``, chunks synthesized); R-c server VAD at
     ``OS_VAD_DEVICE`` = the card and = the host (one call per append, ms
     per append) and a language-pinned commit through the continuous
     batcher (32 K1 per admission); W-a the Wyoming server: describe, a 5 s
     transcribe (beam 5 with fallback, the VAD on the card) equal to the
     router called with the handler's arguments, a synthesize equal to the
     direct bytes; then ``test-tiny-eot`` on the card behind a second app:
     a realtime commit and a Wyoming transcribe give the CPU's text. Fails
     on any warning of the realtime or Wyoming modules (a disabled or
     failed VAD).
 13. model management (``runtime/model_manager.py``, ``runtime/lifecycle.py``,
     ``server/metrics.py`` behind ``create_app``) over a fresh bf16 turbo
     ``BackendRouter`` on the card and phase 11's ``TTSRouter``: 13a ``POST
     /api/models/{turbo}/load`` (loaded on cuda:0 by torch-whisper; K1
     launches equal to a direct ``load_model``'s; status, progress,
     ``/api/ps``; walls and resident bytes); 13b request a through the
     route: ``/metrics`` counts it, the recorded RTFx agrees with the
     client's within the HTTP overhead, a speech request adds a TTFA;
     ``/api/stats`` has the JAX app's keys; 13c ``/api/profiler/start``, one
     transcription, ``stop``: the Chrome trace's ``flash_fwd_bf16`` kernel
     events equal the K1 launches counted, and a second start answers 409;
     13d turbo idle past ``OS_MODEL_TTL`` with a pinned batcher in the pool:
     one lifecycle sweep evicts it and retires the batcher, and the card's
     allocated memory returns to within 64 MiB of the phase's baseline;
     then ``OS_MAX_LOADED_MODELS=1`` evicts the older of the fixture and
     turbo; 13e ``DELETE /api/models/{turbo}`` (then 404), the memory back.
 14. Piper (VITS) and the speech effects (``models/piper``,
     ``tts/backends/piper_torch.py``, ``PiperBatcher``, ``audio/effects.py``):
     14a piper "medium" at full width (``PiperConfig()``, random weights
     from seed 11, float32) card against CPU stage by stage (text encoder,
     log durations, durations and n_frames exact, flow, audio), one
     128-phoneme row's wall and RTFx, 4 and 16 concurrent rows through the
     batcher (each row = its solo run), a profiled synthesis; 14b the
     registry voice behind ``create_app``: speech WAV (22.05 kHz) and
     streamed PCM equal to the direct backend call, Wyoming describe (its
     30 Piper voices) and synthesize at 16 kHz, the unload and load routes
     giving the voice's bytes back, ``pocket-tts`` serving its own audio;
     14c the five effects and a chain on 12 s at 24 kHz against the CPU
     with ms per effect, and a speech request with the chain, whole and
     streamed. Fails if a flash kernel is launched in phase 14.
 15. Pocket TTS (``models/pocket``, ``runtime/pocket_batcher.py``,
     ``tts/backends/pocket_tts.py``) at full width (``PocketLMConfig()`` +
     ``MimiConfig()``, random weights from seed 13, float32, TF32 off):
     15a card against CPU: the Mimi codes of a 2 s clip (equal wherever
     the CPU's RVQ margin exceeds 1e-3), a voice prompt's caches, 24 frames
     teacher-forced on the CPU's tokens (hidden, text and depformer logits
     per step within relative L2 1e-4; tokens equal at every decision whose
     top-2 margin exceeds 1e-3), the card's streamed decode of those frames
     against the CPU's whole decode; a sentence's TTFA, wall, ms per frame
     and RTFx, and a profiled frame (launches, idle share); 15b the slot
     pool at 1, 4 and 16 sessions (each row's frames and PCM against its
     solo run, TTFA, wall, peak memory) and the host syncs of its groups
     (at most one each); 15c ``pocket-tts`` behind ``create_app``: speech
     with a speaker, a base64 reference clip and a voice design, whole and
     streamed, and the clone route, each equal to the direct backend call;
     capabilities, voices and Wyoming describe; the load and unload routes
     giving the card's memory back. Fails if a flash kernel is launched.
 16. speaker diarization (``models/{segmentation,wespeaker,ge2e,diarize}.py``,
     ``diarization.py``), run after phase 12 while phase 4's router is
     loaded: PyanNet segmentation-3.0 and WeSpeaker ResNet34 at full width
     from random released-layout checkpoints (seed 17) found through
     ``OS_SEGMENTATION_CKPT_PATH`` and ``OS_WESPEAKER_CKPT_PATH`` (both must
     convert), GE2E and the conv embedder, float32 with TF32 off. 16a card
     against CPU: segmentation log-probs of a 60 s three-speaker
     recording's chunks (relative L2, least argmax margin, every decision
     past 1e-3 equal), kaldi fbank, WeSpeaker, GE2E and conv embeddings of
     16 windows, and the whole segmented and energy-gated diarizations
     (turns equal). 16b: both pipelines on 60 s and 10 min (wall, RTFx,
     segmentation and embedding time, host gathering and clustering, peak
     memory), a batch of 8 chunks and a 512-window dispatch alone, a
     profiled segmentation batch. 16c: ``POST
     /v1/audio/transcriptions?diarize=true`` with ``STT_DIARIZE_ENABLED``
     equals the direct transcription plus the direct diarization, with the
     plain transcription's K1 launches; 400 with the setting off. Fails if
     a flash kernel is launched in 16a or 16b.

Each phase's seconds, and the whole script's, are printed on lines of
their own.

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
    t_script = time.perf_counter()

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name} seconds: {time.perf_counter() - t0:.1f}")
        return out

    device = timed("1 (device)", phase_device)
    timed("2 (build)", phase_build)
    kernels = timed("3 (kernels)", phase_kernels)
    launches, router, seq_rtfx = timed("4 (REST)", phase_main)
    launches["flash_attention"] += timed("4b (batched REST)", phase_rest_batched, router, seq_rtfx)
    streaming = timed("5 (streaming)", phase_streaming, router)
    launches["flash_attention"] += streaming.pop("flash_attention")  # S3's admissions
    launches.update(streaming)
    timed("6 (fixture)", phase_fixture)
    from open_speech_tpu_torch.ops import attention as A

    before = dict(A.launches)
    timed("7 (kokoro)", phase_kokoro)
    timed("8 (kokoro serving)", phase_kokoro_serving)
    if dict(A.launches) != before:  # Kokoro has no hand kernel on its path
        raise AssertionError(f"kokoro launched the flash kernels: {before} -> {dict(A.launches)}")
    log(f"kokoro serving T-d: flash launch counts unchanged through phases 7 and 8: {before}")
    timed("9 (int8)", phase_int8, router)
    timed("10 (speculative)", phase_spec)
    tts = timed("11-12 (kokoro load)", load_kokoro)
    # 11-13: the same kernels through the sockets, each counted from 0
    phases = [timed("11 (server)", phase_server, router, tts),
              timed("12 (realtime and Wyoming)", phase_realtime, router, tts),
              timed("16 (diarization)", phase_diarize, router)]  # here: 16c serves phase 4's router
    del router  # phase 13 loads turbo on a router of its own
    phases.append(timed("13 (model management)", phase_management, tts))
    timed("14 (piper and effects)", phase_piper)
    timed("15 (pocket)", phase_pocket)
    for phase in phases:
        for key, n in phase.items():
            launches[key] = launches.get(key, 0) + n
    tts.unload_model("kokoro")
    for entry in kernels:  # K1 from REST (both paths) and S3, K2 and its combine from S1/S2
        entry["launches"] = launches.get(entry["name"], 0)
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} was not launched on its path")
    log(f"whole script seconds: {time.perf_counter() - t_script:.1f}")
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


def _speechlike(seconds: float, seed: int, sr: int = SR):
    """Deterministic test signal: gated harmonic tones over noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 60 * np.sin(2 * np.pi * 0.3 * t)
    voice = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / sr) / h for h in (1, 2, 3, 4))
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

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.runtime.router import BackendRouter

    settings.stt_model_dir = str(Path(__file__).resolve().parent / "tests" / "fixtures")
    model_id = "test-tiny-eot"
    routers = {dev: BackendRouter(device=dev, compute_type="float32")  # TF32 off
               for dev in ("cuda", "cpu")}
    for router in routers.values():
        router.load_model(model_id)
    _fixture_rest(routers, model_id, "fixture")
    _fixture_streaming(routers, model_id)
    _fixture_batcher(routers, model_id)
    _fixture_batched_longform(routers, model_id)


def _fixture_rest(routers: dict, model_id: str, label: str, strict: bool = True) -> None:
    """The two beep clips of tests/test_eot_ckpt.py, greedy and beam 5, no
    fallback, through each router's backend: card tokens against the
    CPU's. On a difference, the first differing step and the CPU's top-2
    logit margin there; it raises unless ``strict`` is off."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.whisper.model import decoder_forward, encode
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim

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
            log(f"{label} beeps k={k} beam={beam}: {len(toks_c)} tokens on cuda, "
                f"{len(toks_h)} on cpu, equal={toks_c == toks_h}")
            if toks_c != toks_h:
                i = _first_difference(toks_c, toks_h)
                entry = host._models[model_id]
                sp = entry["tok"].special
                prefix = sp.sot_sequence("en", "transcribe") + toks_h[:i]
                cfg = entry["cfg"]
                fpw = cfg.n_audio_ctx * 2  # as the seek loop pads and slices
                padded = pad_or_trim(torch.from_numpy(clip), 2 * fpw * 160)
                mel = log_mel_spectrogram(padded, n_mels=cfg.n_mels)[:, :fpw]
                enc_out = encode(entry["model"], mel[None], cfg)
                logits = decoder_forward(entry["model"], torch.tensor([prefix]), enc_out, cfg)[0, -1]
                top2 = torch.topk(logits, 2).values
                msg = (f"{label} k={k} beam={beam}: tokens differ at step {i} "
                       f"(cuda {toks_c[i:i + 3]} vs cpu {toks_h[i:i + 3]}); "
                       f"top-2 logit margin there {float(top2[0] - top2[1]):.3e}")
                if strict:
                    raise AssertionError(msg)
                log(msg)


def _fixture_batcher(routers: dict, model_id: str, label: str = "fixture",
                     against_greedy: bool = True) -> None:
    """Three concurrent windows through the continuous batcher on the card
    and on the CPU (the same mel windows): equal tokens, and (with
    ``against_greedy``) each equal to the card's B=1 greedy decode of its
    window. An int8 model's pool stays dense bf16 while its greedy decode
    reads int8 cross packs, so there the greedy tokens are only printed."""
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
    log(f"{label} batcher, 3 windows: tokens per window {[len(t) for t in got['cuda']]} on "
        f"cuda, equal to cpu={got['cuda'] == got['cpu']}, to cuda B=1 greedy="
        f"{got['cuda'] == greedy}")
    if (got["cuda"] != got["cpu"] or (against_greedy and got["cuda"] != greedy)
            or not any(got["cpu"])):
        raise AssertionError(f"{label} batcher: cuda {got['cuda']} cpu {got['cpu']} "
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


def _fixture_streaming(routers: dict, model_id: str, label: str = "fixture") -> None:
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
            _check_session_bounds(f"{label} stream {dev}", ws)
            events[dev] = [{k: v for k, v in e.items() if k != "session_id"} for _, e in ws.events]
            launched = A.launches["flash_attention_varlen"] - before
            if (launched > 0) != (dev == "cuda"):
                raise AssertionError(f"{label} stream {dev}: {launched} K2 launches")
        n = len([e for e in events["cpu"] if e["type"] == "transcript"])
        log(f"{label} stream {seconds} s: {len(events['cuda'])} events on cuda, "
            f"{len(events['cpu'])} on cpu ({n} transcripts), equal={events['cuda'] == events['cpu']}")
        if events["cuda"] != events["cpu"] or n == 0:
            diff = next((i for i, (a, b) in enumerate(zip(events["cuda"], events["cpu"]))
                         if a != b), None)
            raise AssertionError(f"{label} stream {seconds} s: events differ at {diff}: "
                                 f"{events['cuda'][diff:diff + 2]} vs {events['cpu'][diff:diff + 2]}"
                                 if diff is not None else f"{label} stream {seconds} s: {n} transcripts")


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
    from open_speech_tpu_torch.ops import vocoder as V

    real = V.CUDNN_F32  # the scope every TTS model's inference() enters
    try:
        V.CUDNN_F32 = V._CudnnScope(allow_tf32=True)
        tf32, tf32_wall, tf32_rel = card_run()
    finally:
        V.CUDNN_F32 = real
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


# ── phase 8: Kokoro serving ──────────────────────────────────────────────

# two sentences of 55 and 53 phoneme ids (the rule G2P, vendored vocab)
SERVING_TEXT = ("Please call me back when you are ready to talk about the project. "
                "The weather should stay clear and warm for the rest of the week.")
SERVING_TEXTS = [  # one per concurrent request, in turn
    SERVING_TEXT,
    "Our train leaves at half past seven, so we should pack tonight. "
    "She found the old map in a box under the stairs last winter.",
]
SERVING_CONCURRENCY = (1, 4, 16)


def _pcm_seconds(n_bytes: int, rate: int) -> float:
    return n_bytes / 2 / rate


def phase_kokoro_serving() -> None:
    import numpy as np
    import torch

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.runtime import tts_batcher as TB
    from open_speech_tpu_torch.runtime.speech import speech_response
    from open_speech_tpu_torch.text.g2p import split_sentences
    from open_speech_tpu_torch.tts.router import TTSRouter

    router = TTSRouter()  # the card: settings.tts_effective_device
    backend = router.get_backend("kokoro")
    saved = settings.os_tts_batcher_enabled
    settings.os_tts_batcher_enabled = True
    try:
        t0 = time.perf_counter()
        router.load_model("kokoro")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cfg = backend._cfg
        rows = max(int(b) for b in settings.os_tts_precompile_buckets.split(",") if b.strip())
        log(f"kokoro serving: TTSRouter -> {type(backend).__name__} on {backend.device}, "
            f"kokoro-82M geometry ({cfg.max_phonemes} phonemes, {cfg.max_frames} frames), random "
            f"weights from seed 7, float32; load + warmup synthesis + batcher warmup batch of {rows} "
            f"rows {load_s:.3f} s; G2P {type(backend._g2p).__name__}")
        settings.os_tts_batcher_enabled = False
        _serving_one_request(router, backend, speech_response, split_sentences)
        _serving_concurrent(router, settings, TB, speech_response)
        _serving_checks(router, backend, settings, TB, speech_response, split_sentences)
        _serving_profile(backend, TB, split_sentences)
    finally:
        settings.os_tts_batcher_enabled = saved
        threads = [b._thread for b in TB._batchers.values() if b._thread is not None]
        TB.reset_tts_batchers()
        for thread in threads:
            thread.join(timeout=60)
        router.unload_model("kokoro")
        torch.cuda.empty_cache()


def _serving_one_request(router, backend, speech_response, split_sentences) -> None:
    """T-a: the two-sentence request, per-request path, one-shot WAV and
    streamed PCM; the second of two runs of each counts."""
    import numpy as np

    from open_speech_tpu_torch.ops import audio as codec

    sentences = split_sentences(SERVING_TEXT)
    g2p_ms, lengths = [], []
    for s in sentences:
        t0 = time.perf_counter()
        ids = backend._encode_text(s, "en-us")
        g2p_ms.append(1e3 * (time.perf_counter() - t0))
        lengths.append(len(ids) - 2)
    body = {"input": SERVING_TEXT, "voice": "af_heart"}
    for _ in range(2):
        t0 = time.perf_counter()
        ct, wav = speech_response(router, {**body, "response_format": "wav"})
        wav_s = time.perf_counter() - t0
    audio, rate = codec.read_wav(wav)
    if ct != "audio/wav" or rate != 24000 or audio.size == 0 or not np.isfinite(audio).all():
        raise AssertionError(f"kokoro serving T-a wav: {ct}, {rate} Hz, {audio.size} samples")
    wav_audio_s = audio.size / rate
    for _ in range(2):
        t0 = time.perf_counter()
        ct, chunks = speech_response(router, {**body, "response_format": "pcm"}, stream=True)
        sizes = [len(next(chunks))]
        ttfa_s = time.perf_counter() - t0
        sizes += [len(c) for c in chunks]
        wall_s = time.perf_counter() - t0
    pcm_audio_s = _pcm_seconds(sum(sizes), 24000)
    if ct != "audio/pcm" or abs(pcm_audio_s - wav_audio_s) > 0.05 * wav_audio_s:
        raise AssertionError(f"kokoro serving T-a pcm: {ct}, {pcm_audio_s} s vs wav {wav_audio_s} s")
    log(f"kokoro serving T-a ({len(sentences)} sentences, {lengths} phonemes; n_frames in "
        f"T-c): wav one-shot "
        f"wall_ms {1e3 * wav_s:.3f} (the first byte is the whole body) audio_s {wav_audio_s:.3f} "
        f"RTFx {wav_audio_s / wav_s:.2f}; pcm streamed TTFA_ms {1e3 * ttfa_s:.3f} wall_ms "
        f"{1e3 * wall_s:.3f} audio_s {pcm_audio_s:.3f} RTFx {pcm_audio_s / wall_s:.2f} in "
        f"{len(sizes)} chunks; G2P host ms per sentence "
        + " ".join(f"{m:.3f}" for m in g2p_ms) + f"; G2P {type(backend._g2p).__name__}")


def _serving_concurrent(router, settings, TB, speech_response) -> None:
    """T-b: N concurrent streamed PCM requests from threads, through the
    batcher (N = 1, 4, 16; each twice) and without it (16), in this call."""
    import statistics
    import threading

    import torch

    def run(n: int, batcher: bool, label: str) -> None:
        settings.os_tts_batcher_enabled = batcher
        for b in TB._batchers.values():  # this run's batches only
            b.stats.update(batches=0, jobs=0, peak_batch=0)
        start = threading.Barrier(n + 1)
        first, end, audio_s, errors = [0.0] * n, [0.0] * n, [0.0] * n, []

        def client(i: int) -> None:
            try:
                start.wait()
                _, chunks = speech_response(router, {
                    "input": SERVING_TEXTS[i % len(SERVING_TEXTS)], "voice": "af_heart",
                    "response_format": "pcm"}, stream=True)
                total = len(next(chunks))
                first[i] = time.perf_counter() - t0
                total += sum(len(c) for c in chunks)
                end[i] = time.perf_counter() - t0
                audio_s[i] = _pcm_seconds(total, 24000)
            except Exception as e:  # noqa: BLE001 — reported below, on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        start.wait()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads) or min(audio_s) <= 0:
            raise AssertionError(f"kokoro serving T-b n={n}: {errors or 'a client did not finish'}")
        stats = ""
        if batcher:
            (one,) = TB.tts_batcher_stats().values()
            stats = f"batches {one['batches']} for {one['jobs']} jobs, peak batch {one['peak_batch']}; "
        wall = max(end)
        log(f"kokoro serving T-b {n} concurrent, batcher {'on' if batcher else 'off'}, {label}: "
            f"TTFA_ms p50 "
            f"{1e3 * statistics.median(first):.3f} max {1e3 * max(first):.3f}; wall_ms "
            f"{1e3 * wall:.3f}; audio_s {sum(audio_s):.3f} (RTFx {sum(audio_s) / wall:.2f}); "
            f"{stats}peak card memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    for n in SERVING_CONCURRENCY:  # a batch size's first run pays cuDNN's plan builds
        run(n, True, "first run")
        run(n, True, "repeat")
    run(SERVING_CONCURRENCY[-1], False, "after the runs above")
    settings.os_tts_batcher_enabled = False


def _serving_checks(router, backend, settings, TB, speech_response, split_sentences) -> None:
    """T-c: a row of a batch of four against the same request alone (K-c's
    bound on own features), and the served WAV against ``vocode_blocks``
    called directly on the same ids, style and generators."""
    import queue

    import numpy as np
    import torch

    from open_speech_tpu_torch.audio.encode import encode_audio
    from open_speech_tpu_torch.audio.postprocessing import process_tts_chunks
    from open_speech_tpu_torch.models.kokoro import model as K
    from open_speech_tpu_torch.ops import audio as codec

    cfg, model, dev = backend._cfg, backend._model, backend.device
    sentences = [s for text in SERVING_TEXTS for s in split_sentences(text)]
    jobs = []
    for s in sentences:
        ids = backend._encode_text(s, "en-us")
        jobs.append((ids, backend._style_for("af_heart", len(ids) - 2), 1.0))
    batcher = TB.TTSBatcher(model, cfg)

    def run(js):
        sinks = [queue.Queue() for _ in js]
        batcher._run_batch([(*j, q) for j, q in zip(js, sinks)])
        out = []
        for q in sinks:
            parts = []
            while (item := q.get_nowait()) is not None:
                parts.append(item)
            out.append(np.concatenate(parts))
        return out

    batch = run(jobs)
    worst_rel, worst_abs = 0.0, 0.0
    for i, job in enumerate(jobs):
        (alone,) = run([job])
        worst_rel = max(worst_rel, _rel_l2(f"kokoro serving T-c row {i} vs alone", batch[i], alone,
                                           KOKORO_OWN_FEATURES_REL_L2))
        worst_abs = max(worst_abs, float(np.abs(batch[i] - alone).max()))

    # the served WAV against the direct calls, per-request path
    settings.os_tts_batcher_enabled = False
    _, wav = speech_response(router, {"input": SERVING_TEXT, "voice": "af_heart",
                                      "response_format": "wav"})
    served, _ = codec.read_wav(wav)
    direct, frames = [], []
    for s in split_sentences(SERVING_TEXT):
        ids = backend._encode_text(s, "en-us")
        style = torch.from_numpy(backend._style_for("af_heart", len(ids) - 2)[None]).to(dev)
        ph = torch.zeros((1, cfg.max_phonemes), dtype=torch.int64)
        ph[0, : len(ids)] = torch.tensor(ids)
        g, n_frames = K.encode_utterance(model, cfg, ph.to(dev), torch.tensor([len(ids)], device=dev),
                                         style, torch.ones(1, device=dev))
        frames.append(int(n_frames[0]))
        direct += [b[0] for b in K.vocode_blocks(model, cfg, g, n_frames, style)]
    raw = np.concatenate(direct)
    if raw.size != sum(frames) * cfg.samples_per_frame:
        raise AssertionError(f"kokoro serving T-c: {raw.size} samples for frames {frames}")
    (processed,) = process_tts_chunks(iter(direct), trim=settings.tts_trim_silence,
                                      normalize=settings.tts_normalize_output)
    want, _ = codec.read_wav(encode_audio(processed, 24000, "wav"))
    if served.shape != want.shape:
        raise AssertionError(f"kokoro serving T-c: served {served.shape} vs direct {want.shape}")
    served_err = float(np.abs(served - want).max())
    if served_err > KOKORO_TOL["audio"]:
        raise AssertionError(f"kokoro serving T-c: served vs direct max |diff| {served_err:.3e}")
    log(f"kokoro serving T-c: batch of {len(jobs)} through the batcher (16-frame first block, "
        f"32-frame blocks, int16 wire) rows vs alone rel_L2 max {worst_rel:.3e} max|diff| "
        f"{worst_abs:.3e} (bound rel_L2 {KOKORO_OWN_FEATURES_REL_L2}); served WAV {served.size} "
        f"samples = n_frames {frames} x {cfg.samples_per_frame} less {raw.size - served.size} "
        f"trimmed, vs vocode_blocks called directly max|diff| {served_err:.3e} "
        f"(identical {bool(served_err == 0.0)})")


def _serving_profile(backend, TB, split_sentences) -> None:
    """T-e: one batch of 16 sentences through the batcher's ``_run_batch``
    (the T-b shape) under torch.profiler: device busy, idle share."""
    import queue

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sentences = [s for text in SERVING_TEXTS for s in split_sentences(text)]
    jobs = []
    for i in range(16):
        ids = backend._encode_text(sentences[i % len(sentences)], "en-us")
        jobs.append((ids, backend._style_for("af_heart", len(ids) - 2), 1.0))
    batcher = TB.TTSBatcher(backend._model, backend._cfg)

    def once():
        sinks = [queue.Queue() for _ in jobs]
        batcher._run_batch([(*j, q) for j, q in zip(jobs, sinks)])

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
        raise AssertionError("kokoro serving profile: no device time in the trace")
    log(f"kokoro serving T-e profiled batch of 16 sentences (encode, 16-frame first block, 32-frame "
        f"blocks, int16 wire): wall_s {wall:.4f} device_busy_s {busy:.4f} idle_share "
        f"{1 - busy / wall:.4f} kernel launches {sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")



# ── phase 9: int8 compute ────────────────────────────────────────────────


class _Timed:
    """Wraps ``module.name`` for a ``with`` block: counts its calls and
    records CUDA events around each, read once the run is over. The queue
    is empty when a decode step starts (the loops sync every step), so an
    event span is the call's wall on the card, host launches included."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name, self.events = module, name, []

    def __enter__(self):
        import torch

        real = self.real = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def ms_per_call(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / max(1, len(self.events))


def _free(*routers) -> None:
    """Unload every model of ``routers`` and return the memory to the card."""
    import gc

    import torch

    for router in routers:
        for info in router.loaded_models():
            router.unload_model(info.model)
    gc.collect()
    torch.cuda.empty_cache()


def phase_int8(router) -> None:
    """Q-a: the phase-4 request a (5 s json, beam 5, fallback) on the loaded
    bf16 model and on the same seed-0 weights loaded at
    STT_COMPUTE_TYPE=int8 (packed at load, then warmed up): wall, RTFx,
    encode ms per window, decode_step ms per call, K1 launches (must be
    equal), resident and peak memory. Q-b: the fixture at int8, card
    against CPU. Frees both turbo models."""
    import torch

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.whisper import decode as D
    from open_speech_tpu_torch.models.whisper import transcribe as T
    from open_speech_tpu_torch.models.whisper.quantize import model_nbytes
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response

    settings.os_stt_batched_longform = False  # the int8 load warms beam 5 alone
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    q_router = BackendRouter(compute_type="int8")
    q_router.load_model(MAIN_MODEL)  # seed 0, packed, then the warmup: K1 on int8 activations
    torch.cuda.synchronize()
    log(f"int8 Q-a: loaded {MAIN_MODEL} at STT_COMPUTE_TYPE=int8 with warmup in "
        f"{time.perf_counter() - t0:.2f} s; card memory held after the load "
        f"{(torch.cuda.memory_allocated() - before) / 2**30:.3f} GiB")
    models = {name: r.get_backend(MAIN_MODEL)._models[MAIN_MODEL]["model"]
              for name, r in (("bf16", router), ("int8", q_router))}
    resident = {name: model_nbytes(m) for name, m in models.items()}
    wav = codec.write_wav(_speechlike(5.0, 1), SR)
    k1 = {}
    for name, r in (("bf16", router), ("int8", q_router), ("int8", q_router), ("bf16", router)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        A.launches["flash_attention"] = 0
        with _Timed(T, "encode") as enc, _Timed(D, "decode_step") as step:
            t1 = time.perf_counter()
            body = transcription_response(r, wav, model=MAIN_MODEL, response_format="json")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            enc_ms, step_ms = enc.ms_per_call(), step.ms_per_call()
        n = A.launches["flash_attention"]
        k1.setdefault(name, set()).add(n)
        _check_body(f"int8 Q-a {name}", body, "json", 5.0)
        log(f"int8 Q-a {name} a transcribe 5 s json (beam 5, fallback): wall_s {wall:.3f} "
            f"rtfx {5.0 / wall:.3f} windows {len(enc.events)} encode_ms/window {enc_ms:.3f} "
            f"decode_step calls {len(step.events)} ms/call {step_ms:.3f} flash_launches {n} "
            f"resident_GiB {resident[name] / 2**30:.3f} peak_over_resident_GiB "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f}")
    if len(k1["bf16"] | k1["int8"]) != 1:
        raise AssertionError(f"int8 Q-a: K1 launches differ for the same request: {k1}")
    log(f"int8 Q-a: resident bytes int8 / bf16 = {resident['int8']} / {resident['bf16']} = "
        f"{resident['int8'] / resident['bf16']:.4f}")
    _free(router, q_router)
    _int8_fixture()


def _int8_fixture() -> None:
    """Q-b: test-tiny-eot packed by quantize_whisper_params at a float32
    base (TF32 off since phase 6): REST greedy and beam 5, a streaming
    session (K2 in float32) and three windows through the batcher, card
    against CPU, must be equal. Then the backend at STT_COMPUTE_TYPE=int8
    (bf16 base), card against CPU: agreement printed, not held."""
    from open_speech_tpu_torch.models.whisper.quantize import quantize_whisper_params
    from open_speech_tpu_torch.runtime.router import BackendRouter

    model_id = "test-tiny-eot"
    routers = {dev: BackendRouter(device=dev, compute_type="float32") for dev in ("cuda", "cpu")}
    for router in routers.values():
        router.load_model(model_id)
        quantize_whisper_params(router.get_backend(model_id)._models[model_id]["model"])
    _fixture_rest(routers, model_id, "int8 Q-b (f32 base)")
    _fixture_streaming(routers, model_id, "int8 Q-b (f32 base)")
    _fixture_batcher(routers, model_id, "int8 Q-b (f32 base)", against_greedy=False)
    _free(*routers.values())
    routers = {dev: BackendRouter(device=dev, compute_type="int8") for dev in ("cuda", "cpu")}
    for router in routers.values():
        router.load_model(model_id)
    _fixture_rest(routers, model_id, "int8 Q-b backend (bf16 base)", strict=False)
    _free(*routers.values())


# ── phase 10: speculative decoding ──────────────────────────────────────

SPEC_TARGET, SPEC_DRAFT = "whisper-large-v3", "whisper-distil-large-v3"


class _Captured:
    """Wraps ``module.name`` for a ``with`` block and keeps each call's
    arguments and result."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def captured(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        setattr(self.module, self.name, captured)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def phase_spec() -> None:
    """Sp-a: test-tiny-eot at float32 through the backend with
    OS_SPEC_DRAFT_MODEL=test-tiny-draft, gamma 4: card tokens == plain
    greedy's == the CPU's, and the speculative decode ran. Sp-b:
    whisper-large-v3 with distil-large-v3 as its draft (random, bf16), one
    5 s upload with and without the draft: wall, tokens, rounds, accepted,
    host syncs per round (must be 1), K1 launches. Sp-c: the target as its
    own draft against greedy_decode on one encoder output."""
    import numpy as np

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.whisper import transcribe as T
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter

    model_id = "test-tiny-eot"
    settings.os_spec_gamma = 4
    routers = {dev: BackendRouter(device=dev, compute_type="float32") for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(11)
    kw = dict(language="en", beam_size=1, fallback=False, response_format="verbose_json")
    for k in (1, 3):
        wav = codec.write_wav(_beeps(k, rng), SR)
        settings.os_spec_draft_model = ""
        plain = routers["cuda"].transcribe(wav, model_id, **kw)
        settings.os_spec_draft_model = "test-tiny-draft"
        with _Captured(T, "speculative_greedy_decode") as spec:
            got = {dev: r.transcribe(wav, model_id, **kw) for dev, r in routers.items()}
        settings.os_spec_draft_model = ""
        toks = {name: [t for s in body["segments"] for t in s["tokens"]]
                for name, body in (("plain", plain), *got.items())}
        rounds = [(c[2].spec_rounds, c[2].spec_accepted) for c in spec.calls]
        log(f"spec Sp-a beeps k={k}: {len(toks['cuda'])} tokens, cuda spec == cuda plain "
            f"{toks['cuda'] == toks['plain']}, == cpu spec {toks['cuda'] == toks['cpu']}; "
            f"speculative_greedy_decode calls {len(spec.calls)} (rounds, accepted) {rounds}")
        if toks["cuda"] != toks["plain"] or toks["cuda"] != toks["cpu"] or len(spec.calls) < 2:
            raise AssertionError(f"spec Sp-a k={k}: {toks}, {len(spec.calls)} speculative calls")
    _free(*routers.values())
    _spec_full_width()


def _spec_full_width() -> None:
    import numpy as np
    import torch

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.whisper import decode as D
    from open_speech_tpu_torch.models.whisper import speculative as SP
    from open_speech_tpu_torch.models.whisper import transcribe as T
    from open_speech_tpu_torch.models.whisper.model import decoder_forward
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter

    settings.os_precompile_on_load = False  # the kernels are built (phase 2)
    # no warmed budget to round up to: a 5 s upload decodes its own 80
    # tokens (random weights never emit EOT), not 224
    settings.os_stt_precompile_budgets = ""
    router = BackendRouter()  # cuda, bf16
    t0 = time.perf_counter()
    for mid in (SPEC_TARGET, SPEC_DRAFT):
        router.load_model(mid)
    torch.cuda.synchronize()
    log(f"spec Sp-b: loaded {SPEC_TARGET} (target) and {SPEC_DRAFT} (draft), random, bf16, in "
        f"{time.perf_counter() - t0:.2f} s")
    wav = codec.write_wav(_speechlike(5.0, 9), SR)
    kw = dict(language="en", beam_size=1, fallback=False, response_format="json")
    runs = {}
    for name in ("plain", "spec", "spec", "plain"):
        settings.os_spec_draft_model = SPEC_DRAFT if name == "spec" else ""
        A.launches["flash_attention"] = 0
        with _Captured(T, "speculative_greedy_decode") as spec, \
                _Captured(T, "greedy_decode") as greedy:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if name == "spec" and name in runs:  # the second spec run counts its syncs
                syncs = _count_syncs(lambda: router.transcribe(wav, SPEC_TARGET, **kw))
            else:
                syncs = None
                router.transcribe(wav, SPEC_TARGET, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        calls = spec.calls or greedy.calls  # one per window
        results = [res for _args, _kw, res in calls]
        rounds = sum(res.spec_rounds or 0 for res in results)
        line = (f"spec Sp-b {name}: wall_s {wall:.3f} windows {len(calls)} tokens "
                f"{sum(int(res.lengths[0]) for res in results)} "
                f"flash_launches {A.launches['flash_attention']}")
        if name == "spec":
            line += f" rounds {rounds} accepted {sum(res.spec_accepted for res in results)}"
        if syncs is not None:
            per_round = [s for s in syncs if "speculative.py" in s and ".tolist()" in s]
            line += (f" host syncs {len(syncs)} ({len(per_round)} in the rounds: "
                     f"{len(per_round) / rounds:.3f} per round)")
            # one read per round; the rest (uploads, the result's reads) is
            # set-up that does not grow with the rounds
            if len(per_round) != rounds or len(syncs) - len(per_round) >= rounds:
                raise AssertionError(f"spec Sp-b: {len(per_round)} syncs in {rounds} rounds: "
                                     f"{syncs}")
        log(line + (" (random weights: the draft is almost never accepted, the worst case)"
                    if name == "spec" else ""))
        runs.setdefault(name, (calls[0][0], results[0]))
    settings.os_spec_draft_model = ""
    (model, cfg, sp, enc_out, prompt, opts), plain = runs["plain"][0][:6], runs["plain"][1]
    spec = runs["spec"][1]
    a, b = list(plain.tokens[0][: plain.lengths[0]]), list(spec.tokens[0][: spec.lengths[0]])
    if a == b:
        log(f"spec Sp-b: speculative tokens == plain greedy tokens ({len(a)}) in bf16")
    else:
        i = _first_difference(a, b)
        prefix = torch.tensor([list(prompt[0]) + a[:i]], device=enc_out.device)
        logits = decoder_forward(model, prefix, enc_out, cfg)[0, -1]
        top2 = torch.topk(logits, 2).values
        log(f"spec Sp-b: bf16 speculative tokens first differ from plain at step {i} "
            f"(plain {a[i:i + 3]} vs spec {b[i:i + 3]}); top-2 logit margin there "
            f"{float(top2[0] - top2[1]):.3e}")

    # Sp-c: the target as its own draft, the best case
    gamma = 4
    walls = {}
    for name in ("greedy", "self-draft", "self-draft", "greedy"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if name == "greedy":
            res = D.greedy_decode(model, cfg, sp, enc_out, prompt, opts)
        else:
            res = SP.speculative_greedy_decode(model, cfg, model, cfg, sp, enc_out, enc_out,
                                               prompt, opts, gamma=gamma)
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t1)
        runs[name] = res
    n = int(runs["greedy"].lengths[0]) + int((runs["greedy"].tokens[0] == sp.eot).any())
    selfd = runs["self-draft"]
    log(f"spec Sp-c self-draft gamma {gamma}: {n} tokens emitted, rounds {selfd.spec_rounds} "
        f"(ceil(n / (gamma + 1)) = {-(-n // (gamma + 1))}), accepted {selfd.spec_accepted}, "
        f"tokens == greedy {np.array_equal(selfd.tokens, runs['greedy'].tokens)}; wall_s "
        f"self-draft {' '.join(f'{w:.3f}' for w in walls['self-draft'])} greedy "
        f"{' '.join(f'{w:.3f}' for w in walls['greedy'])}")
    _free(router)


# ── phase 11: the HTTP and WebSocket server ─────────────────────────────

WS_SECONDS = 10.0  # the 11a socket session: 16 kHz PCM16 paced in 100 ms frames
SHELL_REPEATS = 5  # the shell-alone requests of each kind


class _Served:
    """``create_app(stt_router, tts_router)`` served on 127.0.0.1 (a free
    port, TLS off) by an event loop on a thread of its own."""

    def __init__(self, stt_router, tts_router) -> None:
        from open_speech_tpu_torch.server.app import create_app

        self.app = create_app(stt_router=stt_router, tts_router=tts_router)

    def __enter__(self):
        import threading

        from open_speech_tpu_torch.server.http import serve_app

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = self._run(serve_app(self.app, "127.0.0.1", 0))
        self.port = self.server.port
        return self

    def _run(self, coro, timeout: float = 120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def __exit__(self, *exc):
        try:
            self._run(self.server.close())
            self._run(self.app.cleanup())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
            self.loop.close()


def _http(port: int, method: str, path: str, body: bytes = b"", headers=None):
    """(status, headers, body) of one request on a new connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _multipart(fields: dict, audio: bytes) -> tuple[bytes, dict]:
    """A multipart/form-data body with ``fields`` and ``audio`` as ``file``."""
    import os

    boundary = "chipsmoke" + os.urandom(8).hex()
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="clip.wav"'
                 f"\r\nContent-Type: audio/wav\r\n\r\n".encode() + audio + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), {"Content-Type": f"multipart/form-data; boundary={boundary}"}


class _SocketClient:
    """A minimal RFC 6455 client on a plain socket: the handshake, masked
    frames out, and a reader thread that keeps every server text frame with
    its arrival time and answers the server's close frame."""

    def __init__(self, port: int, path: str, protocol: str | None = None) -> None:
        import base64
        import hashlib
        import os
        import socket
        import threading

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=300)
        key = base64.b64encode(os.urandom(16)).decode()
        offer = f"Sec-WebSocket-Protocol: {protocol}\r\n" if protocol else ""
        self.sock.sendall(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                          f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n{offer}"
                          "Sec-WebSocket-Version: 13\r\n\r\n".encode())
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += self.sock.recv(1)
        accept = base64.b64encode(hashlib.sha1(
            key.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest()).decode()
        if not head.startswith(b"HTTP/1.1 101 ") or f"Sec-WebSocket-Accept: {accept}".encode() not in head:
            raise AssertionError(f"websocket handshake refused: {head[:200]!r}")
        if protocol and f"Sec-WebSocket-Protocol: {protocol}\r\n".encode() not in head:
            raise AssertionError(f"websocket subprotocol {protocol!r} not answered: {head[:300]!r}")
        self.events: list[tuple[float, dict]] = []
        self.arrived = threading.Condition()  # notified per event and at the close
        self.close_code = None
        self.closing = False  # our close frame went out
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def send(self, opcode: int, payload: bytes) -> None:
        import os
        import struct

        import numpy as np

        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x80 | opcode])
        head += bytes([0x80 | n]) if n < 126 else (
            bytes([0x80 | 126]) + struct.pack("!H", n) if n < 65536 else bytes([0x80 | 127]) + struct.pack("!Q", n))
        body = (np.frombuffer(payload, np.uint8) ^ np.resize(np.frombuffer(mask, np.uint8), n)).tobytes()
        self.sock.sendall(head + mask + body)

    def _exactly(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("socket closed")
            out += chunk
        return out

    def _read(self) -> None:
        import struct

        while True:
            b0, b1 = self._exactly(2)
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack("!H", self._exactly(2))
            elif n == 127:
                (n,) = struct.unpack("!Q", self._exactly(8))
            payload = self._exactly(n)
            if b0 & 0x0F == 0x1:
                with self.arrived:
                    self.events.append((time.perf_counter(), json.loads(payload)))
                    self.arrived.notify_all()
            elif b0 & 0x0F == 0x8:
                with self.arrived:
                    self.close_code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
                    self.arrived.notify_all()
                if not self.closing:
                    self.send(0x8, payload[:2])
                self.sock.close()
                return

    def close(self, code: int = 1000) -> None:
        """Close from the client's side and wait for the server's reply."""
        import struct

        self.closing = True
        self.send(0x8, struct.pack("!H", code))
        self.reader.join(60)
        if self.close_code is None:
            raise AssertionError("websocket: no close frame from the server")

    def of_type(self, kind: str) -> list[dict]:
        return [e for _, e in self.events if e["type"] == kind]


def load_kokoro():
    """A kokoro-82M ``TTSRouter`` on the card (random weights from seed 7,
    float32), loaded with its warmup synthesis."""
    import torch

    from open_speech_tpu_torch.tts.router import TTSRouter

    tts = TTSRouter()  # the card
    t0 = time.perf_counter()
    tts.load_model("kokoro")
    torch.cuda.synchronize()
    log(f"server: kokoro-82M (random weights from seed 7, float32) loaded with its warmup "
        f"synthesis in {time.perf_counter() - t0:.3f} s")
    return tts


def phase_server(router, tts=None) -> dict:
    """11a: ``create_app`` over phase 4's router and a kokoro-82M TTSRouter
    (``tts``, or one loaded here and unloaded after), served in this
    process; 11b: ``python -m open_speech_tpu_torch.server`` in a subprocess
    on the fixture. Returns the flash launches of both."""
    import torch

    from open_speech_tpu_torch.ops import attention as A

    for key in A.launches:
        A.launches[key] = 0  # count this phase only
    own = tts is None
    if own:
        tts = load_kokoro()
    entry = router.get_backend(MAIN_MODEL)._ensure_model(MAIN_MODEL)
    real_tok = entry["tok"]
    entry["tok"] = _WordTokenizer(real_tok)  # bodies and events carry the decoded words
    try:
        with _Served(router, tts) as served:
            log(f"server 11a: create_app serving on http://127.0.0.1:{served.port}")
            _server_rest(router, served.port)
            _server_speech(tts, served.port)
            _server_stream(router, served.port)
    finally:
        entry["tok"] = real_tok
        if own:
            tts.unload_model("kokoro")
            torch.cuda.empty_cache()
    _server_subprocess()
    return dict(A.launches)


def _served_post(port: int, route: str, body: bytes, headers: dict, probe_health: bool):
    """(status, headers, body, wall s, /health latencies s while it ran)."""
    import threading

    import torch

    result, health = {}, []

    def post():
        t1 = time.perf_counter()
        result["answer"] = _http(port, "POST", route, body, headers)
        torch.cuda.synchronize()
        result["wall"] = time.perf_counter() - t1

    poster = threading.Thread(target=post)
    poster.start()
    if probe_health:
        time.sleep(0.5)
        while poster.is_alive():
            t1 = time.perf_counter()
            status, _, hbody = _http(port, "GET", "/health")
            if status != 200 or json.loads(hbody)["status"] != "ok":
                raise AssertionError(f"server 11a /health during a transcription: {status} {hbody!r}")
            if poster.is_alive():
                health.append(time.perf_counter() - t1)
            time.sleep(0.25)  # a poll rate that takes little of the decode's interpreter lock
    poster.join()
    return (*result["answer"], result["wall"], health)


def _server_rest(router, port: int) -> None:
    """Requests a and c of phase 4, direct (D) then served (S); /health
    polled while the served c runs in the server's executor."""
    import statistics

    import torch

    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import transcription_response, translation_response

    # the shell alone: request a's upload refused after its parse (a bad
    # temperature: 422 before any model work), and /health, on an idle server
    body, headers = _multipart({"model": MAIN_MODEL, "temperature": "hot"},
                               codec.write_wav(_speechlike(5.0, 1), SR))
    shell = {"post": [], "health": []}
    for _ in range(SHELL_REPEATS):
        for key, args in (("post", ("POST", "/v1/audio/transcriptions", body, headers)),
                          ("health", ("GET", "/health"))):
            t0 = time.perf_counter()
            status, _, _ = _http(port, *args)
            shell[key].append(1e3 * (time.perf_counter() - t0))
            if status != (422 if key == "post" else 200):
                raise AssertionError(f"server 11a shell {key}: {status}")
    log(f"server 11a shell alone, {SHELL_REPEATS} each, new connection per request: a's {len(body)}-byte "
        f"multipart POST refused with 422 after its parse, ms p50 {statistics.median(shell['post']):.3f} "
        f"max {max(shell['post']):.3f}; GET /health ms p50 {statistics.median(shell['health']):.3f} "
        f"max {max(shell['health']):.3f}")

    turns = "DS"  # one pair each: ~5-10 s per decode at random weights
    for name, seconds, seed, route, fmt in (
        ("a transcribe 5 s json", 5.0, 1, "/v1/audio/transcriptions", "json"),
        ("c translate 10 s srt", 10.0, 3, "/v1/audio/translations", "srt"),
    ):
        wav = codec.write_wav(_speechlike(seconds, seed), SR)
        direct_fn = translation_response if route.endswith("translations") else transcription_response
        body, headers = _multipart({"model": MAIN_MODEL, "response_format": fmt}, wav)
        walls, k1s, bodies, health = {t: [] for t in "DS"}, {t: [] for t in "DS"}, [], []
        for turn in turns:
            k1 = A.launches["flash_attention"]
            if turn == "D":
                t0 = time.perf_counter()
                out = direct_fn(router, wav, model=MAIN_MODEL, response_format=fmt)
                torch.cuda.synchronize()
                walls[turn].append(time.perf_counter() - t0)
            else:
                status, rheaders, rbody, wall, probes = _served_post(
                    port, route, body, headers, probe_health=name.startswith("c"))
                want_type = f"{'application/json' if fmt == 'json' else 'text/plain'}; charset=utf-8"
                if status != 200 or rheaders.get("Content-Type") != want_type:
                    raise AssertionError(f"server 11a {name}: {status} {rheaders.get('Content-Type')} "
                                         f"{rbody[:300]!r}")
                out = json.loads(rbody) if fmt == "json" else rbody.decode()
                walls["S"].append(wall)
                health += probes
            k1s[turn].append(A.launches["flash_attention"] - k1)
            bodies.append(out)
        if any(b != bodies[0] for b in bodies) or not (bodies[0]["text"] if fmt == "json" else bodies[0]):
            raise AssertionError(f"server 11a {name}: bodies in turns {turns}: {bodies}")
        if len({n for ns in k1s.values() for n in ns}) != 1 or k1s["S"][0] <= 0:
            raise AssertionError(f"server 11a {name}: K1 launches {k1s}")
        fmt_walls = lambda ws: " ".join(f"{w:.3f}" for w in ws)  # noqa: E731
        log(f"server 11a {name}: wall_s in turns {turns}: direct {fmt_walls(walls['D'])} "
            f"served {fmt_walls(walls['S'])} (served - direct, mean "
            f"{statistics.mean(walls['S']) - statistics.mean(walls['D']):+.3f} s); K1 launches "
            f"{k1s['S'][0]} per request, served = direct; bodies equal ({len(json.dumps(bodies[0]))} "
            f"bytes of JSON)")
        if name.startswith("c"):
            if not health:
                raise AssertionError("server 11a: no /health answer while the translation ran")
            health_ms = sorted(1e3 * h for h in health)
            log(f"server 11a /health during served c: {len(health)} answers while it ran, latency ms "
                f"p50 {statistics.median(health_ms):.3f} max {health_ms[-1]:.3f}")


def _server_speech(tts, port: int) -> None:
    """The two-sentence streamed PCM request of phase 8, direct and over
    HTTP (chunked) in turns after a warm run: first chunk time, the samples,
    and the threads the synthesis ran on."""
    import http.client
    import threading

    import numpy as np

    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.speech import speech_response

    body = {"input": SERVING_TEXT, "voice": "af_heart", "response_format": "pcm"}
    b"".join(speech_response(tts, body, stream=True)[1])  # warm: the timed runs find the plans made
    # an executor thread's first synthesis pays a one-time set-up: this
    # served run takes it before the timed turns, and its TTFA is printed
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/audio/speech?stream=true", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read1(1 << 20)
        cold_ttfa = time.perf_counter() - t0
        resp.read()
    finally:
        conn.close()
    # the threads each run's synthesis steps ran on (one per chunk produced)
    synthesize, threads = tts.synthesize, []

    def traced(*args, **kw):
        for chunk in synthesize(*args, **kw):
            threads[-1].append(threading.get_ident())
            yield chunk

    tts.synthesize = traced
    ttfa, walls, outs = {"D": [], "S": []}, {"D": [], "S": []}, []
    for turn in "DSSD":
        threads.append([])
        t0 = time.perf_counter()
        if turn == "D":
            _, chunks = speech_response(tts, body, stream=True)
            parts = [next(chunks)]
            ttfa["D"].append(time.perf_counter() - t0)
            parts += list(chunks)
            walls["D"].append(time.perf_counter() - t0)
            outs.append(b"".join(parts))
            continue
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request("POST", "/v1/audio/speech?stream=true", body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            first = resp.read1(1 << 20)
            ttfa["S"].append(time.perf_counter() - t0)
            outs.append(first + resp.read())
            walls["S"].append(time.perf_counter() - t0)
            status, ctype = resp.status, resp.getheader("Content-Type")
            coding = resp.getheader("Transfer-Encoding")
        finally:
            conn.close()
        if status != 200 or ctype != "audio/pcm" or coding != "chunked" or not first:
            raise AssertionError(f"server 11a speech: {status} {ctype} {coding}, first chunk {len(first)} bytes")
    want = codec.pcm16_to_float(outs[0])
    err = 0.0
    for out in outs[1:]:
        got = codec.pcm16_to_float(out)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"server 11a speech: {got.shape} samples vs {want.shape}")
        err = max(err, float(np.abs(got - want).max()) if got.size else 0.0)
    if err > 2e-3 + 2 / 32768:
        raise AssertionError(f"server 11a speech: runs differ by {err}")
    del tts.synthesize
    ms = lambda xs: " ".join(f"{1e3 * x:.3f}" for x in xs)  # noqa: E731
    log(f"server 11a speech (streamed pcm, two sentences, {want.size / 24000:.3f} s of audio): first "
        f"served request TTFA ms {1e3 * cold_ttfa:.3f}; then in turns "
        f"DSSD: TTFA ms over HTTP {ms(ttfa['S'])}, direct first chunk {ms(ttfa['D'])}; wall ms served "
        f"{ms(walls['S'])} direct {ms(walls['D'])}; served == direct bytes "
        f"{all(o == outs[0] for o in outs)} (max err {err:.2e}); threads that ran the synthesis per "
        f"turn {[len(set(t)) for t in threads]} over {[len(t) for t in threads]} steps, "
        f"{len(set(threads[1] + threads[2]))} across the served turns")


def _server_stream(router, port: int) -> None:
    """A /v1/audio/stream session over the socket: ~10 s of 16 kHz PCM16
    paced in 100 ms frames, then stop. K2 and its combine run in the
    incremental block encoder. Phase 5's S1 is the in-process yardstick of
    what the socket adds."""
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.server import streaming as S

    cfg = router.get_backend(MAIN_MODEL)._ensure_model(MAIN_MODEL)["cfg"]
    frames = _pcm16_frames(WS_SECONDS, 8)
    k2, combine = A.launches["flash_attention_varlen"], A.launches["flash_combine"]
    ws = _SocketClient(port, f"/v1/audio/stream?model={MAIN_MODEL}&sample_rate={SR}&vad=false")
    deadline = time.perf_counter() + 60
    while not ws.events or not S._active_sessions:
        if time.perf_counter() > deadline:
            raise AssertionError("server 11a stream: no session.begin")
        time.sleep(0.005)
    session = next(iter(S._active_sessions.values()))
    passes, sent = [], [0]
    schedule, transcribe, send_event = (session._schedule_interim, session._transcribe_utterance,
                                        session._send_event)
    newest = [0.0]

    def timed_schedule():
        newest[0] = time.perf_counter()
        schedule()

    async def timed_transcribe():
        t_chunk, n0 = newest[0], sent[0]
        await transcribe()
        passes.append((t_chunk, n0, sent[0]))

    async def counted_send(event):
        await send_event(event)
        sent[0] += 1

    session._schedule_interim, session._transcribe_utterance = timed_schedule, timed_transcribe
    session._send_event = counted_send
    sent[0] = 1  # session.begin went out before the hooks
    t0 = time.perf_counter()
    for i, frame in enumerate(frames):
        time.sleep(max(0.0, t0 + i * FRAME_S - time.perf_counter()))
        ws.send(0x2, frame)
    stop_at = time.perf_counter()
    ws.send(0x1, json.dumps({"type": "stop"}).encode())
    ws.reader.join(120)
    enc = session._inc_encoder
    n_k2, n_combine = A.launches["flash_attention_varlen"] - k2, A.launches["flash_combine"] - combine
    kinds = [e["type"] for _, e in ws.events]
    transcripts = ws.of_type("transcript")
    interims = [e for e in transcripts if not e["is_final"]]
    finals = [(t, e) for t, e in ws.events if e.get("speech_final")]
    if ws.close_code != 1000 or kinds[0] != "session.begin" or kinds[-1] != "session.end":
        raise AssertionError(f"server 11a stream: close {ws.close_code}, events {kinds[:3]} ... {kinds[-3:]}")
    if ws.events[-1][1]["errors"] or not interims or len(finals) != 1 or session._inc_failures:
        raise AssertionError(f"server 11a stream: {len(interims)} interims, {len(finals)} finals, "
                             f"end {ws.events[-1][1]}, incremental failures {session._inc_failures}")
    blocks = enc.block_encodes + enc.tail_encodes
    if n_k2 <= 0 or n_k2 != cfg.n_audio_layer * blocks or n_combine != n_k2:
        raise AssertionError(f"server 11a stream: K2 {n_k2}, combine {n_combine} for {blocks} block encodes")
    turnaround = []
    for t_chunk, n0, n1 in passes:
        arrivals = [ws.events[i][0] for i in range(n0, min(n1, len(ws.events)))
                    if ws.events[i][1]["type"] == "transcript"]
        if arrivals:
            turnaround.append(arrivals[0] - t_chunk)
    log(f"server 11a stream ({WS_SECONDS} s 16 kHz pcm16 paced over the socket, auto-detect, VAD off): "
        f"events {len(ws.events)} interims {len(interims)} interim passes {len(passes)} "
        f"coalesced {session._interims_coalesced}; interim turnaround (newest chunk -> transcript "
        f"event at the client, {len(turnaround)} passes with an event) s {_p50_max(turnaround)}; "
        f"final latency after stop s {finals[0][0] - stop_at:.4f}")
    log(f"server 11a stream: K2 launches {n_k2} = {cfg.n_audio_layer} x ({enc.block_encodes} committed + "
        f"{enc.tail_encodes} tail block encodes), combine launches {n_combine}; close code 1000")


def _server_subprocess() -> None:
    """11b: ``python -m open_speech_tpu_torch.server`` (TLS off, a free
    port, the fixture preloaded on the card at float32): /health reports
    it loaded, the fixture clips transcribe to the CPU's text, SIGTERM ends
    it cleanly."""
    import os
    import signal
    import socket
    import tempfile
    from pathlib import Path

    import numpy as np

    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response

    from open_speech_tpu_torch.config import settings

    root = Path(__file__).resolve().parent
    model_id = "test-tiny-eot"
    settings.stt_model_dir = str(root / "tests" / "fixtures")  # the host's copy, as phase 6 reads it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OS_SSL_ENABLED="false", OS_HOST="127.0.0.1", OS_PORT=str(port),
               STT_MODEL_DIR=str(root / "tests" / "fixtures"), STT_PRELOAD_MODELS=model_id,
               STT_COMPUTE_TYPE="float32")
    host = BackendRouter(device="cpu", compute_type="float32")
    host.load_model(model_id)
    rng = np.random.default_rng(11)  # the clips of tests/test_eot_ckpt.py
    clips = {k: codec.write_wav(_beeps(k, rng), SR) for k in (1, 3)}
    want = {k: transcription_response(host, wav, model=model_id) for k, wav in clips.items()}
    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "open_speech_tpu_torch.server"], cwd=root,
                                env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None or time.perf_counter() - t0 > 240:
                    raise AssertionError(f"server 11b: not up (exit {proc.poll()})")
                try:
                    status, _, body = _http(port, "GET", "/health")
                    if status == 200 and json.loads(body)["models_loaded"] >= 1:
                        break
                except OSError:
                    pass
                time.sleep(0.25)
            up_s = time.perf_counter() - t0
            for k, wav in clips.items():
                form, headers = _multipart({"model": model_id}, wav)
                status, _, body = _http(port, "POST", "/v1/audio/transcriptions", form, headers)
                if status != 200 or json.loads(body) != want[k]:
                    raise AssertionError(f"server 11b beeps k={k}: {status} {body[:200]!r} vs cpu {want[k]}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            if code != 0:
                raise AssertionError(f"server 11b: exit {code} after SIGTERM")
            log(f"server 11b: python -m open_speech_tpu_torch.server up with {model_id} loaded on the "
                f"card in {up_s:.3f} s; clips k=1,3 text equal to the CPU's "
                f"{[want[k]['text'] for k in clips]}; SIGTERM -> exit 0 in {time.perf_counter() - t1:.3f} s")
        except BaseException:
            out.seek(0)
            log("server 11b output:\n" + out.read().decode(errors="replace")[-4000:])
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# ── phase 12: the realtime socket and Wyoming ────────────────────────────

RT_SECONDS = 5.0  # R-a's and W-a's clips
RT_VOICE = "af_heart"
RT_APPEND = 4800  # bytes of 24 kHz PCM16 per append: 100 ms
RT_CANCEL_TEXT = " ".join([SERVING_TEXT] * 3)  # six sentences: the cancel lands mid-stream
RT_VAD_DEVICES = ("cuda", "cpu")  # R-c's OS_VAD_DEVICE values: the card, then the host
COMMIT = {"type": "input_audio_buffer.commit"}


class _Warnings:
    """Records of WARNING and above from the named loggers."""

    def __init__(self, *names: str) -> None:
        import logging

        class Keep(logging.Handler):
            def emit(inner, record):
                self.records.append(record)

        self.records: list = []
        self.handler, self.names = Keep(logging.WARNING), names
        for name in names:
            logging.getLogger(name).addHandler(self.handler)

    def close(self) -> list[str]:
        import logging

        for name in self.names:
            logging.getLogger(name).removeHandler(self.handler)
        return [f"{r.name}: {r.getMessage()}" for r in self.records]


def _rt_send(ws: _SocketClient, event: dict) -> float:
    ws.send(0x1, json.dumps(event).encode())
    return time.perf_counter()


def _rt_wait(ws: _SocketClient, kind: str, start: int, timeout: float = 180.0):
    """(index, arrival, event) of the first ``kind`` event at or after
    ``start``; an error event or a close fails. Sleeps until the reader
    thread notifies: a poll would take the interpreter lock from the decode
    the wait is timing."""
    deadline, i = time.perf_counter() + timeout, start
    with ws.arrived:
        while True:
            for i in range(i, len(ws.events)):
                t, e = ws.events[i]
                if e["type"] == kind:
                    return i, t, e
                if e["type"] == "error":
                    raise AssertionError(f"realtime: error event {e['error']}")
            i = len(ws.events)
            left = deadline - time.perf_counter()
            if left <= 0 or ws.close_code is not None:
                raise AssertionError(f"realtime: no {kind} (close {ws.close_code}); events "
                                     f"{[e['type'] for _, e in ws.events[start:]]}")
            ws.arrived.wait(left)


def _rt_session(port: int, model: str, session: dict) -> _SocketClient:
    """A ``/v1/realtime`` socket (the ``realtime`` subprotocol) after its
    ``session.update``."""
    ws = _SocketClient(port, f"/v1/realtime?model={model}", protocol="realtime")
    _rt_wait(ws, "session.created", 0)
    _rt_send(ws, {"type": "session.update", "session": session})
    _rt_wait(ws, "session.updated", 1)
    return ws


def _rt_appends(ws: _SocketClient, pcm24: bytes) -> int:
    import base64

    for i in range(0, len(pcm24), RT_APPEND):
        _rt_send(ws, {"type": "input_audio_buffer.append",
                      "audio": base64.b64encode(pcm24[i:i + RT_APPEND]).decode()})
    return -(-len(pcm24) // RT_APPEND)


def _rt_buffered(pcm24: bytes) -> bytes:
    """The 16 kHz PCM the session's buffer holds after ``_rt_appends``:
    each append is resampled on its own."""
    from open_speech_tpu_torch.server.realtime.audio_buffer import decode_audio_to_pcm16

    return b"".join(decode_audio_to_pcm16(pcm24[i:i + RT_APPEND], "pcm16", 16000)
                    for i in range(0, len(pcm24), RT_APPEND))


def _rt_deltas(ws: _SocketClient, start: int, end: int) -> tuple[list[float], bytes]:
    import base64

    deltas = [(t, e) for t, e in ws.events[start:end] if e["type"] == "response.audio.delta"]
    return [t for t, _ in deltas], b"".join(base64.b64decode(e["delta"]) for _, e in deltas)


async def _closed(server) -> None:
    """Close an asyncio server on its own loop."""
    server.close()
    await server.wait_closed()


class _WyomingClient:
    """A minimal Wyoming client on a plain socket: one JSON header line,
    then the optional data and payload bytes."""

    def __init__(self, port: int) -> None:
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=300)
        self.file = self.sock.makefile("rb")

    def send(self, kind: str, data: dict | None = None, payload: bytes = b"") -> None:
        head = {"type": kind, "data": data or {}, "payload_length": len(payload) or None}
        self.sock.sendall(json.dumps(head).encode() + b"\n" + payload)

    def until(self, kind: str) -> list[tuple[str, dict, bytes]]:
        out = []
        while not out or out[-1][0] != kind:
            line = self.file.readline()
            if not line:
                raise AssertionError(f"wyoming: connection closed before {kind}")
            head = json.loads(line)
            data = head.get("data") or {}
            if head.get("data_length"):
                data = {**data, **json.loads(self.file.read(head["data_length"]))}
            payload = self.file.read(head["payload_length"]) if head.get("payload_length") else b""
            out.append((head["type"], data, payload))
        return out

    def close(self) -> None:
        self.file.close()
        self.sock.close()


def phase_realtime(router, tts) -> dict:
    """12: ``/v1/realtime`` and the Wyoming server on phase 4's turbo router
    and phase 11's kokoro-82M ``TTSRouter``, served by ``create_app`` in
    this process; then the fixture card against the CPU. Returns the flash
    launches."""
    import torch

    from open_speech_tpu_torch.ops import attention as A

    for key in A.launches:
        A.launches[key] = 0  # count this phase only
    warned = _Warnings("open_speech_tpu_torch.server.realtime.server",
                       "open_speech_tpu_torch.server.wyoming.server")
    entry = router.get_backend(MAIN_MODEL)._ensure_model(MAIN_MODEL)
    real_tok = entry["tok"]
    entry["tok"] = _WordTokenizer(real_tok)  # transcripts carry the decoded words
    try:
        with _Served(router, tts) as served:
            log(f"realtime 12: create_app serving /v1/realtime and Wyoming on 127.0.0.1:{served.port}")
            per_chunk = _realtime_turns(router, tts, served.port)
            _realtime_cancel(tts, served.port, per_chunk)
            _realtime_vad(router, served.port)
            _realtime_batcher(router, served)
            _wyoming_turbo(router, tts, served)
        _realtime_fixture(tts)
    finally:
        entry["tok"] = real_tok
        torch.cuda.empty_cache()
        warnings = warned.close()
    if warnings:  # the VAD fell back or was disabled, or a session failed
        raise AssertionError(f"realtime 12: warnings logged: {warnings}")
    return dict(A.launches)


def _realtime_turns(router, tts, port: int) -> int:
    """R-a: two turns (5 s of 24 kHz PCM16 appended in 100 ms events, a
    commit, a two-sentence response) after the realtime pool's four
    threads are warmed; against ``_run_stt`` and the direct synthesis.
    Returns the most deltas one synthesis chunk makes."""
    import threading

    import numpy as np
    import torch

    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.server.realtime import server as RS
    from open_speech_tpu_torch.server.realtime.audio_buffer import encode_pcm16_to_format

    barrier = threading.Barrier(4)

    def warm():  # one short synthesis on each of the pool's threads
        barrier.wait(60)
        list(tts.synthesize(text="Hello there.", model="kokoro", voice=RT_VOICE, speed=1.0))

    t0 = time.perf_counter()
    for f in [RS._executor.submit(warm) for _ in range(4)]:
        f.result(120)
    warm_s = time.perf_counter() - t0
    pcm24 = codec.float_to_pcm16(_speechlike(RT_SECONDS * 24000 / SR, 21))
    pcm16 = _rt_buffered(pcm24)
    k1 = A.launches["flash_attention"]
    t0 = time.perf_counter()
    direct = RS._run_stt(router, pcm16, MAIN_MODEL)
    torch.cuda.synchronize()
    direct_s, direct_k1 = time.perf_counter() - t0, A.launches["flash_attention"] - k1
    t0 = time.perf_counter()  # the same call on a realtime pool thread, as a commit runs it
    pooled = RS._executor.submit(RS._run_stt, router, pcm16, MAIN_MODEL).result(300)
    torch.cuda.synchronize()
    pooled_s = time.perf_counter() - t0
    if pooled["text"] != direct["text"]:
        raise AssertionError(f"realtime R-a: pool thread {pooled['text'][:80]!r} vs {direct['text'][:80]!r}")
    chunks, t0 = [], time.perf_counter()
    for c in tts.synthesize(text=SERVING_TEXT, model="kokoro", voice=RT_VOICE, speed=1.0):
        chunks.append(encode_pcm16_to_format(codec.float_to_pcm16(np.asarray(c, np.float32)), 24000, "pcm16"))
        if len(chunks) == 1:
            direct_first = time.perf_counter() - t0
    direct_tts_s, want = time.perf_counter() - t0, b"".join(chunks)
    per_chunk = max(-(-len(c) // RS._DELTA_BYTES) for c in chunks)

    ws = _rt_session(port, MAIN_MODEL, {"turn_detection": None, "voice": RT_VOICE})
    lines = []
    for turn in (1, 2):
        n = _rt_appends(ws, pcm24)
        k1 = A.launches["flash_attention"]
        t_commit = _rt_send(ws, COMMIT)
        i, t_done, done = _rt_wait(ws, "conversation.item.input_audio_transcription.completed", len(ws.events))
        served_k1 = A.launches["flash_attention"] - k1
        if done["transcript"] != direct["text"] or not done["transcript"] or served_k1 != direct_k1:
            raise AssertionError(f"realtime R-a turn {turn}: transcript {done['transcript'][:80]!r} vs direct "
                                 f"{direct['text'][:80]!r}, K1 {served_k1} vs {direct_k1}")
        start = len(ws.events)
        t_create = _rt_send(ws, {"type": "response.create", "response": {"instructions": SERVING_TEXT}})
        end, t_end, done = _rt_wait(ws, "response.done", start)
        times, audio = _rt_deltas(ws, start, end)
        if done["response"]["status"] != "completed" or audio != want:
            raise AssertionError(f"realtime R-a turn {turn}: {done['response']['status']}, "
                                 f"{len(audio)} delta bytes vs {len(want)} direct, equal {audio == want}")
        lines.append(f"turn {turn}: {n} appends, commit -> transcription.completed "
                     f"{t_done - t_commit:.4f} s, K1 {served_k1}; response.create -> first "
                     f"delta {1e3 * (times[0] - t_create):.3f} ms, response wall {t_end - t_create:.4f} s, "
                     f"{len(times)} deltas")
    ws.close()
    log(f"realtime 12 R-a ({RT_SECONDS} s 24 kHz pcm16 in 100 ms appends, turn_detection null, "
        f"pool warmed in {warm_s:.3f} s): direct _run_stt {direct_s:.4f} s (on a pool thread "
        f"{pooled_s:.4f} s), K1 {direct_k1}; direct "
        f"synthesis first chunk {1e3 * direct_first:.3f} ms, wall {direct_tts_s:.4f} s; "
        + "; ".join(lines) + f"; transcripts = direct, K1 served = direct, decoded deltas == direct "
        f"bytes ({len(want)} bytes); close code {ws.close_code}")
    return per_chunk


def _realtime_cancel(tts, port: int, per_chunk: int) -> None:
    """R-b: ``response.cancel`` once the first delta arrived: deltas that
    arrive after it, the time to ``response.done`` (cancelled), and the
    chunks the synthesis produced before it stopped."""
    import threading

    ws = _rt_session(port, MAIN_MODEL, {"turn_detection": None, "voice": RT_VOICE})
    synthesize, produced, stopped = tts.synthesize, [], threading.Event()

    def traced(*args, **kw):
        try:
            for chunk in synthesize(*args, **kw):
                produced.append(time.perf_counter())
                yield chunk
        finally:
            stopped.set()

    total = sum(1 for _ in synthesize(text=RT_CANCEL_TEXT, model="kokoro", voice=RT_VOICE, speed=1.0))
    tts.synthesize = traced
    try:
        start = len(ws.events)
        t_create = _rt_send(ws, {"type": "response.create", "response": {"instructions": RT_CANCEL_TEXT}})
        _, t_first, _ = _rt_wait(ws, "response.audio.delta", start)
        t_cancel = _rt_send(ws, {"type": "response.cancel"})
        end, t_done, done = _rt_wait(ws, "response.done", start)
        if not stopped.wait(60):
            raise AssertionError("realtime R-b: the synthesis did not stop")
    finally:
        del tts.synthesize
    times, _ = _rt_deltas(ws, start, end)
    after = sum(t > t_cancel for t in times)
    if done["response"]["status"] != "cancelled" or after > per_chunk or len(produced) >= total:
        raise AssertionError(f"realtime R-b: {done['response']['status']}, {after} deltas after the cancel "
                             f"(one chunk makes up to {per_chunk}), {len(produced)} of {total} chunks produced")
    ws.close()
    log(f"realtime 12 R-b cancel: first delta {1e3 * (t_first - t_create):.3f} ms after response.create; "
        f"cancel sent, then {after} deltas (one chunk makes up to {per_chunk}), response.done cancelled "
        f"after {1e3 * (t_done - t_cancel):.3f} ms; synthesis produced {len(produced)} of {total} chunks, "
        f"the last {1e3 * (produced[-1] - t_cancel):+.3f} ms from the cancel")


def _realtime_vad(router, port: int) -> None:
    """R-c: server VAD at ``OS_VAD_DEVICE`` = the card, then the host. The
    weights are random, so the threshold sits above every probability:
    the VAD runs once per append and opens no turn."""
    import statistics

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.vad import silero as V
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.server.realtime import server as RS

    sessions, initialize, call = [], RS.RealtimeSession.initialize, V.SileroVAD.__call__
    times: list[float] = []

    async def recorded(self):
        sessions.append(self)
        await initialize(self)

    def timed(self, audio):
        t0 = time.perf_counter()
        p = call(self, audio)  # ends in a host copy of the probabilities
        times.append(time.perf_counter() - t0)
        return p

    pcm24 = codec.float_to_pcm16(_speechlike(RT_SECONDS * 24000 / SR, 22))
    saved = settings.os_vad_device
    RS.RealtimeSession.initialize, V.SileroVAD.__call__ = recorded, timed
    out = []
    try:
        for device in RT_VAD_DEVICES:
            settings.os_vad_device = device
            ws = _rt_session(port, MAIN_MODEL, {"turn_detection": {
                "type": "server_vad", "threshold": 0.999, "silence_duration_ms": 500}})
            times.clear()
            n = _rt_appends(ws, pcm24)
            _rt_send(ws, {"type": "input_audio_buffer.clear"})  # answered after every append
            _rt_wait(ws, "input_audio_buffer.cleared", 2)
            vad = sessions[-1].audio_buffer._vad
            if vad is None or vad.calls != n or vad.session.device.type != device or len(times) != n:
                raise AssertionError(f"realtime R-c VAD at {device}: {vad and vad.calls} calls of {n} appends, "
                                     f"on {vad and vad.session.device}")
            if ws.of_type("input_audio_buffer.speech_started"):
                raise AssertionError(f"realtime R-c VAD at {device}: a turn opened")
            ws.close()
            ms = sorted(1e3 * t for t in times)
            out.append(f"OS_VAD_DEVICE={device}: {vad.calls} calls = appends, on {vad.session.device}, "
                       f"ms per 100 ms append p50 {statistics.median(ms):.3f} max {ms[-1]:.3f}")
    finally:
        settings.os_vad_device = saved
        RS.RealtimeSession.initialize, V.SileroVAD.__call__ = initialize, call
    log("realtime 12 R-c server VAD (random weights, threshold 0.999, on the event loop): " + "; ".join(out)
        + "; no 'disabling server VAD' warning")


def _realtime_batcher(router, served) -> None:
    """R-c: a language-pinned commit (2 s) with ``OS_BATCHER_ENABLED``: one
    batcher admission, 32 K1 launches (the encoder)."""
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime import batcher_pool as P
    from open_speech_tpu_torch.server.realtime import server as RS

    cfg = router.get_backend(MAIN_MODEL)._ensure_model(MAIN_MODEL)["cfg"]
    real, admissions = RS.transcribe_pcm_batched, []

    async def counted(*args, **kw):
        admissions.append(args[2])
        return await real(*args, **kw)

    saved = settings.os_batcher_enabled
    settings.os_batcher_enabled, RS.transcribe_pcm_batched = True, counted
    try:
        ws = _rt_session(served.port, MAIN_MODEL, {
            "turn_detection": None, "input_audio_transcription": {"model": "whisper-1", "language": "en"}})
        _rt_appends(ws, codec.float_to_pcm16(_speechlike(2.0 * 24000 / SR, 23)))
        k1 = A.launches["flash_attention"]
        t_commit = _rt_send(ws, COMMIT)
        _, t_done, done = _rt_wait(ws, "conversation.item.input_audio_transcription.completed", 2)
        n_k1 = A.launches["flash_attention"] - k1
        ws.close()
    finally:
        settings.os_batcher_enabled, RS.transcribe_pcm_batched = saved, real
        served._run(P.shutdown_batchers())
    if admissions != ["en"] or n_k1 != cfg.n_audio_layer or not done["transcript"]:
        raise AssertionError(f"realtime R-c batcher: admissions {admissions}, K1 {n_k1}, "
                             f"transcript {done['transcript'][:80]!r}")
    log(f"realtime 12 R-c batcher (language en pinned, 2 s commit): 1 admission, K1 {n_k1} = "
        f"{cfg.n_audio_layer} per admission; commit -> transcription.completed {t_done - t_commit:.4f} s")


def _wyoming_turbo(router, tts, served) -> None:
    """W-a: the Wyoming server on the same routers: describe, a 5 s 16 kHz
    transcribe (beam 5 with fallback, the VAD on the card) against the
    router called directly with the arguments the handler passed, and a
    two-sentence synthesize against the direct bytes."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.audio.postprocessing import process_tts_chunks
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.ops.resample import resample_pcm16
    from open_speech_tpu_torch.server.wyoming.server import start_wyoming_server

    server = served._run(start_wyoming_server(router, tts, host="127.0.0.1", port=0))
    calls, transcribe = [], router.transcribe

    def recorded(**kw):
        calls.append(kw)
        return transcribe(**kw)

    router.transcribe = recorded
    try:
        client = _WyomingClient(server.sockets[0].getsockname()[1])
        client.send("describe")
        ((_, info, _),) = client.until("info")
        meta = {"rate": SR, "width": 2, "channels": 1}
        pcm = codec.float_to_pcm16(_speechlike(RT_SECONDS, 24))
        k1, t0 = A.launches["flash_attention"], time.perf_counter()
        client.send("transcribe", {"name": MAIN_MODEL})
        client.send("audio-start", meta)
        for i in range(0, len(pcm), SR // 10 * 2):
            client.send("audio-chunk", meta, pcm[i:i + SR // 10 * 2])
        client.send("audio-stop")
        (*_, (_, said, _)) = client.until("transcript")
        served_s, served_k1 = time.perf_counter() - t0, A.launches["flash_attention"] - k1
        t0 = time.perf_counter()
        client.send("synthesize", {"text": SERVING_TEXT, "voice": {"name": RT_VOICE}})
        events = client.until("audio-stop")
        synth_s = time.perf_counter() - t0
        client.close()
    finally:
        del router.transcribe
        served._run(_closed(server))
    (kw,) = calls
    gated = codec.read_wav(kw["audio"])[0].size
    k1, t0 = A.launches["flash_attention"], time.perf_counter()
    direct = transcribe(**kw)
    torch.cuda.synchronize()
    direct_s, direct_k1 = time.perf_counter() - t0, A.launches["flash_attention"] - k1
    if said["text"] != direct["text"] or not said["text"] or served_k1 != direct_k1:
        raise AssertionError(f"wyoming W-a: transcript {said['text'][:80]!r} vs direct {direct['text'][:80]!r}, "
                             f"K1 {served_k1} vs {direct_k1}")
    backend = tts.get_backend("kokoro")
    audio = np.concatenate(list(process_tts_chunks(
        tts.synthesize(text=SERVING_TEXT, model="kokoro", voice=RT_VOICE, speed=1.0),
        trim=settings.tts_trim_silence, normalize=settings.tts_normalize_output)))
    want = resample_pcm16(codec.float_to_pcm16(audio), 24000, 16000, backend.device)
    got = b"".join(p for kind, _, p in events if kind == "audio-chunk")
    if [e[0] for e in events[:1] + events[-1:]] != ["audio-start", "audio-stop"] or got != want:
        raise AssertionError(f"wyoming W-a synthesize: {len(got)} bytes vs {len(want)} direct, equal {got == want}")
    log(f"wyoming 12 W-a: info lists {len(info['asr'][0]['models'])} asr models and "
        f"{len(info['tts'][0]['voices'])} voices; transcribe ({RT_SECONDS} s 16 kHz, beam 5 with fallback, "
        f"VAD on the card kept {gated / SR:.3f} s) wall {served_s:.4f} s vs direct router call "
        f"{direct_s:.4f} s, K1 {served_k1} = direct, text equal; synthesize (two sentences) wall "
        f"{synth_s:.4f} s, {len(events) - 2} chunks, {len(got)} bytes == direct")


def _realtime_fixture(tts) -> None:
    """W-b / R-d: ``test-tiny-eot`` (float32) on the card behind a second
    app: a realtime commit and a Wyoming transcribe of the fixture's beeps
    give the CPU's text."""
    import numpy as np

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter
    from open_speech_tpu_torch.server.realtime import server as RS
    from open_speech_tpu_torch.server.wyoming.server import start_wyoming_server
    from pathlib import Path

    model_id = "test-tiny-eot"
    settings.stt_model_dir = str(Path(__file__).resolve().parent / "tests" / "fixtures")
    card, host = BackendRouter(compute_type="float32"), BackendRouter(device="cpu", compute_type="float32")
    for r in (card, host):
        r.load_model(model_id)
    clip = codec.float_to_pcm16(_beeps(3, np.random.default_rng(11)))
    pcm24 = codec.linear_resample_pcm16(clip, SR, 24000)
    want_rt = RS._run_stt(host, _rt_buffered(pcm24), model_id)["text"]
    texts = {}
    with _Served(card, tts) as served:
        ws = _rt_session(served.port, model_id, {"turn_detection": None})
        _rt_appends(ws, pcm24)
        _rt_send(ws, COMMIT)
        _, _, done = _rt_wait(ws, "conversation.item.input_audio_transcription.completed", 2)
        ws.close()
        meta = {"rate": SR, "width": 2, "channels": 1}
        saved, settings.stt_vad_enabled = settings.stt_vad_enabled, False  # random VAD weights sit at 0.5
        try:
            for name, r in (("card", card), ("cpu", host)):
                server = served._run(start_wyoming_server(r, tts, host="127.0.0.1", port=0))
                try:
                    client = _WyomingClient(server.sockets[0].getsockname()[1])
                    client.send("transcribe", {"name": model_id})
                    client.send("audio-chunk", meta, clip)
                    client.send("audio-stop")
                    texts[name] = client.until("transcript")[-1][1]["text"]
                    client.close()
                finally:
                    served._run(_closed(server))
        finally:
            settings.stt_vad_enabled = saved
    if done["transcript"] != want_rt or not want_rt or texts["card"] != texts["cpu"] or not texts["cpu"]:
        raise AssertionError(f"realtime 12 fixture: realtime {done['transcript']!r} vs cpu {want_rt!r}; "
                             f"wyoming card {texts['card']!r} vs cpu {texts['cpu']!r}")
    log(f"realtime 12 fixture ({model_id}, float32): realtime commit text {want_rt!r} = CPU; Wyoming "
        f"transcribe (VAD off) text {texts['cpu']!r} = CPU")



# ── phase 13: model management, the lifecycle and serving metrics ───────

MIB = 1 << 20
FREED_SLACK = 64 * MIB  # what may stay allocated after an eviction or an unload
FIXTURE_MODEL = "test-tiny-eot"
OTHER_DEFAULT = "whisper-large-v3"  # stt_model while turbo must be evictable


def _card_bytes() -> int:
    """Bytes allocated on the card once Python's garbage, the allocator's
    cache and cuBLAS's per-thread workspaces are let go (each executor
    thread that ran a matmul holds a workspace of its own)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def _json_call(port: int, method: str, path: str, want: int, body=None) -> dict:
    """The JSON body of one request, which must answer ``want``."""
    payload = b"" if body is None else json.dumps(body).encode()
    headers = {"Content-Type": "application/json"} if body is not None else {}
    status, _, raw = _http(port, method, path, payload, headers)
    if status != want:
        raise AssertionError(f"management 13: {method} {path}: {status} {raw[:300]!r} (want {want})")
    return json.loads(raw)


def _metric(text: str, sample: str) -> float:
    """The value of one sample line of Prometheus text."""
    for line in text.splitlines():
        name, _, value = line.rpartition(" ")
        if name == sample:
            return float(value)
    raise AssertionError(f"management 13: no {sample!r} in /metrics")


def phase_management(tts) -> dict:
    """13: model management on the served app (``create_app`` on 127.0.0.1,
    a stdlib client) over a fresh bf16 turbo ``BackendRouter`` on the card
    and phase 11's kokoro-82M ``TTSRouter``: a) a load through the route
    against a direct load; b) the serving counters; c) a profiler trace of
    one transcription; d) TTL and LRU eviction by one lifecycle sweep, and
    the stale batcher's retirement; e) an unload through the route. The
    card's memory returns to its baseline after d and e. Returns the flash
    launches."""
    from open_speech_tpu_torch.config import Settings, settings
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.runtime.router import BackendRouter
    from open_speech_tpu_torch.server import app as app_module
    from open_speech_tpu_torch.server.metrics import Metrics

    for key in A.launches:
        A.launches[key] = 0  # count this phase only
    loading = ("os_stt_batched_longform", "os_precompile_on_load", "os_stt_precompile_budgets")
    keys = loading + ("stt_model", "os_model_ttl", "os_max_loaded_models", "os_batcher_enabled",
                      "stt_model_dir")
    saved = {key: getattr(settings, key) for key in keys}
    saved_metrics, app_module.metrics = app_module.metrics, Metrics()  # this phase's counts only
    defaults = Settings({})  # a deployment's load (earlier phases change these): one beam-5 warmup
    for key in loading:
        setattr(settings, key, getattr(defaults, key))
    try:
        baseline = _card_bytes()
        direct = _management_direct_load(baseline)
        router = BackendRouter(device="cuda:0")  # bf16, the settings' default
        with _Served(router, tts) as served:
            log(f"management 13: create_app serving on http://127.0.0.1:{served.port}")
            _management_load(served.port, router, baseline, direct)
            _management_counters(served.port)
            _management_profiler(served.port)
            _management_evict(served, router, baseline)
            _management_unload(served.port, baseline)
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        app_module.metrics = saved_metrics
    return dict(A.launches)


def _management_direct_load(baseline: int) -> dict:
    """The yardstick of 13a: ``load_model`` on a router of its own."""
    import torch

    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.runtime.router import BackendRouter

    router = BackendRouter(device="cuda:0")
    k1 = A.launches["flash_attention"]
    t0 = time.perf_counter()
    router.load_model(MAIN_MODEL)
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0, "k1": A.launches["flash_attention"] - k1,
           "resident": _card_bytes() - baseline}
    _free(router)
    del router
    if _card_bytes() - baseline > FREED_SLACK:
        raise AssertionError("management 13a: the direct load's router did not give its memory back")
    return out


def _management_load(port: int, router, baseline: int, direct: dict) -> None:
    """13a: POST /api/models/{turbo}/load, its K1 launches against the
    direct load's; status, progress and /api/ps."""
    import torch

    from open_speech_tpu_torch.ops import attention as A

    k1 = A.launches["flash_attention"]
    t0 = time.perf_counter()
    info = _json_call(port, "POST", f"/api/models/{MAIN_MODEL}/load", 200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_k1 = A.launches["flash_attention"] - k1
    if (info["state"], info["device"], info["provider"]) != ("loaded", str(router._default_backend.device),
                                                             "torch-whisper"):
        raise AssertionError(f"management 13a: load answered {info}")
    if n_k1 != direct["k1"] or n_k1 <= 0:
        raise AssertionError(f"management 13a: K1 launches route {n_k1} vs direct {direct['k1']}")
    status = _json_call(port, "GET", f"/api/models/{MAIN_MODEL}/status", 200)
    progress = _json_call(port, "GET", f"/api/models/{MAIN_MODEL}/progress", 200)
    ps = _json_call(port, "GET", "/api/ps", 200)["models"]
    if status["state"] != "loaded" or progress["status"] != "ready" or [m["model"] for m in ps] != [MAIN_MODEL]:
        raise AssertionError(f"management 13a: status {status}, progress {progress}, /api/ps {ps}")
    resident = _card_bytes() - baseline
    log(f"management 13a: POST /api/models/{MAIN_MODEL}/load -> loaded on {info['device']} "
        f"({info['provider']}) wall_s {wall:.3f} against a direct load_model {direct['wall']:.3f}; K1 "
        f"launches {n_k1} = direct {direct['k1']}; resident bytes {resident} (direct {direct['resident']}); "
        f"status loaded, progress ready, /api/ps lists it")


def _management_counters(port: int) -> None:
    """13b: request a of phase 4 through the route, then one speech
    request; /metrics and /api/stats."""
    from open_speech_tpu_torch.ops import audio as codec

    wav = codec.write_wav(_speechlike(5.0, 1), SR)
    body, headers = _multipart({"model": MAIN_MODEL, "response_format": "json"}, wav)
    t0 = time.perf_counter()
    status, _, raw = _http(port, "POST", "/v1/audio/transcriptions", body, headers)
    client_wall = time.perf_counter() - t0
    if status != 200 or not isinstance(json.loads(raw)["text"], str):  # random weights: often no words
        raise AssertionError(f"management 13b: transcription {status} {raw[:300]!r}")
    text = _http(port, "GET", "/metrics")[2].decode()
    stats = _json_call(port, "GET", "/api/stats", 200)
    recorded = stats["histograms"]["stt_rtfx"]["mean"]
    server_wall = 5.0 / recorded
    overhead = client_wall - server_wall
    if (_metric(text, "open_speech_stt_requests_total") != 1 or _metric(text, "open_speech_stt_rtfx_count") != 1
            or not 0 <= overhead < 0.5):
        raise AssertionError(f"management 13b: /metrics {text!r}; client wall {client_wall} server {server_wall}")
    speech = json.dumps({"input": SERVING_TEXT, "voice": RT_VOICE, "response_format": "wav"}).encode()
    status, _, audio = _http(port, "POST", "/v1/audio/speech", speech, {"Content-Type": "application/json"})
    text = _http(port, "GET", "/metrics")[2].decode()
    ttfa_p50 = _metric(text, 'open_speech_tts_ttfa_seconds{quantile="0.50"}')
    if status != 200 or _metric(text, "open_speech_tts_requests_total") != 1 or not ttfa_p50 > 0:
        raise AssertionError(f"management 13b: speech {status} ({len(audio)} bytes); /metrics {text!r}")
    stats = _json_call(port, "GET", "/api/stats", 200)
    jax_keys = {"uptime_seconds", "counters", "gauges", "histograms", "streaming_sessions", "batchers",
                "tts_batchers", "pocket_batchers", "replica"}
    if set(stats) != jax_keys or set(stats["replica"]) != {"replica", "replica_count", "local_devices",
                                                           "global_devices"}:
        raise AssertionError(f"management 13b: /api/stats keys {sorted(stats)}")
    log(f"management 13b: request a through the route: stt_requests_total 1, stt_rtfx count 1; recorded "
        f"RTFx {recorded:.4f} (server wall {server_wall:.4f} s) against the client's {5.0 / client_wall:.4f} "
        f"(wall {client_wall:.4f} s; HTTP, multipart and ingest {1e3 * overhead:.1f} ms); speech: "
        f"tts_requests_total 1, tts_ttfa_seconds p50 {1e3 * ttfa_p50:.3f} ms; /api/stats has the JAX keys, "
        f"replica {stats['replica']}")


def _management_profiler(port: int) -> None:
    """13c: a torch.profiler trace over one transcription (language en,
    temperature 0.2: one decode attempt); its flash_fwd_bf16 kernel events
    against the K1 counter; a second start answers 409."""
    import os
    import shutil
    import tempfile

    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec

    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        _json_call(port, "POST", "/api/profiler/start", 200, {"dir": trace_dir})
        _json_call(port, "POST", "/api/profiler/start", 409, {"dir": trace_dir})
        wav = codec.write_wav(_speechlike(5.0, 1), SR)
        body, headers = _multipart({"model": MAIN_MODEL, "language": "en", "temperature": "0.2"}, wav)
        k1 = A.launches["flash_attention"]
        t0 = time.perf_counter()
        status, _, raw = _http(port, "POST", "/v1/audio/transcriptions", body, headers)
        traced_wall = time.perf_counter() - t0
        n_k1 = A.launches["flash_attention"] - k1
        t0 = time.perf_counter()
        stopped = _json_call(port, "POST", "/api/profiler/stop", 200)
        stop_s = time.perf_counter() - t0
        [name] = os.listdir(trace_dir)
        size = os.path.getsize(os.path.join(trace_dir, name))
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if "flash_fwd_bf16" in e.get("name", "")]
    if status != 200 or stopped["dir"] != trace_dir or len(flash) != n_k1 or n_k1 <= 0:
        raise AssertionError(f"management 13c: transcription {status}; K1 counted {n_k1}, flash_fwd_bf16 "
                             f"kernel events {len(flash)} of {len(kernels)}")
    log(f"management 13c: profiler trace of one transcription (wall {traced_wall:.3f} s traced; stop and "
        f"export {stop_s:.3f} s, {size} bytes): {len(kernels)} kernel events, flash_fwd_bf16 {len(flash)} "
        f"= K1 counted {n_k1} ({sum(e['dur'] for e in flash) / 1e3:.3f} ms on the card); a second start "
        f"answered 409")


def _management_evict(served, router, baseline: int) -> None:
    """13d: turbo idle past OS_MODEL_TTL with a pinned batcher in the pool:
    one sweep evicts it and retires the batcher, and the card's memory
    returns to the baseline; then OS_MAX_LOADED_MODELS=1 over the fixture
    and turbo: one sweep evicts the older."""
    import asyncio
    from pathlib import Path

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime import batcher_pool as P

    settings.stt_model, settings.os_model_ttl = OTHER_DEFAULT, 1
    settings.os_batcher_enabled = True
    ws = _rt_session(served.port, MAIN_MODEL, {
        "turn_detection": None, "input_audio_transcription": {"model": "whisper-1", "language": "en"}})
    _rt_appends(ws, codec.float_to_pcm16(_speechlike(2.0 * 24000 / SR, 23)))
    _rt_send(ws, COMMIT)
    _rt_wait(ws, "conversation.item.input_audio_transcription.completed", 2)
    ws.close()
    settings.os_batcher_enabled = False
    pool = list(P.pool_stats())
    if pool != [f"{MAIN_MODEL}/en/transcribe"]:
        raise AssertionError(f"management 13d: pool after the pinned commit {pool}")
    before = _card_bytes() - baseline
    time.sleep(1.5)  # idle past the TTL

    async def sweep_and_drain():
        await served.app["lifecycle"]._sweep()
        await asyncio.gather(*list(P._retiring))  # the retired batcher's drain and stop

    t0 = time.perf_counter()
    served._run(sweep_and_drain())
    sweep_s = time.perf_counter() - t0
    ps = _json_call(served.port, "GET", "/api/ps", 200)["models"]
    after = _card_bytes() - baseline
    if ps or P.pool_stats() or after > FREED_SLACK:
        raise AssertionError(f"management 13d: after the TTL sweep /api/ps {ps}, pool {P.pool_stats()}, "
                             f"{after} bytes over the baseline")
    log(f"management 13d TTL: {MAIN_MODEL} and its batcher (KV pools) resident {before} bytes over the "
        f"baseline; one sweep ({sweep_s:.3f} s with the drain) evicted it and retired the batcher: /api/ps empty, "
        f"pool empty, {before - after} bytes freed, {after} over the baseline")

    settings.os_model_ttl, settings.os_max_loaded_models = 0, 1
    settings.stt_model_dir = str(Path(__file__).resolve().parent / "tests" / "fixtures")
    settings.os_precompile_on_load = False
    router.load_model(FIXTURE_MODEL)
    time.sleep(0.01)
    router.load_model(MAIN_MODEL)  # the newer one
    served._run(served.app["lifecycle"]._sweep())
    ps = [m["model"] for m in _json_call(served.port, "GET", "/api/ps", 200)["models"]]
    if ps != [MAIN_MODEL]:
        raise AssertionError(f"management 13d LRU: /api/ps {ps}")
    log(f"management 13d LRU: OS_MAX_LOADED_MODELS=1 over {FIXTURE_MODEL} (older) and {MAIN_MODEL}: one "
        f"sweep left {ps}")


def _management_unload(port: int, baseline: int) -> None:
    """13e: DELETE /api/models/{turbo}, twice; the memory returns."""
    done = _json_call(port, "DELETE", f"/api/models/{MAIN_MODEL}", 200)
    again = _json_call(port, "DELETE", f"/api/models/{MAIN_MODEL}", 404)
    want = {"error": {"message": f"Model {MAIN_MODEL} is not loaded", "code": "not_loaded"}}
    after = _card_bytes() - baseline
    if done != {"status": "unloaded", "model": MAIN_MODEL} or again != want or after > FREED_SLACK:
        raise AssertionError(f"management 13e: {done}, {again}, {after} bytes over the baseline")
    log(f"management 13e: DELETE /api/models/{MAIN_MODEL} -> unloaded, again -> 404 not_loaded; "
        f"{after} bytes over the baseline")



# ── phase 14: Piper (VITS) and the effects chain ────────────────────────

PIPER_VOICE = "piper/en_US-lessac-medium"
PIPER_SEED = 11  # the weights of 14a
PIPER_ROWS = (4, 16)  # 14a's concurrent jobs through the PiperBatcher
# 14a card against CPU, float32 with cuDNN's TF32 off on both: max |diff|
# relative to max(1, max|CPU|) per stage, the audio in relative L2, batched
# rows against their solo runs in max |diff| (tanh audio, |x| < 1)
PIPER_TOL = {"x": 1e-4, "m": 1e-4, "logs": 1e-4, "logw": 1e-4, "z": 1e-4, "audio_rel_l2": 1e-3, "row": 1e-4}
EFFECTS_SECONDS = 12.0
EFFECTS_SR = 24000
EFFECT_CASES = {
    "normalize": [{"type": "normalize"}],
    "pitch": [{"type": "pitch", "semitones": 3}],
    "reverb": [{"type": "reverb", "room": "large"}],
    "podcast_eq": [{"type": "podcast_eq"}],
    "robot": [{"type": "robot"}],
    "chain": [{"type": "podcast_eq"}, {"type": "pitch", "semitones": -2}, {"type": "reverb", "room": "medium"},
              {"type": "robot"}, {"type": "normalize", "target_lufs": -18}],
}
# card against CPU, max |diff| on a signal of peak ~0.5: float32 rounding
# (the phase vocoder's and the chain's through it: 1.7e-5 and 4.8e-5 on an
# H100, bound 10x; tests/test_torch_effects.py holds the CPU against JAX)
EFFECTS_TOL = {"normalize": 1e-5, "pitch": 5e-4, "reverb": 1e-5, "podcast_eq": 1e-5, "robot": 1e-5,
               "chain": 5e-4}


def phase_piper() -> None:
    """14: Piper and the effects on the card. 14a the model at piper
    "medium" width (``PiperConfig()``: hidden 192, 6 encoder layers,
    upsample 8.8.2.2 from 512 channels, resblocks 3/7/11, 22.05 kHz, buckets
    of 128 phonemes and 512 frames; random weights from a seed, float32):
    card against CPU stage by stage, one 128-phoneme row's wall and RTFx,
    4 and 16 concurrent rows through the ``PiperBatcher`` against their solo
    runs, one profiled synthesis. 14b served: the Piper voice through
    ``create_app`` (speech WAV and streamed PCM against the direct backend
    call, Wyoming describe and synthesize at 16 kHz, the load and unload
    routes and the card's bytes, Pocket's named error). 14c the five
    effects and a chain on 12 s at 24 kHz against the CPU, ms per effect,
    and a speech request with effects, whole and streamed. Fails if a flash
    kernel is launched."""
    from open_speech_tpu_torch.ops import attention as A

    before = dict(A.launches)
    _piper_model()
    _piper_effects()
    _piper_served()
    if dict(A.launches) != before:
        raise AssertionError(f"piper 14: flash launches moved: {before} -> {dict(A.launches)}")
    log(f"piper 14: flash launch counts unchanged through phase 14: {before}")


def _piper_models():
    """The same ``PiperConfig()`` weights on the card and on the CPU (the
    coupling layers' zero-initialised ``post`` convolutions filled, so the
    flow is live)."""
    import torch

    from open_speech_tpu_torch.models.piper import PiperConfig, PiperModel, init_piper_params

    cfg = PiperConfig()
    host = init_piper_params(torch.Generator().manual_seed(PIPER_SEED), cfg, device="cpu")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(PIPER_SEED + 1)
        for name, p in host.named_parameters():
            if name.startswith("flow.") and ".post." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    card = PiperModel.empty(cfg, "cuda")
    card.load_state_dict(host.state_dict())
    return cfg, host, card


def _piper_row(cfg, n: int, seed: int):
    """One row of ``n`` phoneme ids drawn from ``seed``: (ids, length, speaker, speed)."""
    import torch

    ids = torch.zeros((1, cfg.max_phonemes), dtype=torch.int64)
    ids[0, :n] = torch.randint(1, cfg.n_phonemes, (n,), generator=torch.Generator().manual_seed(seed))
    return ids, torch.tensor([n]), torch.tensor([0]), torch.tensor([1.0])


def _piper_model() -> None:
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.piper import model as PM
    from open_speech_tpu_torch.runtime.tts_batcher import _piper_rows, _row_noise

    cfg, host, card = _piper_models()
    n_params = sum(p.numel() for p in card.parameters())
    log(f"piper 14a: piper medium geometry (hidden {cfg.hidden}, {cfg.n_layers} encoder layers, upsample "
        f"{cfg.upsample_rates} from {cfg.upsample_initial} channels, resblocks {cfg.resblock_kernels}, "
        f"{cfg.sample_rate} Hz, buckets {cfg.max_phonemes} phonemes / {cfg.max_frames} frames = "
        f"{cfg.max_frames * cfg.samples_per_frame / cfg.sample_rate:.2f} s), random weights from seed "
        f"{PIPER_SEED}, float32: {n_params} parameters ({4 * n_params / 1e9:.3f} GB)")
    row = _piper_row(cfg, cfg.max_phonemes, 21)
    dp, z = _row_noise(7, cfg, "cpu")
    noise = dict(dp_noise=dp[None], z_noise=z[None])

    # stage by stage: each card stage on the CPU stage's inputs
    ids, n, spk, speed = row
    mask = (torch.arange(cfg.max_phonemes) < n[:, None]).float()[:, None]
    with PM.inference():
        stages = {}
        for name, m in (("cpu", host), ("card", card)):
            dev = m.device
            x, mm, logs = PM.text_encoder(m, cfg, ids.to(dev), mask.to(dev))
            x_in = stages["cpu"]["x"].to(dev) if name == "card" else x
            logw = PM.sdp_log_durations(m, cfg, x_in, mask.to(dev), None, dp[None].to(dev))
            w_ceil, _, n_frames = PM.durations(logw, mask.to(dev), speed.to(dev), cfg.max_frames)
            n_in = stages["cpu"]["n_frames"].to(dev) if name == "card" else n_frames
            fmask = (torch.arange(cfg.max_frames, device=dev) < n_in[:, None]).float()[:, None]
            zp = (stages["cpu"]["zp"].to(dev) if name == "card"
                  else (z[None] * fmask.cpu()).to(dev))
            zz = PM.flow_inverse(m, cfg, zp, fmask, None)
            stages[name] = {k: v.cpu() for k, v in dict(
                x=x, m=mm, logs=logs, logw=logw, w_ceil=w_ceil, n_frames=n_frames, zp=zp, z=zz).items()}
    cpu, gpu = stages["cpu"], stages["card"]
    errs = {k: _piper_within(f"piper 14a {k}", gpu[k], cpu[k], PIPER_TOL[k]) for k in ("x", "m", "logs", "logw", "z")}
    w = (torch.exp(cpu["logw"]) * mask)[mask > 0]
    margin = (w - w.round()).abs().min().item()
    if not (torch.equal(gpu["w_ceil"], cpu["w_ceil"]) and torch.equal(gpu["n_frames"], cpu["n_frames"])):
        raise AssertionError(f"piper 14a: card durations differ from the CPU's (least distance of a "
                             f"duration from an integer {margin:.3e})")
    audio = {}
    for name, m in (("cpu", host), ("card", card)):
        a, nf = PM.synthesize_vits(m, cfg, *row, **noise)
        audio[name] = (a.cpu(), nf.cpu())
    if not torch.equal(audio["card"][1], audio["cpu"][1]):
        raise AssertionError(f"piper 14a: n_frames {audio['card'][1]} vs CPU {audio['cpu'][1]}")
    frames = int(audio["cpu"][1][0])
    valid = frames * cfg.samples_per_frame
    rel = _rel_l2("piper 14a audio", audio["card"][0][:, :valid], audio["cpu"][0][:, :valid],
                  PIPER_TOL["audio_rel_l2"])
    log(f"piper 14a card vs CPU (same weights and noise, {cfg.max_phonemes} phonemes): max|diff| "
        + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; durations and n_frames ({frames}) equal (least distance of a duration from an integer "
        f"{margin:.3e}); audio relative L2 {rel:.3e} (max|audio| {audio['cpu'][0].abs().max().item():.4g})")

    # wall and RTFx of one 128-phoneme row, as the backend runs a piece
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        a, nf = _piper_rows(card, cfg, *row, [7])
        pcm = a[0, : int(nf[0]) * cfg.samples_per_frame].cpu().numpy()
        walls.append(time.perf_counter() - t0)
    seconds = pcm.size / cfg.sample_rate
    if not np.isfinite(pcm).all() or pcm.size != valid:
        raise AssertionError(f"piper 14a: {pcm.size} samples vs {valid}, or not finite")
    log(f"piper 14a one row: {cfg.max_phonemes} phonemes -> {frames} frames, {seconds:.3f} s of audio; "
        f"wall_ms first {1e3 * walls[0]:.3f} then " + " ".join(f"{1e3 * w:.3f}" for w in walls[1:])
        + f"; RTFx {seconds / min(walls[1:]):.2f} (best of 3 after the first)")
    _piper_batches(cfg, card)
    _piper_profile(cfg, card, row)


def _piper_within(name: str, got, want, tol: float) -> float:
    """Max |got - want|, raising past tol * max(1, max|want|)."""
    import torch

    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or not finite")
    err = (got - want).abs().max().item()
    if err > tol * max(1.0, want.abs().max().item()):
        raise AssertionError(f"{name}: max |diff| {err:.3e} over {tol:.1e}")
    return err


def _piper_batches(cfg, card) -> None:
    """4 and 16 concurrent jobs of different lengths, speeds and seeds
    through one ``PiperBatcher``; each row against its solo run."""
    import threading

    import numpy as np
    import torch

    from open_speech_tpu_torch.runtime.tts_batcher import PiperBatcher, _piper_rows

    rng = np.random.default_rng(31)
    for rows in PIPER_ROWS:
        jobs = [(rng.integers(1, cfg.n_phonemes, int(rng.integers(24, cfg.max_phonemes + 1))).tolist(), 0,
                 float(rng.uniform(0.8, 1.25)), int(s)) for s in rng.integers(0, 1 << 20, rows)]
        solo = []
        for ids, spk, speed, seed in jobs:
            ph = torch.zeros((1, cfg.max_phonemes), dtype=torch.int64)
            ph[0, : len(ids)] = torch.tensor(ids)
            a, nf = _piper_rows(card, cfg, ph, torch.tensor([len(ids)]), torch.tensor([spk]),
                                torch.tensor([speed]), [seed])
            solo.append(a[0, : int(nf[0]) * cfg.samples_per_frame].cpu().numpy())
        batcher = PiperBatcher(card, cfg)
        batcher.precompile(rows)  # the card's libraries set up for this batch shape
        walls = []
        for _ in range(2):  # the first round also pays the batcher thread's first calls
            batcher.stats.update(batches=0, jobs=0, peak_batch=0)
            got: list = [None] * rows
            start = threading.Barrier(rows + 1)

            def run(i):
                start.wait()
                got[i] = np.concatenate(list(batcher.synthesize(*jobs[i])))

            threads = [threading.Thread(target=run, args=(i,)) for i in range(rows)]
            for th in threads:
                th.start()
            start.wait()
            t0 = time.perf_counter()
            for th in threads:
                th.join(300)
            walls.append(time.perf_counter() - t0)
            if any(th.is_alive() for th in threads) or any(g is None for g in got):
                raise AssertionError(f"piper 14a batch of {rows}: a job did not finish")
        batcher.stop()
        err = 0.0
        for g, want in zip(got, solo):
            if g.shape != want.shape:
                raise AssertionError(f"piper 14a batch of {rows}: row {g.shape} vs solo {want.shape}")
            err = max(err, float(np.abs(g - want).max()))
        if err > PIPER_TOL["row"]:
            raise AssertionError(f"piper 14a batch of {rows}: max |row - solo| {err:.3e}")
        audio_s = sum(g.size for g in got) / cfg.sample_rate
        stats = batcher.stats
        log(f"piper 14a batcher {rows} concurrent jobs: wall_s {walls[0]:.4f} then {walls[1]:.4f} for "
            f"{audio_s:.2f} s of audio (RTFx {audio_s / walls[1]:.1f}); batches {stats['batches']} in the "
            f"second round, peak batch {stats['peak_batch']}; max |row - solo| {err:.3e}")


def _piper_profile(cfg, card, row) -> None:
    """One 128-phoneme synthesis under torch.profiler: idle share, top ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from open_speech_tpu_torch.runtime.tts_batcher import _piper_rows

    def once():
        a, nf = _piper_rows(card, cfg, *row, [7])
        a[0, : int(nf[0]) * cfg.samples_per_frame].cpu()

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
        raise AssertionError("piper profile: no device time in the trace")
    log(f"piper 14a profiled synthesis: wall_s {wall:.4f} device_busy_s {busy:.4f} "
        f"idle_share {1 - busy / wall:.4f} kernel launches {sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")


def _piper_served() -> None:
    """14b: a full-width Piper voice behind ``create_app`` and Wyoming."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.audio.postprocessing import StreamingPostProcessor, process_tts_chunks
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter
    from open_speech_tpu_torch.tts.router import TTSRouter

    saved = {k: getattr(settings, k) for k in ("tts_model", "os_tts_batcher_enabled")}
    baseline = _card_bytes()
    tts = TTSRouter()  # the card
    t0 = time.perf_counter()
    tts.load_model(PIPER_VOICE)
    torch.cuda.synchronize()
    load_s, loaded = time.perf_counter() - t0, _card_bytes() - baseline
    backend = tts.get_backend(PIPER_VOICE)
    if backend.device.type != "cuda" or backend._models[PIPER_VOICE][0].device.type != "cuda":
        raise AssertionError(f"piper 14b: the voice landed on {backend.device}, not the card")
    log(f"piper 14b: {PIPER_VOICE} (registry voice, random weights from its sha256 seed, float32) loaded in "
        f"{load_s:.3f} s, {loaded} bytes on the card")

    def direct(streamed: bool = False) -> np.ndarray:
        """The direct backend call, post-processed as the route does: whole,
        or chunk by chunk (the streamed gain follows the running peak)."""
        chunks = tts.synthesize(text=SERVING_TEXT, model=PIPER_VOICE, voice="ignored", speed=1.0)
        kw = dict(trim=settings.tts_trim_silence, normalize=settings.tts_normalize_output)
        if not streamed:
            return np.concatenate(list(process_tts_chunks(chunks, **kw)))
        pp = StreamingPostProcessor(**kw)
        return np.concatenate([p for c in chunks for p in pp.feed(c)] + list(pp.finish()))

    try:
        with _Served(BackendRouter(device="cuda:0"), tts) as served:
            want = direct()
            body = json.dumps({"model": PIPER_VOICE, "input": SERVING_TEXT, "response_format": "wav"}).encode()
            headers = {"Content-Type": "application/json"}
            t0 = time.perf_counter()
            status, _, wav = _http(served.port, "POST", "/v1/audio/speech", body, headers)
            wav_s = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"piper 14b speech: {status} {wav[:300]!r}")
            got, rate = codec.read_wav(wav)
            direct_pcm = codec.float_to_pcm16(want)
            if rate != 22050 or not np.array_equal(got, codec.pcm16_to_float(direct_pcm)):
                raise AssertionError(f"piper 14b speech: {rate} Hz, {got.shape} vs direct {want.shape}")
            want_streamed = direct(streamed=True)
            ttfa, pcm = _piper_streamed_ttfa(served.port, PIPER_VOICE)
            if pcm != codec.float_to_pcm16(want_streamed):
                raise AssertionError(f"piper 14b streamed PCM: {len(pcm)} bytes vs {2 * want_streamed.size} direct")
            log(f"piper 14b POST /v1/audio/speech model={PIPER_VOICE}: 200, {rate} Hz WAV of "
                f"{got.size / rate:.3f} s, samples = the direct backend call's, wall {wav_s:.4f} s; "
                f"streamed PCM TTFA {1e3 * ttfa:.3f} ms, bytes = the direct call's through the streaming "
                f"post-processor")
            _piper_wyoming(served, tts, want)
            _piper_pocket(served.port)
            _piper_routes(served.port)
            _piper_effects_served(served.port, want, want_streamed)
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        for m in [m.model for m in tts.loaded_models()]:
            tts.unload_model(m)


def _piper_streamed_ttfa(port: int, model: str, effects=None) -> tuple[float, bytes]:
    """A streamed PCM speech request on a raw connection: (seconds to the
    first body chunk, the whole body)."""
    import http.client

    body = {"model": model, "input": SERVING_TEXT, "response_format": "pcm"}
    if effects:
        body["effects"] = effects
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/audio/speech?stream=true", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"piper 14b streamed speech: {resp.status} {resp.read()[:300]!r}")
        first = resp.read1(65536)
        ttfa = time.perf_counter() - t0
        return ttfa, first + resp.read()
    finally:
        conn.close()


def _piper_wyoming(served, tts, want) -> None:
    """Wyoming describe lists Piper's voices; a synthesize with the Piper
    voice as ``tts_model`` answers its audio resampled to 16 kHz."""
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.ops.resample import resample_pcm16
    from open_speech_tpu_torch.server.wyoming.server import start_wyoming_server

    settings.tts_model = PIPER_VOICE
    server = served._run(start_wyoming_server(served.app["stt_router"], tts, host="127.0.0.1", port=0))
    try:
        client = _WyomingClient(server.sockets[0].getsockname()[1])
        client.send("describe")
        ((_, info, _),) = client.until("info")
        t0 = time.perf_counter()
        client.send("synthesize", {"text": SERVING_TEXT, "voice": {"name": PIPER_VOICE}})
        events = client.until("audio-stop")
        synth_s = time.perf_counter() - t0
        client.close()
    finally:
        served._run(_closed(server))
    voices = [v["name"] for v in info["tts"][0]["voices"]]
    piper = [v for v in voices if v.startswith("piper/")]
    direct = resample_pcm16(codec.float_to_pcm16(want), 22050, 16000, tts.get_backend(PIPER_VOICE).device)
    got = b"".join(p for kind, _, p in events if kind == "audio-chunk")
    rates = {d.get("rate") for kind, d, _ in events if kind == "audio-start"}
    if len(piper) != 30 or PIPER_VOICE not in piper or rates != {16000} or got != direct:
        raise AssertionError(f"piper 14b wyoming: {len(piper)} piper voices, rates {rates}, "
                             f"{len(got)} bytes vs {len(direct)} direct, equal {got == direct}")
    log(f"piper 14b wyoming: describe lists {len(voices)} voices ({len(piper)} piper); synthesize with "
        f"{PIPER_VOICE}: 16000 Hz, {len(got)} bytes == the direct audio resampled 22050 -> 16000, "
        f"wall {synth_s:.4f} s")


def _piper_pocket(port: int) -> None:
    """``pocket-tts`` serves its own audio (the backend's default tiny
    preset, random weights, on the card), not the default backend's, and
    reports its own capabilities."""
    import numpy as np

    from open_speech_tpu_torch.ops import audio as codec

    body = json.dumps({"model": "pocket-tts", "input": "Hello there.", "response_format": "wav"}).encode()
    status, _, raw = _http(port, "POST", "/v1/audio/speech", body, {"Content-Type": "application/json"})
    caps = _json_call(port, "GET", "/api/tts/capabilities?model=pocket-tts", 200)
    if status != 200:
        raise AssertionError(f"piper 14b pocket-tts: {status} {raw[:200]!r}")
    samples, rate = codec.read_wav(raw)
    if rate != 24000 or not samples.size or not np.isfinite(samples).all() or caps["backend"] != "pocket-tts" \
            or not caps["capabilities"]["voice_clone"]:
        raise AssertionError(f"piper 14b pocket-tts: {rate} Hz, {samples.size} samples, {caps}")
    log(f"piper 14b pocket-tts: speech answers 200, {samples.size / rate:.3f} s of 24 kHz WAV from the Pocket "
        f"backend; its capabilities name it, voice_clone on")


def _piper_routes(port: int) -> None:
    """The model manager's unload and load routes on the loaded voice: the
    unload gives its bytes back, the load takes as many again."""
    with_voice = _card_bytes()
    done = _json_call(port, "DELETE", f"/api/models/{PIPER_VOICE}", 200)
    freed = with_voice - _card_bytes()
    t0 = time.perf_counter()
    loaded = _json_call(port, "POST", f"/api/models/{PIPER_VOICE}/load", 200)
    load_s, held = time.perf_counter() - t0, _card_bytes() - (with_voice - freed)
    status = _json_call(port, "GET", f"/api/models/{PIPER_VOICE}/status", 200)
    if done.get("status") != "unloaded" or loaded.get("state") != "loaded" or status.get("state") != "loaded" \
            or not str(loaded.get("device")).startswith("cuda") or freed < 100 * MIB or abs(held - freed) > FREED_SLACK:
        raise AssertionError(f"piper 14b routes: {done}, {loaded}, {status}; freed {freed}, held {held}")
    log(f"piper 14b DELETE /api/models/{PIPER_VOICE}: unloaded, {freed} bytes freed on the card; POST .../load: "
        f"{loaded['state']} on {loaded.get('device')} in {load_s:.3f} s, {held} bytes held again")


def _piper_effects() -> None:
    """14c: the effects on the card against the CPU, ms per effect."""
    import statistics

    import numpy as np
    import torch

    from open_speech_tpu_torch.audio.effects import apply_chain

    x = _speechlike(EFFECTS_SECONDS, 41, EFFECTS_SR)
    for name, chain in EFFECT_CASES.items():
        want = apply_chain(x, EFFECTS_SR, chain, device="cpu")
        got = apply_chain(x, EFFECTS_SR, chain, device="cuda")
        err = float(np.abs(got - want).max())
        if got.shape != want.shape or not np.isfinite(got).all() or err > EFFECTS_TOL[name]:
            raise AssertionError(f"piper 14c {name}: card vs CPU max |diff| {err:.3e} over {EFFECTS_TOL[name]}")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply_chain(x, EFFECTS_SR, chain, device="cuda")  # host copies in and out included
            times.append(time.perf_counter() - t0)
        log(f"piper 14c {name}: {EFFECTS_SECONDS} s at {EFFECTS_SR} Hz, card vs CPU max |diff| {err:.3e} "
            f"(bound {EFFECTS_TOL[name]}); ms on the card p50 {1e3 * statistics.median(times):.3f} "
            f"min {1e3 * min(times):.3f} (5 calls, host copies included)")


def _piper_effects_served(port: int, plain, plain_streamed) -> None:
    """14c: a speech request with the five-effect chain, whole and
    streamed: 200, and the samples within the chain's bound of the CPU's
    chain on the direct synthesis, post-processed whole (``plain``) or
    chunk by chunk (``plain_streamed``), as each branch does."""
    import numpy as np

    from open_speech_tpu_torch.audio.effects import apply_chain
    from open_speech_tpu_torch.ops import audio as codec

    chain = EFFECT_CASES["chain"]
    body = json.dumps({"model": PIPER_VOICE, "input": SERVING_TEXT, "response_format": "pcm",
                       "effects": chain}).encode()
    t0 = time.perf_counter()
    status, _, whole = _http(port, "POST", "/v1/audio/speech", body, {"Content-Type": "application/json"})
    whole_s = time.perf_counter() - t0
    if status != 200:
        raise AssertionError(f"piper 14c served effects: {status} {whole[:300]!r}")
    ttfa, streamed = _piper_streamed_ttfa(port, PIPER_VOICE, chain)
    errs = []
    for name, pcm, before in (("whole", whole, plain), ("streamed", streamed, plain_streamed)):
        want = apply_chain(before, 22050, chain, device="cpu")
        got = codec.pcm16_to_float(pcm)
        errs.append(float(np.abs(got - want).max()) if got.shape == want.shape else float("inf"))
        if errs[-1] > EFFECTS_TOL["chain"] + 2 / 32767:
            raise AssertionError(f"piper 14c served effects {name}: {got.shape} vs {want.shape}, "
                                 f"max |diff| {errs[-1]:.3e}")
    log(f"piper 14c POST /v1/audio/speech with the five-effect chain: whole 200 in {whole_s:.4f} s, "
        f"streamed 200, the processed utterance as its first chunk at {1e3 * ttfa:.3f} ms; max |diff| "
        f"against the CPU chain on the direct synthesis {errs[0]:.3e} (whole) {errs[1]:.3e} (streamed)")


# ── phase 15: Pocket TTS ─────────────────────────────────────────────────

POCKET_SEED = 13  # the weights of 15a and 15b
POCKET_FRAMES = 24  # 15a's teacher-forced frames
POCKET_TEXT = "Please call me back when you are ready to talk."  # 47 frames at one per character
POCKET_ROWS = (1, 4, 16)  # 15b's concurrent sessions
# 15a card against CPU (float32, TF32 off on both), relative L2: the prompt
# caches, per generation step the temporal hidden, text and depformer
# logits, and the streamed decode of the CPU's frames against the CPU's
# whole decode; 15b a batched row's PCM against its solo run, max |diff|
POCKET_TOL = {"cache": 1e-4, "hidden": 1e-4, "text_logits": 1e-4, "dep_logits": 1e-4, "pcm": 1e-3, "row": 1e-4}
# a token decision must agree where the reference's top-2 logit gap exceeds
# this, an RVQ code where its two nearest squared distances differ by more
POCKET_MARGIN = 1e-3


def phase_pocket() -> None:
    """15: Pocket TTS at full width (``PocketLMConfig()``: LM 1024 x 16
    layers, depformer 256 x 4 x 8 stages; ``MimiConfig()``: 512 x 8
    layers; max_ctx 1536; random weights from a seed, float32, TF32 off).
    15a card against CPU: Mimi codes of a 2 s clip, a voice prompt's
    caches, 24 frames of generation teacher-forced on the CPU's tokens, the
    streamed decode of its frames; then TTFA, wall and RTFx of a sentence,
    a frame's wall without the profiler, and the launches and device time
    of a profiled frame. 15b the slot-pool batcher at 1, 4 and 16 sessions
    (rows against solo runs, host syncs per group, TTFA, wall, peak
    memory). 15c served through ``create_app``: speech (speaker, clone,
    design; whole and streamed; the speaker again with the batcher on) and
    the clone route against direct backend calls, capabilities, voices,
    Wyoming describe, and the load and unload routes giving the card's
    memory back. Fails if a flash kernel is launched."""
    import gc

    from open_speech_tpu_torch.ops import attention as A

    before = dict(A.launches)
    host, card = _pocket_models()
    state = _pocket_card_vs_cpu(host, card)
    del host
    gc.collect()
    _pocket_timings(card, state)
    _pocket_batcher(card, state)
    del card, state
    _pocket_served()
    if dict(A.launches) != before:
        raise AssertionError(f"pocket 15: flash launches moved: {before} -> {dict(A.launches)}")
    log(f"pocket 15: flash launch counts unchanged through phase 15: {before}")


def _pocket_models():
    """The same full-width random weights on the CPU and on the card."""
    import copy

    import torch

    from open_speech_tpu_torch.models.pocket import MimiConfig, PocketLMConfig, PocketTTS

    t0 = time.perf_counter()
    host = PocketTTS.random_init(torch.Generator().manual_seed(POCKET_SEED), PocketLMConfig(), MimiConfig(),
                                 device="cpu")
    init_s = time.perf_counter() - t0
    card = PocketTTS(copy.deepcopy(host.lm_params).to("cuda"), copy.deepcopy(host.mimi_params).to("cuda"),
                     host.lm_cfg, host.mimi_cfg)
    torch.cuda.synchronize()
    lm_n = sum(b.numel() for b in card.lm_params.buffers())
    mimi_n = sum(b.numel() for b in card.mimi_params.buffers())
    cfg, mcfg = card.lm_cfg, card.mimi_cfg
    pool = 2 * cfg.n_layers * 16 * cfg.n_heads * cfg.max_ctx * cfg.head_dim * 4
    log(f"pocket 15a: LM d {cfg.d_model} x {cfg.n_layers} layers ({cfg.n_heads} heads), depformer "
        f"{cfg.dep_d_model} x {cfg.dep_layers} x {cfg.n_q} stages, Mimi {mcfg.dimension} x {mcfg.t_layers} layers, "
        f"max_ctx {cfg.max_ctx}, random weights from seed {POCKET_SEED} (drawn in {init_s:.1f} s), float32: "
        f"{lm_n} + {mimi_n} parameters ({4 * lm_n / 1e9:.3f} + {4 * mimi_n / 1e9:.3f} GB); a 16-slot KV pool is "
        f"{pool / 1e9:.3f} GB, a voice prompt's caches {pool / 16 / 1e9:.3f} GB; {torch.cuda.memory_allocated()} "
        f"bytes allocated on the card")
    return host, card


def _pocket_encode(host, card):
    """15a 1: Mimi codes of a 2 s clip, card against CPU; the CPU's codes."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.pocket import mimi as Mi
    from open_speech_tpu_torch.ops.vocoder import inference

    mcfg = host.mimi_cfg
    clip = _speechlike(2.0, 51, mcfg.sample_rate)
    spf = mcfg.samples_per_frame
    padded = np.zeros((1, -(-clip.size // spf) * spf), np.float32)
    padded[0, : clip.size] = clip
    codes, margins = {}, {}
    for name, m in (("cpu", host), ("card", card)):
        found: list = []
        with inference():
            codes[name] = Mi.mimi_encode(m.mimi_params, mcfg, torch.from_numpy(padded).to(m.device), found)[0].cpu()
        margins[name] = torch.stack([g[0].cpu() for g in found])  # [n_q, F]
    want, got, margin = codes["cpu"], codes["card"], margins["cpu"]
    # each frame's residual chain: after a code that differs within the
    # margin, the later levels quantize another residual and are excused
    excused = 0
    for f in range(want.shape[1]):
        for q in range(want.shape[0]):
            if got[q, f] != want[q, f]:
                if margin[q, f] > POCKET_MARGIN:
                    raise AssertionError(f"pocket 15a encode: frame {f} level {q}: card code {int(got[q, f])} vs CPU "
                                         f"{int(want[q, f])} at margin {float(margin[q, f]):.3e}")
                excused += want.shape[0] - q
                break
    log(f"pocket 15a Mimi encode of a 2 s clip: {want.shape[0]} x {want.shape[1]} codes, card = CPU at every code "
        f"({excused} after a flip within the margin {POCKET_MARGIN}); least CPU margin {float(margin.min()):.3e}, "
        f"{int((margin <= POCKET_MARGIN).sum())} codes within it")
    return want[None].numpy()


def _pocket_prefill_text(m, state):
    """generate_stream's text prefill of POCKET_TEXT after ``state`` on a
    copy of its caches: (caches, next position, text pad token)."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.pocket import model as Mo

    cfg, dev = m.lm_cfg, m.device
    ids = [cfg.text_bos_id] + m.tokenizer.encode(POCKET_TEXT) + [cfg.text_eos_id]
    pad_to = Mo._bucket(len(ids), cap=cfg.max_ctx - state.length - 1)
    text = np.full((1, pad_to), cfg.text_pad_id, np.int64)
    text[0, : len(ids)] = ids
    grid = torch.full((1, cfg.n_q, pad_to), cfg.audio_initial, dtype=torch.int64, device=dev)
    caches = (state.k_cache.clone(), state.v_cache.clone())
    caches = Mo._prefill(m.lm_params, cfg, torch.from_numpy(text).to(dev), grid, caches, state.length, len(ids))
    return caches, state.length + len(ids), torch.full((1,), cfg.text_pad_id, dtype=torch.int64, device=dev)


def _pocket_steps(m, state, feed=None) -> dict:
    """POCKET_FRAMES frames of greedy generation after the text prefill:
    per step the temporal hidden, the text logits, the depformer's logits
    at the step's tokens and the tokens. With ``feed`` (the CPU's tokens
    per step) the tokens and the next step's inputs are the CPU's: teacher
    forcing."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.pocket import lm as L
    from open_speech_tpu_torch.ops.vocoder import inference

    cfg, dev, p = m.lm_cfg, m.device, m.lm_params
    delays = np.asarray(cfg.delays)
    out = {"hidden": [], "text_logits": [], "dep_logits": [], "toks": []}
    with inference():
        caches, pos, text_pad = _pocket_prefill_text(m, state)
        audio_in = torch.full((1, cfg.n_q), cfg.audio_initial, dtype=torch.int64, device=dev)
        for s in range(POCKET_FRAMES + cfg.max_delay):
            h, caches = L.temporal_step(p, cfg, L.embed_step(p, cfg, text_pad, audio_in), caches,
                                        torch.full((1,), pos + s, dtype=torch.int64, device=dev))
            hn = L._rms(h, p["out_norm"])
            toks = L.depformer_sample(p, cfg, hn, text_pad) if feed is None else feed[s].to(dev)
            out["hidden"].append(h[0].cpu())
            out["text_logits"].append((hn @ p["text_linear"]["w"])[0].cpu())
            out["dep_logits"].append(L.depformer_forward(p, cfg, hn, text_pad, toks)[0].cpu())
            out["toks"].append(toks.cpu())
            frame = s - delays
            live = torch.from_numpy((frame >= 0) & (frame < POCKET_FRAMES)).to(dev)
            audio_in = torch.where(live[None], toks, cfg.audio_initial)
    return out


def _pocket_card_vs_cpu(host, card):
    """15a checks 1-4; returns the card's prompt state (the CPU's codes)."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.pocket import mimi as Mi
    from open_speech_tpu_torch.ops.vocoder import inference

    tokens = _pocket_encode(host, card)
    t0 = time.perf_counter()
    states = {"cpu": host.state_for_tokens(tokens), "card": card.state_for_tokens(tokens)}
    torch.cuda.synchronize()
    if states["cpu"].length != states["card"].length:
        raise AssertionError(f"pocket 15a prompt: lengths {states['cpu'].length} vs {states['card'].length}")
    n = states["cpu"].length
    errs = [_rel_l2(f"pocket 15a prompt {kind} cache", getattr(states["card"], kind)[..., :n, :],
                    getattr(states["cpu"], kind)[..., :n, :], POCKET_TOL["cache"]) for kind in ("k_cache", "v_cache")]
    log(f"pocket 15a voice prompt: {tokens.shape[2]} frames -> {n} steps in the caches on both; relative L2 "
        f"k {errs[0]:.3e} v {errs[1]:.3e} (bound {POCKET_TOL['cache']}); both prefills {time.perf_counter() - t0:.2f} s")

    cpu = _pocket_steps(host, states["cpu"])
    gpu = _pocket_steps(card, states["card"], feed=cpu["toks"])
    worst = {}
    for key in ("hidden", "text_logits", "dep_logits"):
        worst[key] = max(_rel_l2(f"pocket 15a step {s} {key}", g, w, POCKET_TOL[key])
                         for s, (g, w) in enumerate(zip(gpu[key], cpu[key])))
    cfg = host.lm_cfg
    dep_cpu, dep_gpu = torch.stack(cpu["dep_logits"]), torch.stack(gpu["dep_logits"])  # [S, n_q, card]
    top2 = torch.topk(dep_cpu, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > POCKET_MARGIN
    want = torch.stack(cpu["toks"])[:, 0]  # [S, n_q]
    got = dep_gpu.argmax(-1)
    if not torch.equal(got[decided], want[decided]):
        bad = (got != want) & decided
        raise AssertionError(f"pocket 15a: card tokens differ from the CPU's at {int(bad.sum())} decided decisions")
    log(f"pocket 15a generation, {POCKET_FRAMES} frames ({want.shape[0]} steps) teacher-forced on the CPU's tokens: "
        f"worst per-step relative L2 hidden {worst['hidden']:.3e} text logits {worst['text_logits']:.3e} depformer "
        f"logits {worst['dep_logits']:.3e} (bound 1e-4); card tokens = CPU at all {int(decided.sum())} of "
        f"{decided.numel()} decisions whose top-2 margin exceeds {POCKET_MARGIN}; least margin {float(margin.min()):.3e}, "
        f"{int((~decided).sum())} decisions under it ({int((got != want).sum())} differ)")

    delays = np.asarray(cfg.delays)
    toks = want.numpy()
    frames = np.stack([toks[d: d + POCKET_FRAMES, k] for k, d in enumerate(delays)])[None]  # [1, n_q, F]
    with inference():
        whole = Mi.mimi_decode(host.mimi_params, host.mimi_cfg, torch.from_numpy(frames))
    streamed = Mi.MimiStreamingDecoder(card.mimi_params, card.mimi_cfg, block_frames=2).feed(frames)
    rel = _rel_l2("pocket 15a streamed decode", streamed, whole, POCKET_TOL["pcm"])
    log(f"pocket 15a Mimi streaming decode on the card of the CPU's {POCKET_FRAMES} frames (blocks of 2) against the "
        f"CPU's whole decode: relative L2 {rel:.3e} (bound {POCKET_TOL['pcm']}), {streamed.shape[1]} samples, "
        f"max|pcm| {float(whole.abs().max()):.4g}")
    return states["card"]


def _pocket_timings(card, state) -> None:
    """15a 5: one sentence through ``generate_stream`` from the voice
    prompt (TTFA = the first 2-frame block), then five frames without the
    profiler and one under it."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from open_speech_tpu_torch.models.pocket import model as Mo
    from open_speech_tpu_torch.ops.vocoder import inference

    runs = []
    for _ in range(3):  # the first run also pays the card's one-time set-ups
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ttfa, blocks = None, []
        for blk in card.generate_stream(POCKET_TEXT, state):
            ttfa = ttfa if ttfa is not None else time.perf_counter() - t0
            blocks.append(blk)
        runs.append((ttfa, time.perf_counter() - t0, np.concatenate(blocks)))
    pcm = runs[-1][2]
    frames = len(POCKET_TEXT)
    if not np.isfinite(pcm).all() or pcm.size != frames * card.mimi_cfg.samples_per_frame:
        raise AssertionError(f"pocket 15a sentence: {pcm.size} samples, or not finite")
    if not all(np.array_equal(r[2], pcm) for r in runs):
        raise AssertionError("pocket 15a sentence: runs differ")
    audio_s = pcm.size / card.sample_rate
    log(f"pocket 15a one sentence ({len(POCKET_TEXT)} characters, {frames} frames, {audio_s:.3f} s of audio) from "
        f"the voice prompt: TTFA ms " + " ".join(f"{1e3 * r[0]:.3f}" for r in runs) + "; wall s "
        + " ".join(f"{r[1]:.4f}" for r in runs) + f"; ms per frame {1e3 * runs[-1][1] / frames:.3f}; RTFx "
        f"{audio_s / runs[-1][1]:.2f} (the last of 3 runs; Mimi decode included)")

    cfg, dev = card.lm_cfg, card.device
    with inference():
        caches, pos, text_pad = _pocket_prefill_text(card, state)
        audio_in = torch.full((1, cfg.n_q), cfg.audio_initial, dtype=torch.int64, device=dev)

        def frame(s):
            toks, _, _ = Mo._gen_step(card.lm_params, cfg, text_pad, text_pad, audio_in, caches,
                                      torch.full((1,), pos + s, dtype=torch.int64, device=dev))
            return toks.cpu()  # the loop's one readback per frame

        frame(0)
        plain = []  # frames without the profiler, whose own host cost would count as idle
        for s in range(1, 6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(s)
            plain.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            frame(6)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy <= 0:
        raise AssertionError("pocket 15a profile: no device time in the trace")
    n_launch = sum(e.count for e in kernels)
    plain_wall = sorted(plain)[len(plain) // 2]
    log(f"pocket 15a one frame (temporal step + 8-stage depformer + readback): unprofiled wall_ms median "
        f"{1e3 * plain_wall:.3f} of " + " ".join(f"{1e3 * t:.3f}" for t in plain) + f"; profiled wall_ms "
        f"{1e3 * wall:.3f} (profiler overhead included) device_busy_ms {1e3 * busy:.3f}; kernel launches {n_launch}; "
        f"idle_share against the unprofiled wall {1 - busy / plain_wall:.4f} (against the profiled "
        f"{1 - busy / wall:.4f}); host us per launch (unprofiled wall / launches) {1e6 * plain_wall / n_launch:.2f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")


def _pocket_texts(n: int) -> list[str]:
    words = SERVING_TEXT.replace(".", "").split()
    return [" ".join(words[i % 7: i % 7 + 3 + i % 4]) for i in range(n)]


class _PocketSolo:
    """Wraps ``depformer_sample`` of the model module: each step's tokens
    and per-stage logits of the runs made inside the block."""

    def __enter__(self):
        from open_speech_tpu_torch.models.pocket import model as Mo

        self.module, self.real, self.steps = Mo, Mo.depformer_sample, []

        def logged(params, cfg, h, text_tok, temp=0.0, generator=None):
            logits: list = []
            toks = self.real(params, cfg, h, text_tok, temp, generator, logits_out=logits)
            self.steps.append((toks, logits))
            return toks

        Mo.depformer_sample = logged
        return self

    def __exit__(self, *exc):
        self.module.depformer_sample = self.real


def _pocket_solo(card, text, state):
    """A solo run's PCM, frames [n_q, F] and per-decision margins [n_q, F]."""
    import numpy as np
    import torch

    with _PocketSolo() as rec:
        pcm = np.concatenate(list(card.generate_stream(text, state)))
    delays, n = card.lm_cfg.delays, max(4, len(text))
    toks = torch.stack([t[0] for t, _ in rec.steps]).cpu()  # [S, n_q]
    logits = torch.stack([torch.stack([lg[0] for lg in stages]) for _, stages in rec.steps])  # [S, n_q, card]
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()
    frames = np.stack([toks[d: d + n, k].numpy() for k, d in enumerate(delays)])
    margins = np.stack([margin[d: d + n, k].numpy() for k, d in enumerate(delays)])
    return pcm, frames, margins


def _pocket_batch_round(card, jobs, log_tokens: bool):
    """Every job queued before the scheduler starts (one wave); (per job:
    PCM, frames or None, TTFA s), wall s, peak bytes."""
    import queue
    import threading

    import numpy as np
    import torch

    from open_speech_tpu_torch.runtime import pocket_batcher as TB

    b = TB.PocketBatcher(card, slots=16, block_frames=2)
    b.precompile()
    blocks: dict = {}
    real = TB._mimi_group
    if log_tokens:
        def logged(mimi_params, cfg, tokens, state, reset_mask, decode_mask):
            for row in torch.nonzero(decode_mask).flatten().tolist():
                blocks.setdefault(id(b._slots[row].out), []).append(tokens[row].cpu().numpy())
            return real(mimi_params, cfg, tokens, state, reset_mask, decode_mask)

        TB._mimi_group = logged
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs = [queue.Queue() for _ in jobs]
        got: list = [None] * len(jobs)

        def drain(i):
            parts, first = [], None
            while (item := outs[i].get(timeout=600)) is not None:
                if isinstance(item, Exception):
                    got[i] = item
                    return
                first = first if first is not None else time.perf_counter()
                parts.append(item)
            got[i] = (np.concatenate(parts), first)

        threads = [threading.Thread(target=drain, args=(i,)) for i in range(len(jobs))]
        for th in threads:
            th.start()
        t0 = time.perf_counter()
        for (text, state), out in zip(jobs, outs):
            b._queue.put(TB._Job(text, state, out))
        b._ensure_thread()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        TB._mimi_group = real
        b.stop(wait=True)
    rows = []
    for job, out, res in zip(jobs, outs, got):
        if not isinstance(res, tuple):
            raise AssertionError(f"pocket 15b: a session failed: {res!r}")
        frames = np.concatenate(blocks[id(out)], axis=1)[:, : max(4, len(job[0]))] if log_tokens else None
        rows.append((res[0], frames, res[1] - t0))
    return rows, wall, peak, b.stats


def _pocket_batcher(card, state) -> None:
    """15b: 1, 4 and 16 sessions through one wave of the slot pool, every
    second one in the cloned voice; each row's frames and PCM against its
    solo run; then the host syncs of a full pool's groups."""
    import statistics

    import numpy as np

    texts = _pocket_texts(max(POCKET_ROWS))
    jobs = [(t, state if i % 2 else None) for i, t in enumerate(texts)]
    solo = [_pocket_solo(card, t, s) for t, s in jobs]
    for n in POCKET_ROWS:
        rows, _, _, _ = _pocket_batch_round(card, jobs[:n], log_tokens=True)
        flips, err = [], 0.0
        for i, ((pcm, frames, _), (want_pcm, want_frames, margins)) in enumerate(zip(rows, solo)):
            if frames.shape != want_frames.shape or pcm.shape != want_pcm.shape:
                raise AssertionError(f"pocket 15b {n} rows: row {i} {frames.shape} vs solo {want_frames.shape}")
            diff = np.argwhere(frames != want_frames)
            upto = pcm.size
            if diff.size:  # the first differing decision must be a near-tie of the solo run
                k, f = diff[np.argmin(diff[:, 1])]
                if margins[k, f] > POCKET_MARGIN:
                    raise AssertionError(f"pocket 15b {n} rows: row {i} frame {f} stage {k}: {frames[k, f]} vs solo "
                                         f"{want_frames[k, f]} at margin {margins[k, f]:.3e}")
                flips.append((i, int(f), float(margins[k, f])))
                upto = int(f) * card.mimi_cfg.samples_per_frame
            err = max(err, float(np.abs(pcm[:upto] - want_pcm[:upto]).max()) if upto else 0.0)
        if err > POCKET_TOL["row"]:
            raise AssertionError(f"pocket 15b {n} rows: max |row - solo| {err:.3e}")
        rows2, wall, peak, stats = _pocket_batch_round(card, jobs[:n], log_tokens=False)
        ttfa = [r[2] for r in rows2]
        audio_s = sum(r[0].size for r in rows2) / card.sample_rate
        log(f"pocket 15b {n} concurrent sessions ({sum(len(t) for t, _ in jobs[:n])} frames): frames = their solo "
            f"runs' ({len(flips)} near-tie flips {flips}), max |row - solo| {err:.3e}; TTFA s p50 "
            f"{statistics.median(ttfa):.4f} max {max(ttfa):.4f}; wall {wall:.4f} s for {audio_s:.2f} s of audio "
            f"(RTFx {audio_s / wall:.2f}); groups {stats['groups']}, peak live {stats['peak_live']}; peak card memory "
            f"{peak} bytes")
    _pocket_sync_probe(card, jobs)


def _pocket_sync_probe(card, jobs) -> None:
    """Four groups of a 16-session pool run on this thread under CUDA's sync
    debug mode: each may sync with the host once. As in phase 5's probe,
    garbage is collected first, under the mode, and its syncs reported
    apart (so is the mode's first switch in a process)."""
    import gc
    import queue

    import torch

    from open_speech_tpu_torch.ops.vocoder import inference
    from open_speech_tpu_torch.runtime import pocket_batcher as TB

    b = TB.PocketBatcher(card, slots=16, block_frames=2)
    try:
        with inference():
            b._install([TB._Job(t, s, queue.Queue()) for t, s in jobs], list(range(len(jobs))))
            torch.cuda.synchronize()
            in_gc = _count_syncs(gc.collect)
            syncs, times = [], []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                syncs.append(_count_syncs(b._run_group))
                times.append(time.perf_counter() - t0)
    finally:
        b.stop(wait=True)
    if any(len(s) > 1 for s in syncs):
        raise AssertionError(f"pocket 15b: pool groups synced at {syncs} (want at most 1 each)")
    log(f"pocket 15b sync probe: collecting garbage first synced {len(in_gc)} time(s) {in_gc}")
    log(f"pocket 15b sync probe: 4 groups of 16 live sessions, host syncs per group {[len(s) for s in syncs]} at "
        f"{sorted({x for s in syncs for x in s})}; group ms " + " ".join(f"{1e3 * t:.3f}" for t in times))


def _pocket_multipart(fields: dict, ref: bytes) -> tuple[bytes, dict]:
    """A multipart body: ``fields`` and ``ref`` as the ``reference_audio`` file."""
    import os

    boundary = "chipsmoke" + os.urandom(8).hex()
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="reference_audio"; filename="ref.wav"'
                 f"\r\nContent-Type: audio/wav\r\n\r\n".encode() + ref + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _pocket_served() -> None:
    """15c: pocket-tts at full width behind ``create_app`` on the card."""
    import base64
    import os

    import numpy as np

    from open_speech_tpu_torch.audio.postprocessing import StreamingPostProcessor, process_tts_chunks
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.pocket import PocketLMConfig
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter
    from open_speech_tpu_torch.tts.router import TTSRouter

    saved_env = os.environ.get("OS_POCKET_PRESET")
    os.environ["OS_POCKET_PRESET"] = "base"
    baseline = _card_bytes()
    tts = TTSRouter()  # the card
    model = "pocket-tts"
    ref = codec.write_wav(_speechlike(3.0, 61, 16000), 16000)
    kw = dict(trim=settings.tts_trim_silence, normalize=settings.tts_normalize_output)
    try:
        with _Served(BackendRouter(device="cuda:0"), tts) as served:
            port = served.port
            t0 = time.perf_counter()
            loaded = _json_call(port, "POST", f"/api/models/{model}/load", 200)
            load_s, held = time.perf_counter() - t0, _card_bytes() - baseline
            backend = tts.get_backend(model)
            if loaded.get("state") != "loaded" or backend._model.device.type != "cuda" \
                    or backend._model.lm_cfg != PocketLMConfig():
                raise AssertionError(f"pocket 15c load: {loaded}, {backend._model.device}")
            log(f"pocket 15c POST /api/models/{model}/load (OS_POCKET_PRESET=base, random weights, warmup "
                f"included): {loaded['state']} on {loaded.get('device')} in {load_s:.3f} s, {held} bytes on the card")

            def direct(streamed: bool, **extra) -> np.ndarray:
                chunks = backend.synthesize(POCKET_TEXT, extra.pop("voice", "pocket/alice"), **extra)
                if not streamed:
                    return np.concatenate(list(process_tts_chunks(chunks, **kw)))
                pp = StreamingPostProcessor(**kw)
                return np.concatenate([p for c in chunks for p in pp.feed(c)] + list(pp.finish()))

            cases = [("speaker", {"voice": "pocket/alice"}, {"voice": "pocket/alice"}),
                     ("clone", {"reference_audio": base64.b64encode(ref).decode()}, {"reference_audio": ref}),
                     ("design", {"voice_design": "a warm narrator"}, {"voice_design": "a warm narrator"})]
            for name, fields, extra in cases:
                body = {"model": model, "input": POCKET_TEXT, **fields}
                t0 = time.perf_counter()
                status, _, wav = _http(port, "POST", "/v1/audio/speech",
                                       json.dumps({**body, "response_format": "wav"}).encode(),
                                       {"Content-Type": "application/json"})
                wall = time.perf_counter() - t0
                if status != 200:
                    raise AssertionError(f"pocket 15c speech {name}: {status} {wav[:300]!r}")
                got, rate = codec.read_wav(wav)
                want = direct(False, **dict(extra))
                if rate != 24000 or not np.array_equal(got, codec.pcm16_to_float(codec.float_to_pcm16(want))):
                    raise AssertionError(f"pocket 15c speech {name}: {rate} Hz, {got.shape} vs direct {want.shape}")
                ttfa, pcm = _pocket_streamed(port, body)
                want_streamed = direct(True, **dict(extra))
                if pcm != codec.float_to_pcm16(want_streamed):
                    raise AssertionError(f"pocket 15c streamed {name}: {len(pcm)} bytes vs {2 * want_streamed.size}")
                log(f"pocket 15c POST /v1/audio/speech {name}: WAV {got.size / rate:.3f} s = the direct backend call's "
                    f"samples, wall {wall:.4f} s; streamed PCM = the direct call's bytes, TTFA {1e3 * ttfa:.3f} ms")
            _pocket_served_batched(port, backend, direct, want_solo=direct(False))
            payload, headers = _pocket_multipart(
                {"input": POCKET_TEXT, "model": model, "response_format": "wav", "transcript": "a tone"}, ref)
            t0 = time.perf_counter()
            status, _, wav = _http(port, "POST", "/v1/audio/speech/clone", payload, headers)
            wall = time.perf_counter() - t0
            want = direct(False, voice="Ryan", reference_audio=ref, clone_transcript="a tone")
            if status != 200 or not np.array_equal(codec.read_wav(wav)[0],
                                                   codec.pcm16_to_float(codec.float_to_pcm16(want))):
                raise AssertionError(f"pocket 15c clone route: {status} {wav[:200]!r}")
            log(f"pocket 15c POST /v1/audio/speech/clone (multipart, 16 kHz reference): 200, WAV = the direct call's "
                f"samples, wall {wall:.4f} s")
            _pocket_listings(served, tts, backend)
            t0 = time.perf_counter()
            done = _json_call(port, "DELETE", f"/api/models/{model}", 200)
            after = _card_bytes() - baseline
            if done.get("status") != "unloaded" or after > FREED_SLACK:
                raise AssertionError(f"pocket 15c unload: {done}, {after} bytes over the baseline")
            log(f"pocket 15c DELETE /api/models/{model}: unloaded in {time.perf_counter() - t0:.3f} s, {after} bytes "
                f"over the phase's baseline (bound {FREED_SLACK})")
    finally:
        if saved_env is None:
            os.environ.pop("OS_POCKET_PRESET", None)
        else:
            os.environ["OS_POCKET_PRESET"] = saved_env
        for m in [m.model for m in tts.loaded_models()]:
            tts.unload_model(m)


def _pocket_served_batched(port: int, backend, direct, want_solo) -> None:
    """15c: one speaker request with ``OS_TTS_BATCHER_ENABLED`` on, so the
    served path runs the backend's slot-pool batcher at full width; its
    body equals the direct call's through the batcher, whole and streamed,
    and is within ``POCKET_TOL["row"]`` of the solo generation's."""
    import numpy as np

    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.pocket_batcher import pocket_batcher_stats

    body = {"model": "pocket-tts", "input": POCKET_TEXT, "voice": "pocket/alice"}
    saved = settings.os_tts_batcher_enabled
    settings.os_tts_batcher_enabled = True
    try:
        t0 = time.perf_counter()
        status, _, wav = _http(port, "POST", "/v1/audio/speech", json.dumps({**body, "response_format": "wav"}).encode(),
                               {"Content-Type": "application/json"})
        wall = time.perf_counter() - t0
        if status != 200:
            raise AssertionError(f"pocket 15c batched speech: {status} {wav[:300]!r}")
        ttfa, pcm = _pocket_streamed(port, body)
        want, want_streamed = direct(False), direct(True)
        stats = pocket_batcher_stats()
    finally:
        settings.os_tts_batcher_enabled = saved
    got, rate = codec.read_wav(wav)
    if rate != 24000 or not np.array_equal(got, codec.pcm16_to_float(codec.float_to_pcm16(want))):
        raise AssertionError(f"pocket 15c batched speech: {rate} Hz, {got.shape} vs direct {want.shape}")
    if pcm != codec.float_to_pcm16(want_streamed):
        raise AssertionError(f"pocket 15c batched streamed: {len(pcm)} bytes vs {2 * want_streamed.size}")
    err = float(np.abs(want - want_solo).max()) if want.shape == want_solo.shape else float("inf")
    if err > POCKET_TOL["row"]:
        raise AssertionError(f"pocket 15c batched: {want.shape} vs solo {want_solo.shape}, max |batched - solo| {err:.3e}")
    jobs = sum(st["jobs"] for st in stats.values())
    if jobs < 4:  # the two served and the two direct requests
        raise AssertionError(f"pocket 15c batched: the batcher counted {stats}")
    log(f"pocket 15c POST /v1/audio/speech speaker with OS_TTS_BATCHER_ENABLED on: WAV and streamed PCM = the direct "
        f"call's through the batcher, max |batched - solo| {err:.3e} (bound {POCKET_TOL['row']}); wall {wall:.4f} s, "
        f"streamed TTFA {1e3 * ttfa:.3f} ms; batcher {stats}")


def _pocket_streamed(port: int, body: dict) -> tuple[float, bytes]:
    """A streamed PCM speech request: (seconds to the first chunk, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/audio/speech?stream=true", body=json.dumps({**body, "response_format": "pcm"}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"pocket 15c streamed speech: {resp.status} {resp.read()[:300]!r}")
        first = resp.read1(65536)
        return time.perf_counter() - t0, first + resp.read()
    finally:
        conn.close()


def _pocket_listings(served, tts, backend) -> None:
    """The capabilities route, the voices route and Wyoming describe list
    Pocket as the JAX app does: its capabilities and its 8 speakers."""
    from open_speech_tpu_torch.server.wyoming.server import start_wyoming_server

    port = served.port
    speakers = ["alice", "bob", "carol", "dave", "eve", "frank", "grace", "henry"]
    caps = _json_call(port, "GET", "/api/tts/capabilities?model=pocket-tts", 200)
    voices = _json_call(port, "GET", "/v1/audio/voices?model=pocket-tts", 200)["voices"]
    want_caps = {**backend.capabilities}
    if caps != {"backend": "pocket-tts", "capabilities": want_caps} or not want_caps["voice_clone"] \
            or [v["id"] for v in voices] != [f"pocket/{s}" for s in speakers]:
        raise AssertionError(f"pocket 15c listings: {caps}, {voices}")
    server = served._run(start_wyoming_server(served.app["stt_router"], tts, host="127.0.0.1", port=0))
    try:
        client = _WyomingClient(server.sockets[0].getsockname()[1])
        client.send("describe")
        ((_, info, _),) = client.until("info")
        client.close()
    finally:
        served._run(_closed(server))
    names = [v["name"] for v in info["tts"][0]["voices"]]
    if [n for n in names if n.startswith("pocket/")] != [f"pocket/{s}" for s in speakers]:
        raise AssertionError(f"pocket 15c wyoming describe: {names}")
    log(f"pocket 15c /api/tts/capabilities: pocket-tts, voice_clone and voice_design on; /v1/audio/voices and Wyoming "
        f"describe list the 8 pocket/ speakers ({len(names)} voices in all)")



# ── phase 16: speaker diarization ───────────────────────────────────────

DIARIZE_SEED = 17  # the released-layout checkpoints' weights, GE2E's, the recordings
DIARIZE_SECONDS = (60.0, 600.0)  # 16b's recordings; 16a's whole diarizations run the first
SERVED_DIARIZE_SECONDS = 20.0  # 16c's upload
DIARIZE_WINDOWS = 16  # 16a's 1.5 s windows for the embedders
DIARIZE_VARS = ("OS_SEGMENTATION_CKPT_PATH", "OS_WESPEAKER_CKPT_PATH", "OS_DIARIZER_CKPT_PATH")
# 16a card against CPU (float32, TF32 off on both), relative L2
DIARIZE_TOL = {"logp": 1e-4, "fbank": 1e-4, "wespeaker": 1e-4, "ge2e_mel": 1e-4, "ge2e": 1e-4,
               "conv": 1e-4, "embeddings": 1e-4}
# a powerset decision must agree where the CPU's top-2 log-prob gap exceeds this
DIARIZE_MARGIN = 1e-3


def _meeting(seconds: float, seed: int):
    """Three synthetic speakers (harmonic stacks at 115, 185 and 265 Hz with
    vibrato and a syllable gate) taking turns of 2-8 s with short gaps;
    every fourth turn overlaps the next by 1-2 s. (float32 16 kHz audio,
    the reference turns)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    ref, pos, spk, k = [], 0.0, 0, 0
    while pos < seconds - 0.5:
        end = min(seconds, pos + rng.uniform(2.0, 8.0))
        ref.append({"speaker": "ABC"[spk], "start": round(pos, 3), "end": round(end, 3)})
        spk = (spk + int(rng.integers(1, 3))) % 3
        pos = end - (rng.uniform(1.0, 2.0) if k % 4 == 3 else -rng.uniform(0.0, 0.3))
        k += 1
    audio = 0.005 * rng.standard_normal(n)
    for turn in ref:
        a, b = int(turn["start"] * SR), int(turn["end"] * SR)
        i = "ABC".index(turn["speaker"])
        t = np.arange(a, b) / SR
        f0 = (115.0, 185.0, 265.0)[i] * (1 + 0.03 * np.sin(2 * np.pi * (0.4 + 0.1 * i) * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        gate = 0.6 + 0.4 * (np.sin(2 * np.pi * (3.0 + i) * t) > -0.3)
        audio[a:b] += 0.15 * gate * sum(np.sin(h * phase) / h for h in (1, 2, 3, 4))
    return audio.astype(np.float32), ref


def _diarize_checkpoints(tmp: str) -> tuple[str, str]:
    """Full-size random weights (seed ``DIARIZE_SEED``) in the released key
    layouts: PyanNet as pyannote/segmentation-3.0 ships it (a Lightning
    checkpoint's ``state_dict``) and WeSpeaker ResNet34 as
    wespeaker-voxceleb-resnet34-LM (BatchNorm running statistics moved off
    identity, so the folding is exercised)."""
    import os

    import torch

    from open_speech_tpu_torch.models.segmentation import SegmentationConfig, _default_sinc_init
    from open_speech_tpu_torch.models.wespeaker import WeSpeakerConfig

    gen = torch.Generator().manual_seed(DIARIZE_SEED)

    def normal(*shape, std: float):
        return torch.randn(shape, generator=gen) * std

    cfg = SegmentationConfig()
    h, pairs = cfg.lstm_hidden, cfg.n_sinc // 2
    low, band = _default_sinc_init(pairs)
    seg = {"sincnet.wav_norm1d.weight": torch.ones(1), "sincnet.wav_norm1d.bias": torch.zeros(1),
           "sincnet.conv1d.0.filterbank.low_hz_": torch.tensor(low, dtype=torch.float32) + normal(pairs, 1, std=5.0),
           "sincnet.conv1d.0.filterbank.band_hz_": torch.tensor(band, dtype=torch.float32) + normal(pairs, 1, std=5.0)}
    for i, c_in in ((1, cfg.n_sinc), (2, cfg.conv_hidden)):
        seg[f"sincnet.conv1d.{i}.weight"] = normal(cfg.conv_hidden, c_in, 5, std=(5 * c_in) ** -0.5)
        seg[f"sincnet.conv1d.{i}.bias"] = normal(cfg.conv_hidden, std=0.05)
    for i, c in enumerate((cfg.n_sinc, cfg.conv_hidden, cfg.conv_hidden)):
        seg[f"sincnet.norm1d.{i}.weight"] = 1 + normal(c, std=0.1)
        seg[f"sincnet.norm1d.{i}.bias"] = normal(c, std=0.1)
    for k in range(cfg.lstm_layers):
        d_in = cfg.conv_hidden if k == 0 else 2 * h
        for sfx in (f"l{k}", f"l{k}_reverse"):
            seg[f"lstm.weight_ih_{sfx}"] = normal(4 * h, d_in, std=d_in**-0.5)
            seg[f"lstm.weight_hh_{sfx}"] = normal(4 * h, h, std=h**-0.5)
            seg[f"lstm.bias_ih_{sfx}"] = normal(4 * h, std=0.05)
            seg[f"lstm.bias_hh_{sfx}"] = normal(4 * h, std=0.05)
    for name, (d_out, d_in) in (("linear.0", (cfg.linear_hidden, 2 * h)),
                                ("linear.1", (cfg.linear_hidden, cfg.linear_hidden)),
                                ("classifier", (cfg.n_classes, cfg.linear_hidden))):
        seg[f"{name}.weight"] = normal(d_out, d_in, std=d_in**-0.5)
        seg[f"{name}.bias"] = normal(d_out, std=0.05)
    seg_path = os.path.join(tmp, "segmentation-3.0.bin")
    torch.save({"state_dict": seg, "hyper_parameters": {"sample_rate": SR}}, seg_path)

    wcfg = WeSpeakerConfig()
    ws = {}

    def bn(prefix: str, c: int) -> None:
        ws[f"{prefix}.weight"], ws[f"{prefix}.bias"] = 1 + normal(c, std=0.1), normal(c, std=0.1)
        ws[f"{prefix}.running_mean"] = normal(c, std=0.1)
        ws[f"{prefix}.running_var"] = 1 + 0.2 * torch.rand(c, generator=gen)
        ws[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    m = wcfg.m_channels
    ws["conv1.weight"] = normal(m, 1, 3, 3, std=9**-0.5)
    bn("bn1", m)
    for li, n_blocks in enumerate(wcfg.num_blocks):
        cout = m << li
        for bi in range(n_blocks):
            cin = (m if li == 0 else cout // 2) if bi == 0 else cout
            p = f"layer{li + 1}.{bi}"
            ws[f"{p}.conv1.weight"] = normal(cout, cin, 3, 3, std=(9 * cin) ** -0.5)
            bn(f"{p}.bn1", cout)
            ws[f"{p}.conv2.weight"] = normal(cout, cout, 3, 3, std=(9 * cout) ** -0.5)
            bn(f"{p}.bn2", cout)
            if bi == 0 and li > 0:
                ws[f"{p}.shortcut.0.weight"] = normal(cout, cin, 1, 1, std=cin**-0.5)
                bn(f"{p}.shortcut.1", cout)
    ws["seg_1.weight"] = normal(wcfg.embed_dim, wcfg.stats_dim, std=wcfg.stats_dim**-0.5)
    ws["seg_1.bias"] = torch.zeros(wcfg.embed_dim)
    ws_path = os.path.join(tmp, "wespeaker-resnet34.bin")
    torch.save(ws, ws_path)
    return seg_path, ws_path


def _diarizers():
    """(card, host) segmented diarizers converted from the released-layout
    checkpoints through ``OS_SEGMENTATION_CKPT_PATH`` and
    ``OS_WESPEAKER_CKPT_PATH``, and (card, host) energy-gated ones (no
    checkpoint: the conv embedder, seed 23)."""
    import os
    import tempfile

    import torch

    from open_speech_tpu_torch.models.diarize import DiarizerConfig, TorchDiarizer
    from open_speech_tpu_torch.models.segmentation import SegmentationConfig
    from open_speech_tpu_torch.models.wespeaker import WeSpeakerConfig

    saved = {v: os.environ.pop(v, None) for v in DIARIZE_VARS}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            seg_path, ws_path = _diarize_checkpoints(tmp)
            os.environ["OS_SEGMENTATION_CKPT_PATH"], os.environ["OS_WESPEAKER_CKPT_PATH"] = seg_path, ws_path
            t0 = time.perf_counter()
            card = TorchDiarizer(device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            host = TorchDiarizer(device="cpu")
        for v in DIARIZE_VARS[:2]:
            del os.environ[v]
        plain_card, plain_host = TorchDiarizer(device="cuda"), TorchDiarizer(device="cpu")
    finally:
        for v, value in saved.items():
            if value is not None:
                os.environ[v] = value
    for d in (card, host):  # a failed conversion must not fall back quietly
        if d.seg is None or d.wespeaker is None or d.seg[1] != SegmentationConfig() \
                or d.wespeaker[1] != WeSpeakerConfig():
            raise AssertionError(f"diarize 16: the checkpoints did not convert at full width on {d.device}")
    if card.seg[0].device.type != "cuda" or card.wespeaker[0].seg.weight.device.type != "cuda":
        raise AssertionError("diarize 16: the converted models are not on the card")
    for d in (plain_card, plain_host):
        if d.seg is not None or d.wespeaker is not None or d.ge2e is not None or d.cfg != DiarizerConfig():
            raise AssertionError("diarize 16: the energy-gated diarizer found a checkpoint")
    count = lambda m: sum(t.numel() for k, t in m.state_dict().items() if ".bias_hh_" not in k)  # noqa: E731
    log(f"diarize 16: released-layout checkpoints (random, seed {DIARIZE_SEED}) converted on the card in "
        f"{load_s:.3f} s: PyanNet segmentation-3.0 ({count(card.seg[0])} tensors' elements: sinc 80 x 251, "
        f"4 BiLSTM x 128) and WeSpeaker ResNet34 (m_channels 32, blocks 3/4/6/3, {count(card.wespeaker[0])} "
        f"elements with the BatchNorms folded); conv embedder {count(plain_card.params)} elements (seed 23); "
        f"float32, TF32 off")
    return card, host, plain_card, plain_host


def phase_diarize(router) -> dict:
    """16: speaker diarization (``models/{segmentation,wespeaker,ge2e,
    diarize}.py``, ``diarization.py``) at full width on the card. 16a card
    against CPU: segmentation log-probs of a 60 s recording's 10 s chunks
    (relative L2, least argmax margin, decisions), kaldi fbank and WeSpeaker
    embeddings of 16 windows, GE2E's mels and embeddings, the conv
    embedder, then the whole segmented and energy-gated diarizations of the
    60 s (turns equal). 16b on the card for 60 s and 10 min: wall and RTFx
    of both pipelines, ms per segmentation call and per embed dispatch,
    host ms of gathering and clustering, peak memory; a segmentation batch
    of 8 chunks and a 512-window dispatch alone; one segmentation batch
    under torch.profiler. Fails if a flash kernel is launched in 16a-16b.
    16c ``POST /v1/audio/transcriptions?diarize=true`` on phase 4's router
    through ``create_app``, with the segmented and then the energy-gated
    diarizer shared: each body equals the direct transcription plus
    ``Diarizer().diarize`` and ``attach_text_to_speakers``, K1 launches equal
    the plain transcription's, and with the setting off the route answers
    400. Returns 16c's launches."""
    import gc

    from open_speech_tpu_torch.ops import attention as A

    before = dict(A.launches)
    card, host, plain_card, plain_host = _diarizers()
    _diarize_stages(card, host, plain_card, plain_host)
    _diarize_whole(card, host, plain_card, plain_host)
    del host, plain_host
    gc.collect()
    _diarize_speed(card, plain_card)
    if dict(A.launches) != before:
        raise AssertionError(f"diarize 16: flash launches moved: {before} -> {dict(A.launches)}")
    log(f"diarize 16: flash launch counts unchanged through 16a and 16b: {before}")
    return _diarize_served(router, card, plain_card)


def _diarize_windows(audio, n: int):
    """The first ``n`` 1.5 s windows, 0.75 s apart, as [n, 24000]."""
    import numpy as np

    from open_speech_tpu_torch.models.diarize import HOP_S, WINDOW_S

    win, hop = int(WINDOW_S * SR), int(HOP_S * SR)
    return np.stack([audio[i * hop : i * hop + win] for i in range(n)])


def _diarize_stages(card, host, plain_card, plain_host) -> None:
    """16a, stage by stage: each card stage on the same inputs as the CPU's."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models import diarize as D
    from open_speech_tpu_torch.models import ge2e as G
    from open_speech_tpu_torch.models import wespeaker as W
    from open_speech_tpu_torch.models.segmentation import CHUNK_SAMPLES
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram

    audio, _ = _meeting(DIARIZE_SECONDS[0], DIARIZE_SEED)
    chunks = np.stack([audio[s : s + CHUNK_SAMPLES]
                       for s in range(0, len(audio) - CHUNK_SAMPLES + 1, CHUNK_SAMPLES // 2)])
    want, got = host._segment(chunks), card._segment(chunks)
    rel = _rel_l2("diarize 16a segmentation log-probs", got, want, DIARIZE_TOL["logp"])
    top = np.sort(want, axis=-1)
    margin = top[..., -1] - top[..., -2]
    decided = margin > DIARIZE_MARGIN
    flips = int((got.argmax(-1) != want.argmax(-1))[decided].sum())
    if flips:
        raise AssertionError(f"diarize 16a segmentation: {flips} decided powerset frames differ")
    classes = np.bincount(want.argmax(-1).ravel(), minlength=want.shape[-1]).tolist()
    log(f"diarize 16a segmentation {len(chunks)} x 10 s chunks -> {list(want.shape)} log-probs: relative L2 "
        f"{rel:.3e} (bound {DIARIZE_TOL['logp']}), max |diff| {np.abs(got - want).max():.3e}; least CPU top-2 "
        f"margin {margin.min():.3e}, {int((~decided).sum())} of {margin.size} frames within {DIARIZE_MARGIN}, "
        f"every other decision equal; CPU classes per frame {classes}")

    windows = _diarize_windows(audio, DIARIZE_WINDOWS)
    x_host = torch.from_numpy(windows)
    x_card = x_host.cuda()
    fb_host, fb_card = W.kaldi_fbank(x_host), W.kaldi_fbank(x_card)
    rels = {"fbank": _rel_l2("diarize 16a kaldi fbank", fb_card, fb_host, DIARIZE_TOL["fbank"])}
    rels["wespeaker"] = _rel_l2("diarize 16a WeSpeaker embeddings", W.wespeaker_embed(card.wespeaker[0], fb_card),
                                W.wespeaker_embed(host.wespeaker[0], fb_host), DIARIZE_TOL["wespeaker"])
    g_host = G.init_ge2e_params(torch.Generator().manual_seed(DIARIZE_SEED), device="cpu")
    g_card = G.init_ge2e_params(torch.Generator().manual_seed(DIARIZE_SEED), device="cuda")
    mel_host, mel_card = G.ge2e_mel(x_host), G.ge2e_mel(x_card)
    rels["ge2e_mel"] = _rel_l2("diarize 16a GE2E mels", mel_card, mel_host, DIARIZE_TOL["ge2e_mel"])
    rels["ge2e"] = _rel_l2("diarize 16a GE2E embeddings", G.ge2e_embed(g_card, mel_card),
                           G.ge2e_embed(g_host, mel_host), DIARIZE_TOL["ge2e"])
    lm_host = log_mel_spectrogram(x_host, n_mels=plain_host.cfg.n_mels)[..., :150]
    lm_card = log_mel_spectrogram(x_card, n_mels=plain_card.cfg.n_mels)[..., :150]
    rels["conv"] = _rel_l2("diarize 16a conv embedder", D.embed_windows(plain_card.params, lm_card),
                           D.embed_windows(plain_host.params, lm_host), DIARIZE_TOL["conv"])
    log(f"diarize 16a {DIARIZE_WINDOWS} windows of 1.5 s, card against CPU, relative L2: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
        + f" (bound 1e-4 each; WeSpeaker 256-d, GE2E 3 x LSTM 256 full width, seed {DIARIZE_SEED})")


def _capture_embeddings(d, into: list) -> None:
    """Keep each ``_embed_bucketed`` result of diarizer ``d`` in ``into``."""
    real = d._embed_bucketed

    def embed(flat):
        out = real(flat)
        into.append(out)
        return out

    d._embed_bucketed = embed


def _diarize_whole(card, host, plain_card, plain_host) -> None:
    """16a, whole: both pipelines on the 60 s recording, turns equal. Where
    a powerset frame within ``DIARIZE_MARGIN`` decides differently on the
    card (16a's stage check holds every other frame equal), the card runs
    again on the CPU's log-probs and must then give the CPU's turns."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.diarize import diarization_error_rate

    audio, ref = _meeting(DIARIZE_SECONDS[0], DIARIZE_SEED)
    embs: dict = {}
    _capture_embeddings(host, embs.setdefault("cpu", []))
    _capture_embeddings(plain_host, embs.setdefault("cpu-plain", []))
    try:
        t0 = time.perf_counter()
        wants = {"segmented": host.diarize_audio(audio)}
        cpu_s = {"segmented": time.perf_counter() - t0}
        t0 = time.perf_counter()
        wants["energy-gated"] = plain_host.diarize_audio(audio)
        cpu_s["energy-gated"] = time.perf_counter() - t0
    finally:
        del host._embed_bucketed, plain_host._embed_bucketed
    for name, c, cpu_key in (("segmented", card, "cpu"), ("energy-gated", plain_card, "cpu-plain")):
        want, note = wants[name], ""
        card_embs: list = []
        _capture_embeddings(c, card_embs)
        try:
            t0 = time.perf_counter()
            got = c.diarize_audio(audio)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            if got != want and name == "segmented":
                note = (f"; the card's own log-probs gave {len(got)} turns (DER to the CPU's "
                        f"{diarization_error_rate(want, got):.4f}) through frames within {DIARIZE_MARGIN}, and on "
                        f"the CPU's log-probs its turns are the CPU's")
                card_embs.clear()
                c._segment = host._segment
                got = c.diarize_audio(audio)
        finally:
            c.__dict__.pop("_segment", None)
            del c._embed_bucketed
        if got != want or not want:
            raise AssertionError(f"diarize 16a {name}: card turns {got} vs CPU {want}")
        rel = _rel_l2(f"diarize 16a {name} embeddings", np.concatenate(card_embs),
                      np.concatenate(embs[cpu_key]), DIARIZE_TOL["embeddings"])
        log(f"diarize 16a {name} {DIARIZE_SECONDS[0]:.0f} s (three synthetic speakers, {len(ref)} reference turns "
            f"with overlaps): {len(got)} turns of {len({t['speaker'] for t in got})} speakers, equal to the CPU's"
            f"{note}; {len(card_embs[0])} windows embedded, relative L2 {rel:.3e}; DER against the script's "
            f"reference {diarization_error_rate(ref, got):.4f} (random weights); wall card {card_s:.3f} s, CPU "
            f"{cpu_s[name]:.3f} s")


def _median_s(fn, repeats: int = 5) -> float:
    """Median wall of ``fn()`` (which reads its result back, so it ends
    synchronised) after one warm call."""
    import statistics

    fn()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def _wespeaker_flops(cfg, frames: int) -> float:
    """Multiply-adds x 2 of one window through the ResNet (convolutions,
    shortcuts and the embedding layer), from the shapes."""
    f, t, c_in, total = cfg.n_mels, frames, 1, 0
    total += 9 * c_in * cfg.m_channels * f * t
    c_in = cfg.m_channels
    for li, n_blocks in enumerate(cfg.num_blocks):
        cout = cfg.m_channels << li
        for bi in range(n_blocks):
            if bi == 0 and li > 0:
                f, t = (f + 1) // 2, (t + 1) // 2
                total += c_in * cout * f * t  # the 1x1 shortcut
            total += 9 * (c_in if bi == 0 else cout) * cout * f * t + 9 * cout * cout * f * t
        c_in = cout
    return 2.0 * (total + cfg.stats_dim * cfg.embed_dim)


def _segmentation_flops(cfg, n_samples: int) -> float:
    """Multiply-adds x 2 of one chunk (sinc and Conv1d stages, the BiLSTM,
    the linears), from the shapes."""
    t0 = (n_samples - cfg.sinc_kernel) // cfg.sinc_stride + 1
    t1 = (t0 - 3) // 3 + 1 - 4
    t2 = (t1 - 3) // 3 + 1 - 4
    t = (t2 - 3) // 3 + 1
    h = cfg.lstm_hidden
    total = t0 * cfg.n_sinc * cfg.sinc_kernel + t1 * cfg.conv_hidden * cfg.n_sinc * 5 \
        + t2 * cfg.conv_hidden * cfg.conv_hidden * 5
    for k in range(cfg.lstm_layers):
        d_in = cfg.conv_hidden if k == 0 else 2 * h
        total += 2 * t * 4 * h * (d_in + h)
    total += t * (2 * h * cfg.linear_hidden + cfg.linear_hidden ** 2 + cfg.linear_hidden * cfg.n_classes)
    return 2.0 * total


def _diarize_speed(card, plain_card) -> None:
    """16b: both pipelines on 60 s and 10 min recordings, the steady costs
    of one segmentation batch and one 512-window dispatch, and a profiled
    segmentation batch."""
    import numpy as np
    import torch

    from open_speech_tpu_torch.models.diarize import EMBED_ROWS, SEG_BATCH
    from open_speech_tpu_torch.models.segmentation import CHUNK_SAMPLES

    dev = torch.cuda.get_device_name(0)
    for seconds in DIARIZE_SECONDS:
        audio, ref = _meeting(seconds, DIARIZE_SEED + 1)
        for name, d in (("segmented", card), ("energy-gated", plain_card)):
            spans = {"_segment": [], "_embed": []}
            for attr, into in spans.items():
                real = getattr(d, attr)

                def timed(arg, real=real, into=into):
                    t0 = time.perf_counter()
                    out = real(arg)  # numpy: read back, so synchronised
                    into.append((time.perf_counter() - t0, len(arg)))
                    return out

                setattr(d, attr, timed)
            try:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                turns = d.diarize_audio(audio)
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
            finally:
                for attr in spans:
                    delattr(d, attr)
            seg_s = sum(s for s, _ in spans["_segment"])
            emb_s = sum(s for s, _ in spans["_embed"])
            n_chunks = sum(n for _, n in spans["_segment"])
            seg_part = (f"{n_chunks} chunks in {-(-n_chunks // SEG_BATCH)} segmentation batches "
                        f"({1e3 * seg_s:.1f} ms), " if spans["_segment"] else "")
            log(f"diarize 16b {name} {seconds:.0f} s on {dev}: wall {wall:.4f} s, RTFx {seconds / wall:.1f}; "
                f"{seg_part}{sum(n for _, n in spans['_embed'])} windows in {len(spans['_embed'])} embed dispatches "
                f"({1e3 * emb_s:.1f} ms); host gathering + clustering {1e3 * (wall - seg_s - emb_s):.1f} ms; "
                f"{len(turns)} turns of {len({t['speaker'] for t in turns})} speakers ({len(ref)} reference "
                f"turns); peak card memory {peak / 2**20:.1f} MiB over the {base / 2**20:.1f} MiB held")

    audio, _ = _meeting(DIARIZE_SECONDS[0], DIARIZE_SEED)
    chunks = np.stack([audio[s : s + CHUNK_SAMPLES] for s in range(0, SEG_BATCH * 80000, 80000)])
    windows = np.resize(_diarize_windows(audio, 64), (EMBED_ROWS, 24000))
    seg_cfg, ws_cfg = card.seg[1], card.wespeaker[1]
    seg_ms = 1e3 * _median_s(lambda: card._segment(chunks))
    emb_ms = 1e3 * _median_s(lambda: card._embed(windows))
    seg_tf = SEG_BATCH * _segmentation_flops(seg_cfg, CHUNK_SAMPLES) / 1e12
    emb_tf = EMBED_ROWS * _wespeaker_flops(ws_cfg, 148) / 1e12
    log(f"diarize 16b steady on {dev}: a segmentation batch of {SEG_BATCH} x 10 s chunks {seg_ms:.3f} ms "
        f"({seg_tf:.4f} TFLOP, {seg_tf / seg_ms * 1e3:.2f} TFLOP/s; f32 bound {seg_tf / H100_F32_FLOPS * 1e15:.3f} ms), "
        f"a {EMBED_ROWS}-window WeSpeaker dispatch {emb_ms:.3f} ms ({emb_tf:.3f} TFLOP, "
        f"{emb_tf / emb_ms * 1e3:.2f} TFLOP/s; f32 bound {emb_tf / H100_F32_FLOPS * 1e15:.3f} ms); both read back "
        f"to the host")
    _diarize_profile(card, chunks)


def _diarize_profile(card, chunks) -> None:
    """One segmentation batch under torch.profiler: launches, idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card._segment(chunks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card._segment(chunks)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy <= 0:
        raise AssertionError("diarize 16b profile: no device time in the trace")
    log(f"diarize 16b profiled segmentation batch ({len(chunks)} chunks): wall_s {wall:.4f} device_busy_s "
        f"{busy:.4f} idle_share {1 - busy / wall:.4f} kernel launches {sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  {e.key[:90]}")


def _diarize_served(router, card, plain_card) -> dict:
    """16c: a diarized transcription through ``create_app`` against the
    direct calls, with the segmented diarizer shared and then the
    energy-gated one; the route's 400 with the setting off."""
    import torch

    from open_speech_tpu_torch import diarization as TDS
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import prepare_upload, transcription_response
    from open_speech_tpu_torch.tts.router import TTSRouter

    audio, _ = _meeting(SERVED_DIARIZE_SECONDS, DIARIZE_SEED + 2)
    wav = codec.write_wav(audio, SR)
    body, headers = _multipart({"model": MAIN_MODEL}, wav)
    route = "/v1/audio/transcriptions?diarize=true"
    entry = router.get_backend(MAIN_MODEL)._ensure_model(MAIN_MODEL)
    real_tok, saved = entry["tok"], (TDS._shared, settings.stt_diarize_enabled)
    entry["tok"] = _WordTokenizer(real_tok)  # the words that attach_text_to_speakers spreads
    settings.stt_diarize_enabled = True
    lines, launches = [], {}
    try:
        with _Served(router, TTSRouter()) as served:
            for key in A.launches:
                A.launches[key] = 0
            t0 = time.perf_counter()
            text = transcription_response(router, wav, model=MAIN_MODEL, response_format="json")["text"]
            torch.cuda.synchronize()
            stt_s, k1_plain = time.perf_counter() - t0, A.launches["flash_attention"]
            prepared = prepare_upload(router, MAIN_MODEL, wav, "audio/wav")
            for name, shared in (("segmented", card), ("energy-gated", plain_card)):
                TDS._shared = shared
                t0 = time.perf_counter()
                turns = TDS.Diarizer().diarize(prepared)
                diarize_s = time.perf_counter() - t0
                want = {"text": text, "segments": TDS.attach_text_to_speakers(text, turns)}
                for key in A.launches:
                    A.launches[key] = 0  # the served request's launches only
                t0 = time.perf_counter()
                status, rheaders, rbody = _http(served.port, "POST", route, body, headers)
                served_s = time.perf_counter() - t0
                if status != 200 or json.loads(rbody) != want:
                    raise AssertionError(f"diarize 16c {name}: {status} {rbody[:300]!r} vs direct {want}")
                if A.launches["flash_attention"] != k1_plain or k1_plain <= 0:
                    raise AssertionError(f"diarize 16c {name}: K1 launches served {dict(A.launches)} vs plain "
                                         f"{k1_plain}")
                for key, n in A.launches.items():
                    launches[key] = launches.get(key, 0) + n
                lines.append(f"{name}: {len(want['segments'])} turns of {len({t['speaker'] for t in turns})} "
                             f"speakers, served wall {served_s:.3f} s, direct diarization {diarize_s:.3f} s")
            settings.stt_diarize_enabled = False
            off, _, off_body = _http(served.port, "POST", route, body, headers)
            if off != 400 or b"STT_DIARIZE_ENABLED" not in off_body:
                raise AssertionError(f"diarize 16c with the setting off: {off} {off_body[:200]!r}")
    finally:
        entry["tok"] = real_tok
        TDS._shared, settings.stt_diarize_enabled = saved
    log(f"diarize 16c POST {route} ({SERVED_DIARIZE_SECONDS:.0f} s, three speakers, model {MAIN_MODEL}, "
        f"{len(text.split())} words): 200 {rheaders.get('Content-Type')}, body = the direct transcription + "
        f"Diarizer().diarize + attach_text_to_speakers, K1 launches {k1_plain} per request = the plain "
        f"transcription's (direct transcription {stt_s:.3f} s); " + "; ".join(lines) + "; setting off: 400")
    return launches


if __name__ == "__main__":
    sys.exit(main())
