"""Voxtral-Small-24B's admission and decode step on one card, by size.

    python tools/torch_voxtral_admission.py [--sizes 1,2,4,8,16] [--seed N]

Builds the port's Voxtral at the published widths with the benchmark's
seeded weights (``speechbench/weights_voxtral.py``), then times with CUDA
events, after a warm-up at each size: an admission of n windows (the
audio tower, the adapter and the prefill of the 382-position prompt into a
64-slot pool) for each n, and one decode step of the 64-slot pool at
cache lengths of 383-528. Prints one line a size and a JSON line; this is
what ``runtime/audio_llm_batcher.py:PREFILL_POSITIONS`` was set from.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from open_speech_tpu_torch.models.voxtral.model import (  # noqa: E402
    Voxtral,
    VoxtralConfig,
    decode_step,
    encode_audio,
    prefill,
    rope_tables,
)
from open_speech_tpu_torch.models.voxtral.tokens import VoxtralTokens  # noqa: E402
from speechbench import weights_voxtral  # noqa: E402

CONFIG = Path(__file__).resolve().parents[1] / "speechbench" / "configs" / "voxtral-small-24b.json"


def timed_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.no_grad()
def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", default="1,2,4,8,12,16")
    p.add_argument("--seed", type=int, default=2**31 + 11)
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    config = json.loads(CONFIG.read_text())
    cfg = VoxtralConfig.from_hf(config)
    with torch.device("meta"):
        model = Voxtral(cfg, torch.bfloat16)
    targets = model.state_dict()
    made = weights_voxtral.make(config, args.seed, "cuda")
    model.load_state_dict({k: v.to(targets[k].dtype) for k, v in made.items()}, assign=True)
    del made, targets
    slots, cache_len = 64, 576
    tok = VoxtralTokens(cfg.audio_positions, {"en": config["assumed"]["lang_ids"]})
    ids = torch.tensor(tok.transcription_prompt("en")[:-1], device="cuda")
    cache = torch.zeros(cfg.layers, 2, slots, cfg.kv_heads, cache_len, cfg.head_dim,
                        dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"card": card, "admission_ms": {}, "prompt_positions": len(ids)}
    for n in (int(s) for s in args.sizes.split(",")):
        mel = torch.randn(n, cfg.audio.n_mels, 2 * cfg.audio.n_audio_ctx, generator=gen,
                          device="cuda")
        slot_ids = torch.arange(n, device="cuda")
        enc_ms = timed_ms(lambda: encode_audio(model, mel))
        ms = timed_ms(lambda: prefill(model, encode_audio(model, mel), ids, cache, slot_ids))
        out["admission_ms"][n] = ms
        print(f"admission of {n:2d} windows ({n * len(ids)} prompt positions): {ms:8.2f} ms, "
              f"{ms / n:6.2f} ms a window (audio tower and adapter {enc_ms / n:6.2f})", flush=True)
    rope = rope_tables(cfg, cache_len, "cuda")
    tokens = torch.randint(1000, cfg.vocab, (slots,), generator=gen, device="cuda")
    pos = torch.randint(len(ids), len(ids) + 145, (slots,), generator=gen, device="cuda")
    out["decode_step_ms"] = timed_ms(lambda: decode_step(model, tokens, pos, cache, rope), iters=10)
    print(f"decode step of {slots} slots: {out['decode_step_ms']:.2f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
