"""The card's published peaks and the work of the calls the benchmark reads.

Operations are counted from shapes (two per multiply-add) and bytes as each
input read once and each output written once, whatever a kernel reads again.
The K1 bound is the one ``chip_smoke.py:_flash_bound_ms`` computes for a
bf16 call without lengths; the model's operations follow the Whisper block
(pre-LN attention and MLP, a cross-attention in each decoder block, logits
against the token embedding).
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet: dense bf16 tensor-core rate and HBM3
# bandwidth, at the full 700 W power limit. A card not listed has no peak
# here, and the metrics that need one report nothing.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def peak(device_kind: str | None) -> dict | None:
    return PEAKS.get(device_kind or "")


def k1_bound_s(b: int, h: int, t_q: int, t_k: int, d: int, peaks: dict,
               causal: bool = False, itemsize: int = 2) -> float:
    """Least time of one K1 call: the visible (q, k) pairs at the bf16 peak
    against q, k, v read once and the output written once."""
    if causal:
        visible = sum(min(max(i + t_k - t_q + 1, 0), t_k) for i in range(t_q))
    else:
        visible = t_q * t_k
    flops = 4 * b * h * visible * d
    nbytes = b * h * (2 * t_q + 2 * t_k) * d * itemsize
    return max(flops / peaks["bf16_flops"], nbytes / peaks["bytes_per_s"])


def encoder_flops(cfg: dict) -> float:
    """One 30 s window through the encoder, and the cross-attention K and V
    of every decoder layer computed from its output."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    frames = 2 * t
    conv = 2 * cfg["num_mel_bins"] * d * 3 * frames + 2 * d * d * 3 * t
    layer = 4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * cfg["encoder_ffn_dim"]
    cross_kv = cfg["decoder_layers"] * 2 * 2 * t * d * d
    return conv + cfg["encoder_layers"] * layer + cross_kv


def decoder_position_flops(cfg: dict, length: float) -> float:
    """One decoder position that attends to ``length`` earlier positions
    (itself included) and to the whole encoder output, logits included."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    layer = (4 * 2 * d * d + 2 * 2 * length * d  # self-attention
             + 2 * 2 * d * d + 2 * 2 * t * d  # cross-attention: q, o, scores
             + 2 * 2 * d * cfg["decoder_ffn_dim"])
    return cfg["decoder_layers"] * layer + 2 * d * cfg["vocab_size"]
