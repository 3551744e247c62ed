"""Whisper weights made from the seed on the device, at a configuration's
published shapes, in the type they are served in.

Names follow openai/whisper's state dict. Every bf16 tensor is a view of one
buffer filled by one ``randn`` on the device's generator, then scaled per
tensor; the float32 layer norms come from a second call. The same seed on
the same device gives the same tensors, so the reference remakes them after
the window instead of keeping a copy. Scales: linears and convolutions
normal over sqrt(fan in), the token embedding over sqrt(d), biases and the
decoder's positions 0.02, layer-norm gains 1 + 0.02 N(0, 1) and biases
0.02 N(0, 1); the encoder's positions are the fixed sinusoids.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SMALL_STD = 0.02


def sinusoids(length: int, channels: int) -> np.ndarray:
    """openai/whisper's encoder positions: [sin | cos] over log-spaced scales."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    scaled = np.arange(length)[:, None] * np.exp(-inc * np.arange(channels // 2))[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def layout(cfg: dict) -> tuple[list[tuple[str, tuple, float]], list[str]]:
    """([(name, shape, std)] of the bf16 normal tensors, [layer-norm prefixes])."""
    d, mels, ffn_e, ffn_d = (cfg["d_model"], cfg["num_mel_bins"], cfg["encoder_ffn_dim"],
                             cfg["decoder_ffn_dim"])
    normal: list[tuple[str, tuple, float]] = [
        ("encoder.conv1.weight", (d, mels, 3), (3 * mels) ** -0.5),
        ("encoder.conv1.bias", (d,), SMALL_STD),
        ("encoder.conv2.weight", (d, d, 3), (3 * d) ** -0.5),
        ("encoder.conv2.bias", (d,), SMALL_STD),
        ("decoder.token_embedding.weight", (cfg["vocab_size"], d), d**-0.5),
        ("decoder.positional_embedding", (cfg["max_target_positions"], d), SMALL_STD),
    ]
    norms = ["encoder.ln_post", "decoder.ln"]

    def attention(prefix: str) -> None:
        for part in ("query", "key", "value", "out"):
            normal.append((f"{prefix}.{part}.weight", (d, d), d**-0.5))
            if part != "key":  # Whisper's key projection has no bias
                normal.append((f"{prefix}.{part}.bias", (d,), SMALL_STD))

    def block(prefix: str, ffn: int, cross: bool) -> None:
        attention(f"{prefix}.attn")
        norms.extend([f"{prefix}.attn_ln", f"{prefix}.mlp_ln"])
        if cross:
            attention(f"{prefix}.cross_attn")
            norms.append(f"{prefix}.cross_attn_ln")
        normal.extend([
            (f"{prefix}.mlp.0.weight", (ffn, d), d**-0.5), (f"{prefix}.mlp.0.bias", (ffn,), SMALL_STD),
            (f"{prefix}.mlp.2.weight", (d, ffn), ffn**-0.5), (f"{prefix}.mlp.2.bias", (d,), SMALL_STD),
        ])

    for i in range(cfg["encoder_layers"]):
        block(f"encoder.blocks.{i}", ffn_e, False)
    for i in range(cfg["decoder_layers"]):
        block(f"decoder.blocks.{i}", ffn_d, True)
    return normal, norms


@torch.no_grad()
def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every tensor of the model, from ``seed``, on ``device``."""
    normal, norms = layout(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(shape) for _, shape, _ in normal)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, std in normal:
        n = math.prod(shape)
        out[name] = flat[at: at + n].view(shape).mul_(std)
        at += n
    d = cfg["d_model"]
    ln = torch.randn(len(norms), 2, d, generator=gen, device=device).mul_(SMALL_STD)
    ln[:, 0] += 1.0
    for i, prefix in enumerate(norms):
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = ln[i, 0], ln[i, 1]
    out["encoder.positional_embedding"] = torch.from_numpy(
        sinusoids(cfg["max_source_positions"], d)).to(device, torch.bfloat16)
    return out
