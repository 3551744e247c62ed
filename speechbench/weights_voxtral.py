"""Voxtral weights made from the seed on the device, at a configuration's
published shapes, in bf16 (the encoder's layer norms in float32).

Names are the port's ``Voxtral`` state dict's. Every tensor comes from its
own generator, seeded from (seed, the tensor's index in ``layout``), so the
reference remakes one layer at a time (the float32 copy of the whole model,
97 GB, is more than the card holds) and gets the same tensors. Scales:
linears and convolutions normal over sqrt(fan in), the token embedding over
sqrt(hidden), the encoder's biases 0.02, layer-norm and RMSNorm gains 1 +
0.02 N(0, 1) and layer-norm biases 0.02 N(0, 1); the encoder's positions
are the fixed sinusoids.
"""

from __future__ import annotations

import numpy as np
import torch

from speechbench.weights import SMALL_STD, sinusoids

NORMAL, GAIN, BIAS, POSITIONS = "normal", "gain", "bias", "positions"


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """[(name, shape, kind, std)] in a fixed order; kind is ``normal`` (std
    N(0, 1)), ``gain`` (1 + 0.02 N), ``bias`` (0.02 N, float32 layer-norm
    biases) or ``positions`` (the sinusoids)."""
    a, t = cfg["audio_config"], cfg["text_config"]
    da, mels, ffn_a = a["hidden_size"], a["num_mel_bins"], a["intermediate_size"]
    d, hd, ffn = t["hidden_size"], t["head_dim"], t["intermediate_size"]
    h, h_kv, vocab = t["num_attention_heads"], t["num_key_value_heads"], t["vocab_size"]
    out: list[tuple[str, tuple, str, float]] = [
        ("encoder.conv1.weight", (da, mels, 3), NORMAL, (3 * mels) ** -0.5),
        ("encoder.conv1.bias", (da,), NORMAL, SMALL_STD),
        ("encoder.conv2.weight", (da, da, 3), NORMAL, (3 * da) ** -0.5),
        ("encoder.conv2.bias", (da,), NORMAL, SMALL_STD),
        ("encoder.pos", (a["max_source_positions"], da), POSITIONS, 0.0),
    ]
    for i in range(a["num_hidden_layers"]):
        p = f"encoder.blocks.{i}"
        for ln in ("ln1", "ln_mlp"):
            out += [(f"{p}.{ln}.weight", (da,), GAIN, 0.0), (f"{p}.{ln}.bias", (da,), BIAS, 0.0)]
        for part in "qkvo":
            out.append((f"{p}.attn.{part}.weight", (da, da), NORMAL, da**-0.5))
            if part != "k":  # Whisper's key projection has no bias
                out.append((f"{p}.attn.{part}.bias", (da,), NORMAL, SMALL_STD))
        out += [(f"{p}.mlp_in.weight", (ffn_a, da), NORMAL, da**-0.5),
                (f"{p}.mlp_in.bias", (ffn_a,), NORMAL, SMALL_STD),
                (f"{p}.mlp_out.weight", (da, ffn_a), NORMAL, ffn_a**-0.5),
                (f"{p}.mlp_out.bias", (da,), NORMAL, SMALL_STD)]
    out += [("encoder.ln_post.weight", (da,), GAIN, 0.0), ("encoder.ln_post.bias", (da,), BIAS, 0.0),
            ("adapter.linear_1.weight", (d, 4 * da), NORMAL, (4 * da) ** -0.5),
            ("adapter.linear_2.weight", (d, d), NORMAL, d**-0.5),
            ("embed", (vocab, d), NORMAL, d**-0.5)]
    for i in range(t["num_hidden_layers"]):
        p = f"layers.{i}"
        out += [(f"{p}.attn_norm.weight", (d,), GAIN, 0.0),
                (f"{p}.q.weight", (h * hd, d), NORMAL, d**-0.5),
                (f"{p}.k.weight", (h_kv * hd, d), NORMAL, d**-0.5),
                (f"{p}.v.weight", (h_kv * hd, d), NORMAL, d**-0.5),
                (f"{p}.o.weight", (d, h * hd), NORMAL, (h * hd) ** -0.5),
                (f"{p}.mlp_norm.weight", (d,), GAIN, 0.0),
                (f"{p}.gate.weight", (ffn, d), NORMAL, d**-0.5),
                (f"{p}.up.weight", (ffn, d), NORMAL, d**-0.5),
                (f"{p}.down.weight", (d, ffn), NORMAL, ffn**-0.5)]
    out += [("norm.weight", (d,), GAIN, 0.0), ("head.weight", (vocab, d), NORMAL, d**-0.5)]
    return out


def _stream(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


@torch.no_grad()
def make(cfg: dict, seed: int, device, select=None) -> dict[str, torch.Tensor]:
    """The tensors of the model whose names ``select`` accepts (all by
    default), from ``seed``, on ``device``: bf16 but the encoder's layer
    norms (float32)."""
    device = torch.device(device)
    out: dict[str, torch.Tensor] = {}
    for index, (name, shape, kind, std) in enumerate(layout(cfg)):
        if select is not None and not select(name):
            continue
        if kind == POSITIONS:
            out[name] = torch.from_numpy(sinusoids(*shape)).to(device, torch.bfloat16)
            continue
        gen = torch.Generator(device=device).manual_seed(_stream(seed, index))
        encoder_ln = name.startswith("encoder.") and kind in (GAIN, BIAS)
        dtype = torch.float32 if encoder_ln else torch.bfloat16
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        out[name] = x.mul_(std) if kind == NORMAL else x.mul_(SMALL_STD).add_(float(kind == GAIN))
    return out
