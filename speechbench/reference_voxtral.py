"""Plain float32 Voxtral: the yardstick that decides ``correct`` in the
audio-LLM cells, and its control one precision down.

It imports nothing of the program. It follows mistralai/Voxtral-Small-24B-
2507 as ``transformers`` describes it: Whisper's encoder (the float64 NumPy
front end of ``reference.py`` before it), four consecutive encoder frames
folded into one position and the adapter (linear, GELU, linear, no
biases), then Llama's layers (RMSNorm, grouped-query attention with
rotate-half RoPE over the whole head, RMSNorm, SwiGLU), a final RMSNorm and
an untied head, the ``[AUDIO]`` positions taking the adapter's outputs in
order. Float32 PyTorch with TF32 off, no cache, no batching of positions
into slots, no kernel: the model runs layer by layer over the sampled
windows together (each window padded at its end; causal attention keeps the
padding out of every earlier row), with each layer's weights remade from
the seed (``weights_voxtral.py``) when it runs and dropped after, since the
float32 model is 97 GB. Teacher-forced over each window's prompt and served
tokens, the logits at each position are what greedy decoding through a
cache should have seen.

Departures from the published description: RMSNorm keeps float32 through
its gain (Llama rounds to the input's dtype before the gain: no rounding in
float32); the RoPE angles are computed in float64 and used in float32.

The control (``fp8=True``) is the same model with every product of a
linear layer, the head's included, taken over operands rounded to float8
e4m3 (``reference.fp8_e4m3``: one scale per activation row and per weight
row), accumulated in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speechbench import weights_voxtral
from speechbench.reference import LN_EPS, fp8_e4m3

FRAMES_PER_POSITION = 4


class LayerWeights:
    """One group of the model's tensors (names starting with ``prefix``),
    remade from the seed in float32; linear weights rounded to e4m3 under
    ``fp8``."""

    def __init__(self, cfg: dict, seed: int, device, prefix: str, fp8: bool) -> None:
        made = weights_voxtral.make(cfg, seed, device, select=lambda n: n.startswith(prefix))
        self.t = {k: v.float() for k, v in made.items()}
        self.fp8 = fp8

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.t[name]

    def get(self, name: str):
        return self.t.get(name)

    def linear(self, x: torch.Tensor, name: str, bias: str | None = None) -> torch.Tensor:
        w = self.t[name]
        if self.fp8:
            x, w = fp8_e4m3(x), fp8_e4m3(w)
        return F.linear(x, w, None if bias is None else self.t.get(bias))


def _attention(q, k, v, causal: bool) -> torch.Tensor:
    """q [B, H, T, D], k/v [B, H, S, D] -> [B, H, T, D], softmax in float32."""
    scores = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        t, s = scores.shape[-2:]
        mask = torch.ones(t, s, dtype=torch.bool, device=q.device).triu(s - t + 1)
        scores = scores.masked_fill(mask, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


@torch.no_grad()
def encode(cfg: dict, seed: int, mels: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """mels [B, n_mels, 3000] float32 -> audio embeddings [B, 375, hidden]:
    Whisper's encoder, then the adapter."""
    a = cfg["audio_config"]
    dev = mels.device
    stem = LayerWeights(cfg, seed, dev, "encoder.", fp8)  # the whole encoder: 2.5 GB at float32
    x = F.gelu(F.conv1d(mels, stem["encoder.conv1.weight"], stem["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, stem["encoder.conv2.weight"], stem["encoder.conv2.bias"], stride=2,
                        padding=1))
    x = x.transpose(1, 2) + stem["encoder.pos"]
    b, t, d = x.shape
    heads = a["num_attention_heads"]
    for i in range(a["num_hidden_layers"]):
        p = f"encoder.blocks.{i}"
        h = F.layer_norm(x, (d,), stem[f"{p}.ln1.weight"], stem[f"{p}.ln1.bias"], LN_EPS)
        q, k, v = (stem.linear(h, f"{p}.attn.{n}.weight", f"{p}.attn.{n}.bias")
                   .view(b, t, heads, d // heads).transpose(1, 2) for n in "qkv")
        out = _attention(q, k, v, False).transpose(1, 2).reshape(b, t, d)
        x = x + stem.linear(out, f"{p}.attn.o.weight", f"{p}.attn.o.bias")
        h = F.layer_norm(x, (d,), stem[f"{p}.ln_mlp.weight"], stem[f"{p}.ln_mlp.bias"], LN_EPS)
        x = x + stem.linear(F.gelu(stem.linear(h, f"{p}.mlp_in.weight", f"{p}.mlp_in.bias")),
                            f"{p}.mlp_out.weight", f"{p}.mlp_out.bias")
    x = F.layer_norm(x, (d,), stem["encoder.ln_post.weight"], stem["encoder.ln_post.bias"], LN_EPS)
    del stem
    ad = LayerWeights(cfg, seed, dev, "adapter.", fp8)
    x = x.reshape(b, t // FRAMES_PER_POSITION, FRAMES_PER_POSITION * d)
    return ad.linear(F.gelu(ad.linear(x, "adapter.linear_1.weight")), "adapter.linear_2.weight")


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, T, D] rotated at positions 0..T-1: pairs (i, i + D/2) by
    angle position * theta^(-2i / D)."""
    t, d = x.shape[-2:]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) * 2 / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits(cfg: dict, seed: int, mels: torch.Tensor, windows: list[list[int]],
           rows: list[range], fp8: bool = False) -> list[torch.Tensor]:
    """Teacher-forced logits of each window: ``windows[i]`` the ids of
    window i (its prompt, then its served tokens), ``rows[i]`` the
    positions whose logits are wanted (row j predicts id j + 1). Returns
    [len(rows[i]), vocab] float32 per window."""
    t_cfg = cfg["text_config"]
    dev = mels.device
    audio = encode(cfg, seed, mels, fp8)  # [B, 375, d]
    b, length = len(windows), max(len(w) for w in windows)
    ids = torch.zeros(b, length, dtype=torch.long, device=dev)
    for i, w in enumerate(windows):
        ids[i, : len(w)] = torch.tensor(w, device=dev)
    emb = LayerWeights(cfg, seed, dev, "embed", fp8)
    x = emb["embed"][ids]
    del emb
    for i, w in enumerate(windows):
        at = [j for j, tok in enumerate(w) if tok == cfg["audio_token_id"]]
        x[i, at] = audio[i]
    heads, kv, hd = t_cfg["num_attention_heads"], t_cfg["num_key_value_heads"], t_cfg["head_dim"]
    eps, theta = t_cfg["rms_norm_eps"], t_cfg["rope_theta"]
    for layer in range(t_cfg["num_hidden_layers"]):
        p = f"layers.{layer}."
        w = LayerWeights(cfg, seed, dev, p, fp8)
        h = _rms(x, w[p + "attn_norm.weight"], eps)
        q = w.linear(h, p + "q.weight").view(b, length, heads, hd).transpose(1, 2)
        k = w.linear(h, p + "k.weight").view(b, length, kv, hd).transpose(1, 2)
        v = w.linear(h, p + "v.weight").view(b, length, kv, hd).transpose(1, 2)
        q, k = _rope(q, theta), _rope(k, theta)
        group = heads // kv  # query head j reads KV head j // group
        out = _attention(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1), True)
        x = x + w.linear(out.transpose(1, 2).reshape(b, length, heads * hd), p + "o.weight")
        h = _rms(x, w[p + "mlp_norm.weight"], eps)
        x = x + w.linear(F.silu(w.linear(h, p + "gate.weight")) * w.linear(h, p + "up.weight"),
                         p + "down.weight")
        del w
    out = LayerWeights(cfg, seed, dev, "norm.", fp8)
    head = LayerWeights(cfg, seed, dev, "head.", fp8)
    return [head.linear(_rms(x[i, r.start: r.stop], out["norm.weight"], eps), "head.weight")
            for i, r in enumerate(rows)]
