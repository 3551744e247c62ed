"""Plain float32 Voxtral: the yardstick the port's Voxtral is held to in the
CPU tests.

It imports nothing of the port and nothing of JAX: plain ``torch``
operations over a dict of weights named as the port's ``Voxtral`` state
dict names them, in float32, with no kernel, cache or batching. It follows
mistralai/Voxtral-Small-24B-2507 as ``transformers`` describes it:

  audio tower: Whisper's encoder (conv k3 s1, GELU, conv k3 s2, GELU, +
               positions, pre-LN blocks of self-attention and a GELU MLP,
               a final LayerNorm);
  adapter:     four consecutive encoder frames concatenated into one
               position, linear_1, GELU, linear_2 (no biases);
  language model: Llama's layers (RMSNorm, grouped-query attention with
               rotate-half RoPE over the whole head, RMSNorm, SwiGLU),
               a final RMSNorm and an untied head; the ``[AUDIO]``
               positions take the adapter's outputs in order.

Departures from the published description: RMSNorm keeps float32 through
its gain (Llama rounds to the input's dtype before the gain, which in
float32 is no rounding); the RoPE angles are computed in float64 and used
in float32; attention is computed head by head in loops, query head h
reading KV head h // g.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def _mha(q, k, v, causal: bool):
    """q [Hq, T, D], k/v [Hq, S, D] -> [Hq, T, D], softmax in float32."""
    scores = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
    if causal:
        t, s = scores.shape[1:]
        mask = torch.ones(t, s, dtype=torch.bool).triu(s - t + 1)
        scores = scores.masked_fill(mask, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def encoder(w: dict, mel: torch.Tensor, heads: int, layers: int) -> torch.Tensor:
    """mel [n_mels, T] -> [T / 2, d]."""
    x = F.gelu(F.conv1d(mel[None], w["encoder.conv1.weight"], w["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, w["encoder.conv2.weight"], w["encoder.conv2.bias"], stride=2, padding=1))
    x = x[0].T + w["encoder.pos"][: x.shape[2]]
    d = x.shape[1]
    for i in range(layers):
        p = f"encoder.blocks.{i}"
        h = F.layer_norm(x, (d,), w[f"{p}.ln1.weight"], w[f"{p}.ln1.bias"], LN_EPS)
        q, k, v = (F.linear(h, w[f"{p}.attn.{n}.weight"], w.get(f"{p}.attn.{n}.bias"))
                   .view(-1, heads, d // heads).transpose(0, 1) for n in "qkv")
        out = _mha(q, k, v, False).transpose(0, 1).reshape(-1, d)
        x = x + F.linear(out, w[f"{p}.attn.o.weight"], w[f"{p}.attn.o.bias"])
        h = F.layer_norm(x, (d,), w[f"{p}.ln_mlp.weight"], w[f"{p}.ln_mlp.bias"], LN_EPS)
        h = F.gelu(F.linear(h, w[f"{p}.mlp_in.weight"], w[f"{p}.mlp_in.bias"]))
        x = x + F.linear(h, w[f"{p}.mlp_out.weight"], w[f"{p}.mlp_out.bias"])
    return F.layer_norm(x, (d,), w["encoder.ln_post.weight"], w["encoder.ln_post.bias"], LN_EPS)


def adapter(w: dict, enc: torch.Tensor) -> torch.Tensor:
    """[T, d_audio] -> [T / 4, hidden]: row i concatenates frames 4i..4i+3."""
    frames = torch.stack([torch.cat([enc[4 * i + j] for j in range(4)])
                          for i in range(enc.shape[0] // 4)])
    return F.linear(F.gelu(F.linear(frames, w["adapter.linear_1.weight"])),
                    w["adapter.linear_2.weight"])


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, T, D] rotated per position: pairs (i, i + D/2) by angle
    position * theta^(-2i / D), as a complex product."""
    d = x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64) * 2 / d)
    ang = positions.double()[:, None] * inv[None, :]
    rot = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)  # [T, half]
    z = torch.complex(x[..., :half], x[..., half:]) * rot
    return torch.cat([z.real, z.imag], dim=-1)


def language_model(w: dict, x: torch.Tensor, cfg: dict, kv_head=None) -> torch.Tensor:
    """Input embeddings [T, hidden] at positions 0..T-1 -> logits [T, vocab].
    ``kv_head(h, g)`` names the KV head of query head h (h // g unless a
    test swaps it)."""
    kv_head = kv_head or (lambda h, g: h // g)
    hq, hkv, hd, eps = cfg["heads"], cfg["kv_heads"], cfg["head_dim"], cfg["rms_eps"]
    g = hq // hkv
    t = x.shape[0]
    pos = torch.arange(t)
    for i in range(cfg["layers"]):
        p = f"layers.{i}"
        h = rms_norm(x, w[f"{p}.attn_norm.weight"], eps)
        q = F.linear(h, w[f"{p}.q.weight"]).view(t, hq, hd).transpose(0, 1)
        k = F.linear(h, w[f"{p}.k.weight"]).view(t, hkv, hd).transpose(0, 1)
        v = F.linear(h, w[f"{p}.v.weight"]).view(t, hkv, hd).transpose(0, 1)
        q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
        heads = [_mha(q[j:j + 1], k[kv_head(j, g):kv_head(j, g) + 1],
                      v[kv_head(j, g):kv_head(j, g) + 1], True) for j in range(hq)]
        out = torch.cat(heads).transpose(0, 1).reshape(t, hq * hd)
        x = x + F.linear(out, w[f"{p}.o.weight"])
        h = rms_norm(x, w[f"{p}.mlp_norm.weight"], eps)
        x = x + F.linear(F.silu(F.linear(h, w[f"{p}.gate.weight"])) * F.linear(h, w[f"{p}.up.weight"]),
                         w[f"{p}.down.weight"])
    return F.linear(rms_norm(x, w["norm.weight"], eps), w["head.weight"])


def forward(w: dict, mel: torch.Tensor, ids: list[int], cfg: dict, kv_head=None) -> torch.Tensor:
    """Teacher-forced logits [len(ids), vocab] of one window: row i predicts
    ids[i + 1]; the ``[AUDIO]`` ids take the window's audio embeddings."""
    audio = adapter(w, encoder(w, mel, cfg["audio_heads"], cfg["audio_layers"]))
    x = w["embed"][torch.tensor(ids)].clone()
    at = [i for i, t in enumerate(ids) if t == cfg["audio_token_id"]]
    x[at] = audio
    return language_model(w, x, cfg, kv_head)
