"""Whisper encoder/decoder as PyTorch modules.

Counterpart of ``open_speech_tpu/models/whisper/model.py`` (openai/whisper
architecture):

  encoder: conv1d(k3,s1) -> GELU -> conv1d(k3,s2) -> GELU -> +sinusoid pos
           -> N x [preLN self-attn, preLN MLP] -> LN
  decoder: tok emb + learned pos -> N x [preLN causal self-attn,
           preLN cross-attn, preLN MLP] -> LN -> logits = h @ emb.T

Weights live in ``nn.Module``s (``nn.Linear`` weights in [out, in] order,
``nn.Conv1d`` in [out, in, k]) in the compute dtype, with float32 layer
norms and logits. The functions below keep the JAX package's signatures
and layouts: mel [B, n_mels, T] -> encoder states [B, T, d]; self-KV
[L, 2, B, H, T_max, Dh]; cross-KV [L, 2, B, H, T_enc, Dh].

int8 compute (``quantize.py``): ``QuantLinear`` and ``QuantEmbedding`` take
the place of the linears and the token embedding, and the primitives below
compute from the int8 packs as the JAX package's int8 branches do; the
cross-KV of such a model is a dict of per-position int8 packs
{"k", "k_s", "v", "v_s"}, each [L, B, H, T_enc, *].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.ops.attention import (
    beam_select_attention,
    decode_attention,
    flash_attention,
)

LN_EPS = 1e-5


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_langs: int = 99  # 100 for large-v3 family

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


# Model catalog (openai/whisper release table; v3 family: 128 mels, 100
# languages; distil-* keep the full encoder with a shallow decoder)
PRESETS: dict[str, WhisperConfig] = {
    "tiny": WhisperConfig(80, 51865, 1500, 384, 6, 4, 448, 384, 6, 4, 99),
    "tiny.en": WhisperConfig(80, 51864, 1500, 384, 6, 4, 448, 384, 6, 4, 99),
    "base": WhisperConfig(80, 51865, 1500, 512, 8, 6, 448, 512, 8, 6, 99),
    "base.en": WhisperConfig(80, 51864, 1500, 512, 8, 6, 448, 512, 8, 6, 99),
    "small": WhisperConfig(80, 51865, 1500, 768, 12, 12, 448, 768, 12, 12, 99),
    "small.en": WhisperConfig(80, 51864, 1500, 768, 12, 12, 448, 768, 12, 12, 99),
    "medium": WhisperConfig(80, 51865, 1500, 1024, 16, 24, 448, 1024, 16, 24, 99),
    "medium.en": WhisperConfig(80, 51864, 1500, 1024, 16, 24, 448, 1024, 16, 24, 99),
    "large-v1": WhisperConfig(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 99),
    "large-v2": WhisperConfig(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 99),
    "large-v3": WhisperConfig(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 32, 100),
    "large-v3-turbo": WhisperConfig(
        128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 100
    ),
    "distil-large-v3": WhisperConfig(
        128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 2, 100
    ),
    "distil-small.en": WhisperConfig(80, 51864, 1500, 768, 12, 12, 448, 768, 12, 4, 99),
    "distil-medium.en": WhisperConfig(80, 51864, 1500, 1024, 16, 24, 448, 1024, 16, 2, 99),
    # test-size config: everything minimal, byte-level-friendly vocab
    "test-tiny": WhisperConfig(80, 384, 60, 64, 2, 2, 32, 64, 2, 2, 2),
    "test-tiny-draft": WhisperConfig(80, 384, 60, 64, 2, 1, 32, 64, 2, 1, 2),
}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal position table (openai layout: [sin | cos])."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32
    )


# ──────────────────────────────────────────────────────────────────────
# Modules
# ──────────────────────────────────────────────────────────────────────


class LayerNorm(nn.Module):
    """Gain and bias kept in float32 whatever the compute dtype."""

    def __init__(self, d: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32))


class QuantLinear(nn.Module):
    """Weight-only int8 linear: ``q`` int8 [out, in], ``s`` float32 [out]
    (one scale per output channel), and the bias of the linear it replaced."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bias: torch.Tensor | None) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.register_buffer("bias", None if bias is None else bias.detach())


class QuantEmbedding(nn.Module):
    """int8 token embedding: ``q`` int8 [V, d], ``s`` float32 [V, 1]."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


class Attention(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.q = nn.Linear(d, d, dtype=dtype)
        self.k = nn.Linear(d, d, bias=False, dtype=dtype)
        self.v = nn.Linear(d, d, dtype=dtype)
        self.o = nn.Linear(d, d, dtype=dtype)


class Block(nn.Module):
    def __init__(self, d: int, cross: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.ln1 = LayerNorm(d)
        self.attn = Attention(d, dtype)
        if cross:
            self.ln_cross = LayerNorm(d)
            self.cross = Attention(d, dtype)
        self.ln_mlp = LayerNorm(d)
        self.mlp_in = nn.Linear(d, 4 * d, dtype=dtype)
        self.mlp_out = nn.Linear(4 * d, d, dtype=dtype)


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype: torch.dtype) -> None:
        super().__init__()
        d = cfg.n_audio_state
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1, dtype=dtype)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, dtype=dtype)
        self.register_buffer("pos", torch.zeros(cfg.n_audio_ctx, d, dtype=dtype))
        self.blocks = nn.ModuleList(
            Block(d, False, dtype) for _ in range(cfg.n_audio_layer)
        )
        self.ln_post = LayerNorm(d)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype: torch.dtype) -> None:
        super().__init__()
        d = cfg.n_text_state
        self.tok_emb = nn.Parameter(torch.zeros(cfg.n_vocab, d, dtype=dtype))
        self.pos_emb = nn.Parameter(torch.zeros(cfg.n_text_ctx, d, dtype=dtype))
        self.blocks = nn.ModuleList(
            Block(d, True, dtype) for _ in range(cfg.n_text_layer)
        )
        self.ln = LayerNorm(d)


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.encoder = AudioEncoder(cfg, dtype)
        self.decoder = TextDecoder(cfg, dtype)

    @classmethod
    def empty(cls, cfg: WhisperConfig, dtype: torch.dtype, device) -> "Whisper":
        """Uninitialised storage on ``device``: built on the meta device so
        no initialiser runs; the caller fills every tensor."""
        with torch.device("meta"):
            model = cls(cfg, dtype)
        return model.to_empty(device=device).requires_grad_(False).eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.ln.weight.device


@torch.no_grad()
def init_params(
    generator: torch.Generator, cfg: WhisperConfig, dtype=torch.float32, device=None
) -> Whisper:
    """Random-init model: weights drawn from ``generator`` on its device
    with the JAX package's distributions (normal * fan_in^-0.5, zero biases,
    unit layer norms, sinusoidal encoder positions, zero decoder positions).
    """
    device = torch.device(device) if device is not None else generator.device
    model = Whisper.empty(cfg, dtype, device)

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=device) * std)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias" or name == "decoder.pos_emb":
            p.zero_()
        elif name.startswith("encoder.conv"):
            normal(p, (p.shape[1] * p.shape[2]) ** -0.5)
        elif name == "decoder.tok_emb":
            normal(p, cfg.n_text_state**-0.5)
        else:  # linear [out, in]
            normal(p, p.shape[1] ** -0.5)
    model.encoder.pos.copy_(torch.from_numpy(sinusoids(cfg.n_audio_ctx, cfg.n_audio_state)))
    return model


# ──────────────────────────────────────────────────────────────────────
# Primitive layers
# ──────────────────────────────────────────────────────────────────────


def layer_norm(x: torch.Tensor, ln: LayerNorm) -> torch.Tensor:
    """Normalise in float32, cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return (out * ln.weight.float() + ln.bias.float()).to(x.dtype)


def linear(x: torch.Tensor, lin: nn.Linear | QuantLinear) -> torch.Tensor:
    if isinstance(lin, QuantLinear):
        # the scale applies to the product, then the bias: the JAX package's
        # order (folding the scale into the weight rounds otherwise in bf16)
        out = (x @ lin.q.T.to(x.dtype)) * lin.s.to(x.dtype)
        return out if lin.bias is None else out + lin.bias
    return F.linear(x, lin.weight, lin.bias)


def embed_tokens(dec: TextDecoder, tokens: torch.Tensor) -> torch.Tensor:
    emb = dec.tok_emb
    if isinstance(emb, QuantEmbedding):  # bf16 whatever the base dtype, as in JAX
        return emb.q[tokens].to(torch.bfloat16) * emb.s[tokens].to(torch.bfloat16)
    return emb[tokens]


def output_logits(x: torch.Tensor, dec: TextDecoder) -> torch.Tensor:
    emb = dec.tok_emb
    if isinstance(emb, QuantEmbedding):
        return ((x @ emb.q.T.to(x.dtype)) * emb.s[:, 0].to(x.dtype)).float()
    return (x @ emb.T.to(x.dtype)).float()


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def self_attention(x, attn: Attention, n_head: int, causal: bool) -> torch.Tensor:
    q = _split_heads(linear(x, attn.q), n_head)
    k = _split_heads(linear(x, attn.k), n_head)
    v = _split_heads(linear(x, attn.v), n_head)
    out = flash_attention(q, k, v, causal=causal)
    return linear(_merge_heads(out), attn.o)


def mlp(x: torch.Tensor, blk: Block) -> torch.Tensor:
    return linear(F.gelu(linear(x, blk.mlp_in)), blk.mlp_out)


# ──────────────────────────────────────────────────────────────────────
# Encoder
# ──────────────────────────────────────────────────────────────────────


def conv_stem(enc: AudioEncoder, mel: torch.Tensor, first_frame: int = 0) -> torch.Tensor:
    """mel [B, n_mels, T] -> conv features [B, T // 2, d] (before positions).

    ``first_frame`` is the global mel index of ``mel``'s first column. conv1
    outputs at global indices < 0 are zeroed: there the full encoder's
    stride-2 conv sees zero padding, not computed activations (the
    streaming encoder's blocks start two frames early).
    """
    x = F.gelu(enc.conv1(mel.to(enc.conv1.weight.dtype)))  # features f32 -> compute dtype
    if first_frame < 0:
        x[:, :, : -first_frame] = 0
    return F.gelu(enc.conv2(x)).transpose(1, 2)


def encode(model: Whisper, mel: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> encoder states [B, 1500, d].

    Records a graph only where a weight requires grad (training); a served
    model's weights are frozen and its callers run under ``no_grad``."""
    enc = model.encoder
    x = conv_stem(enc, mel)  # [B, T, d]
    x = x + enc.pos[: x.shape[1]]
    for blk in enc.blocks:
        x = x + self_attention(layer_norm(x, blk.ln1), blk.attn, cfg.n_audio_head, False)
        x = x + mlp(layer_norm(x, blk.ln_mlp), blk)
    return layer_norm(x, enc.ln_post)


# ──────────────────────────────────────────────────────────────────────
# Decoder — full forward (scoring)
# ──────────────────────────────────────────────────────────────────────


def decoder_forward(
    model: Whisper, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: WhisperConfig
) -> torch.Tensor:
    """tokens [B, T] + encoder states -> logits [B, T, vocab] (teacher-forced;
    differentiable, as ``encode``)."""
    dec = model.decoder
    n_head = cfg.n_text_head
    t = tokens.shape[1]
    x = embed_tokens(dec, tokens) + dec.pos_emb[:t]
    for blk in dec.blocks:
        x = x + self_attention(layer_norm(x, blk.ln1), blk.attn, n_head, True)
        hc = layer_norm(x, blk.ln_cross)
        q = _split_heads(linear(hc, blk.cross.q), n_head)
        k = _split_heads(linear(enc_out, blk.cross.k), n_head)
        v = _split_heads(linear(enc_out, blk.cross.v), n_head)
        x = x + linear(_merge_heads(flash_attention(q, k, v)), blk.cross.o)
        x = x + mlp(layer_norm(x, blk.ln_mlp), blk)
    return output_logits(layer_norm(x, dec.ln), dec)


# ──────────────────────────────────────────────────────────────────────
# Decoder — incremental (KV cache)
# ──────────────────────────────────────────────────────────────────────


def init_self_kv(
    cfg: WhisperConfig, batch: int, max_len: int | None = None,
    dtype=torch.float32, device=None,
) -> torch.Tensor:
    """Zeroed self-attn KV cache: [L, 2, B, H, T_max, Dh]."""
    max_len = max_len or cfg.n_text_ctx
    dh = cfg.n_text_state // cfg.n_text_head
    return torch.zeros(
        (cfg.n_text_layer, 2, batch, cfg.n_text_head, max_len, dh),
        dtype=dtype, device=device,
    )


@torch.no_grad()
def precompute_cross_kv_dense(
    model: Whisper, enc_out: torch.Tensor, cfg: WhisperConfig
) -> torch.Tensor:
    """Cross-attention K/V for all layers, dense: [L, 2, B, H, T_enc, Dh]
    (the JAX package's ``_precompute_cross_kv_impl``; int8 linears too)."""
    n_head = cfg.n_text_head
    return torch.stack([
        torch.stack([
            _split_heads(linear(enc_out, blk.cross.k), n_head),
            _split_heads(linear(enc_out, blk.cross.v), n_head),
        ])
        for blk in model.decoder.blocks
    ])


@torch.no_grad()
def _precompute_cross_kv_int8(
    model: Whisper, enc_out: torch.Tensor, cfg: WhisperConfig
) -> dict[str, torch.Tensor]:
    """Per-position int8 packs of the cross K/V: {"k", "v"} int8 and
    {"k_s", "v_s"} float32 scales (one per position and head), [L, B, H,
    T_enc, *]."""
    from open_speech_tpu_torch.models.whisper.quantize import quantize_tensor

    n_head = cfg.n_text_head
    layers = []
    for blk in model.decoder.blocks:
        k = quantize_tensor(_split_heads(linear(enc_out, blk.cross.k), n_head), axis=-1)
        v = quantize_tensor(_split_heads(linear(enc_out, blk.cross.v), n_head), axis=-1)
        layers.append({"k": k["q"], "k_s": k["s"], "v": v["q"], "v_s": v["s"]})
    return {key: torch.stack([layer[key] for layer in layers]) for key in layers[0]}


def precompute_cross_kv(model: Whisper, enc_out: torch.Tensor, cfg: WhisperConfig):
    """Cross-attention K/V for all layers: dense [L, 2, B, H, T_enc, Dh], or
    the int8 packs when the model is int8 (its token embedding is packed)."""
    if isinstance(model.decoder.tok_emb, QuantEmbedding):
        return _precompute_cross_kv_int8(model, enc_out, cfg)
    return precompute_cross_kv_dense(model, enc_out, cfg)


def cross_layer(cross_kv, i: int):
    """Layer ``i`` of either cross-KV form."""
    if isinstance(cross_kv, dict):
        return {key: val[i] for key, val in cross_kv.items()}
    return cross_kv[i]


def cross_attend(qc, ckv, batch: int, enc_len=None, beam: int = 1):
    """Cross-attention against one layer's cross-KV: dense [2, B, H, T_enc,
    Dh], or a dict of int8 packs [B, H, T_enc, *] (see ``cross_layer``).

    ``enc_len`` ([B]) masks encoder positions past the real audio; it is
    clamped to >= 1, because decode_attention over zero valid positions
    softmaxes uniformly over the cache.

    ``beam > 1``: qc carries B*K rows while ckv stays at B rows. The K beams
    fold into the query axis ([B*K, H, 1, D] -> [B, H, K, D]), one attention
    over the un-replicated memory, fold back. Only q_len == 1 is defined.
    """
    if beam > 1:
        bk, h, q_len, d = qc.shape
        if q_len != 1:
            raise ValueError(f"cross_attend with beam {beam} needs q_len 1, got {q_len}")
        b = bk // beam
        q_fold = qc.reshape(b, beam, h, d).transpose(1, 2)  # [B, H, K, D]
        out = cross_attend(q_fold, ckv, b, enc_len)
        return out.transpose(1, 2).reshape(bk, h, q_len, d)
    if enc_len is not None:
        enc_len = torch.clamp(enc_len, min=1)
    if isinstance(ckv, dict):
        if enc_len is None:
            enc_len = torch.full((batch,), ckv["k"].shape[2], dtype=torch.long, device=qc.device)
        return decode_attention(qc, ckv["k"], ckv["v"], enc_len,
                                k_scale=ckv["k_s"], v_scale=ckv["v_s"])
    if enc_len is None:
        enc_len = torch.full((batch,), ckv.shape[3], dtype=torch.long, device=qc.device)
    return decode_attention(qc, ckv[0], ckv[1], enc_len)


@torch.no_grad()
def decode_step(
    model: Whisper, tokens: torch.Tensor, pos: int, self_kv: torch.Tensor,
    cross_kv: torch.Tensor, cfg: WhisperConfig, enc_len=None,
    beam: int = 1, row_map=None,
):
    """One incremental decode position.

    tokens: [B, 1] (current input token); pos: position; self_kv:
    [L, 2, B, H, T_max, Dh], WRITTEN IN PLACE at ``pos`` (the JAX version
    donates and returns a new buffer; here the same tensor is returned).
    ``beam > 1``: tokens/self_kv carry B*K rows while cross_kv and enc_len
    stay at B rows (see cross_attend). ``row_map`` [B*K, T]: beam-ancestry
    physical-row table; self-attention then reads lineage rows in place.
    A position past the table reads its last row, as JAX's clamped
    ``dynamic_slice`` does (the speculative draft proposes such tokens).
    Returns (logits [B, vocab] float32, self_kv).
    """
    dec = model.decoder
    n_head = cfg.n_text_head
    b = tokens.shape[0]
    row = min(pos, dec.pos_emb.shape[0] - 1)
    x = embed_tokens(dec, tokens) + dec.pos_emb[row : row + 1]  # [B, 1, d]
    length = torch.full((b,), pos + 1, dtype=torch.long, device=x.device)
    for i, blk in enumerate(dec.blocks):
        hn = layer_norm(x, blk.ln1)
        q = _split_heads(linear(hn, blk.attn.q), n_head)
        self_kv[i, 0, :, :, pos : pos + 1] = _split_heads(linear(hn, blk.attn.k), n_head)
        self_kv[i, 1, :, :, pos : pos + 1] = _split_heads(linear(hn, blk.attn.v), n_head)
        k_cache, v_cache = self_kv[i, 0], self_kv[i, 1]
        if row_map is not None:
            attn = beam_select_attention(q, k_cache, v_cache, row_map, length, beam)
        else:
            attn = decode_attention(q, k_cache, v_cache, length)
        x = x + linear(_merge_heads(attn), blk.attn.o)
        hc = layer_norm(x, blk.ln_cross)
        qc = _split_heads(linear(hc, blk.cross.q), n_head)
        ckv = cross_layer(cross_kv, i)
        x = x + linear(_merge_heads(cross_attend(qc, ckv, b, enc_len, beam)), blk.cross.o)
        x = x + mlp(layer_norm(x, blk.ln_mlp), blk)
    logits = output_logits(layer_norm(x, dec.ln), dec)
    return logits[:, 0], self_kv
