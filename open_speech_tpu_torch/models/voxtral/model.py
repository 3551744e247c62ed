"""Voxtral (Mistral AI's audio-LLM transcriber) as PyTorch modules.

Architecture (mistralai/Voxtral-Small-24B-2507's ``config.json`` and the
``transformers`` Voxtral model):

  audio tower: Whisper's encoder, exactly: the port's ``AudioEncoder`` and
               ``models/whisper/model.py:encode`` (mel [B, n_mels, 3000] ->
               [B, 1500, d_audio])
  adapter:     [B, 1500, d_audio] row-major -> [B, 375, 4 d_audio] (four
               consecutive frames a position) -> linear_1 (no bias) -> GELU
               -> linear_2 (no bias) -> [B, 375, d]
  language model (``text_config``, Llama's layer equations): token
               embeddings, the audio positions taking the place of the
               ``[AUDIO]`` tokens' -> N x [RMSNorm, grouped-query attention
               with RoPE (rotate-half over the whole head), RMSNorm, SwiGLU]
               -> RMSNorm -> an untied head; no biases.

Weights are bf16; RMSNorm normalises in float32 and rounds before its gain,
as Llama's does; RoPE's rotation is computed in float32 from float32 angle
tables. The self-KV cache is [L, 2, S, H_kv, T, Dh]: ``prefill`` writes a
batch of prompts into the claimed slots in one causal pass, and
``decode_step`` appends one position a slot, each slot at its own position.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.models.whisper.model import AudioEncoder, WhisperConfig, encode
from open_speech_tpu_torch.ops.attention import decode_attention, flash_attention

FRAMES_PER_POSITION = 4  # encoder frames the adapter folds into one position


@dataclass(frozen=True)
class VoxtralConfig:
    audio: WhisperConfig  # the audio tower's shapes (its text fields are unused)
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    rope_theta: float
    rms_eps: float
    audio_token_id: int

    @classmethod
    def from_hf(cls, cfg: dict) -> "VoxtralConfig":
        """From the published ``config.json``'s keys: ``audio_config``,
        ``text_config``, ``projector_hidden_act`` and ``audio_token_id``."""
        a, t = cfg["audio_config"], cfg["text_config"]
        if a["intermediate_size"] != 4 * a["hidden_size"]:
            raise ValueError("the port's Whisper encoder has an MLP of 4 x d_model")
        if cfg.get("projector_hidden_act", "gelu") != "gelu" or t.get("hidden_act", "silu") != "silu":
            raise ValueError("Voxtral's adapter takes GELU and its language model SiLU")
        audio = WhisperConfig(
            n_mels=a["num_mel_bins"], n_vocab=a.get("vocab_size", 51866),
            n_audio_ctx=a["max_source_positions"], n_audio_state=a["hidden_size"],
            n_audio_head=a["num_attention_heads"], n_audio_layer=a["num_hidden_layers"],
        )
        return cls(
            audio=audio, hidden=t["hidden_size"],
            layers=t["num_hidden_layers"], heads=t["num_attention_heads"],
            kv_heads=t["num_key_value_heads"],
            head_dim=t.get("head_dim") or t["hidden_size"] // t["num_attention_heads"],
            ffn=t["intermediate_size"], vocab=t["vocab_size"], rope_theta=float(t["rope_theta"]),
            rms_eps=float(t["rms_norm_eps"]), audio_token_id=cfg["audio_token_id"],
        )

    @property
    def audio_positions(self) -> int:
        """Language-model positions of one 30 s window's audio."""
        return self.audio.n_audio_ctx // FRAMES_PER_POSITION

    @property
    def group(self) -> int:
        """Query heads per KV head."""
        return self.heads // self.kv_heads


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype))


class Adapter(nn.Module):
    def __init__(self, cfg: VoxtralConfig, dtype: torch.dtype) -> None:
        super().__init__()
        d_in = FRAMES_PER_POSITION * cfg.audio.n_audio_state
        self.linear_1 = nn.Linear(d_in, cfg.hidden, bias=False, dtype=dtype)
        self.linear_2 = nn.Linear(cfg.hidden, cfg.hidden, bias=False, dtype=dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: VoxtralConfig, dtype: torch.dtype) -> None:
        super().__init__()
        d, hd = cfg.hidden, cfg.head_dim
        self.attn_norm = RMSNorm(d, dtype)
        self.q = nn.Linear(d, cfg.heads * hd, bias=False, dtype=dtype)
        self.k = nn.Linear(d, cfg.kv_heads * hd, bias=False, dtype=dtype)
        self.v = nn.Linear(d, cfg.kv_heads * hd, bias=False, dtype=dtype)
        self.o = nn.Linear(cfg.heads * hd, d, bias=False, dtype=dtype)
        self.mlp_norm = RMSNorm(d, dtype)
        self.gate = nn.Linear(d, cfg.ffn, bias=False, dtype=dtype)
        self.up = nn.Linear(d, cfg.ffn, bias=False, dtype=dtype)
        self.down = nn.Linear(cfg.ffn, d, bias=False, dtype=dtype)


class Voxtral(nn.Module):
    def __init__(self, cfg: VoxtralConfig, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg.audio, dtype)
        self.adapter = Adapter(cfg, dtype)
        self.embed = nn.Parameter(torch.zeros(cfg.vocab, cfg.hidden, dtype=dtype))
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype) for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.hidden, dtype)
        self.head = nn.Linear(cfg.hidden, cfg.vocab, bias=False, dtype=dtype)

    @classmethod
    def empty(cls, cfg: VoxtralConfig, dtype: torch.dtype, device) -> "Voxtral":
        """Uninitialised storage on ``device``: built on the meta device so
        no initialiser runs; the caller fills every tensor."""
        with torch.device("meta"):
            model = cls(cfg, dtype)
        return model.to_empty(device=device).requires_grad_(False).eval()

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ──────────────────────────────────────────────────────────────────────
# Layers
# ──────────────────────────────────────────────────────────────────────


def rms_norm(x: torch.Tensor, norm: RMSNorm, eps: float) -> torch.Tensor:
    """Llama's RMSNorm: normalise in float32, round to the input's dtype,
    then the gain."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return norm.weight * normed.to(x.dtype)


def rope_tables(cfg: VoxtralConfig, length: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [length, head_dim] float32 of positions 0..length-1: angle
    p * theta^(-2i / head_dim) at i and i + head_dim / 2 (rotate-half)."""
    half = cfg.head_dim // 2
    inv = cfg.rope_theta ** (-torch.arange(half, dtype=torch.float64, device=device) / half)
    angles = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    angles = torch.cat([angles, angles], dim=-1)
    return angles.cos().float(), angles.sin().float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, Dh] rotated by cos/sin [T, Dh] (or broadcastable), in
    float32, back in x's dtype."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rotated * sin).to(x.dtype)


def swiglu(x: torch.Tensor, layer: DecoderLayer) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, layer.gate.weight)) * F.linear(x, layer.up.weight),
                    layer.down.weight)


def adapt(model: Voxtral, enc_out: torch.Tensor) -> torch.Tensor:
    """Encoder states [B, T_enc, d_audio] -> audio embeddings [B, T_enc / 4,
    hidden]: four consecutive frames a position, then the adapter."""
    b, t, d = enc_out.shape
    x = enc_out.reshape(b, t // FRAMES_PER_POSITION, FRAMES_PER_POSITION * d)
    return F.linear(F.gelu(F.linear(x, model.adapter.linear_1.weight)), model.adapter.linear_2.weight)


def encode_audio(model: Voxtral, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> audio embeddings [B, 375, hidden]: Whisper's
    ``encode`` on the audio tower, then the adapter."""
    return adapt(model, encode(model, mel, model.cfg.audio))


def prompt_embeddings(model: Voxtral, ids: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """ids [P] (one prompt for every window) and audio embeddings [B, A,
    hidden] -> [B, P, hidden]: the token embeddings, with the A ``[AUDIO]``
    positions, in order, taking the windows' audio embeddings (a gather and
    a select on the device: no read of the ids on the host)."""
    is_audio = ids == model.cfg.audio_token_id
    nth = (torch.cumsum(is_audio, 0) - 1).clamp(min=0)  # each position's audio row
    return torch.where(is_audio[None, :, None], audio[:, nth].to(model.embed.dtype),
                       model.embed[ids][None])


@torch.no_grad()
def prefill(model: Voxtral, audio: torch.Tensor, ids: torch.Tensor, cache: torch.Tensor,
            slots: torch.Tensor) -> None:
    """One dense causal pass over B prompts of the same ``ids`` [P], whose
    ``[AUDIO]`` positions take ``audio`` [B, A, hidden], at positions
    0..P-1: writes every layer's K and V into ``cache`` [L, 2, S, H_kv, T,
    Dh] rows ``slots`` [B], positions 0..P-1, in place. Attention is K1 at
    D = 128 with the grouped KV heads read in place (``flash_attention``).
    No logits: the caller feeds the prompt's last token as the first
    decode step."""
    cfg = model.cfg
    b, p = audio.shape[0], ids.shape[0]
    cos, sin = rope_tables(cfg, p, audio.device)
    x = prompt_embeddings(model, ids, audio)  # [B, P, d]
    hd = cfg.head_dim
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.rms_eps)
        q = F.linear(h, layer.q.weight).view(b, p, cfg.heads, hd).transpose(1, 2)
        k = F.linear(h, layer.k.weight).view(b, p, cfg.kv_heads, hd).transpose(1, 2)
        v = F.linear(h, layer.v.weight).view(b, p, cfg.kv_heads, hd).transpose(1, 2).contiguous()
        q, k = apply_rope(q, cos, sin).contiguous(), apply_rope(k, cos, sin).contiguous()
        cache[i, 0, slots, :, :p] = k.to(cache.dtype)
        cache[i, 1, slots, :, :p] = v.to(cache.dtype)
        out = flash_attention(q, k, v, causal=True)  # [B, H, P, Dh]
        x = x + F.linear(out.transpose(1, 2).reshape(b, p, cfg.heads * hd), layer.o.weight)
        x = x + swiglu(rms_norm(x, layer.mlp_norm, cfg.rms_eps), layer)


@torch.no_grad()
def decode_step(model: Voxtral, tokens: torch.Tensor, pos: torch.Tensor, cache: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One position for every slot, each at its own position: tokens [S],
    pos [S] (the position each token takes), ``rope`` the (cos, sin) tables
    of ``rope_tables`` over the cache's positions. Writes K and V at each
    slot's position (clamped to the cache) IN PLACE; returns the logits
    [S, vocab] in float32. Attention folds each KV head's group of query
    heads into the decode kernel's query rows: q [S, H_kv, g, Dh] against
    the cache's [S, H_kv, T, Dh] layer views, with no copy of the cache."""
    cfg = model.cfg
    s, hd = tokens.shape[0], cfg.head_dim
    rows = torch.arange(s, device=tokens.device)
    at = pos.clamp(0, cache.shape[4] - 1)
    cos, sin = rope[0][at][:, None], rope[1][at][:, None]  # [S, 1, Dh]
    length = at + 1
    x = model.embed[tokens]  # [S, d]
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.rms_eps)
        q = apply_rope(F.linear(h, layer.q.weight).view(s, cfg.heads, hd), cos, sin)
        k = apply_rope(F.linear(h, layer.k.weight).view(s, cfg.kv_heads, hd), cos, sin)
        cache[i, 0, rows, :, at] = k.to(cache.dtype)
        cache[i, 1, rows, :, at] = F.linear(h, layer.v.weight).view(s, cfg.kv_heads, hd).to(cache.dtype)
        out = decode_attention(q.view(s, cfg.kv_heads, cfg.group, hd), cache[i, 0], cache[i, 1],
                               length)
        x = x + F.linear(out.reshape(s, cfg.heads * hd), layer.o.weight)
        x = x + swiglu(rms_norm(x, layer.mlp_norm, cfg.rms_eps), layer)
    return F.linear(rms_norm(x, model.norm, cfg.rms_eps), model.head.weight).float()
