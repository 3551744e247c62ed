"""Pocket-TTS language model in PyTorch: the delayed-streams transformer over
Mimi tokens, held against the JAX model.

Counterpart of ``open_speech_tpu/models/pocket/lm.py``:

  - a **temporal transformer** (RMSNorm eps 1e-8, interleaved RoPE rotated
    in float32, SiLU-gated MLP, causal) consumes, per 12.5 Hz step, the sum
    of one text-token embedding and one embedding per audio codebook;
  - a **depth transformer** ("depformer") with per-stage attention and MLP
    weights predicts the n_q codebooks of the next frame one stage at a
    time, each conditioned on the temporal hidden plus the previous
    codebook's token embedding;
  - the acoustic streams lag the semantic one by ``acoustic_delay`` steps.

The weights are the JAX package's tree as an ``nn.Module`` (``ParamTree``):
dicts are submodules, lists ``ModuleList``s, arrays buffers, with the JAX
names and layouts (per-layer weights stacked on a leading axis, linears
[in, out]), so ``p["layers"]["qkv"]["w"][i]`` reads as it does in JAX.
The stages are functions of (params, cfg, tensors).

KV caches are [L, B, H, max_ctx, Dh] tensors written in place:
``temporal_prefill`` writes each row's valid positions only (a row with
length 0 keeps its cache untouched, and a bucket-padded prefill leaves the
cache an exact one leaves), and ``temporal_step`` writes one position per
row. Callers that must keep a cache (a voice's prompt state) pass a copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.ops.attention import decode_attention
from open_speech_tpu_torch.ops.vocoder import tts_device

# moshi-family RMSNorm epsilon (transformers MoshiConfig rms_norm_eps=1e-8)
RMS_EPS = 1e-8
_MASKED = -1e30  # the JAX model's masked logit


@dataclass(frozen=True)
class PocketLMConfig:
    # temporal transformer
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 16
    ff: int = 4096  # gated-SiLU hidden = 2*ff//3
    # depth transformer (per-stage weights)
    dep_d_model: int = 256
    dep_heads: int = 8
    dep_layers: int = 4
    dep_ff: int = 1024
    # token spaces
    n_q: int = 8
    card: int = 2048
    text_card: int = 4000
    acoustic_delay: int = 2
    max_ctx: int = 1536  # KV-cache capacity in steps
    # text special-token ids: 0/1/2 for random weights; a release's
    # config.json overrides them (convert.load_checkpoint)
    text_pad_id: int = 0
    text_bos_id: int = 1
    text_eos_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def hidden(self) -> int:
        return 2 * self.ff // 3

    @property
    def dep_hidden(self) -> int:
        return 2 * self.dep_ff // 3

    @property
    def audio_initial(self) -> int:
        """Embedding row for 'not generated yet' (moshi initial token)."""
        return self.card

    @property
    def text_initial(self) -> int:
        return self.text_card

    @property
    def delays(self) -> tuple[int, ...]:
        return (0,) + (self.acoustic_delay,) * (self.n_q - 1)

    @property
    def max_delay(self) -> int:
        return max(self.delays)


TEST_TINY_LM = PocketLMConfig(
    d_model=32,
    n_heads=2,
    n_layers=2,
    ff=48,
    dep_d_model=16,
    dep_heads=2,
    dep_layers=2,
    dep_ff=24,
    n_q=4,
    card=32,
    text_card=64,
    max_ctx=128,
)


class ParamTree(nn.Module):
    """A nested dict of arrays as an ``nn.Module``: dicts become submodules,
    lists ``ModuleList``s, arrays buffers (float32 unless integer). Indexing
    by key reads a child, as the JAX tree is indexed."""

    def __init__(self, tree: dict, device=None) -> None:
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value, device))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v, device) for v in value))
            else:
                t = value.to(device) if isinstance(value, torch.Tensor) else torch.tensor(value, device=device)
                self.register_buffer(key, t.float() if t.is_floating_point() else t)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._buffers or key in self._modules

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device


def _at(tree: ParamTree, i: int) -> dict:
    """Layer ``i`` of a tree whose arrays stack layers on axis 0."""
    out = {k: v[i] for k, v in tree._buffers.items()}
    out.update({k: _at(m, i) for k, m in tree._modules.items()})
    return out


def _layers(tree: ParamTree) -> list[dict]:
    n = next(iter(tree.buffers())).shape[0]
    return [_at(tree, i) for i in range(n)]


# ──────────────────────────────────────────────────────────────────────
# init
# ──────────────────────────────────────────────────────────────────────


def init_pocket_lm_params(generator: torch.Generator, cfg: PocketLMConfig, device=None) -> ParamTree:
    """Random weights with the JAX package's shapes and scales (normal
    times fan_in^-0.5, embeddings x0.02, RMS gains 1), drawn from
    ``generator`` on its device, then moved to ``device``
    (``settings.tts_effective_device`` when None). The values are
    ``torch.Generator``'s, not ``jax.random``'s."""
    d, dd, k_q = cfg.d_model, cfg.dep_d_model, cfg.n_q

    def normal(*shape, scale: float) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=generator.device) * scale

    def ones(*shape):
        return torch.ones(shape, device=generator.device)

    nl, hid = cfg.n_layers, cfg.hidden
    layers = {
        "ln1": {"a": ones(nl, d)},
        "qkv": {"w": normal(nl, d, 3 * d, scale=d**-0.5)},
        "out": {"w": normal(nl, d, d, scale=d**-0.5)},
        "ln2": {"a": ones(nl, d)},
        "gate_in": {"w": normal(nl, d, 2 * hid, scale=d**-0.5)},
        "gate_out": {"w": normal(nl, hid, d, scale=hid**-0.5)},
    }
    dl, dh = cfg.dep_layers, cfg.dep_hidden
    dep_layers = {
        "ln1": {"a": ones(dl, dd)},
        "qkv": {"w": normal(dl, k_q, dd, 3 * dd, scale=dd**-0.5)},
        "out": {"w": normal(dl, k_q, dd, dd, scale=dd**-0.5)},
        "ln2": {"a": ones(dl, dd)},
        "gate_in": {"w": normal(dl, k_q, dd, 2 * dh, scale=dd**-0.5)},
        "gate_out": {"w": normal(dl, k_q, dh, dd, scale=dh**-0.5)},
    }
    tree = {
        "text_emb": normal(cfg.text_card + 1, d, scale=0.02),
        "emb": normal(k_q, cfg.card + 1, d, scale=0.02),
        "layers": layers,
        "out_norm": {"a": ones(d)},
        "text_linear": {"w": normal(d, cfg.text_card, scale=d**-0.5)},
        "dep_in": normal(k_q, d, dd, scale=d**-0.5),
        "dep_text_emb": normal(cfg.text_card + 1, dd, scale=0.02),
        "dep_emb": normal(k_q - 1, cfg.card + 1, dd, scale=0.02),
        "dep_layers": dep_layers,
        "linears": normal(k_q, dd, cfg.card, scale=dd**-0.5),
    }
    return ParamTree(tree, tts_device(device)).requires_grad_(False)


# ──────────────────────────────────────────────────────────────────────
# shared pieces
# ──────────────────────────────────────────────────────────────────────


def _rms(x: torch.Tensor, p) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + RMS_EPS)
    return (x32 * scale * p["a"]).to(x.dtype)


def _rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, head_dim: int):
    """Interleaved-pair RoPE on [B, H, T, D]; ``positions`` is [T] (shared
    by the batch) or [B, T] (per row). Rotated in float32, returned in the
    input's dtype."""
    half = head_dim // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32, device=q.device) / half)
    ang = positions[..., None].float() * freqs  # [..., T, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.dim() == 2:  # [T, half] -> [1, 1, T, half]
        cos, sin = cos[None, None], sin[None, None]
    else:  # [B, T, half] -> [B, 1, T, half]
        cos, sin = cos[:, None], sin[:, None]

    def rot(x: torch.Tensor) -> torch.Tensor:
        xr = x.reshape(*x.shape[:-1], half, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1).reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


def _gated_mlp(x: torch.Tensor, p) -> torch.Tensor:
    a, b = (x @ p["gate_in"]["w"]).chunk(2, dim=-1)
    return (F.silu(a) * b) @ p["gate_out"]["w"]


def _embed(table: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Per-codebook embeddings summed: table [K, V, D], toks [..., K] -> [..., D]."""
    k = table.shape[0]
    rows = torch.arange(k, device=toks.device).expand(toks.shape)
    return table[rows, toks].sum(dim=-2)


def embed_step(params, cfg: PocketLMConfig, text_tok: torch.Tensor, audio_toks: torch.Tensor) -> torch.Tensor:
    """Input embedding: text [B] + per-codebook audio [B, n_q] -> [B, D]."""
    return params["text_emb"][text_tok] + _embed(params["emb"], audio_toks)


def embed_grid(params, text_toks: torch.Tensor, audio_grid: torch.Tensor) -> torch.Tensor:
    """Teacher-forced inputs: text [B, T] + audio [B, n_q, T] -> [B, T, D]."""
    return params["text_emb"][text_toks] + _embed(params["emb"], audio_grid.transpose(1, 2))


def _attend(q, kc, vc, mask, scale):
    logits = torch.matmul(q.float(), kc.float().transpose(-1, -2)) * scale
    probs = torch.softmax(torch.where(mask, logits, _MASKED), dim=-1).to(vc.dtype)
    return torch.matmul(probs, vc)


# ──────────────────────────────────────────────────────────────────────
# temporal transformer
# ──────────────────────────────────────────────────────────────────────


def init_caches(cfg: PocketLMConfig, batch: int, dtype=torch.float32, device=None):
    shape = (cfg.n_layers, batch, cfg.n_heads, cfg.max_ctx, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _as_rows(v, b: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device).reshape(-1).expand(b)


def temporal_prefill(params, cfg: PocketLMConfig, x: torch.Tensor, caches, start, length=None):
    """Causal forward over a segment, writing its K/V into the caches.

    x [B, T, D]; caches (k, v) each [L, B, H, max_ctx, Dh], written in
    place; ``start`` (int or [B]): row b's segment occupies global positions
    [start_b, start_b + T). Queries attend to everything already in the
    cache plus the causal prefix of the segment. ``length`` (int or [B],
    default T) is the valid prefix: keys past start + length are masked,
    and only valid positions are written, so a bucket-padded prefill
    leaves the caches an exact one leaves and a row with length 0 keeps
    its cache untouched. Returns (hidden [B, T, D], caches)."""
    b, t, d = x.shape
    nh, hd, ctx = cfg.n_heads, cfg.head_dim, cfg.max_ctx
    dev = x.device
    start_v = _as_rows(start, b, dev)
    length_v = _as_rows(t if length is None else length, b, dev)
    steps = torch.arange(t, device=dev)
    positions = start_v[:, None] + steps  # [B, T]
    gj = torch.arange(ctx, device=dev)[None, None, :]
    mask = (gj <= positions[:, :, None]) & (gj < (start_v + length_v)[:, None, None])
    mask = mask[:, None]  # [B, 1, T, ctx]
    # each valid step's cache slot; the others rewrite their old value at a
    # slot no valid step of the row writes (no slot gets two values)
    valid = steps[None, :] < length_v[:, None]
    spare = torch.where(start_v + length_v < ctx, start_v + length_v, start_v - 1).clamp(min=0)
    slots = torch.where(valid, positions, spare[:, None]).clamp(max=ctx - 1)
    rows = torch.arange(b, device=dev)[:, None].expand(b, t)
    k_cache, v_cache = caches

    def write(cache: torch.Tensor, new: torch.Tensor) -> None:  # new [B, H, T, Dh]
        new = new.transpose(1, 2).to(cache.dtype)  # [B, T, H, Dh], as cache[rows, :, slots]
        cache[rows, :, slots] = torch.where(valid[:, :, None, None], new, cache[rows, :, slots])

    h = x
    for i, p in enumerate(_layers(params["layers"])):
        hn = _rms(h, p["ln1"])
        q, k, v = (hn @ p["qkv"]["w"]).chunk(3, dim=-1)
        q = q.reshape(b, t, nh, hd).transpose(1, 2)
        k = k.reshape(b, t, nh, hd).transpose(1, 2)
        v = v.reshape(b, t, nh, hd).transpose(1, 2)
        q, k = _rope(q, k, positions, hd)
        kc, vc = k_cache[i], v_cache[i]
        write(kc, k)
        write(vc, v)
        att = _attend(q, kc, vc, mask, hd**-0.5)
        h = h + att.transpose(1, 2).reshape(b, t, d) @ p["out"]["w"]
        h = h + _gated_mlp(_rms(h, p["ln2"]), p)
    return h, caches


def temporal_step(params, cfg: PocketLMConfig, x: torch.Tensor, caches, pos: torch.Tensor):
    """One decode step. x [B, D], pos [B] -> (hidden [B, D], caches); row b
    writes its K/V at ``pos[b]`` (clamped to the cache, as the JAX write
    is) and attends to positions <= pos[b], through ``decode_attention``."""
    b, d = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    k_cache, v_cache = caches
    rows = torch.arange(b, device=x.device)
    slot = pos.clamp(0, cfg.max_ctx - 1)
    h = x
    for i, p in enumerate(_layers(params["layers"])):
        hn = _rms(h, p["ln1"])
        q, k, v = (hn @ p["qkv"]["w"]).chunk(3, dim=-1)
        q = q.reshape(b, 1, nh, hd).transpose(1, 2)
        k = k.reshape(b, 1, nh, hd).transpose(1, 2)
        v = v.reshape(b, 1, nh, hd)
        q, k = _rope(q, k, pos[:, None], hd)
        kc, vc = k_cache[i], v_cache[i]
        kc[rows, :, slot] = k[:, :, 0].to(kc.dtype)
        vc[rows, :, slot] = v[:, 0].to(vc.dtype)
        att = decode_attention(q, kc, vc, pos + 1)
        h = h + att.transpose(1, 2).reshape(b, d) @ p["out"]["w"]
        h = h + _gated_mlp(_rms(h, p["ln2"]), p)
    return h, caches


# ──────────────────────────────────────────────────────────────────────
# depth transformer
# ──────────────────────────────────────────────────────────────────────


def _dep_stage_inputs(params, cfg: PocketLMConfig, h, text_tok, audio_toks):
    """Stage inputs [B, n_q, Dd]: dep_in_s(h) + the previous token's embedding."""
    proj = torch.einsum("bd,kde->bke", h, params["dep_in"])
    prev0 = params["dep_text_emb"][text_tok]  # [B, Dd]
    rest = audio_toks[:, : cfg.n_q - 1]
    stage = torch.arange(cfg.n_q - 1, device=h.device).expand(rest.shape)
    prev = torch.cat([prev0[:, None], params["dep_emb"][stage, rest]], dim=1)
    return proj + prev


def depformer_forward(params, cfg: PocketLMConfig, h, text_tok, audio_toks):
    """Teacher-forced depth pass -> logits [B, n_q, card].

    h: temporal hidden [B, D]; text_tok [B]; audio_toks [B, n_q] are the
    target frame's tokens (stage s sees tokens < s)."""
    b = h.shape[0]
    nh, hd, kq = cfg.dep_heads, cfg.dep_d_model // cfg.dep_heads, cfg.n_q
    x = _dep_stage_inputs(params, cfg, h, text_tok, audio_toks)
    s = torch.arange(kq, device=h.device)
    mask = (s[None, :] <= s[:, None])[None, None]
    for p in _layers(params["dep_layers"]):
        hn = _rms(x, p["ln1"])
        q, k, v = torch.einsum("bkd,kde->bke", hn, p["qkv"]["w"]).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, kq, nh, hd).transpose(1, 2) for t in (q, k, v))
        att = _attend(q, k, v, mask, hd**-0.5).transpose(1, 2).reshape(b, kq, cfg.dep_d_model)
        x = x + torch.einsum("bkd,kde->bke", att, p["out"]["w"])
        a_g, b_g = torch.einsum("bkd,kde->bke", _rms(x, p["ln2"]), p["gate_in"]["w"]).chunk(2, dim=-1)
        x = x + torch.einsum("bkh,khd->bkd", F.silu(a_g) * b_g, p["gate_out"]["w"])
    return torch.einsum("bkd,kdc->bkc", x, params["linears"])


def depformer_sample(params, cfg: PocketLMConfig, h, text_tok, temp: float = 0.0,
                     generator: torch.Generator | None = None, *, logits_out: list | None = None):
    """Depth sampling -> tokens [B, n_q], one single-position pass per stage
    over per-layer stage K/V caches (O(n_q) depth work per frame). ``temp``
    <= 0 takes the argmax; otherwise each stage samples from
    softmax(logits / temp) with ``generator``. ``logits_out``, when given,
    receives each stage's logits [B, card]."""
    b = h.shape[0]
    nh, hd, kq = cfg.dep_heads, cfg.dep_d_model // cfg.dep_heads, cfg.n_q
    layers = _layers(params["dep_layers"])
    dt = params["dep_layers"]["qkv"]["w"].dtype
    toks = torch.full((b, kq), cfg.audio_initial, dtype=torch.int64, device=h.device)
    kc = torch.zeros((len(layers), b, nh, kq, hd), dtype=dt, device=h.device)
    vc = torch.zeros_like(kc)
    proj = torch.einsum("bd,kde->kbe", h, params["dep_in"])  # [n_q, B, Dd]
    for s in range(kq):
        prev = params["dep_text_emb"][text_tok] if s == 0 else params["dep_emb"][s - 1][toks[:, s - 1]]
        x = proj[s] + prev
        for i, p in enumerate(layers):
            hn = _rms(x, p["ln1"])
            q, k, v = (hn @ p["qkv"]["w"][s]).chunk(3, dim=-1)
            kc[i, :, :, s] = k.reshape(b, nh, hd).to(dt)
            vc[i, :, :, s] = v.reshape(b, nh, hd).to(dt)
            # stages 0..s are live: attend over them alone
            logits = torch.einsum("bhd,bhkd->bhk", q.reshape(b, nh, hd).float(),
                                  kc[i, :, :, : s + 1].float()) * hd**-0.5
            probs = torch.softmax(logits, -1).to(dt)
            att = torch.einsum("bhk,bhkd->bhd", probs, vc[i, :, :, : s + 1])
            x = x + att.reshape(b, cfg.dep_d_model).to(x.dtype) @ p["out"]["w"][s]
            a_g, b_g = (_rms(x, p["ln2"]) @ p["gate_in"]["w"][s]).chunk(2, dim=-1)
            x = x + (F.silu(a_g) * b_g) @ p["gate_out"]["w"][s]
        logits = x @ params["linears"][s]
        if logits_out is not None:
            logits_out.append(logits)
        if temp > 0:
            probs = torch.softmax(logits.float() / max(temp, 1e-6), -1)
            toks[:, s] = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            toks[:, s] = torch.argmax(logits, -1)
    return toks


# ──────────────────────────────────────────────────────────────────────
# full-sequence forward (teacher forcing, parity)
# ──────────────────────────────────────────────────────────────────────


def lm_forward(params, cfg: PocketLMConfig, text_tokens: torch.Tensor, audio_tokens: torch.Tensor):
    """Teacher-forced forward over T steps.

    text_tokens [B, T]; audio_tokens [B, n_q, T] delayed-timeline inputs.
    Returns (text_logits [B, T, text_card], audio_logits [B, T, n_q, card],
    caches): audio_logits[:, t] are the depformer's outputs conditioned on
    the next step's target prefix."""
    b, t = text_tokens.shape
    dev = text_tokens.device
    x = embed_grid(params, text_tokens, audio_tokens)
    caches = init_caches(cfg, b, params["text_emb"].dtype, dev)
    h, caches = temporal_prefill(params, cfg, x, caches, 0)
    hn = _rms(h, params["out_norm"])
    text_logits = hn @ params["text_linear"]["w"]
    nxt_text = torch.cat([text_tokens[:, 1:], torch.full((b, 1), cfg.text_initial, device=dev,
                                                         dtype=text_tokens.dtype)], 1)
    nxt_audio = torch.cat([audio_tokens[:, :, 1:], torch.full((b, cfg.n_q, 1), cfg.audio_initial, device=dev,
                                                              dtype=audio_tokens.dtype)], 2)
    dep = depformer_forward(params, cfg, hn.reshape(b * t, -1), nxt_text.reshape(-1),
                            nxt_audio.transpose(1, 2).reshape(b * t, cfg.n_q))
    return text_logits, dep.reshape(b, t, cfg.n_q, cfg.card), caches
