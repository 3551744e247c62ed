"""Kokoro-82M in PyTorch: the KModel graph, held against the JAX model.

Counterpart of ``open_speech_tpu/models/kokoro/model.py`` (hexgrad's
StyleTTS2-derived KModel):

  phoneme ids
    -> PL-BERT (ALBERT: 128-dim embeddings, one shared 768-wide layer
       iterated 12x) -> linear to 512
    -> prosody predictor: style-conditioned duration encoder (biLSTM +
       AdaLayerNorm pairs), sigmoid-sum duration head, shared biLSTM and
       AdaIN residual stacks for F0 and energy at 2x frames
    -> text encoder (embedding, convs, biLSTM)
    -> hard alignment (each frame takes the phoneme whose cumulative
       duration covers it)
    -> ISTFTNet decoder: AdaIN residual blocks, then the harmonic-source
       generator (sine harmonics from F0, their STFT features added into
       the upsampling stages) -> exp/sin spectrum -> inverse STFT, 24 kHz.

The weights live in ``KModel``, an ``nn.Module`` tree named as the
published ``kokoro-v1_0.pth`` checkpoint names its tensors (see
``convert.py``); the stages are functions of (model, cfg, tensors), as the
JAX package's are of (params, cfg, arrays). Everything runs in float32.
The phoneme axis is padded to ``cfg.max_phonemes`` and the frame axis to
``cfg.max_frames``, with masked statistics, so a padded row computes what
an exact-length row computes on its valid prefix.

Layouts: the text side is [B, T, C], as in the JAX package; the convolution
stacks (F0/N heads, decoder, generator) are channel-first [B, C, T], with
masks [B, 1, T], so the harmonic-STFT features are [B, n_fft+2, frames]
where the JAX package has [B, frames, n_fft+2]. ``decode_audio`` returns
x as [B, C, 2F].

On the card, convolutions and LSTMs run through cuDNN with TF32 off inside
the entry points (``_inference``); matmuls are float32 by PyTorch's default.
"""

from __future__ import annotations

import hashlib
import math
import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.ops.vocoder import (
    CUDNN_F32 as _CUDNN,
    _synthesis_basis,
    compress_durations,
    conv1d,
    conv_transpose1d,
    layer_norm,
)
from open_speech_tpu_torch.ops.vocoder import inference as _inference
from open_speech_tpu_torch.ops.vocoder import tts_device as _tts_device

SAMPLE_RATE = 24_000
# streamed blocks overlap their neighbours by this many alignment frames
HALO_FRAMES = 16


@dataclass(frozen=True)
class KokoroConfig:
    n_symbols: int = 178
    # PL-BERT (ALBERT)
    plbert_emb: int = 128
    plbert_hidden: int = 768
    plbert_heads: int = 12
    plbert_interm: int = 2048
    plbert_layers: int = 12
    max_positions: int = 512
    # prosody predictor / text encoder
    hidden: int = 512
    style_dim: int = 128  # per component; the voice vector is 2x this
    max_dur: int = 50
    text_kernel: int = 5
    text_depth: int = 3
    dur_layers: int = 3
    # istftnet decoder
    dec_mid: int = 1024
    dec_blocks: int = 4  # decode stack depth (the last block upsamples)
    asr_res_dim: int = 64
    upsample_rates: tuple[int, ...] = (10, 6)
    upsample_kernels: tuple[int, ...] = (20, 12)
    resblock_kernels: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5),) * 3
    noise_res_kernels: tuple[int, ...] = (7, 11)
    gen_n_fft: int = 20
    gen_hop: int = 5
    harmonics: int = 8
    sine_amp: float = 0.1
    noise_std: float = 0.003
    voiced_threshold: float = 10.0
    sample_rate: int = SAMPLE_RATE
    # serving buckets (alignment frames; 1 frame = 25 ms at 24 kHz)
    max_phonemes: int = 256
    max_frames: int = 480

    @property
    def upsample_total(self) -> int:
        r = 2  # the F0 path runs at 2x alignment frames
        for u in self.upsample_rates:
            r *= u
        return r * self.gen_hop

    @property
    def samples_per_frame(self) -> int:
        return self.upsample_total  # 600 for (10, 6) x 5

    @property
    def voice_dim(self) -> int:
        return 2 * self.style_dim


# Reduced geometry with the full kokoro topology (real upsample and iSTFT
# rates, every module present) for tests: OS_KOKORO_GEOMETRY=tiny.
TINY_CONFIG = KokoroConfig(
    plbert_emb=32,
    plbert_hidden=64,
    plbert_heads=4,
    plbert_interm=128,
    plbert_layers=2,
    hidden=64,
    style_dim=16,
    # random-init durations are about max_dur/2 frames per phoneme
    max_dur=8,
    text_depth=2,
    dur_layers=2,
    dec_mid=96,
    asr_res_dim=16,
    max_phonemes=128,
    max_frames=160,
)


def resolve_kokoro_config() -> KokoroConfig:
    """Serving geometry: kokoro-82M unless OS_KOKORO_GEOMETRY=tiny."""
    if os.environ.get("OS_KOKORO_GEOMETRY", "").lower() == "tiny":
        return TINY_CONFIG
    return KokoroConfig()


def voice_vector(name: str, voice_dim: int = 256) -> np.ndarray:
    """Deterministic per-voice vector for when no voice pack is on disk.

    ``voice_dim`` is the whole voice-pack row, decoder style then prosody
    style (``cfg.voice_dim``). With a voice pack, use
    ``convert.convert_voice_pack`` and ``convert.select_voice_style``."""
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(voice_dim) * 0.1).astype(np.float32)


# ──────────────────────────────────────────────────────────────────────
# modules (named as the checkpoint names its tensors)
# ──────────────────────────────────────────────────────────────────────


def _container(**children: nn.Module) -> nn.Module:
    mod = nn.Module()
    for name, child in children.items():
        setattr(mod, name, child)
    return mod


class BiLSTM(nn.Module):
    """A bidirectional LSTM kept as two unidirectional ones, so ``bilstm``
    can run the backward one over each row reversed within its own length
    (the checkpoint's ``*_reverse`` tensors are ``bw``'s)."""

    def __init__(self, d_in: int, hidden: int) -> None:
        super().__init__()
        self.fw = nn.LSTM(d_in, hidden, batch_first=True)
        self.bw = nn.LSTM(d_in, hidden, batch_first=True)


class AdaNorm(nn.Module):
    """AdaIN1d or AdaLayerNorm: the style predicts (gamma, beta)."""

    def __init__(self, style_dim: int, c: int) -> None:
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * c)


class ChannelLayerNorm(nn.Module):
    """StyleTTS2's LayerNorm over channels (tensors ``gamma``, ``beta``)."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))


class AdainResBlk1d(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int, upsample: bool = False) -> None:
        super().__init__()
        self.conv1 = nn.Conv1d(cin, cout, 3)
        self.conv2 = nn.Conv1d(cout, cout, 3)
        self.norm1 = AdaNorm(style_dim, cin)
        self.norm2 = AdaNorm(style_dim, cout)
        if upsample:  # depthwise ConvTranspose1d(k=3, stride=2, pad=1, output_pad=1)
            self.pool = nn.ConvTranspose1d(cin, cin, 3, groups=cin)
        if cin != cout:
            self.conv1x1 = nn.Conv1d(cin, cout, 1, bias=False)


class AdaINResBlock1(nn.Module):
    """ISTFTNet's AdaINResBlock1 with snake activations."""

    def __init__(self, c: int, k: int, style_dim: int, n: int = 3) -> None:
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(c, c, k) for _ in range(n))
        self.convs2 = nn.ModuleList(nn.Conv1d(c, c, k) for _ in range(n))
        self.adain1 = nn.ModuleList(AdaNorm(style_dim, c) for _ in range(n))
        self.adain2 = nn.ModuleList(AdaNorm(style_dim, c) for _ in range(n))
        self.alpha1 = nn.ParameterList(nn.Parameter(torch.ones(1, c, 1)) for _ in range(n))
        self.alpha2 = nn.ParameterList(nn.Parameter(torch.ones(1, c, 1)) for _ in range(n))


def _albert(cfg: KokoroConfig) -> nn.Module:
    e, h = cfg.plbert_emb, cfg.plbert_hidden
    layer = _container(
        attention=_container(
            query=nn.Linear(h, h), key=nn.Linear(h, h), value=nn.Linear(h, h),
            dense=nn.Linear(h, h), LayerNorm=nn.LayerNorm(h),
        ),
        ffn=nn.Linear(h, cfg.plbert_interm),
        ffn_output=nn.Linear(cfg.plbert_interm, h),
        full_layer_layer_norm=nn.LayerNorm(h),
    )
    return _container(
        embeddings=_container(
            word_embeddings=nn.Embedding(cfg.n_symbols, e),
            position_embeddings=nn.Embedding(cfg.max_positions, e),
            token_type_embeddings=nn.Embedding(2, e),
            LayerNorm=nn.LayerNorm(e),
        ),
        encoder=_container(
            embedding_hidden_mapping_in=nn.Linear(e, h),
            albert_layer_groups=nn.ModuleList(
                [_container(albert_layers=nn.ModuleList([layer]))]
            ),
        ),
    )


def _predictor(cfg: KokoroConfig) -> nn.Module:
    hid, sty = cfg.hidden, cfg.style_dim
    lstms = []
    for _ in range(cfg.dur_layers):
        lstms += [BiLSTM(hid + sty, hid // 2), AdaNorm(sty, hid)]

    def head() -> nn.ModuleList:
        return nn.ModuleList([
            AdainResBlk1d(hid, hid, sty),
            AdainResBlk1d(hid, hid // 2, sty, upsample=True),
            AdainResBlk1d(hid // 2, hid // 2, sty),
        ])

    return _container(
        text_encoder=_container(lstms=nn.ModuleList(lstms)),
        lstm=BiLSTM(hid + sty, hid // 2),
        duration_proj=_container(linear_layer=nn.Linear(hid, cfg.max_dur)),
        shared=BiLSTM(hid + sty, hid // 2),
        F0=head(), F0_proj=nn.Conv1d(hid // 2, 1, 1),
        N=head(), N_proj=nn.Conv1d(hid // 2, 1, 1),
    )


def _decoder(cfg: KokoroConfig) -> nn.Module:
    hid, sty, mid = cfg.hidden, cfg.style_dim, cfg.dec_mid
    n_feat = cfg.gen_n_fft + 2
    gen = _container(
        m_source=_container(l_linear=nn.Linear(cfg.harmonics + 1, 1)),
        ups=nn.ModuleList(), resblocks=nn.ModuleList(),
        noise_convs=nn.ModuleList(), noise_res=nn.ModuleList(),
    )
    ch = hid
    for i, (u, kk) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        cout = ch // 2
        gen.ups.append(nn.ConvTranspose1d(ch, cout, kk, stride=u))
        for rk in cfg.resblock_kernels:
            gen.resblocks.append(AdaINResBlock1(cout, rk, sty))
        stride_f0 = math.prod(cfg.upsample_rates[i + 1:])
        k_src = 2 * stride_f0 if i + 1 < len(cfg.upsample_rates) else 1
        gen.noise_convs.append(nn.Conv1d(n_feat, cout, k_src, stride=stride_f0))
        gen.noise_res.append(AdaINResBlock1(cout, cfg.noise_res_kernels[i], sty))
        ch = cout
    gen.conv_post = nn.Conv1d(ch, n_feat, 7)
    return _container(
        encode=AdainResBlk1d(hid + 2, mid, sty),
        decode=nn.ModuleList(
            [AdainResBlk1d(mid + cfg.asr_res_dim + 2, mid, sty) for _ in range(cfg.dec_blocks - 1)]
            + [AdainResBlk1d(mid + cfg.asr_res_dim + 2, hid, sty, upsample=True)]
        ),
        F0_conv=nn.Conv1d(1, 1, 3, stride=2),
        N_conv=nn.Conv1d(1, 1, 3, stride=2),
        asr_res=nn.ModuleList([nn.Conv1d(hid, cfg.asr_res_dim, 1)]),
        generator=gen,
    )


class KModel(nn.Module):
    """Kokoro's weights: ``bert``, ``bert_encoder``, ``predictor``,
    ``text_encoder`` and ``decoder``, as in the checkpoint."""

    def __init__(self, cfg: KokoroConfig) -> None:
        super().__init__()
        hid = cfg.hidden
        self.bert = _albert(cfg)
        self.bert_encoder = nn.Linear(cfg.plbert_hidden, hid)
        self.predictor = _predictor(cfg)
        self.text_encoder = _container(
            embedding=nn.Embedding(cfg.n_symbols, hid),
            cnn=nn.ModuleList(
                nn.ModuleList([nn.Conv1d(hid, hid, cfg.text_kernel), ChannelLayerNorm(hid)])
                for _ in range(cfg.text_depth)
            ),
            lstm=BiLSTM(hid, hid // 2),
        )
        self.decoder = _decoder(cfg)

    @classmethod
    def empty(cls, cfg: KokoroConfig, device) -> "KModel":
        """Uninitialised float32 storage on ``device`` (built on the meta
        device, so no initialiser runs); the caller fills every tensor."""
        with torch.device("meta"):
            model = cls(cfg)
        return model.to_empty(device=device).requires_grad_(False).eval()

    @property
    def device(self) -> torch.device:
        return self.bert_encoder.weight.device



@torch.no_grad()
def init_kokoro_params(generator: torch.Generator, cfg: KokoroConfig, device=None) -> KModel:
    """Random weights with the JAX package's distributions: linear, conv and
    LSTM weights normal * fan_in^-0.5 (a conv's fan-in is K * C_in, its
    input channels before grouping), embeddings normal * 0.02 (the text
    encoder's * hidden^-0.5), zero biases, unit gains and snake alphas.

    Draws come from ``generator`` on its own device; the model lives on
    ``device`` (``settings.tts_effective_device`` when None)."""
    model = KModel.empty(cfg, _tts_device(device))

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)

    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.LayerNorm, ChannelLayerNorm)):
                p.fill_(1.0 if leaf in ("weight", "gamma") else 0.0)
            elif isinstance(mod, nn.ParameterList):  # snake alphas
                p.fill_(1.0)
            elif "bias" in leaf:
                p.zero_()
            elif isinstance(mod, nn.Embedding):
                normal(p, cfg.hidden**-0.5 if mod_name == "text_encoder.embedding" else 0.02)
            elif isinstance(mod, nn.ConvTranspose1d):  # [C_in, C_out/groups, K]
                normal(p, (p.shape[0] * p.shape[2]) ** -0.5)
            elif isinstance(mod, nn.Conv1d):  # [C_out, C_in, K]
                normal(p, (p.shape[1] * p.shape[2]) ** -0.5)
            else:  # nn.Linear [out, in], LSTM [4H, in]
                normal(p, p.shape[1] ** -0.5)
    return model


# ──────────────────────────────────────────────────────────────────────
# primitives
# ──────────────────────────────────────────────────────────────────────


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight, lin.bias)


def _conv(x: torch.Tensor, conv: nn.Conv1d, **kw) -> torch.Tensor:
    return conv1d(x, conv.weight, conv.bias, **kw)


def _masked_instance_norm(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d over the valid time steps only. x [B, C, T]; mask
    [B, 1, T]. Equals the exact-length instance norm on the valid prefix."""
    cnt = mask.sum(dim=-1, keepdim=True).clamp_min(1.0)
    mean = (x * mask).sum(dim=-1, keepdim=True) / cnt
    var = ((x - mean) * mask).square().sum(dim=-1, keepdim=True) / cnt
    return (x - mean) * torch.rsqrt(var + eps)


def _adain(x: torch.Tensor, style: torch.Tensor, norm: AdaNorm, mask: torch.Tensor) -> torch.Tensor:
    """AdaIN1d: masked instance norm and a style affine; re-masked."""
    gb = _linear(style, norm.fc)  # [B, 2C]
    c = x.shape[1]
    gamma, beta = gb[:, :c, None], gb[:, c:, None]
    return ((1.0 + gamma) * _masked_instance_norm(x, mask) + beta) * mask


def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha."""
    return x + (1.0 / alpha) * torch.sin(alpha * x).square()


def _adaln(x: torch.Tensor, style: torch.Tensor, norm: AdaNorm) -> torch.Tensor:
    """AdaLayerNorm over the channels of x [B, T, C]: a layer norm without
    affine (population variance), then (1 + gamma) x + beta."""
    gb = _linear(style, norm.fc)
    c = x.shape[-1]
    return (1.0 + gb[:, None, :c]) * F.layer_norm(x, (c,), eps=1e-5) + gb[:, None, c:]


def _gather_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, C], idx [B, T'] -> x[b, idx[b, t]] as [B, T', C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def bilstm(lstm: BiLSTM, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM with per-row valid lengths (pack_padded_sequence's
    result without the lengths on the host). x [B, T, In]; lengths [B] ->
    [B, T, 2H], zero beyond each row's length. The forward LSTM runs over the
    masked rows; the backward one over each row reversed within its length.
    """
    t = x.shape[1]
    ar = torch.arange(t, device=x.device)
    mask = (ar[None, :] < lengths[:, None]).to(x.dtype)[..., None]
    xm = x * mask
    fwd, _ = lstm.fw(xm)
    idx = (lengths[:, None] - 1 - ar[None, :]).clamp(0, t - 1)
    bwd_r, _ = lstm.bw(_gather_time(xm, idx))
    bwd = _gather_time(bwd_r, idx)
    return torch.cat([fwd, bwd], dim=-1) * mask


# ──────────────────────────────────────────────────────────────────────
# PL-BERT, text encoder, prosody predictor
# ──────────────────────────────────────────────────────────────────────


def albert_encode(model: KModel, cfg: KokoroConfig, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ALBERT's last hidden state. tokens [B, T]; mask [B, T, 1] -> [B, T, H]."""
    bert = model.bert
    emb = bert.embeddings
    b, t = tokens.shape
    h = (
        emb.word_embeddings.weight[tokens.long()]
        + emb.position_embeddings.weight[:t][None]
        + emb.token_type_embeddings.weight[0][None, None]
    )
    h = F.layer_norm(h, (h.shape[-1],), emb.LayerNorm.weight, emb.LayerNorm.bias, 1e-12)
    h = _linear(h, bert.encoder.embedding_hidden_mapping_in)
    layer = bert.encoder.albert_layer_groups[0].albert_layers[0]
    att = layer.attention
    nh = cfg.plbert_heads
    hd = cfg.plbert_hidden // nh
    add_mask = ((1.0 - mask[..., 0]) * -1e9)[:, None, None, :]  # [B, 1, 1, T]

    def heads(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(b, t, nh, hd).transpose(1, 2)

    def ln(y: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        return F.layer_norm(y, (y.shape[-1],), norm.weight, norm.bias, 1e-12)

    for _ in range(cfg.plbert_layers):  # one shared layer, iterated
        q, k, v = (heads(_linear(h, lin)) for lin in (att.query, att.key, att.value))
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=add_mask)
        ctx = ctx.transpose(1, 2).reshape(b, t, cfg.plbert_hidden)
        h = ln(h + _linear(ctx, att.dense), att.LayerNorm)
        f = F.gelu(_linear(h, layer.ffn), approximate="tanh")  # gelu_new
        h = ln(h + _linear(f, layer.ffn_output), layer.full_layer_layer_norm)
    return h


def text_encode(model: KModel, cfg: KokoroConfig, tokens, lengths, mask) -> torch.Tensor:
    """StyleTTS2 TextEncoder. tokens [B, T] -> [B, T, hidden]."""
    te = model.text_encoder
    x = te.embedding.weight[tokens.long()] * mask
    for conv, ln in te.cnn:
        x = _conv(x.transpose(1, 2), conv).transpose(1, 2)
        x = layer_norm(x, ln.gamma, ln.beta)
        x = F.leaky_relu(x, 0.2) * mask
    return bilstm(te.lstm, x, lengths)


def duration_encode(model: KModel, cfg: KokoroConfig, d_en, style, lengths, mask) -> torch.Tensor:
    """DurationEncoder: [biLSTM(+style), AdaLayerNorm] pairs.
    d_en [B, T, hidden]; style [B, style_dim] -> [B, T, hidden + style_dim]."""
    lstms = model.predictor.text_encoder.lstms
    s_seq = style[:, None, :].expand(-1, d_en.shape[1], -1)
    x = torch.cat([d_en, s_seq], dim=-1) * mask
    for lstm, norm in zip(lstms[0::2], lstms[1::2]):
        x = _adaln(bilstm(lstm, x, lengths), style, norm)
        x = torch.cat([x, s_seq], dim=-1) * mask
    return x


def _adain_res_blk(x: torch.Tensor, style: torch.Tensor, blk: AdainResBlk1d, mask: torch.Tensor):
    """StyleTTS2 AdainResBlk1d (leaky-relu 0.2, /sqrt(2) merge); a block
    with a ``pool`` upsamples 2x (nearest on the shortcut, the depthwise
    transposed conv on the residual). x [B, C, T] -> (out, mask)."""
    upsample = hasattr(blk, "pool")
    sc = x.repeat_interleave(2, dim=-1) if upsample else x
    if hasattr(blk, "conv1x1"):
        sc = conv1d(sc, blk.conv1x1.weight)
    h = F.leaky_relu(_adain(x, style, blk.norm1, mask), 0.2)
    if upsample:
        h = F.conv_transpose1d(h, blk.pool.weight, blk.pool.bias, stride=2, padding=1,
                               output_padding=1, groups=h.shape[1])
        mask = mask.repeat_interleave(2, dim=-1)
    h = _conv(h, blk.conv1) * mask
    h = F.leaky_relu(_adain(h, style, blk.norm2, mask), 0.2)
    h = _conv(h, blk.conv2) * mask
    return (h + sc * mask) / math.sqrt(2.0), mask


def _time_mask(n: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, 1, n] float mask of t < lengths[b]."""
    return (torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]).float()[:, None, :]


def f0n_predict(model: KModel, cfg: KokoroConfig, en, style, frames):
    """F0 and energy curves at 2x alignment frames. en [B, F, hidden+style]
    -> two [B, 2F]."""
    pred = model.predictor
    fmask = _time_mask(en.shape[1], frames)
    x = bilstm(pred.shared, en, frames).transpose(1, 2)  # [B, hidden, F]

    def head(blocks: nn.ModuleList, proj: nn.Conv1d) -> torch.Tensor:
        h, m = x, fmask
        for blk in blocks:
            h, m = _adain_res_blk(h, style, blk, m)
        return (_conv(h, proj) * m)[:, 0]

    return head(pred.F0, pred.F0_proj), head(pred.N, pred.N_proj)


# ──────────────────────────────────────────────────────────────────────
# ISTFTNet decoder
# ──────────────────────────────────────────────────────────────────────


def decode_audio(model: KModel, cfg: KokoroConfig, asr, f0_curve, n_curve, style, frames):
    """ISTFTNet Decoder up to the generator. asr [B, F, hidden]; curves
    [B, 2F]; style [B, style_dim] -> (x [B, hidden, 2F], mask [B, 1, 2F])."""
    dec = model.decoder
    amask = _time_mask(asr.shape[1], frames)
    mask2 = amask.repeat_interleave(2, dim=-1)
    asr = asr.transpose(1, 2) * amask
    f0 = _conv(f0_curve[:, None] * mask2, dec.F0_conv, stride=2) * amask
    n = _conv(n_curve[:, None] * mask2, dec.N_conv, stride=2) * amask
    x, _ = _adain_res_blk(torch.cat([asr, f0, n], dim=1), style, dec.encode, amask)
    asr_res = _conv(asr, dec.asr_res[0]) * amask
    res, m = True, amask
    for blk in dec.decode:
        if res:
            x = torch.cat([x, asr_res, f0, n], dim=1)
        x, m = _adain_res_blk(x, style, blk, m)
        res = res and not hasattr(blk, "pool")
    return x, m


def _gen_res_block(x, style, blk: AdaINResBlock1, mask, dilations):
    """ISTFTNet AdaINResBlock1 (its kernel size is the conv weights')."""
    for i, d in enumerate(dilations):
        h = _snake(_adain(x, style, blk.adain1[i], mask), blk.alpha1[i]) * mask
        h = _conv(h, blk.convs1[i], dilation=d) * mask
        h = _snake(_adain(h, style, blk.adain2[i], mask), blk.alpha2[i]) * mask
        x = x + _conv(h, blk.convs2[i]) * mask
    return x


@lru_cache(maxsize=8)
def _basis_on(n_fft: int, hop: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The synthesis basis and window as tensors on ``device``, copied once."""
    basis, window = _synthesis_basis(n_fft, hop)
    return torch.from_numpy(basis).to(device), torch.from_numpy(window).to(device)


def _stft_mag_phase(x: torch.Tensor, n_fft: int, hop: int):
    """``torch.stft(center=True, reflect)`` magnitude and phase of x [B, S]
    -> two [B, n_fft//2+1, frames]; the magnitude is sqrt(re^2 + im^2 +
    1e-12), as the JAX model takes it.

    Where the imaginary part is zero and the real part negative the phase is
    +pi or -pi by the sign of the zero. An FFT's DC and Nyquist terms are
    exact zeros whose sign is the FFT library's choice, so -0 is taken as +0
    (``+ 0.0``), and every device gives +pi there. The first and last frames
    are reflections, symmetric, so their imaginary parts are zero only up to
    rounding, and the branch there stays rounding's choice (as in the JAX
    model, whose parity tests inject these features)."""
    _, window = _basis_on(n_fft, hop, x.device)
    spec = torch.stft(x, n_fft, hop, n_fft, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    re, im = spec.real, spec.imag
    return torch.sqrt(re * re + im * im + 1e-12), torch.atan2(im + 0.0, re)


def _istft(mag, phase, n_fft: int, hop: int, frame_mask) -> torch.Tensor:
    """``torch.istft(center=True)`` with the window-square normalisation
    taken over live frames only. mag, phase [B, n_bins, T]; frame_mask
    [B, 1, T] -> [B, (T-1)*hop]. Frames come from one matmul against the
    inverse-DFT basis; ``F.fold`` overlaps and adds them."""
    basis, window = _basis_on(n_fft, hop, mag.device)
    spec = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1) * frame_mask
    frames = torch.einsum("kn,bkt->bnt", basis, spec) * window[:, None]  # [B, n_fft, T]
    b, _, t = frames.shape
    out_len = (t - 1) * hop + n_fft

    def ola(y: torch.Tensor) -> torch.Tensor:
        return F.fold(y, (1, out_len), (1, n_fft), stride=(1, hop))[:, 0, 0]

    norm = ola((frame_mask * window.square()[None, :, None]).expand(b, n_fft, t))
    out = ola(frames) / norm.clamp_min(1e-9)
    pad = n_fft // 2
    return out[:, pad : pad + (t - 1) * hop]


def harmonic_source(model: KModel, cfg: KokoroConfig, f0_curve, rand_phase, sine_noise):
    """SourceModuleHnNSF: F0 -> the merged harmonic sine source [B, S].

    f0_curve [B, 2F] in Hz; rand_phase [B, H+1] initial phases (0 for the
    fundamental); sine_noise [B, S, H+1]."""
    up = cfg.upsample_total // 2  # samples per 2F-frame
    nh = cfg.harmonics + 1
    f0 = f0_curve.repeat_interleave(up, dim=1)[:, None, :]  # [B, 1, S]
    harm = torch.arange(1, nh + 1, device=f0.device, dtype=f0.dtype)[None, :, None]
    rad = (f0 * harm / cfg.sample_rate) % 1.0  # floor-mod, as jnp's %
    rad[:, :, 0] += rand_phase
    s = rad.shape[-1]
    # linear down by `up`, cumulative phase, linear back up (half-pixel
    # centres, no antialiasing: jax.image.resize(linear, antialias=False))
    rad_d = F.interpolate(rad, size=s // up, mode="linear", align_corners=False)
    phase = torch.cumsum(rad_d, dim=-1) * (2.0 * np.pi)
    phase = F.interpolate(phase * up, size=s, mode="linear", align_corners=False)
    uv = (f0 > cfg.voiced_threshold).float()
    noise_amp = uv * cfg.noise_std + (1.0 - uv) * cfg.sine_amp / 3.0
    sine_waves = torch.sin(phase) * cfg.sine_amp * uv + noise_amp * sine_noise.transpose(1, 2)
    src = model.decoder.generator.m_source.l_linear
    return torch.tanh(_linear(sine_waves.transpose(1, 2), src))[..., 0]


def har_features(model: KModel, cfg: KokoroConfig, f0_curve, rand_phase, sine_noise):
    """Harmonic source -> its STFT features [B, n_fft+2, frames]."""
    har = harmonic_source(model, cfg, f0_curve, rand_phase, sine_noise)
    mag, phase = _stft_mag_phase(har, cfg.gen_n_fft, cfg.gen_hop)
    return torch.cat([mag, phase], dim=1)


def _gen_stack(model: KModel, cfg: KokoroConfig, x, style, har0, har1, m, first: bool):
    """The ISTFTNet generator over an x window.

    x [B, C, T] at the decode frame rate with mask m [B, 1, T]. ``har0`` is
    the harmonic-feature window as the strided noise convs read it, ``har1``
    as the last stage reads it. ``first`` applies the stream-start
    ReflectionPad1d((1, 0)); interior blocks instead get ``har1`` one frame
    later, so their samples land on the same global grid."""
    gen = model.decoder.generator
    nk = len(cfg.resblock_kernels)
    n_ups = len(cfg.upsample_rates)
    for i, (u, kk) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        x = F.leaky_relu(x, 0.1) * m
        if i + 1 < n_ups:
            stride_f0 = math.prod(cfg.upsample_rates[i + 1:])
            x_src = _conv(har0, gen.noise_convs[i], stride=stride_f0, pad=stride_f0 // 2)
        else:
            x_src = _conv(har1, gen.noise_convs[i])
        x = conv_transpose1d(x, gen.ups[i].weight, gen.ups[i].bias, u, pad=(kk - u) // 2)
        m = m.repeat_interleave(u, dim=-1)
        if i == n_ups - 1 and first:
            x = torch.cat([x[..., 1:2], x], dim=-1)
            m = torch.cat([m[..., :1], m], dim=-1)
        x_src = x_src[..., : x.shape[-1]]
        x_src = _gen_res_block(x_src, style, gen.noise_res[i], m[..., : x_src.shape[-1]], (1, 3, 5))
        x = (x + F.pad(x_src, (0, x.shape[-1] - x_src.shape[-1]))) * m
        # the dilations tuple may outlast the kernels of a config inferred
        # from a checkpoint, so index it by block
        acc = sum(
            _gen_res_block(x, style, gen.resblocks[i * nk + j], m, cfg.resblock_dilations[j])
            for j in range(nk)
        )
        x = acc / nk * m
    x = F.leaky_relu(x, 0.01) * m
    spec = _conv(x, gen.conv_post)
    n_bins = cfg.gen_n_fft // 2 + 1
    return _istft(torch.exp(spec[:, :n_bins]), torch.sin(spec[:, n_bins:]),
                  cfg.gen_n_fft, cfg.gen_hop, m)


def generate_waveform(model: KModel, cfg: KokoroConfig, x, style, f0_curve, frames,
                      rand_phase, sine_noise, har_feat=None):
    """The ISTFTNet generator. x [B, C, 2F] -> audio [B, 2F * up * hop].

    ``har_feat`` [B, n_fft+2, frames] replaces the harmonic-source features
    (parity tests inject them: the +-pi phase branch on symmetric bins
    depends on rounding, and the phase is a raw conv input)."""
    if har_feat is None:
        har_feat = har_features(model, cfg, f0_curve, rand_phase, sine_noise)
    m = _time_mask(x.shape[-1], 2 * frames)
    return _gen_stack(model, cfg, x, style, har_feat, har_feat, m, first=True)


# ──────────────────────────────────────────────────────────────────────
# entry points
# ──────────────────────────────────────────────────────────────────────


def encode_utterance(model: KModel, cfg: KokoroConfig, phonemes, ph_len, style, speed):
    """Front half: durations, alignment, F0/N and the aligned text features.

    phonemes [B, max_phonemes]; ph_len [B]; style [B, 2*style_dim] (the
    voice vector: decoder style, then prosody style); speed [B].
    Returns ((asr [B, F, hidden], f0 [B, 2F], n [B, 2F], s_dec), n_frames
    [B] int32), with F = max_frames."""
    with _inference():
        mask = _time_mask(cfg.max_phonemes, ph_len).transpose(1, 2)  # [B, P, 1]
        s_pred, s_dec = style[:, cfg.style_dim:], style[:, : cfg.style_dim]

        d_en = _linear(albert_encode(model, cfg, phonemes, mask), model.bert_encoder) * mask
        d = duration_encode(model, cfg, d_en, s_pred, ph_len, mask)
        x = bilstm(model.predictor.lstm, d, ph_len)
        logits = _linear(x, model.predictor.duration_proj.linear_layer)
        duration = torch.sigmoid(logits).sum(dim=-1) / speed[:, None]
        pred_dur = torch.round(duration).clamp_min(1.0) * mask[..., 0]  # half to even
        pred_dur = compress_durations(pred_dur, cfg.max_frames) * mask[..., 0]

        ends = torch.cumsum(pred_dur, dim=1)
        n_frames = ends[:, -1].to(torch.int32).clamp(1, cfg.max_frames)
        t_pos = torch.arange(cfg.max_frames, device=ends.device, dtype=ends.dtype) + 0.5
        idx = torch.searchsorted(ends, t_pos.expand(ends.shape[0], -1).contiguous())
        idx = torch.minimum(idx, (ph_len[:, None] - 1).clamp_min(0))

        f0, n = f0n_predict(model, cfg, _gather_time(d, idx), s_pred, n_frames)
        asr = _gather_time(text_encode(model, cfg, phonemes, ph_len, mask), idx)
        return (asr, f0, n, s_dec), n_frames


def _source_noise(rng, b: int, nh: int, s_total: int, device: torch.device):
    """The harmonic source's randomness: initial phases [B, nh] (0 for the
    fundamental) and sine dither [B, s_total, nh].

    ``rng`` is one ``torch.Generator`` (batch-shaped draws) or a list of B
    of them, one per row, so a row's audio does not depend on the batch it
    is in. Draws are made on each generator's device and moved to
    ``device``: host generators give the card and the CPU the same noise."""
    def draw(gen: torch.Generator, rows: int):
        phase = torch.rand(rows, nh - 1, generator=gen, device=gen.device)
        noise = torch.randn(rows, s_total, nh, generator=gen, device=gen.device)
        return F.pad(phase, (1, 0)).to(device), noise.to(device)

    if isinstance(rng, torch.Generator):
        return draw(rng, b)
    if len(rng) != b:
        raise ValueError(f"{len(rng)} generators for {b} rows")
    phases, noises = zip(*(draw(gen, 1) for gen in rng))
    return torch.cat(phases), torch.cat(noises)


def _default_rng(rng, device: torch.device):
    return rng if rng is not None else torch.Generator(device=device).manual_seed(0)


def vocode(model: KModel, cfg: KokoroConfig, g, n_frames, rng=None) -> torch.Tensor:
    """Back half in one pass: decoder and generator over the whole frame
    bucket -> audio [B, max_frames * samples_per_frame] on the model's
    device. ``rng`` as in ``_source_noise`` (a generator seeded 0 when None)."""
    asr, f0, _, s_dec = g
    with _inference():
        x, _ = decode_audio(model, cfg, *g[:3], s_dec, n_frames)
        noise = _source_noise(_default_rng(rng, asr.device), asr.shape[0], cfg.harmonics + 1,
                              cfg.max_frames * cfg.samples_per_frame, asr.device)
        return generate_waveform(model, cfg, x, s_dec, f0, n_frames, *noise)


def synthesize_frames(model: KModel, cfg: KokoroConfig, phonemes, ph_len, style, speed, rng=None):
    """Full synthesis: (audio [B, max_frames * samples_per_frame], n_frames [B])."""
    g, n_frames = encode_utterance(model, cfg, phonemes, ph_len, style, speed)
    return vocode(model, cfg, g, n_frames, rng), n_frames


def _block_first(model, cfg: KokoroConfig, x, har, style, frames, nb: int, h: int):
    """The stream-start generator block: x-frames [0, nb + h), reflect-padded.
    Its samples are the global samples [0, (nb + h) * spf/2)."""
    length = nb + h
    hpx = cfg.samples_per_frame // 2 // cfg.gen_hop
    m = _time_mask(length, 2 * frames)
    return _gen_stack(model, cfg, x[..., :length], style, har[..., : length * hpx],
                      har[..., : length * hpx + 1], m, first=True)


def _block_interior(model, cfg: KokoroConfig, x_pad, har_pad, style, frames, a: int, nb: int, h: int):
    """An interior generator block: core x-frames [a, a + nb) with halo h.

    ``x_pad``/``har_pad`` are the utterance's arrays padded so the window
    never runs off either end (global x-frame g at index g + h, har frame f
    at f + h * hpx). The samples cover [(a - h) * spf/2 + hop,
    (a + nb + h) * spf/2); the caller trims the halo."""
    length = nb + 2 * h
    hpx = cfg.samples_per_frame // 2 // cfg.gen_hop
    gidx = (a - h) + torch.arange(length, device=x_pad.device)
    m = ((gidx[None, :] >= 0) & (gidx[None, :] < 2 * frames[:, None])).float()[:, None, :]
    return _gen_stack(model, cfg, x_pad[..., a : a + length], style,
                      har_pad[..., a * hpx : (a + length) * hpx],
                      har_pad[..., a * hpx + 1 : (a + length) * hpx + 1], m, first=False)


def _to_host(audio: torch.Tensor, wire: str) -> np.ndarray:
    """A block to a host float32 array. ``wire="i16"`` converts on the
    device (clip to [-1, 1], * 32767, truncated to int16), moves int16 and
    divides by 32767 on the host: half the bytes over the bus, and the audio
    leaves the server as 16-bit PCM anyway."""
    if wire == "i16":
        pcm = (audio.clamp(-1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
        return pcm.astype(np.float32) / 32767.0
    return audio.cpu().numpy()


def vocode_streaming(model: KModel, cfg: KokoroConfig, g, n_frames, rng=None, block_frames: int = 64,
                     first_block_frames: int | None = None, wire: str = "f32"):
    """Yield the audio as host float32 arrays [B, n] in blocks of
    ``block_frames`` alignment frames (the last one shorter), covering
    n_frames * spf samples of the longest row. The first block spans
    ``first_block_frames`` (``block_frames`` when None): time to first
    audio is paid on it, later blocks only need to keep ahead of playback.
    ``wire`` is "f32" or "i16" (``_to_host``).

    The decoder and the harmonic features run once per utterance, over
    noise drawn once for the whole bucket (as ``vocode`` draws it); the
    generator, where the samples and the FLOPs are, runs per block over a
    halo of ``HALO_FRAMES``, so the first block waits for one block's work.
    Blocks land on the exact global sample grid. The one approximation is
    that the generator's AdaIN statistics span block and halo, not the
    utterance: the output equals ``vocode``'s when the utterance fits one
    block, and stays close to it beyond (bounded in the tests)."""
    asr, f0, _, s_dec = g
    spf2 = cfg.samples_per_frame // 2
    hop = cfg.gen_hop
    hpx = spf2 // hop
    nb = 2 * block_frames  # x-frames per interior block
    nb1 = 2 * (first_block_frames or block_frames)
    h = min(2 * HALO_FRAMES, nb, nb1)
    if 2 * cfg.max_frames < max(nb, nb1) + h:  # the bucket is smaller than one block
        audio = vocode(model, cfg, g, n_frames, rng)
        total_x = 2 * int(n_frames.max())
        yield audio[:, : total_x * spf2].cpu().numpy()
        return
    with _inference():
        x, _ = decode_audio(model, cfg, *g[:3], s_dec, n_frames)
        noise = _source_noise(_default_rng(rng, asr.device), asr.shape[0], cfg.harmonics + 1,
                              cfg.max_frames * cfg.samples_per_frame, asr.device)
        har = har_features(model, cfg, f0, *noise)
        first = _block_first(model, cfg, x, har, s_dec, n_frames, nb1, h)
    total_x = 2 * int(n_frames.max())  # read after the first block is queued
    yield _to_host(first[:, : min(nb1, total_x) * spf2], wire)
    if total_x <= nb1:
        return
    with _inference():
        x_pad = F.pad(x, (h, nb + h))
        har_pad = F.pad(har, (h * hpx, (nb + h) * hpx + 1))
    for a in range(nb1, total_x, nb):
        with _inference():
            blk = _block_interior(model, cfg, x_pad, har_pad, s_dec, n_frames, a, nb, h)
        start = h * spf2 - hop
        yield _to_host(blk[:, start : start + min(nb, total_x - a) * spf2], wire)


def vocode_blocks(model: KModel, cfg: KokoroConfig, g, n_frames, style=None, rng=None,
                  block_frames: int = 64):
    """The per-sentence blocks, with the JAX package's call shape
    ``vocode_blocks(params, cfg, g, n_frames, style)``. ``style`` is
    accepted and unused: the decoder style travels inside ``g``."""
    return vocode_streaming(model, cfg, g, n_frames, rng=rng, block_frames=block_frames)
