"""Piper (VITS) in PyTorch: the synthesis graph, held against the JAX model.

Counterpart of ``open_speech_tpu/models/piper/model.py``:

  phoneme ids
    -> text encoder (relative-position MHA, window 4, post-LN, conv FFN)
    -> prior stats (m, logs) + the stochastic duration predictor, inverse
       (DDSConv context + rational-quadratic spline flows, noise_scale_w)
    -> hard monotonic length regulation (ceil durations)
    -> sampled latent z_p -> inverse residual-coupling flow (WaveNet blocks)
    -> HiFiGAN decoder -> waveform, 22.05 kHz for the medium voices.

The weights live in ``PiperModel``, an ``nn.Module`` tree named as a
piper_train (VITS ``SynthesizerTrn``) state dict names its tensors, so a
checkpoint loads as it is (``convert.py``); the stages are functions of
(model, cfg, tensors), as the JAX package's are of (params, cfg, arrays).
Tensors are channel-first, [B, C, T], with masks [B, 1, T].

Shapes are the JAX package's buckets: the phoneme axis is padded to
``cfg.max_phonemes`` and the frame axis to ``cfg.max_frames``; length
regulation is a searchsorted gather, and the decoder re-zeros the padded
frames after every convolution, so a padded row computes what an
exact-length row computes on its valid prefix.

Everything runs in float32, inside ``ops.vocoder.inference`` (cuDNN's TF32
off) on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.ops.vocoder import (
    compress_durations,
    conv1d,
    conv_transpose1d,
    inference,
    resblock1,
    resblock1_module,
    tts_device,
)

SAMPLE_RATE = 22_050

_MASK_VAL = -1e4  # VITS masked_fill value


@dataclass(frozen=True)
class PiperConfig:
    n_phonemes: int = 256  # piper num_symbols
    hidden: int = 192  # inter_channels == hidden_channels
    ffn_filter: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    rel_window: int = 4
    # stochastic duration predictor
    dp_filter: int = 192
    dp_kernel: int = 3
    dp_flows: int = 4
    dp_dds_layers: int = 3
    dp_bins: int = 10
    dp_tail: float = 5.0
    # residual coupling flow
    flow_layers: int = 4
    wn_kernel: int = 5
    wn_layers: int = 4
    # HiFiGAN decoder
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernels: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial: int = 512
    resblock_kernels: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5),) * 3
    # speakers
    n_speakers: int = 1
    gin: int = 0  # 0 -> unconditioned (single speaker)
    # inference defaults (piper voice json "inference" block)
    noise_scale: float = 0.667
    noise_scale_w: float = 0.8
    sample_rate: int = SAMPLE_RATE
    # serving buckets
    max_phonemes: int = 128
    max_frames: int = 512

    @property
    def samples_per_frame(self) -> int:
        return math.prod(self.upsample_rates)


# ──────────────────────────────────────────────────────────────────────
# modules (named as piper_train names its tensors)
# ──────────────────────────────────────────────────────────────────────


def _container(**children: nn.Module) -> nn.Module:
    mod = nn.Module()
    for name, child in children.items():
        setattr(mod, name, child)
    return mod


class ChannelLayerNorm(nn.Module):
    """VITS's LayerNorm over channels (tensors ``gamma``, ``beta``)."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))


class RelMHA(nn.Module):
    """Relative-position multi-head attention (VITS ``MultiHeadAttention``)."""

    def __init__(self, c: int, heads: int, window: int) -> None:
        super().__init__()
        hd = c // heads
        self.conv_q, self.conv_k = nn.Conv1d(c, c, 1), nn.Conv1d(c, c, 1)
        self.conv_v, self.conv_o = nn.Conv1d(c, c, 1), nn.Conv1d(c, c, 1)
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window + 1, hd))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window + 1, hd))


def _dds(c: int, k: int, n: int) -> nn.Module:
    return _container(
        convs_sep=nn.ModuleList(nn.Conv1d(c, c, k, groups=c) for _ in range(n)),
        convs_1x1=nn.ModuleList(nn.Conv1d(c, c, 1) for _ in range(n)),
        norms_1=nn.ModuleList(ChannelLayerNorm(c) for _ in range(n)),
        norms_2=nn.ModuleList(ChannelLayerNorm(c) for _ in range(n)),
    )


class ElementwiseAffine(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.m = nn.Parameter(torch.zeros(2, 1))
        self.logs = nn.Parameter(torch.zeros(2, 1))


def _duration_predictor(cfg: PiperConfig) -> nn.Module:
    f = cfg.dp_filter
    # VITS's flow list: [ElementwiseAffine, ConvFlow, Flip, ConvFlow, Flip, ...]
    flows: list[nn.Module] = [ElementwiseAffine()]
    for _ in range(cfg.dp_flows):
        flows += [_container(pre=nn.Conv1d(1, f, 1), convs=_dds(f, cfg.dp_kernel, cfg.dp_dds_layers),
                             proj=nn.Conv1d(f, 3 * cfg.dp_bins - 1, 1)),
                  nn.Identity()]
    dp = _container(pre=nn.Conv1d(cfg.hidden, f, 1), convs=_dds(f, cfg.dp_kernel, cfg.dp_dds_layers),
                    proj=nn.Conv1d(f, f, 1), flows=nn.ModuleList(flows))
    if cfg.gin:
        dp.cond = nn.Conv1d(cfg.gin, f, 1)
    return dp


def _coupling_layer(cfg: PiperConfig) -> nn.Module:
    h, half, n = cfg.hidden, cfg.hidden // 2, cfg.wn_layers
    enc = _container(
        in_layers=nn.ModuleList(nn.Conv1d(h, 2 * h, cfg.wn_kernel) for _ in range(n)),
        res_skip_layers=nn.ModuleList(nn.Conv1d(h, 2 * h if j < n - 1 else h, 1) for j in range(n)),
    )
    if cfg.gin:
        enc.cond_layer = nn.Conv1d(cfg.gin, 2 * h * n, 1)
    return _container(pre=nn.Conv1d(half, h, 1), enc=enc, post=nn.Conv1d(h, half, 1))


def _decoder(cfg: PiperConfig) -> nn.Module:
    ch = cfg.upsample_initial
    dec = _container(conv_pre=nn.Conv1d(cfg.hidden, ch, 7), ups=nn.ModuleList(),
                     resblocks=nn.ModuleList())
    for u, kk in zip(cfg.upsample_rates, cfg.upsample_kernels):
        dec.ups.append(nn.ConvTranspose1d(ch, ch // 2, kk, stride=u))
        ch //= 2
        for rk, rds in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            dec.resblocks.append(resblock1_module(ch, rk, rds))
    # piper's conv_post has no bias; a zero one computes the same
    dec.conv_post = nn.Conv1d(ch, 1, 7)
    if cfg.gin:
        dec.cond = nn.Conv1d(cfg.gin, cfg.upsample_initial, 1)
    return dec


class PiperModel(nn.Module):
    """Piper's weights: ``enc_p``, ``dp``, ``flow``, ``dec`` and, with more
    than one speaker, ``emb_g``, as in a piper_train checkpoint."""

    def __init__(self, cfg: PiperConfig) -> None:
        super().__init__()
        h, n = cfg.hidden, cfg.n_layers
        self.enc_p = _container(
            emb=nn.Embedding(cfg.n_phonemes, h),
            encoder=_container(
                attn_layers=nn.ModuleList(RelMHA(h, cfg.n_heads, cfg.rel_window) for _ in range(n)),
                norm_layers_1=nn.ModuleList(ChannelLayerNorm(h) for _ in range(n)),
                ffn_layers=nn.ModuleList(
                    _container(conv_1=nn.Conv1d(h, cfg.ffn_filter, cfg.kernel_size),
                               conv_2=nn.Conv1d(cfg.ffn_filter, h, cfg.kernel_size))
                    for _ in range(n)),
                norm_layers_2=nn.ModuleList(ChannelLayerNorm(h) for _ in range(n)),
            ),
            proj=nn.Conv1d(h, 2 * h, 1),
        )
        self.dp = _duration_predictor(cfg)
        # [coupling layer, Flip, coupling layer, Flip, ...]
        self.flow = _container(flows=nn.ModuleList(
            m for _ in range(cfg.flow_layers) for m in (_coupling_layer(cfg), nn.Identity())))
        self.dec = _decoder(cfg)
        if cfg.n_speakers > 1:
            self.emb_g = nn.Embedding(cfg.n_speakers, cfg.gin)

    @classmethod
    def empty(cls, cfg: PiperConfig, device) -> "PiperModel":
        """Uninitialised float32 storage on ``device`` (built on the meta
        device, so no initialiser runs); the caller fills every tensor."""
        with torch.device("meta"):
            model = cls(cfg)
        return model.to_empty(device=device).requires_grad_(False).eval()

    @property
    def device(self) -> torch.device:
        return self.enc_p.emb.weight.device

    def conv_flows(self) -> list[nn.Module]:
        return [m for m in self.dp.flows[1:] if not isinstance(m, nn.Identity)]

    def coupling_layers(self) -> list[nn.Module]:
        return [m for m in self.flow.flows if not isinstance(m, nn.Identity)]



@torch.no_grad()
def init_piper_params(generator: torch.Generator, cfg: PiperConfig, device=None) -> PiperModel:
    """Random weights with the JAX package's distributions: convolutions
    normal * (K * C_in)^-0.5 (C_in before grouping), the phoneme embedding
    normal * hidden^-0.5, the relative embeddings normal * head_dim^-0.5,
    speaker embeddings normal * 0.1, zero biases, unit norm gains, and the
    coupling layers' ``post`` convolutions zero (the flow starts as the
    identity, as VITS initialises it).

    Draws come from ``generator`` on its own device; the model lives on
    ``device`` (``settings.tts_effective_device`` when None)."""
    model = PiperModel.empty(cfg, tts_device(device))
    hd = cfg.hidden // cfg.n_heads

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * std)

    for mod_name, mod in model.named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if isinstance(mod, ChannelLayerNorm):
                p.fill_(1.0 if leaf == "gamma" else 0.0)
            elif isinstance(mod, ElementwiseAffine) or leaf == "bias":
                p.zero_()
            elif isinstance(mod, RelMHA):
                normal(p, hd**-0.5)
            elif mod_name == "enc_p.emb":
                normal(p, cfg.hidden**-0.5)
            elif mod_name == "emb_g":
                normal(p, 0.1)
            elif mod_name.startswith("flow.") and mod_name.endswith(".post"):
                p.zero_()
            elif isinstance(mod, nn.ConvTranspose1d):  # [C_in, C_out, K]
                normal(p, (p.shape[0] * p.shape[2]) ** -0.5)
            else:  # Conv1d [C_out, C_in/groups, K]
                normal(p, (p.shape[1] * mod.groups * p.shape[2]) ** -0.5)
    return model


# ──────────────────────────────────────────────────────────────────────
# text encoder (VITS attentions.Encoder: post-LN, relative-position MHA)
# ──────────────────────────────────────────────────────────────────────


def _conv(x: torch.Tensor, conv: nn.Conv1d, **kw) -> torch.Tensor:
    return conv1d(x, conv.weight, conv.bias, groups=conv.groups, **kw)


def _ln(x: torch.Tensor, norm: ChannelLayerNorm) -> torch.Tensor:
    """LayerNorm over the channels of x [B, C, T]."""
    return F.layer_norm(x.transpose(1, 2), (x.shape[1],), norm.gamma, norm.beta, 1e-5).transpose(1, 2)


def _rel_embed(emb: torch.Tensor, t: int, window: int) -> torch.Tensor:
    """Slice or pad the learned relative embeddings [2w+1, d] to [2t-1, d]."""
    pad = max(t - 1 - window, 0)
    start = max(window + 1 - t, 0)
    return F.pad(emb, (0, 0, pad, pad))[start : start + 2 * t - 1]


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] relative logits -> [B, H, T, T] absolute."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, t * 2 * t)
    x = F.pad(x, (0, t - 1))
    return x.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1 :]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, T] attention -> [B, H, T, 2T-1] relative buckets."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1)).reshape(b, h, t * t + t * (t - 1))
    x = F.pad(x, (t, 0))
    return x.reshape(b, h, t, 2 * t)[:, :, :, 1:]


def _rel_attention(x: torch.Tensor, layer: RelMHA, cfg: PiperConfig, attn_mask: torch.Tensor) -> torch.Tensor:
    b, c, t = x.shape
    nh, hd = cfg.n_heads, c // cfg.n_heads

    def heads(conv: nn.Conv1d) -> torch.Tensor:  # [B, C, T] -> [B, nh, T, hd]
        return _conv(x, conv).reshape(b, nh, hd, t).transpose(2, 3)

    q, k, v = heads(layer.conv_q), heads(layer.conv_k), heads(layer.conv_v)
    q = q * hd**-0.5
    scores = q @ k.transpose(-2, -1)
    rel_k = _rel_embed(layer.emb_rel_k[0], t, cfg.rel_window)
    scores = scores + _rel_to_abs(torch.einsum("bhld,md->bhlm", q, rel_k))
    scores = scores.masked_fill(~attn_mask, _MASK_VAL)
    w = torch.softmax(scores, dim=-1)
    out = w @ v
    rel_v = _rel_embed(layer.emb_rel_v[0], t, cfg.rel_window)
    out = out + torch.einsum("bhlm,md->bhld", _abs_to_rel(w), rel_v)
    return _conv(out.transpose(2, 3).reshape(b, c, t), layer.conv_o)


def text_encoder(model: PiperModel, cfg: PiperConfig, tokens: torch.Tensor, mask: torch.Tensor):
    """tokens [B, P] int, mask [B, 1, P] -> (x, m_p, logs_p), each [B, H, P]."""
    enc = model.enc_p
    x = enc.emb(tokens).transpose(1, 2) * math.sqrt(cfg.hidden) * mask
    attn_mask = (mask[:, :, :, None] * mask[:, :, None, :]) > 0  # [B, 1, P, P]
    layers = zip(enc.encoder.attn_layers, enc.encoder.norm_layers_1, enc.encoder.ffn_layers,
                 enc.encoder.norm_layers_2)
    for attn, n1, ffn, n2 in layers:
        x = _ln(x + _rel_attention(x, attn, cfg, attn_mask), n1)
        y = _conv(torch.relu(_conv(x * mask, ffn.conv_1)) * mask, ffn.conv_2)
        x = _ln(x + y * mask, n2)
    x = x * mask
    stats = _conv(x, enc.proj) * mask
    return x, stats[:, : cfg.hidden], stats[:, cfg.hidden :]


# ──────────────────────────────────────────────────────────────────────
# stochastic duration predictor (inverse pass only)
# ──────────────────────────────────────────────────────────────────────


def _dds_conv(dds: nn.Module, x: torch.Tensor, mask: torch.Tensor, cfg: PiperConfig, g=None) -> torch.Tensor:
    """VITS DDSConv: dilated depthwise convolutions with channel LN + GELU."""
    if g is not None:
        x = x + g
    for i in range(cfg.dp_dds_layers):
        y = _conv(x * mask, dds.convs_sep[i], dilation=cfg.dp_kernel**i)
        y = F.gelu(_ln(y, dds.norms_1[i]))
        y = F.gelu(_ln(_conv(y, dds.convs_1x1[i]), dds.norms_2[i]))
        x = x + y
    return x * mask


def _rq_spline_inverse(inputs: torch.Tensor, uw: torch.Tensor, uh: torch.Tensor, ud: torch.Tensor,
                       cfg: PiperConfig) -> torch.Tensor:
    """Inverse piecewise rational-quadratic spline with linear tails.

    inputs [B, T]; uw, uh [B, T, bins]; ud [B, T, bins-1]. Constants match
    VITS transforms.py (min bin width and height 1e-3, min derivative 1e-3).
    """
    nb, tail = cfg.dp_bins, cfg.dp_tail
    min_bw = min_bh = min_d = 1e-3
    inside = (inputs >= -tail) & (inputs <= tail)
    x = inputs.clamp(-tail, tail)
    const = math.log(math.exp(1.0 - min_d) - 1.0)
    ud = F.pad(ud, (1, 1), value=const)

    def knots(u: torch.Tensor, min_size: float) -> tuple[torch.Tensor, torch.Tensor]:
        sizes = min_size + (1.0 - min_size * nb) * torch.softmax(u, dim=-1)
        cum = F.pad(torch.cumsum(sizes, -1), (1, 0))
        cum = 2.0 * tail * cum - tail
        cum[..., 0], cum[..., -1] = -tail, tail
        return cum, cum[..., 1:] - cum[..., :-1]

    cumw, widths = knots(uw, min_bw)
    cumh, heights = knots(uh, min_bh)
    derivs = min_d + F.softplus(ud)

    # bucket by heights (the inverse direction): sum(x >= knot) - 1
    located = cumh.clone()
    located[..., -1] += 1e-6
    idx = ((x[..., None] >= located).sum(-1) - 1).clamp(0, nb - 1)[..., None]

    def take(t: torch.Tensor, i: torch.Tensor = idx) -> torch.Tensor:
        return torch.gather(t, -1, i)[..., 0]

    in_cw, in_w, in_ch, in_h = take(cumw), take(widths), take(cumh), take(heights)
    delta = take(heights / widths)
    d0, d1 = take(derivs), take(derivs, idx + 1)

    dy = x - in_ch
    a = dy * (d0 + d1 - 2.0 * delta) + in_h * (delta - d0)
    b = in_h * d0 - dy * (d0 + d1 - 2.0 * delta)
    c = -delta * dy
    disc = (b * b - 4.0 * a * c).clamp_min(0.0)
    root = 2.0 * c / (-b - torch.sqrt(disc))
    return torch.where(inside, root * in_w + in_cw, inputs)


def _conv_flow_inverse(flow: nn.Module, z: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                       cfg: PiperConfig) -> torch.Tensor:
    x0, x1 = z[:, 0:1], z[:, 1:2]
    h = _dds_conv(flow.convs, _conv(x0, flow.pre), mask, cfg, g=g)
    h = (_conv(h, flow.proj) * mask).transpose(1, 2)  # [B, T, 3*bins-1]
    s, nb = cfg.dp_filter**-0.5, cfg.dp_bins
    x1 = _rq_spline_inverse(x1[:, 0], h[..., :nb] * s, h[..., nb : 2 * nb] * s, h[..., 2 * nb :], cfg)
    return torch.cat([x0, x1[:, None]], dim=1) * mask


def sdp_log_durations(model: PiperModel, cfg: PiperConfig, x: torch.Tensor, mask: torch.Tensor,
                      g: torch.Tensor | None, noise: torch.Tensor) -> torch.Tensor:
    """Inverse SDP: log durations [B, 1, P] from the encoder output and
    noise [B, 2, P] (already scaled by noise_scale_w). Flow order as VITS
    inference runs it: reversed(flows)[:-2] + [ElementwiseAffine], so the
    first ConvFlow is unused ("remove a useless vflow")."""
    dp = model.dp
    h = _conv(x, dp.pre)
    if g is not None:
        h = h + _conv(g, dp.cond)
    h = _dds_conv(dp.convs, h, mask, cfg)
    h = _conv(h, dp.proj) * mask
    flows = model.conv_flows()
    z = noise
    for i in reversed(range(1, cfg.dp_flows)):
        z = _conv_flow_inverse(flows[i], z.flip(1), mask, h, cfg)
    z = z.flip(1)
    ea = dp.flows[0]
    z = (z - ea.m) * torch.exp(-ea.logs) * mask
    return z[:, 0:1]


# ──────────────────────────────────────────────────────────────────────
# residual coupling flow + HiFiGAN decoder
# ──────────────────────────────────────────────────────────────────────


def _wn(enc: nn.Module, x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor | None,
        cfg: PiperConfig) -> torch.Tensor:
    h, n = cfg.hidden, cfg.wn_layers
    out = torch.zeros_like(x)
    g_all = _conv(g, enc.cond_layer) if g is not None else None
    for j in range(n):
        x_in = _conv(x, enc.in_layers[j])
        if g_all is not None:
            x_in = x_in + g_all[:, j * 2 * h : (j + 1) * 2 * h]
        acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
        rs = _conv(acts, enc.res_skip_layers[j])
        if j < n - 1:
            x = (x + rs[:, :h]) * mask
            out = out + rs[:, h:]
        else:
            out = out + rs
    return out * mask


def flow_inverse(model: PiperModel, cfg: PiperConfig, z: torch.Tensor, mask: torch.Tensor,
                 g: torch.Tensor | None) -> torch.Tensor:
    """z_p [B, H, F] -> z through the residual-coupling flow, inverted."""
    half = cfg.hidden // 2
    for layer in reversed(model.coupling_layers()):
        z = z.flip(1)
        x0, x1 = z[:, :half], z[:, half:]
        h = _conv(x0, layer.pre) * mask
        h = _wn(layer.enc, h, mask, g, cfg)
        m = _conv(h, layer.post) * mask
        z = torch.cat([x0, (x1 - m) * mask], dim=1)
    return z


def generator(model: PiperModel, cfg: PiperConfig, z: torch.Tensor, g: torch.Tensor | None,
              fmask: torch.Tensor | None = None) -> torch.Tensor:
    """HiFiGAN decoder: z [B, H, F] -> audio [B, F * samples_per_frame].

    ``fmask`` [B, 1, F] marks the valid frames: a padded-bucket run re-zeros
    after every convolution, so bias garbage in frames past n_frames never
    reaches the valid audio's tail (real piper runs exact-length, and sees
    zero padding there)."""
    dec, m = model.dec, fmask
    x = _conv(z, dec.conv_pre)
    if g is not None:
        x = x + _conv(g, dec.cond)
    if m is not None:
        x = x * m
    nk = len(cfg.resblock_kernels)
    for i, (u, kk) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        up = dec.ups[i]
        x = conv_transpose1d(F.leaky_relu(x, 0.1), up.weight, up.bias, u, pad=(kk - u) // 2)
        if m is not None:
            m = m.repeat_interleave(u, dim=2)
            x = x * m
        acc = None
        for j, rds in enumerate(cfg.resblock_dilations):
            r = resblock1(x, dec.resblocks[i * nk + j], dilations=rds, mask=m)
            acc = r if acc is None else acc + r
        x = acc / nk
    x = F.leaky_relu(x, 0.01)  # torch F.leaky_relu's default slope
    return torch.tanh(_conv(x, dec.conv_post))[:, 0]


# ──────────────────────────────────────────────────────────────────────
# full inference
# ──────────────────────────────────────────────────────────────────────


def speaker_vector(model: PiperModel, speaker_id: torch.Tensor) -> torch.Tensor | None:
    """The speaker embedding [B, gin, 1], or None for a one-speaker voice."""
    return model.emb_g(speaker_id)[:, :, None] if hasattr(model, "emb_g") else None


def durations(logw: torch.Tensor, mask: torch.Tensor, speed: torch.Tensor, f_max: int):
    """Log durations [B, 1, P] -> (integer frame durations [B, P], their
    cumulative ends, n_frames [B]). ``length_scale = 1/speed``; an utterance
    over the frame bucket is compressed into it (``compress_durations``)."""
    w = torch.exp(logw) * mask / speed[:, None, None]
    w_ceil = compress_durations(torch.ceil(w)[:, 0], f_max)
    ends = torch.cumsum(w_ceil, dim=1)
    return w_ceil, ends, ends[:, -1].to(torch.int64).clamp(1, f_max)


def synthesize_vits(model: PiperModel, cfg: PiperConfig, phonemes: torch.Tensor, ph_len: torch.Tensor,
                    speaker_id: torch.Tensor, speed: torch.Tensor, rng: torch.Generator | None = None,
                    dp_noise: torch.Tensor | None = None, z_noise: torch.Tensor | None = None):
    """VITS inference on the model's device.

    phonemes [B, max_phonemes]; ph_len, speaker_id, speed [B]. The noise is
    ``dp_noise`` [B, 2, P] (already scaled by noise_scale_w) and ``z_noise``
    [B, hidden, F] when given, else drawn from ``rng`` (the default
    generator of the model's device when None). Returns (audio [B,
    max_frames * samples_per_frame], n_frames [B])."""
    dev = model.device
    phonemes, ph_len, speaker_id, speed = (t.to(dev) for t in (phonemes, ph_len, speaker_id, speed))
    b, p_max, f_max = phonemes.shape[0], cfg.max_phonemes, cfg.max_frames
    with inference():
        mask = (torch.arange(p_max, device=dev)[None, :] < ph_len[:, None]).float()[:, None, :]
        g = speaker_vector(model, speaker_id)
        x, m_p, logs_p = text_encoder(model, cfg, phonemes, mask)

        def noise(shape, given, scale=1.0):
            if given is not None:
                return given.to(dev)
            gen_dev = rng.device if rng is not None else dev
            return (torch.randn(shape, generator=rng, device=gen_dev) * scale).to(dev)

        logw = sdp_log_durations(model, cfg, x, mask, g, noise((b, 2, p_max), dp_noise, cfg.noise_scale_w))
        _, ends, n_frames = durations(logw, mask, speed, f_max)

        # hard monotonic alignment: frame t belongs to the phoneme whose
        # cumulative duration first exceeds t (VITS generate_path semantics)
        t_pos = (torch.arange(f_max, device=dev, dtype=torch.float32) + 0.5).expand(b, f_max).contiguous()
        idx = torch.searchsorted(ends.contiguous(), t_pos)
        idx = torch.minimum(idx, (ph_len[:, None] - 1).clamp_min(0))[:, None, :].expand(-1, cfg.hidden, -1)
        m_f, logs_f = torch.gather(m_p, 2, idx), torch.gather(logs_p, 2, idx)
        fmask = (torch.arange(f_max, device=dev)[None, :] < n_frames[:, None]).float()[:, None, :]

        z_p = m_f + noise((b, cfg.hidden, f_max), z_noise) * torch.exp(logs_f) * cfg.noise_scale
        z = flow_inverse(model, cfg, z_p, fmask, g)
        audio = generator(model, cfg, z * fmask, g, fmask)
    return audio, n_frames
