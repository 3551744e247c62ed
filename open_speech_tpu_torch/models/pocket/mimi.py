"""The Mimi neural audio codec (Kyutai) in PyTorch, held against the JAX model.

Counterpart of ``open_speech_tpu/models/pocket/mimi.py``:

  encode:  pcm 24 kHz -> SEANet causal conv encoder (ratios 8.6.5.4 -> 25 Hz)
           -> causal windowed transformer -> stride-2 conv downsample
           (12.5 Hz) -> split residual VQ (1 semantic + n_q-1 acoustic)
  decode:  codebook lookups summed -> depthwise transposed-conv upsample ->
           transformer -> SEANet conv decoder -> pcm

Every convolution is causal, so block-streaming decode is exact: the
stream threads each conv's last inputs, each transposed conv's
overlap-add tail and the transformer's rotated K/V window
(``mimi_decode_step``), and a zero state is the full decode's zero left
padding.

The convolutions run channel-first ([B, C, T]) through ``ops/vocoder.py``'s
``conv1d``/``conv_transpose1d`` with PyTorch's weight layouts: ``Conv1d``
[C_out, C_in, K] and ``ConvTranspose1d`` [C_in, C_out/groups, K]
unflipped; the transformer and the quantizer run [B, T, D] with linears
[in, out], as in JAX. ``convert.py`` maps the JAX tree and a moshi state
dict onto this layout. Callers run inside ``ops.vocoder.inference``
(cuDNN's TF32 off): float32 throughout, as in the JAX model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from open_speech_tpu_torch.models.pocket.lm import ParamTree, _layers, _rope
from open_speech_tpu_torch.ops.vocoder import conv1d, conv_transpose1d, inference, tts_device

LN_EPS = 1e-5
_MASKED = -1e30


@dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24_000
    n_filters: int = 64
    dimension: int = 512  # SEANet latent == transformer width
    ratios: tuple[int, ...] = (8, 6, 5, 4)  # decoder order; encoder reversed
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    compress: int = 2
    # bottleneck transformers (encoder and decoder side, same geometry)
    t_layers: int = 8
    t_heads: int = 8
    t_ff: int = 2048
    t_context: int = 250  # causal attention window, in 25 Hz frames
    layer_scale: float = 0.01
    # quantizer
    n_q: int = 8
    card: int = 2048
    q_dim: int = 256
    # conv resample between 25 Hz and the 12.5 Hz token rate
    down_stride: int = 2

    @property
    def seanet_hop(self) -> int:
        h = 1
        for r in self.ratios:
            h *= r
        return h  # 960 -> 25 Hz at 24 kHz

    @property
    def samples_per_frame(self) -> int:
        return self.seanet_hop * self.down_stride  # 1920 -> 12.5 Hz

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.samples_per_frame

    @property
    def head_dim(self) -> int:
        return self.dimension // self.t_heads


# geometry of the unit tests: tiny but structurally complete
TEST_TINY = MimiConfig(
    n_filters=4,
    dimension=16,
    ratios=(4, 3, 2, 2),
    t_layers=2,
    t_heads=2,
    t_ff=32,
    n_q=4,
    card=32,
    q_dim=8,
)


# ──────────────────────────────────────────────────────────────────────
# causal conv helpers (encodec/mimi padding semantics)
# ──────────────────────────────────────────────────────────────────────


def _bias(p) -> torch.Tensor | None:
    return p["b"] if "b" in p else None


def _tr_groups(x: torch.Tensor, w: torch.Tensor) -> int:
    """Depthwise transposed convs ([C, 1, K], mimi's 12.5 -> 25 Hz upsample)
    run with one group per channel; the others are dense."""
    return x.shape[1] if w.shape[1] == 1 and w.shape[0] > 1 else 1


def causal_conv(x: torch.Tensor, p, stride: int = 1, dilation: int = 1, mode: str = "constant") -> torch.Tensor:
    """Causal Conv1d on [B, C, T]: left-pad (k-1)*d - (s-1), right-pad to
    whole frames (encodec's StreamingConv1d, causal). ``mode`` "edge"
    replicates the edge samples (mimi's downsample, torch "replicate")."""
    k = p["w"].shape[-1]
    k_eff = (k - 1) * dilation + 1
    pad_total = k_eff - stride
    t = x.shape[-1]
    n_frames = -(-(t - k_eff + pad_total) // stride) + 1
    ideal = max((n_frames - 1) * stride + k_eff - pad_total, 0)
    extra = max(ideal - t, 0)
    x = F.pad(x, (pad_total, extra), mode="replicate" if mode == "edge" else "constant")
    return conv1d(x, p["w"], _bias(p), stride=stride, dilation=dilation, pad=0)


def causal_convtr(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    """Causal ConvTranspose1d on [B, C, T]: the full output with (k - s)
    trimmed from the right."""
    k = p["w"].shape[-1]
    out = conv_transpose1d(x, p["w"], _bias(p), stride=stride, pad=0, groups=_tr_groups(x, p["w"]))
    trim = k - stride
    return out[..., : out.shape[-1] - trim] if trim > 0 else out


# ──────────────────────────────────────────────────────────────────────
# init
# ──────────────────────────────────────────────────────────────────────


def init_mimi_params(generator: torch.Generator, cfg: MimiConfig, device=None) -> ParamTree:
    """Random weights with the JAX package's shapes and scales (convs normal
    times (k*C_in)^-0.5 with zero biases, layer scales ``cfg.layer_scale``,
    unit-normal codebooks), in PyTorch's layouts, drawn from ``generator``
    on its device and moved to ``device`` (``settings.tts_effective_device``
    when None). The values are ``torch.Generator``'s, not ``jax.random``'s."""
    gdev = generator.device

    def normal(*shape, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=gdev) * scale

    def conv(k, c_in, c_out, bias=True):
        p = {"w": normal(c_out, c_in, k, scale=(k * c_in) ** -0.5)}
        if bias:
            p["b"] = torch.zeros(c_out, device=gdev)
        return p

    def convtr(k, c_in, c_out, bias=True, depthwise=False):
        # the JAX init draws [K, C_in, C_out] at (k * C_in)^-0.5; here in
        # torch's [C_in, C_out/groups, K]
        fan = 1 if depthwise else c_in
        p = {"w": normal(c_out if depthwise else c_in, 1 if depthwise else c_out, k, scale=(k * fan) ** -0.5)}
        if bias:
            p["b"] = torch.zeros(c_out, device=gdev)
        return p

    def res(ch):
        k = cfg.residual_kernel_size
        return {"c1": conv(k, ch, ch // cfg.compress), "c2": conv(1, ch // cfg.compress, ch)}

    f, d = cfg.n_filters, cfg.dimension
    enc = {"conv_in": conv(cfg.kernel_size, 1, f)}
    stages, ch = [], f
    for r in reversed(cfg.ratios):
        stages.append({"res": res(ch), "down": conv(2 * r, ch, 2 * ch)})
        ch *= 2
    enc["stages"] = stages
    enc["conv_out"] = conv(cfg.last_kernel_size, ch, d)
    dec = {"conv_in": conv(cfg.kernel_size, d, ch)}
    dstages = []
    for r in cfg.ratios:
        dstages.append({"up": convtr(2 * r, ch, ch // 2), "res": res(ch // 2)})
        ch //= 2
    dec["stages"] = dstages
    dec["conv_out"] = conv(cfg.last_kernel_size, ch, 1)

    def tlayers():
        n, ff = cfg.t_layers, cfg.t_ff
        return {"layers": {
            "ln1": {"g": torch.ones(n, d, device=gdev), "b": torch.zeros(n, d, device=gdev)},
            "qkv": {"w": normal(n, d, 3 * d, scale=d**-0.5)},
            "out": {"w": normal(n, d, d, scale=d**-0.5)},
            "ls1": torch.full((n, d), cfg.layer_scale, device=gdev),
            "ln2": {"g": torch.ones(n, d, device=gdev), "b": torch.zeros(n, d, device=gdev)},
            "mlp_in": {"w": normal(n, d, ff, scale=d**-0.5)},
            "mlp_out": {"w": normal(n, ff, d, scale=ff**-0.5)},
            "ls2": torch.full((n, d), cfg.layer_scale, device=gdev),
        }}

    def rvq(levels):
        return {"in_proj": {"w": normal(d, cfg.q_dim, scale=d**-0.5)},
                "out_proj": {"w": normal(cfg.q_dim, d, scale=cfg.q_dim**-0.5)},
                "codebooks": normal(levels, cfg.card, cfg.q_dim)}

    tree = {
        "encoder": enc,
        "enc_t": tlayers(),
        "downsample": conv(2 * cfg.down_stride, d, d, bias=False),
        "quantizer": {"first": rvq(1), "rest": rvq(cfg.n_q - 1)},
        "upsample": convtr(2 * cfg.down_stride, d, d, bias=False, depthwise=True),
        "dec_t": tlayers(),
        "decoder": dec,
    }
    return ParamTree(tree, tts_device(device)).requires_grad_(False)


# ──────────────────────────────────────────────────────────────────────
# SEANet
# ──────────────────────────────────────────────────────────────────────


def _res_block(x: torch.Tensor, p) -> torch.Tensor:
    h = causal_conv(F.elu(x), p["c1"])
    h = causal_conv(F.elu(h), p["c2"])
    return x + h


def seanet_encode(params, cfg: MimiConfig, pcm: torch.Tensor) -> torch.Tensor:
    """pcm [B, T] -> latent [B, D, T/960] (25 Hz)."""
    x = causal_conv(pcm[:, None, :], params["conv_in"])
    for stage, r in zip(params["stages"], reversed(cfg.ratios)):
        x = _res_block(x, stage["res"])
        x = causal_conv(F.elu(x), stage["down"], stride=r)
    return causal_conv(F.elu(x), params["conv_out"])


def seanet_decode(params, cfg: MimiConfig, latent: torch.Tensor) -> torch.Tensor:
    """latent [B, D, F25] -> pcm [B, F25*960]."""
    x = causal_conv(latent, params["conv_in"])
    for stage, r in zip(params["stages"], cfg.ratios):
        x = causal_convtr(F.elu(x), stage["up"], stride=r)
        x = _res_block(x, stage["res"])
    return causal_conv(F.elu(x), params["conv_out"])[:, 0]


# ──────────────────────────────────────────────────────────────────────
# bottleneck transformer (causal, windowed, RoPE, layer scales)
# ──────────────────────────────────────────────────────────────────────


def _ln(x: torch.Tensor, p) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p["g"], p["b"], LN_EPS).to(x.dtype)


def _tlayer(h, p, cfg: MimiConfig, q_pos, mask, kh=None, vh=None):
    """One transformer layer on [B, t, D]; with a K/V window (kh, vh
    [B, H, W, hd]) the keys are the window then the new positions. Returns
    (h, keys, values) with the keys rotated."""
    b, t, d = h.shape
    nh, hd = cfg.t_heads, cfg.head_dim
    q, k, v = (_ln(h, p["ln1"]) @ p["qkv"]["w"]).chunk(3, dim=-1)
    q, k, v = (x.reshape(b, t, nh, hd).transpose(1, 2) for x in (q, k, v))
    q, k = _rope(q, k, q_pos, hd)
    if kh is not None:
        k, v = torch.cat([kh.to(k.dtype), k], dim=2), torch.cat([vh.to(v.dtype), v], dim=2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd**-0.5
    probs = torch.softmax(torch.where(mask, logits, _MASKED), dim=-1).to(v.dtype)
    att = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
    h = h + (p["ls1"] * (att @ p["out"]["w"])).to(h.dtype)
    mlp = F.gelu(_ln(h, p["ln2"]) @ p["mlp_in"]["w"]) @ p["mlp_out"]["w"]
    return h + (p["ls2"] * mlp).to(h.dtype), k, v


def mimi_transformer(params, cfg: MimiConfig, x: torch.Tensor) -> torch.Tensor:
    """Causal windowed transformer over [B, T, D]."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    i, j = pos[:, None], pos[None, :]
    mask = ((j <= i) & (i - j < cfg.t_context))[None, None]
    for p in _layers(params["layers"]):
        x, _, _ = _tlayer(x, p, cfg, pos, mask)
    return x


# ──────────────────────────────────────────────────────────────────────
# split residual VQ
# ──────────────────────────────────────────────────────────────────────


def _rvq_encode(p, x: torch.Tensor, n_levels: int, margins: list | None = None) -> torch.Tensor:
    """x [B, T, D] -> codes [B, n_levels, T]. ``margins``, when given,
    receives each level's gap [B, T] between the nearest and the second
    nearest codeword's squared distance."""
    resid = x @ p["in_proj"]["w"]
    codes = []
    for cb in p["codebooks"][:n_levels]:
        d2 = (torch.sum(resid**2, -1, keepdim=True) - 2.0 * resid @ cb.T
              + torch.sum(cb**2, -1)[None, None, :])
        idx = torch.argmin(d2, dim=-1)
        if margins is not None:
            two = torch.topk(d2, 2, dim=-1, largest=False).values
            margins.append(two[..., 1] - two[..., 0])
        resid = resid - cb[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def _rvq_decode(p, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, K, T] -> latent [B, T, D]."""
    quant = sum(p["codebooks"][k][codes[:, k]] for k in range(codes.shape[1]))
    return quant @ p["out_proj"]["w"]


def mimi_encode(params, cfg: MimiConfig, pcm: torch.Tensor, margins: list | None = None) -> torch.Tensor:
    """pcm [B, T] (T a multiple of samples_per_frame) -> tokens [B, n_q, F]
    (int64). ``margins`` receives each RVQ level's distance gap [B, F]."""
    latent = seanet_encode(params["encoder"], cfg, pcm)
    latent = mimi_transformer(params["enc_t"], cfg, latent.transpose(1, 2)).transpose(1, 2)
    latent = causal_conv(latent, params["downsample"], stride=cfg.down_stride, mode="edge").transpose(1, 2)
    q = params["quantizer"]
    sem = _rvq_encode(q["first"], latent, 1, margins)
    aco = _rvq_encode(q["rest"], latent, cfg.n_q - 1, margins)
    return torch.cat([sem, aco], dim=1)


def _latent(params, tokens: torch.Tensor) -> torch.Tensor:
    q = params["quantizer"]
    return _rvq_decode(q["first"], tokens[:, :1]) + _rvq_decode(q["rest"], tokens[:, 1:])


def mimi_decode(params, cfg: MimiConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, n_q, F] -> pcm [B, F*samples_per_frame]."""
    latent = causal_convtr(_latent(params, tokens).transpose(1, 2), params["upsample"], stride=cfg.down_stride)
    latent = mimi_transformer(params["dec_t"], cfg, latent.transpose(1, 2)).transpose(1, 2)
    return seanet_decode(params["decoder"], cfg, latent)


# ──────────────────────────────────────────────────────────────────────
# streaming decode: an O(block) stateful step
# ──────────────────────────────────────────────────────────────────────
#
# State (batch on axis 0 except the transformer's K/V windows, axis 1):
#   up_carry [B, D, k-s]          the upsample's overlap-add tail
#   t: k, v [L, B, H, t_context-1, hd], pos [B]
#   conv_in [B, C, k-1], stages[i]: up [B, C, k-s], c1 [B, C, k-1]
#   conv_out [B, C, k-1]          each causal conv's last inputs


def _sconv(x: torch.Tensor, p, state: torch.Tensor, dilation: int = 1):
    """Streaming causal conv (stride 1): the state is the last (k-1)*d inputs."""
    w = state.shape[-1]
    xc = torch.cat([state.to(x.dtype), x], dim=-1)
    y = conv1d(xc, p["w"], _bias(p), dilation=dilation, pad=0)
    return y, (xc[..., xc.shape[-1] - w:] if w else state)


def _sconvtr(x: torch.Tensor, p, stride: int, carry: torch.Tensor):
    """Streaming causal ConvTranspose1d: emit T*stride samples, carry the
    bias-free k - stride tail into the next block."""
    k = p["w"].shape[-1]
    full = conv_transpose1d(x, p["w"], None, stride=stride, pad=0, groups=_tr_groups(x, p["w"]))
    t_out = x.shape[-1] * stride
    y = full[..., :t_out]
    if k > stride:
        y = torch.cat([y[..., : k - stride] + carry.to(y.dtype), y[..., k - stride:]], dim=-1)
    if "b" in p:
        y = y + p["b"][:, None]
    return y, full[..., t_out:]


def _stream_transformer(params, cfg: MimiConfig, x: torch.Tensor, tstate: dict):
    """Windowed-causal transformer over new positions [B, t, D] with a K/V
    window of rotated keys; per-row ``pos`` lets rows stream at different
    phases (a fresh row has pos 0)."""
    b, t, _ = x.shape
    w_h = cfg.t_context - 1
    pos0 = torch.as_tensor(tstate["pos"], dtype=torch.int64, device=x.device).reshape(-1).expand(b)
    q_pos = pos0[:, None] + torch.arange(t, device=x.device)
    k_pos = pos0[:, None] - w_h + torch.arange(w_h + t, device=x.device)
    rel = q_pos[:, :, None] - k_pos[:, None, :]
    mask = ((rel >= 0) & (rel < cfg.t_context) & (k_pos[:, None, :] >= 0))[:, None]
    ks, vs = [], []
    for i, p in enumerate(_layers(params["layers"])):
        x, k, v = _tlayer(x, p, cfg, q_pos, mask, tstate["k"][i], tstate["v"][i])
        ks.append(k[:, :, k.shape[2] - w_h:] if w_h else tstate["k"][i])
        vs.append(v[:, :, v.shape[2] - w_h:] if w_h else tstate["v"][i])
    return x, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pos0 + t}


def init_mimi_stream_state(params, cfg: MimiConfig, batch: int = 1) -> dict:
    """Zero decode-stream state (the full decode's zero left padding)."""
    dp = params["decoder"]
    dt, dev = dp["conv_in"]["w"].dtype, dp["conv_in"]["w"].device

    def conv_state(p, dilation=1):
        c_in, k = p["w"].shape[1], p["w"].shape[-1]
        return torch.zeros((batch, c_in, (k - 1) * dilation), dtype=dt, device=dev)

    def tr_carry(p, stride, depthwise=False):
        w = p["w"]
        c_out = w.shape[0] if depthwise else w.shape[1]
        return torch.zeros((batch, c_out, max(w.shape[-1] - stride, 0)), dtype=dt, device=dev)

    kv = (cfg.t_layers, batch, cfg.t_heads, cfg.t_context - 1, cfg.head_dim)
    return {
        "up_carry": tr_carry(params["upsample"], cfg.down_stride, depthwise=True),
        "t": {"k": torch.zeros(kv, dtype=dt, device=dev), "v": torch.zeros(kv, dtype=dt, device=dev),
              "pos": torch.zeros((batch,), dtype=torch.int64, device=dev)},
        "conv_in": conv_state(dp["conv_in"]),
        "stages": [{"up": tr_carry(st["up"], r), "c1": conv_state(st["res"]["c1"])}
                   for st, r in zip(dp["stages"], cfg.ratios)],
        "conv_out": conv_state(dp["conv_out"]),
    }


def select_mimi_stream_rows(mask: torch.Tensor, on_true: dict, on_false: dict) -> dict:
    """Per-row where() over two decode-stream states; mask [B] bool."""
    def w0(a, b):  # batch on axis 0
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    def w1(a, b):  # batch on axis 1 (the stacked K/V windows)
        return torch.where(mask.reshape((1, -1) + (1,) * (a.dim() - 2)), a, b)

    ta, tb = on_true["t"], on_false["t"]
    return {
        "up_carry": w0(on_true["up_carry"], on_false["up_carry"]),
        "t": {"k": w1(ta["k"], tb["k"]), "v": w1(ta["v"], tb["v"]),
              "pos": torch.where(mask, ta["pos"], tb["pos"])},
        "conv_in": w0(on_true["conv_in"], on_false["conv_in"]),
        "stages": [{"up": w0(sa["up"], sb["up"]), "c1": w0(sa["c1"], sb["c1"])}
                   for sa, sb in zip(on_true["stages"], on_false["stages"])],
        "conv_out": w0(on_true["conv_out"], on_false["conv_out"]),
    }


def _zeros_like(state):
    if isinstance(state, dict):
        return {k: _zeros_like(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_zeros_like(v) for v in state]
    return torch.zeros_like(state)


def zero_mimi_stream_rows(state: dict, mask: torch.Tensor) -> dict:
    """The rows where ``mask`` is True reset to a fresh stream (a zero row
    is exactly a fresh stream), the others untouched."""
    return select_mimi_stream_rows(mask, _zeros_like(state), state)


def mimi_decode_step(params, cfg: MimiConfig, tokens: torch.Tensor, state: dict):
    """tokens [B, n_q, m] -> (pcm [B, m*samples_per_frame], new state);
    work O(m), independent of the audio the stream has produced."""
    x, up_carry = _sconvtr(_latent(params, tokens).transpose(1, 2), params["upsample"], cfg.down_stride,
                           state["up_carry"])
    x, tstate = _stream_transformer(params["dec_t"], cfg, x.transpose(1, 2), state["t"])
    dp = params["decoder"]
    x, s_in = _sconv(x.transpose(1, 2), dp["conv_in"], state["conv_in"])
    new_stages = []
    for stage, st, r in zip(dp["stages"], state["stages"], cfg.ratios):
        x, up_c = _sconvtr(F.elu(x), stage["up"], r, st["up"])
        h, c1_s = _sconv(F.elu(x), stage["res"]["c1"], st["c1"])
        c2 = stage["res"]["c2"]
        x = x + conv1d(F.elu(h), c2["w"], _bias(c2), pad=0)  # k=1: stateless
        new_stages.append({"up": up_c, "c1": c1_s})
    x, s_out = _sconv(F.elu(x), dp["conv_out"], state["conv_out"])
    return x[:, 0], {"up_carry": up_carry, "t": tstate, "conv_in": s_in, "stages": new_stages,
                     "conv_out": s_out}


class MimiStreamingDecoder:
    """Block-streaming Mimi decode through the stateful O(block) step:
    ``feed`` splits incoming frames into ``block_frames`` chunks."""

    def __init__(self, params, cfg: MimiConfig, block_frames: int = 8) -> None:
        self.params = params
        self.cfg = cfg
        self.block = block_frames
        self._state = None  # made at the first feed, for its batch

    def feed(self, tokens) -> np.ndarray:
        """tokens [B, n_q, F_new] -> float32 pcm [B, F_new*samples_per_frame]."""
        dev = self.params["decoder"]["conv_in"]["w"].device
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(dev)
        outs = []
        with inference():
            if self._state is None:
                self._state = init_mimi_stream_state(self.params, self.cfg, batch=tokens.shape[0])
            for i in range(0, tokens.shape[2], self.block):
                pcm, self._state = mimi_decode_step(self.params, self.cfg, tokens[:, :, i: i + self.block],
                                                    self._state)
                outs.append(pcm.float().cpu().numpy())
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)

