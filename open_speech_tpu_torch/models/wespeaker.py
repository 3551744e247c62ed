"""WeSpeaker ResNet34 speaker embedding (pyannote 3.1's embedding model) in PyTorch.

Counterpart of ``open_speech_tpu/models/wespeaker.py``: kaldi 80-dim log
fbank (CMN) -> ResNet34 (m_channels=32, blocks 3/4/6/3) -> temporal
statistics pooling (TSTP: mean ++ std over time of the flattened
channel x freq map; the std unbiased, ddof 1) -> Linear(5120->256), L2
normalized. This is wespeaker-voxceleb-resnet34-LM's topology, the model
pyannote/speaker-diarization-3.1 embeds with.

``WeSpeakerModel`` keeps the torch geometry [B, 1, F, T] and PyTorch's
convolution layout [O, I, kh, kw]. Its BatchNorms are folded at load into
a per-channel scale ``s`` and shift ``b`` applied after each convolution,
as the JAX module folds them (inference only). The k=3 convolutions pad 1
on both sides whatever the stride, the k=1 shortcuts pad 0. The
convolutions are cuDNN's on the card, in float32 (``inference()``).

``convert_wespeaker`` maps the released state dict (``conv1``/``bn1``,
``layer{1..4}.{i}`` BasicBlocks with ``shortcut`` or ``downsample``,
``seg_1``), ``wespeaker_params_from_jax`` the JAX tree (numpy arrays, HWIO
convolutions), and ``init_wespeaker_params`` draws random weights from a
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.models.diarize import build_model, diarizer_device, l2_normalize
from open_speech_tpu_torch.ops.mel import _dft_bases_raw
from open_speech_tpu_torch.ops.vocoder import inference

SAMPLE_RATE = 16000
FRAME_LEN = 400   # 25 ms
FRAME_HOP = 160   # 10 ms
N_FFT = 512       # kaldi rounds 400 up to the next power of two


@dataclass(frozen=True)
class WeSpeakerConfig:
    n_mels: int = 80
    m_channels: int = 32
    num_blocks: tuple = (3, 4, 6, 3)
    embed_dim: int = 256

    @property
    def stats_dim(self) -> int:
        # channels*freq after 3 stride-2 stages, x2 for mean++std
        return 2 * (8 * self.m_channels) * (self.n_mels // 8)


def _kaldi_mel_banks(n_mels: int = 80, n_fft: int = N_FFT,
                     sample_rate: float = 16000.0,
                     low_freq: float = 20.0, high_freq: float = 0.0):
    """Kaldi mel filterbank: triangles in mel space over FFT bins, no
    normalization (torchaudio.compliance.kaldi semantics, vad-style)."""
    if high_freq <= 0:
        high_freq = sample_rate / 2 + high_freq
    to_mel = lambda hz: 1127.0 * np.log(1.0 + hz / 700.0)  # noqa: E731
    mel_low, mel_high = to_mel(low_freq), to_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    bins = np.arange(n_fft // 2 + 1)
    fft_mel = to_mel(bins * sample_rate / n_fft)  # mel of each FFT bin
    banks = np.zeros((n_mels, len(bins)), np.float32)
    for m in range(n_mels):
        left = mel_low + m * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (fft_mel - left) / (center - left)
        down = (right - fft_mel) / (right - center)
        banks[m] = np.maximum(0.0, np.minimum(up, down))
    return banks  # [n_mels, n_fft//2+1]


def kaldi_fbank(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """float32 waveform [B, S] (±1 range) -> kaldi log-fbank [B, T, n_mels].

    torchaudio.compliance.kaldi.fbank with dither=0 as wespeaker uses it:
    int16 scaling, per-frame DC removal, pre-emphasis 0.97, povey window,
    snip-edges framing, power spectrum, kaldi mel banks, log(max(x, eps)),
    then per-utterance cepstral mean subtraction.
    """
    dev = audio.device
    with inference():
        x = audio.float() * 32768.0
        frames = x.unfold(-1, FRAME_LEN, FRAME_HOP)  # [B, T, 400], snip edges
        frames = frames - frames.mean(dim=-1, keepdim=True)  # remove_dc_offset
        pre = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - 0.97 * pre
        n = torch.arange(FRAME_LEN, device=dev)
        povey = (0.5 - 0.5 * torch.cos(2 * torch.pi * n / (FRAME_LEN - 1))) ** 0.85
        frames = F.pad(frames * povey, (0, N_FFT - FRAME_LEN))
        cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _dft_bases_raw(N_FFT))
        power = (frames @ cos_b) ** 2 + (frames @ sin_b) ** 2
        mel = power @ torch.from_numpy(_kaldi_mel_banks(n_mels).T.copy()).to(dev)
        logmel = torch.log(torch.clamp(mel, min=1.1920928955078125e-07))  # f32 eps
        return logmel - logmel.mean(dim=-2, keepdim=True)  # CMN over time


# ──────────────────────────────────────────────────────────────────────
# the module
# ──────────────────────────────────────────────────────────────────────


class FoldedBN(nn.Module):
    """A BatchNorm folded into per-channel scale ``s`` and shift ``b``."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.s = nn.Parameter(torch.ones(c))
        self.b = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.s[:, None, None] + self.b[:, None, None]


def _conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=1 if k == 3 else 0, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, shortcut: bool) -> None:
        super().__init__()
        self.conv1 = _conv(cin, cout, stride=stride)
        self.bn1 = FoldedBN(cout)
        self.conv2 = _conv(cout, cout)
        self.bn2 = FoldedBN(cout)
        if shortcut:
            self.short = nn.Module()
            self.short.conv = _conv(cin, cout, k=1, stride=stride)
            self.short.bn = FoldedBN(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if hasattr(self, "short"):
            x = self.short.bn(self.short.conv(x))
        return F.relu(h + x)


class WeSpeakerModel(nn.Module):
    """fbank [B, T, n_mels] -> L2-normalized embeddings [B, embed_dim]."""

    def __init__(self, cfg: WeSpeakerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        m = cfg.m_channels
        self.conv1 = _conv(1, m)
        self.bn1 = FoldedBN(m)
        layers, cin = [], m
        for li, n in enumerate(cfg.num_blocks):
            cout = m * (1 << li)
            stride = 2 if li > 0 else 1
            layers.append(nn.ModuleList(
                BasicBlock(cin if bi == 0 else cout, cout, stride if bi == 0 else 1,
                           shortcut=bi == 0 and (li > 0 or cin != cout))
                for bi in range(n)))
            cin = cout
        self.layers = nn.ModuleList(layers)
        self.seg = nn.Linear(cfg.stats_dim, cfg.embed_dim)

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        x = fbank.float().transpose(1, 2)[:, None]  # torch geometry [B, 1, F, T]
        x = F.relu(self.bn1(self.conv1(x)))
        for blocks in self.layers:
            for blk in blocks:
                x = blk(x)
        b, c, f, t = x.shape
        x = x.reshape(b, c * f, t)  # TSTP: channels x freq, flattened
        mean = x.mean(dim=-1)
        std = torch.sqrt(x.var(dim=-1, correction=1) + 1e-7)
        return l2_normalize(self.seg(torch.cat([mean, std], dim=-1)))


def wespeaker_embed(model: WeSpeakerModel, fbank: torch.Tensor) -> torch.Tensor:
    """fbank [B, T, n_mels] -> L2-normalized embeddings [B, embed_dim]."""
    with inference():
        return model(fbank)


def _fold_bn(w, b, mean, var, eps=1e-5) -> tuple[np.ndarray, np.ndarray]:
    s = np.asarray(w) / np.sqrt(np.asarray(var) + eps)
    return s, np.asarray(b) - np.asarray(mean) * s


def _block_names(cfg: WeSpeakerConfig):
    """(layer index, block index, module path, has a shortcut) of every block."""
    m = cfg.m_channels
    for li, n in enumerate(cfg.num_blocks):
        for bi in range(n):
            cin = m if li == 0 else m * (1 << (li - 1))
            short = bi == 0 and (li > 0 or cin != m * (1 << li))
            yield li, bi, f"layers.{li}.{bi}", short


def convert_wespeaker(src, device=None) -> tuple[WeSpeakerModel, WeSpeakerConfig]:
    """wespeaker ResNet34 state_dict (path / mapping) -> (``WeSpeakerModel``, cfg).

    Torch keys: conv1.weight, bn1.*, layer{1..4}.{i}.conv{1,2}.weight,
    layer{1..4}.{i}.bn{1,2}.*, layer{...}.{i}.shortcut.0.weight +
    .shortcut.1.* (also accepted as 'downsample'), seg_1.{weight,bias}.
    BatchNorms fold into scale/bias (in numpy, as the JAX converter folds).
    """
    from open_speech_tpu_torch.models.ckptutil import load_state_dict

    src = load_state_dict(
        src, strip_prefixes=("module.", "model.", "speaker_encoder.")
    )
    num_blocks = tuple(
        1 + max(
            int(k.split(".")[1]) for k in src if k.startswith(f"layer{li}.")
        )
        for li in range(1, 5)
    )
    cfg = WeSpeakerConfig(
        n_mels=80,
        m_channels=src["conv1.weight"].shape[0],
        num_blocks=num_blocks,
        embed_dim=src["seg_1.weight"].shape[0],
    )
    t = {}

    def bn(prefix, name):
        t[f"{name}.s"], t[f"{name}.b"] = _fold_bn(
            src[f"{prefix}.weight"], src[f"{prefix}.bias"],
            src[f"{prefix}.running_mean"], src[f"{prefix}.running_var"],
        )

    t["conv1.weight"] = src["conv1.weight"]
    bn("bn1", "bn1")
    for li, bi, name, short in _block_names(cfg):
        p = f"layer{li + 1}.{bi}"
        for i in (1, 2):
            t[f"{name}.conv{i}.weight"] = src[f"{p}.conv{i}.weight"]
            bn(f"{p}.bn{i}", f"{name}.bn{i}")
        if short:
            kind = "shortcut" if f"{p}.shortcut.0.weight" in src else "downsample"
            t[f"{name}.short.conv.weight"] = src[f"{p}.{kind}.0.weight"]
            bn(f"{p}.{kind}.1", f"{name}.short.bn")
    t["seg.weight"], t["seg.bias"] = src["seg_1.weight"], src["seg_1.bias"]
    return build_model(cfg, WeSpeakerModel, t, diarizer_device(device)), cfg


def wespeaker_params_from_jax(tree: dict, cfg: WeSpeakerConfig, device=None) -> WeSpeakerModel:
    """The JAX WeSpeaker tree (numpy arrays) as a ``WeSpeakerModel``:
    HWIO convolutions -> OIHW, the folded BatchNorms as they are, ``seg``
    transposed."""
    def oihw(w):
        return np.asarray(w).transpose(3, 2, 0, 1)

    t = {"conv1.weight": oihw(tree["conv1"]), "bn1.s": tree["bn1"]["s"], "bn1.b": tree["bn1"]["b"]}
    for li, bi, name, short in _block_names(cfg):
        blk = tree["layers"][li][bi]
        for i in (1, 2):
            t[f"{name}.conv{i}.weight"] = oihw(blk[f"conv{i}"])
            t[f"{name}.bn{i}.s"], t[f"{name}.bn{i}.b"] = blk[f"bn{i}"]["s"], blk[f"bn{i}"]["b"]
        if short:
            t[f"{name}.short.conv.weight"] = oihw(blk["short"]["conv"])
            t[f"{name}.short.bn.s"], t[f"{name}.short.bn.b"] = blk["short"]["bn"]["s"], blk["short"]["bn"]["b"]
    t["seg.weight"], t["seg.bias"] = np.asarray(tree["seg"]["w"]).T, tree["seg"]["b"]
    return build_model(cfg, WeSpeakerModel, t, diarizer_device(device))


def init_wespeaker_params(generator: torch.Generator | None = None,
                          cfg: WeSpeakerConfig = WeSpeakerConfig(), device=None) -> WeSpeakerModel:
    """Random weights in the JAX init's distributions (convolutions normal,
    scaled by fan-in; identity BatchNorms) from ``generator`` (seed 0 when
    None)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def conv(cin, cout, k=3):
        return (torch.randn((cout, cin, k, k), generator=gen) * (k * k * cin) ** -0.5).numpy()

    def bn(name, c):
        t[f"{name}.s"], t[f"{name}.b"] = np.ones(c, np.float32), np.zeros(c, np.float32)

    m = cfg.m_channels
    t = {"conv1.weight": conv(1, m)}
    bn("bn1", m)
    for li, bi, name, short in _block_names(cfg):
        cout = m * (1 << li)
        cin = (m if li == 0 else cout // 2) if bi == 0 else cout
        t[f"{name}.conv1.weight"] = conv(cin, cout)
        t[f"{name}.conv2.weight"] = conv(cout, cout)
        bn(f"{name}.bn1", cout)
        bn(f"{name}.bn2", cout)
        if short:
            t[f"{name}.short.conv.weight"] = conv(cin, cout, k=1)
            bn(f"{name}.short.bn", cout)
    t["seg.weight"] = (torch.randn((cfg.embed_dim, cfg.stats_dim), generator=gen)
                       * cfg.stats_dim**-0.5).numpy()
    t["seg.bias"] = np.zeros(cfg.embed_dim, np.float32)
    return build_model(cfg, WeSpeakerModel, t, diarizer_device(device))


def find_wespeaker_checkpoint() -> Path | None:
    """OS_WESPEAKER_CKPT_PATH, then the HF cache layout."""
    from open_speech_tpu_torch.models.ckptutil import find_checkpoint

    return find_checkpoint(
        "OS_WESPEAKER_CKPT_PATH",
        ("models--pyannote--wespeaker-voxceleb-resnet34-LM/"
         "snapshots/*/pytorch_model.bin",),
    )
