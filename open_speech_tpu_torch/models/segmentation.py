"""PyanNet speaker segmentation (pyannote/segmentation-3.0 topology) in PyTorch.

Counterpart of ``open_speech_tpu/models/segmentation.py``. The first stage
of pyannote's 3.1 diarization recipe: per-frame speaker activity over 10 s
chunks, overlap-aware through a powerset of local speakers:

  waveform [B, 1, 160000]
    -> InstanceNorm1d(1, affine)                       (wav_norm1d)
    -> SincConv(80 analytic filters, k=251, stride=10) (asteroid ParamSincFB)
       |abs| -> MaxPool(3,3) -> InstanceNorm -> LeakyReLU
    -> Conv1d(80->60, k=5) -> MaxPool(3,3) -> InstanceNorm -> LeakyReLU
    -> Conv1d(60->60, k=5) -> MaxPool(3,3) -> InstanceNorm -> LeakyReLU
    -> BiLSTM x4 (hidden 128)
    -> Linear(256->128) -> LeakyReLU -> Linear(128->128) -> LeakyReLU
    -> Linear(128->7) -> log_softmax            (powerset: 3 spk, overlap<=2)

10 s at 16 kHz gives 589 frames, one every 270 samples. The host helpers
(``SegmentationConfig``, the powerset tables, ``n_frames`` and the asteroid
filter synthesis ``sinc_filters``) are numpy copies of the JAX module's.

``SegmentationModel`` keeps tensors in PyTorch's layouts: the sinc filters
and convolutions [C_out, C_in, K], linears [out, in], and one ``nn.LSTM``
(bidirectional, four layers) whose ``bias_ih`` holds the sum of the
checkpoint's two biases and whose ``bias_hh`` is zero, as the JAX scan
keeps one bias per direction. The convolutions and the LSTM are cuDNN's on
the card, in float32: ``segment_chunks`` runs inside
``ops/vocoder.py:inference()``.

``convert_segmentation`` maps the released state dict onto the module,
``segmentation_params_from_jax`` the JAX package's parameter tree (as numpy
arrays), and ``init_segmentation_params`` draws random weights from a
``torch.Generator`` (seed 30 by default) in the JAX init's distributions.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.models.diarize import build_model, diarizer_device, lstm_tensors
from open_speech_tpu_torch.ops.vocoder import inference

SAMPLE_RATE = 16000
CHUNK_S = 10.0
CHUNK_SAMPLES = int(CHUNK_S * SAMPLE_RATE)  # 160000


@dataclass(frozen=True)
class SegmentationConfig:
    n_sinc: int = 80          # sinc filter pairs output channels (2*40)
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_hidden: int = 60
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_hidden: int = 128
    linear_layers: int = 2
    max_speakers: int = 3     # powerset: subsets of this many local speakers
    max_overlap: int = 2      # ... with at most this many simultaneous

    @property
    def n_classes(self) -> int:
        return len(powerset_classes(self.max_speakers, self.max_overlap))


def powerset_classes(max_speakers: int = 3, max_overlap: int = 2):
    """Ordered powerset: subsets by size then lexicographic (pyannote)."""
    classes: list[tuple[int, ...]] = []
    for size in range(max_overlap + 1):
        classes.extend(combinations(range(max_speakers), size))
    return classes


def powerset_to_multilabel(classes_idx: np.ndarray, cfg: SegmentationConfig):
    """argmax class indices [...,] -> binary activity [..., max_speakers]."""
    table = np.zeros((cfg.n_classes, cfg.max_speakers), np.float32)
    for ci, members in enumerate(powerset_classes(cfg.max_speakers, cfg.max_overlap)):
        for m in members:
            table[ci, m] = 1.0
    return table[np.asarray(classes_idx)]


def n_frames(n_samples: int, cfg: SegmentationConfig = SegmentationConfig()) -> int:
    """Output frames for an input length (mirrors the conv/pool chain)."""
    t = (n_samples - cfg.sinc_kernel) // cfg.sinc_stride + 1
    t = (t - 3) // 3 + 1
    t = t - 4            # conv k=5, no padding
    t = (t - 3) // 3 + 1
    t = t - 4
    t = (t - 3) // 3 + 1
    return t


def sinc_filters(
    low_hz: np.ndarray,
    band_hz: np.ndarray,
    kernel_size: int = 251,
    sample_rate: float = 16000.0,
    min_low_hz: float = 50.0,
    min_band_hz: float = 50.0,
) -> np.ndarray:
    """asteroid ParamSincFB filters: [2*n_pairs, kernel_size] float32.

    cos (band-pass) filters then their sin (analytic) pairs, each
    hamming-half-windowed and normalized by 2*band. Pure numpy — the
    filters are constants at inference, materialized once at load.
    """
    low_hz = np.abs(np.asarray(low_hz, np.float64).reshape(-1, 1))
    band_hz = np.abs(np.asarray(band_hz, np.float64).reshape(-1, 1))
    low = min_low_hz + low_hz
    high = np.clip(low + min_band_hz + band_hz, min_low_hz, sample_rate / 2)
    band = (high - low)[:, 0]

    half = kernel_size // 2
    n_lin = np.linspace(0, kernel_size / 2 - 1, num=half)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n_lin / kernel_size)
    n_ = 2 * np.pi * np.arange(-half, 0.0).reshape(1, -1) / sample_rate

    ft_low = low @ n_
    ft_high = high @ n_
    cos_left = (np.sin(ft_high) - np.sin(ft_low)) / (n_ / 2)
    cos_center = 2 * band.reshape(-1, 1)
    cos_right = np.flip(cos_left, axis=1)
    sin_left = (np.cos(ft_low) - np.cos(ft_high)) / (n_ / 2)
    sin_center = np.zeros_like(cos_center)
    sin_right = -np.flip(sin_left, axis=1)

    def assemble(left, center, right):
        f = np.concatenate([left * window, center, right * window], axis=1)
        return f / (2 * band[:, None])

    return np.concatenate(
        [assemble(cos_left, cos_center, cos_right),
         assemble(sin_left, sin_center, sin_right)],
        axis=0,
    ).astype(np.float32)


def _default_sinc_init(n_pairs: int, sample_rate: float = 16000.0,
                       min_low_hz: float = 50.0, min_band_hz: float = 50.0):
    """Mel-spaced filterbank init (asteroid _initialize_filters)."""
    to_mel = lambda hz: 2595 * np.log10(1 + hz / 700)  # noqa: E731
    to_hz = lambda mel: 700 * (10 ** (mel / 2595) - 1)  # noqa: E731
    low_hz, high_hz = 30.0, sample_rate / 2 - (min_low_hz + min_band_hz)
    mel = np.linspace(to_mel(low_hz), to_mel(high_hz), n_pairs + 1)
    hz = to_hz(mel)
    return hz[:-1].reshape(-1, 1), np.diff(hz).reshape(-1, 1)


# ──────────────────────────────────────────────────────────────────────
# the module
# ──────────────────────────────────────────────────────────────────────


class Affine(nn.Module):
    """An instance norm's per-channel scale ``g`` and shift ``b``."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.g = nn.Parameter(torch.ones(c))
        self.b = nn.Parameter(torch.zeros(c))


def _instance_norm(x: torch.Tensor, p: Affine, eps: float = 1e-5) -> torch.Tensor:
    """x [B, C, T]: normalize over T per (example, channel) + affine (ddof 0)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * p.g[:, None] + p.b[:, None]


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class SegmentationModel(nn.Module):
    """PyanNet: chunks [B, n_samples] -> per-frame log-probs [B, T, classes]."""

    def __init__(self, cfg: SegmentationConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.wav_norm = Affine(1)
        self.register_buffer("sinc", torch.zeros(cfg.n_sinc, 1, cfg.sinc_kernel))
        self.norm0 = Affine(cfg.n_sinc)
        self.conv1 = nn.Conv1d(cfg.n_sinc, cfg.conv_hidden, 5)
        self.norm1 = Affine(cfg.conv_hidden)
        self.conv2 = nn.Conv1d(cfg.conv_hidden, cfg.conv_hidden, 5)
        self.norm2 = Affine(cfg.conv_hidden)
        self.lstm = nn.LSTM(cfg.conv_hidden, cfg.lstm_hidden, num_layers=cfg.lstm_layers,
                            bidirectional=True, batch_first=True)
        self.linear = nn.ModuleList(
            nn.Linear(2 * cfg.lstm_hidden if i == 0 else cfg.linear_hidden, cfg.linear_hidden)
            for i in range(cfg.linear_layers))
        self.classifier = nn.Linear(cfg.linear_hidden, cfg.n_classes)

    @property
    def device(self) -> torch.device:
        return self.sinc.device

    def forward(self, chunks: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _instance_norm(chunks.float()[:, None, :], self.wav_norm)  # [B, 1, S]
        x = F.conv1d(x, self.sinc, stride=cfg.sinc_stride)
        x = _leaky(_instance_norm(F.max_pool1d(x.abs(), 3, 3), self.norm0))
        x = _leaky(_instance_norm(F.max_pool1d(self.conv1(x), 3, 3), self.norm1))
        x = _leaky(_instance_norm(F.max_pool1d(self.conv2(x), 3, 3), self.norm2))
        x, _ = self.lstm(x.transpose(1, 2).contiguous())  # [B, T, 2H]
        for lin in self.linear:
            x = _leaky(lin(x))
        return F.log_softmax(self.classifier(x), dim=-1)


def segment_chunks(model: SegmentationModel, chunks) -> torch.Tensor:
    """waveform chunks [B, n_samples] (numpy or tensor) -> per-frame
    log-probs [B, T, classes] on the model's device."""
    with inference():
        return model(torch.as_tensor(chunks, dtype=torch.float32).to(model.device))


def init_segmentation_params(
    generator: torch.Generator | None = None,
    cfg: SegmentationConfig = SegmentationConfig(),
    device=None,
) -> SegmentationModel:
    """Random weights in the JAX init's distributions (normal weights scaled
    by fan-in, zero biases, unit norms, the mel-spaced sinc bank) from
    ``generator`` (seed 30 when None)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(30)

    def normal(*shape, fan_in: int) -> np.ndarray:
        return (torch.randn(shape, generator=gen) * fan_in**-0.5).numpy()

    low, band = _default_sinc_init(cfg.n_sinc // 2)
    h = cfg.lstm_hidden
    t = {"sinc": sinc_filters(low, band, cfg.sinc_kernel)[:, None, :]}
    for name, c in (("wav_norm", 1), ("norm0", cfg.n_sinc), ("norm1", cfg.conv_hidden),
                    ("norm2", cfg.conv_hidden)):
        t[f"{name}.g"], t[f"{name}.b"] = np.ones(c, np.float32), np.zeros(c, np.float32)
    for name, c_in in (("conv1", cfg.n_sinc), ("conv2", cfg.conv_hidden)):
        t[f"{name}.weight"] = normal(cfg.conv_hidden, c_in, 5, fan_in=5 * c_in)
        t[f"{name}.bias"] = np.zeros(cfg.conv_hidden, np.float32)
    for k in range(cfg.lstm_layers):
        d_in = cfg.conv_hidden if k == 0 else 2 * h
        for sfx in (f"l{k}", f"l{k}_reverse"):
            t.update(lstm_tensors("lstm", sfx, normal(4 * h, d_in, fan_in=d_in),
                                  normal(4 * h, h, fan_in=h), np.zeros(4 * h)))
    for i in range(cfg.linear_layers):
        d_in = 2 * h if i == 0 else cfg.linear_hidden
        t[f"linear.{i}.weight"] = normal(cfg.linear_hidden, d_in, fan_in=d_in)
        t[f"linear.{i}.bias"] = np.zeros(cfg.linear_hidden, np.float32)
    t["classifier.weight"] = normal(cfg.n_classes, cfg.linear_hidden, fan_in=cfg.linear_hidden)
    t["classifier.bias"] = np.zeros(cfg.n_classes, np.float32)
    return build_model(cfg, SegmentationModel, t, diarizer_device(device))


def convert_segmentation(src, device=None) -> tuple[SegmentationModel, SegmentationConfig]:
    """pyannote PyanNet state_dict (path / mapping) -> (``SegmentationModel``, cfg).

    Torch keys (pyannote.audio PyanNet, monolithic bi-LSTM):
      sincnet.wav_norm1d.{weight,bias}                       [1]
      sincnet.conv1d.0.filterbank.{low_hz_,band_hz_}         [40, 1]
      sincnet.conv1d.{1,2}.{weight,bias}     [60,80,5]/[60,60,5], [60]
      sincnet.norm1d.{0,1,2}.{weight,bias}            [80]/[60]/[60]
      lstm.{weight_ih,weight_hh,bias_ih,bias_hh}_l{k}[_reverse]
      linear.{0,1}.{weight,bias}, classifier.{weight,bias}
    The two LSTM biases are summed (in float32 numpy, as the JAX converter
    sums them) into ``bias_ih``.
    """
    from open_speech_tpu_torch.models.ckptutil import load_state_dict

    src = load_state_dict(src)

    n_layers = 1 + max(
        int(k.rsplit("_l", 1)[1].removesuffix("_reverse"))
        for k in src
        if k.startswith("lstm.weight_ih_l")
    )
    cfg = SegmentationConfig(
        n_sinc=2 * src["sincnet.conv1d.0.filterbank.low_hz_"].shape[0],
        conv_hidden=src["sincnet.conv1d.1.weight"].shape[0],
        lstm_hidden=src["lstm.weight_hh_l0"].shape[1],
        lstm_layers=n_layers,
        linear_hidden=src["linear.0.weight"].shape[0],
        linear_layers=1 + max(
            int(k.split(".")[1]) for k in src if k.startswith("linear.")
        ),
    )
    if src["classifier.weight"].shape[0] != cfg.n_classes:
        raise ValueError(
            f"classifier has {src['classifier.weight'].shape[0]} classes; "
            f"expected {cfg.n_classes} (powerset {cfg.max_speakers}/{cfg.max_overlap})"
        )
    low = src["sincnet.conv1d.0.filterbank.low_hz_"]
    band = src["sincnet.conv1d.0.filterbank.band_hz_"]
    t = {"sinc": sinc_filters(low, band, cfg.sinc_kernel)[:, None, :]}
    t["wav_norm.g"], t["wav_norm.b"] = src["sincnet.wav_norm1d.weight"], src["sincnet.wav_norm1d.bias"]
    for i in range(3):
        t[f"norm{i}.g"] = src[f"sincnet.norm1d.{i}.weight"]
        t[f"norm{i}.b"] = src[f"sincnet.norm1d.{i}.bias"]
    for i in (1, 2):
        t[f"conv{i}.weight"] = src[f"sincnet.conv1d.{i}.weight"]
        t[f"conv{i}.bias"] = src[f"sincnet.conv1d.{i}.bias"]
    for k in range(n_layers):
        for sfx in (f"l{k}", f"l{k}_reverse"):
            t.update(lstm_tensors("lstm", sfx, src[f"lstm.weight_ih_{sfx}"], src[f"lstm.weight_hh_{sfx}"],
                                  src[f"lstm.bias_ih_{sfx}"] + src[f"lstm.bias_hh_{sfx}"]))
    for i in range(cfg.linear_layers):
        t[f"linear.{i}.weight"], t[f"linear.{i}.bias"] = src[f"linear.{i}.weight"], src[f"linear.{i}.bias"]
    t["classifier.weight"], t["classifier.bias"] = src["classifier.weight"], src["classifier.bias"]
    return build_model(cfg, SegmentationModel, t, diarizer_device(device)), cfg


def segmentation_params_from_jax(tree: dict, cfg: SegmentationConfig, device=None) -> SegmentationModel:
    """The JAX package's segmentation tree (numpy arrays) as a ``SegmentationModel``:
    convolutions [K, C_in, C_out] -> [C_out, C_in, K], linears and LSTM
    weights transposed, each direction's one bias into ``bias_ih``."""
    t = {"sinc": np.asarray(tree["sinc"]["w"]).transpose(2, 1, 0)}
    for name in ("wav_norm", "norm0", "norm1", "norm2"):
        t[f"{name}.g"], t[f"{name}.b"] = tree[name]["g"], tree[name]["b"]
    for name in ("conv1", "conv2"):
        t[f"{name}.weight"] = np.asarray(tree[name]["w"]).transpose(2, 1, 0)
        t[f"{name}.bias"] = tree[name]["b"]
    for k, layer in enumerate(tree["lstm"]):
        for sfx, p in ((f"l{k}", layer["fwd"]), (f"l{k}_reverse", layer["bwd"])):
            t.update(lstm_tensors("lstm", sfx, np.asarray(p["wi"]).T, np.asarray(p["wh"]).T, p["b"]))
    for i, lin in enumerate(tree["linear"]):
        t[f"linear.{i}.weight"], t[f"linear.{i}.bias"] = np.asarray(lin["w"]).T, lin["b"]
    t["classifier.weight"] = np.asarray(tree["classifier"]["w"]).T
    t["classifier.bias"] = tree["classifier"]["b"]
    return build_model(cfg, SegmentationModel, t, diarizer_device(device))


def find_segmentation_checkpoint() -> Path | None:
    """OS_SEGMENTATION_CKPT_PATH, then the HF cache layout."""
    from open_speech_tpu_torch.models.ckptutil import find_checkpoint

    return find_checkpoint(
        "OS_SEGMENTATION_CKPT_PATH",
        ("models--pyannote--segmentation-3.0/snapshots/*/pytorch_model.bin",),
    )
