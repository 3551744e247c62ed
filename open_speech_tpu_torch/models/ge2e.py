"""GE2E speaker encoder (resemblyzer VoiceEncoder) in PyTorch.

Counterpart of ``open_speech_tpu/models/ge2e.py``: the resemblyzer
``pretrained.pt`` d-vector model, a 3-layer LSTM(40->256) +
Linear(256->256) + ReLU with L2-normalized output, embedding the last
layer's final hidden state. ``GE2EModel`` is one ``nn.LSTM`` (cuDNN's on
the card, float32 under ``inference()``) whose ``bias_ih`` holds the sum of
the checkpoint's two biases and whose ``bias_hh`` is zero, as the JAX scan
keeps one bias.

Front-end: resemblyzer's mel — power mel spectrogram (librosa defaults:
n_fft 400, hop 160, 40 slaney-normalized bands, periodic Hann,
center/reflect), NO log — from ``ops/mel.py``'s window-folded DFT bases
and filterbank.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.models.diarize import build_model, diarizer_device, l2_normalize, lstm_tensors
from open_speech_tpu_torch.ops.mel import _dft_bases, mel_filterbank
from open_speech_tpu_torch.ops.vocoder import inference

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160


@dataclass(frozen=True)
class GE2EConfig:
    n_mels: int = 40
    hidden: int = 256
    layers: int = 3
    embed_dim: int = 256


def ge2e_mel(audio: torch.Tensor, n_mels: int = 40) -> torch.Tensor:
    """Power mel frames [..., T, n_mels] of waveforms [..., S]
    (resemblyzer wav_to_mel_spectrogram)."""
    dev = audio.device
    with inference():
        lead = audio.shape[:-1]
        x = audio.float().reshape(-1, 1, audio.shape[-1])
        x = F.pad(x, (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
        frames = x.unfold(-1, N_FFT, HOP)  # [B, T, n_fft]
        cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _dft_bases(N_FFT))
        power = (frames @ cos_b) ** 2 + (frames @ sin_b) ** 2  # [B, T, n_bins]
        mel = power @ torch.from_numpy(mel_filterbank(n_mels).T.copy()).to(dev)
        return mel.reshape(*lead, *mel.shape[-2:])


class GE2EModel(nn.Module):
    def __init__(self, cfg: GE2EConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.lstm = nn.LSTM(cfg.n_mels, cfg.hidden, cfg.layers, batch_first=True)
        self.proj = nn.Linear(cfg.hidden, cfg.embed_dim)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        _, (h_n, _) = self.lstm(mels.float().contiguous())
        return l2_normalize(F.relu(self.proj(h_n[-1])))


def ge2e_embed(model: GE2EModel, mels: torch.Tensor) -> torch.Tensor:
    """mels [B, T, n_mels] -> L2-normalized d-vectors [B, embed_dim]."""
    with inference():
        return model(mels)


def init_ge2e_params(generator: torch.Generator | None = None, cfg: GE2EConfig = GE2EConfig(),
                     device=None) -> GE2EModel:
    """Random weights in the JAX init's distributions (normal, scaled by
    fan-in; zero biases) from ``generator`` (seed 0 when None)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(*shape, fan_in: int) -> np.ndarray:
        return (torch.randn(shape, generator=gen) * fan_in**-0.5).numpy()

    h, t = cfg.hidden, {}
    for k in range(cfg.layers):
        d_in = cfg.n_mels if k == 0 else h
        t.update(lstm_tensors("lstm", f"l{k}", normal(4 * h, d_in, fan_in=d_in),
                              normal(4 * h, h, fan_in=h), np.zeros(4 * h)))
    t["proj.weight"] = normal(cfg.embed_dim, h, fan_in=h)
    t["proj.bias"] = np.zeros(cfg.embed_dim, np.float32)
    return build_model(cfg, GE2EModel, t, diarizer_device(device))


def convert_ge2e(src, device=None) -> tuple[GE2EModel, GE2EConfig]:
    """resemblyzer checkpoint (path / state-dict mapping) -> (``GE2EModel``, cfg).

    Torch keys: lstm.weight_ih_l{k} [4H, In], lstm.weight_hh_l{k} [4H, H],
    lstm.bias_*_l{k} [4H] (i,f,g,o gate order), linear.weight [E, H],
    linear.bias [E].
    """
    from open_speech_tpu_torch.models.ckptutil import load_state_dict

    src = load_state_dict(src, strip_prefixes=("module.",))

    layers = sorted(
        int(k.split("_l")[-1]) for k in src if k.startswith("lstm.weight_ih_l")
    )
    cfg = GE2EConfig(
        n_mels=src["lstm.weight_ih_l0"].shape[1],
        hidden=src["lstm.weight_hh_l0"].shape[1],
        layers=len(layers),
        embed_dim=src["linear.weight"].shape[0],
    )
    t = {}
    for i, k in enumerate(layers):
        t.update(lstm_tensors("lstm", f"l{i}", src[f"lstm.weight_ih_l{k}"], src[f"lstm.weight_hh_l{k}"],
                              src[f"lstm.bias_ih_l{k}"] + src[f"lstm.bias_hh_l{k}"]))
    t["proj.weight"], t["proj.bias"] = src["linear.weight"], src["linear.bias"]
    return build_model(cfg, GE2EModel, t, diarizer_device(device)), cfg


def ge2e_params_from_jax(tree: dict, cfg: GE2EConfig, device=None) -> GE2EModel:
    """The JAX GE2E tree (numpy arrays) as a ``GE2EModel``: weights transposed."""
    t = {}
    for k, p in enumerate(tree["lstm"]):
        t.update(lstm_tensors("lstm", f"l{k}", np.asarray(p["wi"]).T, np.asarray(p["wh"]).T, p["b"]))
    t["proj.weight"], t["proj.bias"] = np.asarray(tree["proj"]["w"]).T, tree["proj"]["b"]
    return build_model(cfg, GE2EModel, t, diarizer_device(device))


def find_ge2e_checkpoint() -> Path | None:
    """OS_DIARIZER_CKPT_PATH, then resemblyzer's bundled location."""
    import os

    env = os.environ.get("OS_DIARIZER_CKPT_PATH", "")
    candidates = [Path(env)] if env else []
    candidates += [
        Path.home() / ".cache" / "resemblyzer" / "pretrained.pt",
    ]
    for c in candidates:
        if c.is_file():
            return c
    return None
