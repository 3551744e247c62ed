"""Silero VAD v5 in PyTorch: STFT front-end, conv encoder, LSTM head.

Counterpart of ``open_speech_tpu/models/vad/silero.py``, with its contract:

  - 512-sample windows of float32 16 kHz mono audio,
  - per-stream recurrent state of shape [2, 1, 128] (h and c of the LSTM),
  - ``SileroVAD.__call__`` returns the max window probability over a chunk,
  - ``is_speech`` and ``get_speech_segments`` keep the same thresholds,
    window math and segment semantics (``segments_from_probs``).

The graph is the silero-vad v5 ONNX model's: windowed-DFT magnitude
(reflect pad 64, 256-sample frames, hop 128), four ReLU conv1d blocks
(129→128→64→64→128, strides 1/2/2/1, k=3, pad 1), an LSTM cell (128, gate
order i, f, g, o), then ReLU → 1x1 projection → sigmoid. Weights keep the
JAX package's layouts (conv [k, in, out], LSTM [in, 4H]), and every product
is a matmul, so the card computes in float32 (a float32 convolution would
go through cuDNN in TF32). ``vad_scan`` runs the front-end of all of a
chunk's windows as one batch (the windows are independent) and threads
the recurrent state through them; it runs exactly the windows it is given.

The model lives on the device ``vad_device`` resolves: ``OS_VAD_DEVICE``
when it names one (``cpu``, or any torch device), else the STT device the
caller passes (the card by default). The JAX package's default is the host
CPU, and it falls back to its default device when the one asked for is
missing; here a device that is not there raises.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.config import settings

logger = logging.getLogger(__name__)

VAD_SAMPLE_RATE = 16000
WINDOW = 512  # 32 ms
_N_FFT = 256
_HOP = 128
_PAD = 64  # reflect pad, both sides
_N_BINS = _N_FFT // 2 + 1  # 129
_HIDDEN = 128
# (in, out, stride) of the four encoder convolutions
_ENC = ((_N_BINS, 128, 1), (128, 64, 2), (64, 64, 2), (64, 128, 1))

_vad_models: dict[str, "SileroVAD"] = {}
_vad_lock = threading.Lock()


@dataclass
class Segment:
    """A detected speech segment."""

    start_ms: int
    end_ms: int


class SileroNet(nn.Module):
    """Silero v5 weights, in the JAX package's layouts (zeros until filled)."""

    def __init__(self) -> None:
        super().__init__()
        self.stft_re = nn.Parameter(torch.zeros(_N_FFT, _N_BINS))  # [256, 129]
        self.stft_im = nn.Parameter(torch.zeros(_N_FFT, _N_BINS))
        self.enc_w = nn.ParameterList(
            nn.Parameter(torch.zeros(3, cin, cout)) for cin, cout, _ in _ENC
        )
        self.enc_b = nn.ParameterList(
            nn.Parameter(torch.zeros(cout)) for _, cout, _ in _ENC
        )
        self.lstm_wi = nn.Parameter(torch.zeros(_HIDDEN, 4 * _HIDDEN))
        self.lstm_wh = nn.Parameter(torch.zeros(_HIDDEN, 4 * _HIDDEN))
        self.lstm_b = nn.Parameter(torch.zeros(4 * _HIDDEN))
        self.head_w = nn.Parameter(torch.zeros(_HIDDEN, 1))
        self.head_b = nn.Parameter(torch.zeros(1))
        self.requires_grad_(False).eval()

    @property
    def device(self) -> torch.device:
        return self.stft_re.device

    def features(self, audio: torch.Tensor) -> torch.Tensor:
        """Windows [B, 512] -> encoder features [B, F', 128]."""
        x = F.pad(audio[:, None, :], (_PAD, _PAD), mode="reflect")[:, 0]
        frames = x.unfold(-1, _N_FFT, _HOP)  # [B, F, 256]
        re = frames @ self.stft_re
        im = frames @ self.stft_im
        h = torch.sqrt(re * re + im * im + 1e-12)  # [B, F, 129]
        for (_, _, stride), w, b in zip(_ENC, self.enc_w, self.enc_b):
            h = torch.relu(_conv1d(h, w, b, stride))
        return h

    def cell(self, feat: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor):
        """One LSTM step, gate order i, f, g, o."""
        gates = feat @ self.lstm_wi + hx @ self.lstm_wh + self.lstm_b
        i, f, g, o = gates.split(_HIDDEN, dim=-1)
        c_new = torch.sigmoid(f) * cx + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(torch.relu(h) @ self.head_w + self.head_b)[..., 0]


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int):
    """x [B, T, Cin], w [3, Cin, Cout], pad 1 -> [B, T', Cout] (a matmul)."""
    frames = F.pad(x, (0, 0, 1, 1)).unfold(1, w.shape[0], stride)  # [B, T', Cin, 3]
    return torch.einsum("btck,kco->bto", frames, w) + b


@torch.no_grad()
def vad_step(model: SileroNet, audio: torch.Tensor, state: torch.Tensor):
    """One VAD step over a batch of windows.

    audio: [B, 512] float32; state: [2, B, 128] (h, c).
    Returns (probs [B], new_state [2, B, 128]).
    """
    feats = model.features(audio)
    hx, cx = state[0], state[1]
    for t in range(feats.shape[1]):
        hx, cx = model.cell(feats[:, t], hx, cx)
    return model.head(hx), torch.stack([hx, cx])


@torch.no_grad()
def vad_scan(model: SileroNet, windows: torch.Tensor, state: torch.Tensor):
    """Sequential windows of ONE stream.

    windows: [N, 512] float32; state: [2, 1, 128]. Returns (probs [N], the
    state after window N-1). The front-end runs once over all N windows;
    the recurrence steps through them in order.
    """
    feats = model.features(windows)  # [N, F', 128]
    hx, cx = state[0], state[1]
    hs = []
    for n in range(feats.shape[0]):
        for t in range(feats.shape[1]):
            hx, cx = model.cell(feats[n : n + 1, t], hx, cx)
        hs.append(hx)
    if not hs:
        return windows.new_zeros((0,)), state
    return model.head(torch.cat(hs)), torch.stack([hx, cx])


def segments_from_probs(
    probs: np.ndarray,
    *,
    threshold: float,
    window_ms: int,
    min_speech_ms: int,
    silence_ms: int,
    total_ms: int,
) -> list[Segment]:
    """Turn a per-window probability track into speech segments.

    A segment opens at the first window >= threshold; it closes once
    ``silence_ms`` of consecutive sub-threshold windows accumulate, ending
    at the first window of that silence run; segments shorter than
    ``min_speech_ms`` of accumulated speech windows are dropped; a segment
    still open at the end of the track is closed at ``total_ms``.
    """
    need_silence = max(1, silence_ms // window_ms)
    need_speech = max(1, min_speech_ms // window_ms)

    out: list[Segment] = []
    open_at: int | None = None  # ms where the current segment began
    voiced = 0  # speech windows inside the current segment
    quiet_run = 0  # trailing sub-threshold windows

    for w, p in enumerate(np.asarray(probs)):
        t_ms = w * window_ms
        if p >= threshold:
            if open_at is None:
                open_at = t_ms
                voiced = 0
            voiced += 1
            quiet_run = 0
        elif open_at is not None:
            quiet_run += 1
            if quiet_run >= need_silence:
                if voiced >= need_speech:
                    out.append(Segment(start_ms=open_at, end_ms=t_ms))
                open_at, voiced, quiet_run = None, 0, 0

    if open_at is not None and voiced >= need_speech:
        out.append(Segment(start_ms=open_at, end_ms=total_ms))
    return out


class SileroVAD:
    """Per-stream VAD.

    ``session`` is the shared ``SileroNet``; each instance carries its own
    recurrent state, on the model's device. ``calls`` counts chunk
    evaluations (``__call__``).
    """

    def __init__(self, session: SileroNet, threshold: float = 0.5):
        self.session = session
        self.sample_rate = VAD_SAMPLE_RATE
        self.threshold = threshold
        self.calls = 0
        self.reset()

    def reset(self) -> None:
        self._state = torch.zeros((2, 1, _HIDDEN), device=self.session.device)

    def _prob_track(self, audio: np.ndarray) -> np.ndarray:
        """Per-window probabilities over consecutive 512-sample windows, in
        one pass over the device and one host sync."""
        n = (len(audio) - WINDOW) // WINDOW + 1 if len(audio) >= WINDOW else 0
        if n <= 0:
            return np.zeros((0,), np.float32)
        windows = np.ascontiguousarray(audio[: n * WINDOW], dtype=np.float32).reshape(
            n, WINDOW
        )
        probs, self._state = vad_scan(
            self.session, torch.from_numpy(windows).to(self.session.device), self._state
        )
        return probs.cpu().numpy().astype(np.float32)

    def __call__(self, audio: np.ndarray) -> float:
        """Max speech probability over consecutive 512-sample windows."""
        self.calls += 1
        if len(audio) == 0:
            return 0.0
        track = self._prob_track(audio)
        return float(track.max()) if track.size else 0.0

    def is_speech(self, pcm16_bytes: bytes, threshold: float | None = None) -> bool:
        if not pcm16_bytes:
            return False
        audio = np.frombuffer(pcm16_bytes, dtype=np.int16).astype(np.float32) / 32768.0
        return self(audio) >= (threshold if threshold is not None else self.threshold)

    def get_speech_segments(
        self,
        pcm16_bytes: bytes,
        threshold: float | None = None,
        min_speech_ms: int = 250,
        silence_ms: int = 800,
    ) -> list[Segment]:
        """Hysteresis segmentation over the whole clip."""
        if not pcm16_bytes:
            return []
        audio = np.frombuffer(pcm16_bytes, dtype=np.int16).astype(np.float32) / 32768.0
        return segments_from_probs(
            self._prob_track(audio),
            threshold=threshold if threshold is not None else self.threshold,
            window_ms=WINDOW * 1000 // self.sample_rate,
            min_speech_ms=min_speech_ms,
            silence_ms=silence_ms,
            total_ms=len(audio) * 1000 // self.sample_rate,
        )


# ── weights ───────────────────────────────────────────────────────────


def _dft_basis() -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed DFT basis, the shape silero's STFT conv basis has."""
    n = np.arange(_N_FFT)[:, None]
    kk = np.arange(_N_BINS)[None, :]
    ang = 2.0 * np.pi * n * kk / _N_FFT
    window = np.hanning(_N_FFT + 1)[:-1]
    return np.cos(ang) * window[:, None], -np.sin(ang) * window[:, None]


@torch.no_grad()
def _fill(model: SileroNet, tree: dict) -> SileroNet:
    """Copy a JAX-layout parameter tree (numpy leaves) into ``model``."""

    def put(dst: torch.Tensor, src) -> None:
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))

    put(model.stft_re, tree["stft_re"])
    put(model.stft_im, tree["stft_im"])
    for i in range(len(_ENC)):
        put(model.enc_w[i], tree[f"enc{i}"]["w"])
        put(model.enc_b[i], tree[f"enc{i}"]["b"])
    put(model.lstm_wi, tree["lstm"]["wi"])
    put(model.lstm_wh, tree["lstm"]["wh"])
    put(model.lstm_b, tree["lstm"]["b"])
    put(model.head_w, tree["head"]["w"])
    put(model.head_b, tree["head"]["b"])
    return model


def vad_params_from_jax_tree(tree: dict, device=None) -> SileroNet:
    """The JAX package's VAD param pytree (numpy leaves) -> ``SileroNet``."""
    return _fill(SileroNet(), tree).to(device or "cpu")


@torch.no_grad()
def init_vad_params(generator: torch.Generator | None = None, device=None) -> SileroNet:
    """Random-init weights with the silero-v5 topology, drawn from
    ``generator`` (seeded 42 on the CPU when not given), then moved to
    ``device`` (the generator's device when not given)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(42)

    def normal(*shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=gen.device) * std

    re, im = _dft_basis()
    tree = {"stft_re": re, "stft_im": im}
    for i, (cin, cout, _) in enumerate(_ENC):
        tree[f"enc{i}"] = {
            "w": normal(3, cin, cout, std=(3 * cin) ** -0.5).cpu().numpy(),
            "b": np.zeros(cout),
        }
    tree["lstm"] = {
        "wi": normal(_HIDDEN, 4 * _HIDDEN, std=_HIDDEN**-0.5).cpu().numpy(),
        "wh": normal(_HIDDEN, 4 * _HIDDEN, std=_HIDDEN**-0.5).cpu().numpy(),
        "b": np.zeros(4 * _HIDDEN),
    }
    tree["head"] = {
        "w": normal(_HIDDEN, 1, std=_HIDDEN**-0.5).cpu().numpy(),
        "b": np.zeros(1),
    }
    return vad_params_from_jax_tree(tree, device or gen.device)


def convert_silero(src: str | Path | bytes | dict, device=None) -> SileroNet:
    """Silero VAD v5 ONNX weights -> ``SileroNet``.

    ``src`` is an ONNX file path or bytes, or an already-parsed name->array
    mapping. Names are matched by suffix, so both ``_model.stft...`` (jit
    export) and ``stft...`` (onnx) prefixes work.
    """
    from open_speech_tpu_torch.models.onnx_io import read_onnx_initializers

    raw = src if isinstance(src, dict) else read_onnx_initializers(src)

    def find(suffix: str) -> np.ndarray:
        matches = [v for k, v in raw.items() if k.endswith(suffix)]
        if not matches:
            raise KeyError(
                f"silero checkpoint missing tensor *{suffix} (have: {sorted(raw)[:8]}...)"
            )
        return np.asarray(matches[0], dtype=np.float32)

    basis = find("stft.forward_basis_buffer").reshape(2 * _N_BINS, _N_FFT)

    def conv(prefix: str) -> dict:
        w = find(f"{prefix}.weight")  # torch [cout, cin, k]
        return {"w": w.transpose(2, 1, 0), "b": find(f"{prefix}.bias")}

    tree = {
        "stft_re": basis[:_N_BINS].T,  # [256, 129]
        "stft_im": basis[_N_BINS:].T,
        **{f"enc{i}": conv(f"encoder.{i}.reparam_conv") for i in range(len(_ENC))},
        "lstm": {  # torch [4H, H], gate order i, f, g, o
            "wi": find("rnn.weight_ih").T,
            "wh": find("rnn.weight_hh").T,
            "b": find("rnn.bias_ih") + find("rnn.bias_hh"),
        },
        "head": {"w": find("decoder.2.weight")[:, :, 0].T, "b": find("decoder.2.bias")},
    }
    return vad_params_from_jax_tree(tree, device)


def _find_vad_checkpoint() -> Path | None:
    """Locate a silero ONNX file: OS_VAD_ONNX_PATH, then
    ~/.cache/silero-vad/silero_vad.onnx."""
    env = os.environ.get("OS_VAD_ONNX_PATH", "")
    candidates = [Path(env)] if env else []
    candidates.append(Path.home() / ".cache" / "silero-vad" / "silero_vad.onnx")
    for c in candidates:
        if c.is_file():
            return c
    return None


def vad_device(stt_device: torch.device | str | None = None) -> torch.device:
    """The VAD's device: ``OS_VAD_DEVICE`` unless it is unset or
    ``default``, else ``stt_device`` (the settings' STT device when not
    given). Raises ``RuntimeError`` if that device is not there."""
    want = (settings.os_vad_device or "").strip()
    name = (stt_device or settings.stt_device) if want in ("", "default") else want
    try:
        device = torch.device(name)
        if device.type == "cuda" and (device.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{torch.cuda.device_count()} CUDA device(s) visible")
        torch.empty(0, device=device)
    except (RuntimeError, AssertionError) as e:  # torch without CUDA asserts
        raise RuntimeError(
            f"VAD device {str(name)!r} is not available (OS_VAD_DEVICE={want!r}): {e}") from e
    return device


def get_vad_model(stt_device: torch.device | str | None = None) -> SileroVAD:
    """The shared VAD on ``vad_device(stt_device)`` (one per device).

    Loads converted silero weights when a checkpoint is on disk; otherwise
    random weights with a warning, so the serving stack stays functional
    for shape and flow testing. Runs one scan so the first chunk pays no
    start-up.
    """
    device = vad_device(stt_device)
    key = str(device)
    with _vad_lock:
        vad = _vad_models.get(key)
        if vad is not None:
            return vad
        ckpt = _find_vad_checkpoint()
        if ckpt is not None:
            model = convert_silero(ckpt, device)
            logger.info("VAD model loaded from %s onto %s", ckpt, key)
        else:
            model = init_vad_params(device=device)
            logger.warning(
                "No silero checkpoint found (OS_VAD_ONNX_PATH unset); VAD running "
                "with random weights — speech probabilities are not meaningful"
            )
        vad_scan(
            model, torch.zeros((4, WINDOW), device=model.device),
            torch.zeros((2, 1, _HIDDEN), device=model.device),
        )
        vad = _vad_models[key] = SileroVAD(model)
        return vad
