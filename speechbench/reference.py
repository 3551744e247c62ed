"""Plain float32 Whisper: the yardstick that decides ``correct``, and its
control one precision down.

It imports nothing of the program. It follows the openai/whisper model
(log-mel front end, conv stem, pre-LN blocks, a cross-attention in every
decoder block, logits against the token embedding) in float64 NumPy for the
front end and float32 PyTorch with TF32 off for the rest, with no cache, no
batching and no kernel. The decoder runs teacher-forced over the prompt and
the served tokens, so its logits at each position are what greedy decoding
through a cache should have seen.

Weights are named as in openai/whisper's state dict (``weights.py`` makes
them). The decoding rules are those the served path states (the JAX
package's ``_suppress_mask`` and ``_apply_rules``): the always-suppressed
special tokens, language tokens included; a blank and <|endoftext|> barred
at the first sampled token, which must be a timestamp no later than
``max_initial_timestamp``; paired and monotonic timestamps; and a timestamp
forced where the timestamps' total probability beats the best other token.

The control (``Weights(..., fp8=True)``) is the same model with every
product of a linear layer, the logits' included, taken over operands
rounded to float8 e4m3 (one scale per row of the activations and per output
channel of the weights, Hopper's fp8 tensor-core type), accumulated in
float32: the step below the configuration's bf16 that would tempt a later
change.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
LN_EPS = 1e-5
MAX_INITIAL_TIMESTAMP_S = 1.0


# ──────────────────────────────────────────────────────────────────────
# Front end (float64 NumPy)
# ──────────────────────────────────────────────────────────────────────


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    step = math.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / step,
                    3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    step = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(step * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's ``filters.mel(sr=16000, n_fft=400, n_mels)``: Slaney scale
    and Slaney area normalisation, [n_mels, 201]."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    out = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, mid, hi = hz[i], hz[i + 1], hz[i + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        out[i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return out


def log_mel(pcm: np.ndarray, n_mels: int, n_samples: int) -> np.ndarray:
    """openai/whisper's ``log_mel_spectrogram(pad_or_trim(pcm, n_samples))``:
    a periodic Hann STFT centred with reflect padding, the last frame
    dropped, power, mel, log10 floored at the peak minus 8, (x + 4) / 4.
    Returns float32 [n_mels, n_samples // HOP]."""
    audio = np.zeros(n_samples, np.float64)
    n = min(len(pcm), n_samples)
    audio[:n] = pcm[:n]
    padded = np.pad(audio, N_FFT // 2, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(padded, N_FFT)[::HOP][: n_samples // HOP]
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT)
    power = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    spec = np.log10(np.maximum(power @ mel_filters(n_mels).T, 1e-10))
    spec = np.maximum(spec, spec.max() - 8.0)
    return ((spec + 4.0) / 4.0).T.astype(np.float32)


# ──────────────────────────────────────────────────────────────────────
# Model (float32 PyTorch)
# ──────────────────────────────────────────────────────────────────────


def strict_float32() -> None:
    """float32 products in float32: cuBLAS and cuDNN may otherwise round
    their inputs to TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per row (its largest
    magnitude at e4m3's 448), back in float32."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """openai/whisper state-dict names -> float32 tensors, upcast on first use.
    With ``fp8``, a linear layer's operands are rounded to e4m3 first."""

    def __init__(self, tensors: dict[str, torch.Tensor], fp8: bool = False) -> None:
        self._src = tensors
        self.fp8 = fp8
        self._f32: dict[str, torch.Tensor] = {}
        self._matrices: dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._f32:
            self._f32[name] = self._src[name].float()
        return self._f32[name]

    def get(self, name: str):
        return self[name] if name in self._src else None

    def matrix(self, name: str) -> torch.Tensor:
        """A linear layer's weight [out, in], as its products take it."""
        if not self.fp8:
            return self[name]
        if name not in self._matrices:
            self._matrices[name] = fp8_e4m3(self._src[name].float())
        return self._matrices[name]

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_e4m3(x) if self.fp8 else x


def _ln(x, w, prefix):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"], w[f"{prefix}.bias"], LN_EPS)


def _lin(x, w, prefix):
    return F.linear(w.operand(x), w.matrix(f"{prefix}.weight"), w.get(f"{prefix}.bias"))


def _attention(x, kv, w, prefix, n_head, causal):
    """Multi-head attention of x [T, d] over kv [S, d], softmax in float32."""
    t, d = x.shape
    s = kv.shape[0]
    dh = d // n_head
    q = _lin(x, w, f"{prefix}.query").view(t, n_head, dh).transpose(0, 1)
    k = _lin(kv, w, f"{prefix}.key").view(s, n_head, dh).transpose(0, 1)
    v = _lin(kv, w, f"{prefix}.value").view(s, n_head, dh).transpose(0, 1)
    scores = (q @ k.transpose(1, 2)) * dh**-0.5
    if causal:
        scores = scores.masked_fill(torch.ones(t, s, dtype=torch.bool, device=x.device)
                                    .triu(1), float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    return _lin(out.transpose(0, 1).reshape(t, d), w, f"{prefix}.out")


def _mlp(x, w, prefix):
    return _lin(F.gelu(_lin(x, w, f"{prefix}.0")), w, f"{prefix}.2")


@torch.no_grad()
def encode(w: Weights, mel: torch.Tensor, cfg: dict) -> torch.Tensor:
    """mel [n_mels, 3000] float32 -> encoder output [1500, d]."""
    x = F.gelu(F.conv1d(mel[None], w["encoder.conv1.weight"], w["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, w["encoder.conv2.weight"], w["encoder.conv2.bias"],
                        stride=2, padding=1))
    x = x[0].T + w["encoder.positional_embedding"]
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.blocks.{i}"
        h = _ln(x, w, f"{p}.attn_ln")
        x = x + _attention(h, h, w, f"{p}.attn", cfg["encoder_attention_heads"], False)
        x = x + _mlp(_ln(x, w, f"{p}.mlp_ln"), w, f"{p}.mlp")
    return _ln(x, w, "encoder.ln_post")


@torch.no_grad()
def decoder_logits(w: Weights, tokens: list[int], xa: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Teacher-forced logits [len(tokens), vocab]: row i predicts token i + 1."""
    ids = torch.tensor(tokens, device=xa.device)
    x = w["decoder.token_embedding.weight"][ids] + w["decoder.positional_embedding"][: len(tokens)]
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.blocks.{i}"
        h = _ln(x, w, f"{p}.attn_ln")
        x = x + _attention(h, h, w, f"{p}.attn", cfg["decoder_attention_heads"], True)
        x = x + _attention(_ln(x, w, f"{p}.cross_attn_ln"), xa, w, f"{p}.cross_attn",
                           cfg["decoder_attention_heads"], False)
        x = x + _mlp(_ln(x, w, f"{p}.mlp_ln"), w, f"{p}.mlp")
    return F.linear(w.operand(_ln(x, w, "decoder.ln")), w.matrix("decoder.token_embedding.weight"))


# ──────────────────────────────────────────────────────────────────────
# Special tokens and the decoding rules
# ──────────────────────────────────────────────────────────────────────


def special_tokens(vocab_size: int, n_langs: int) -> dict:
    """Whisper's positional layout above the text vocabulary: <|endoftext|>,
    <|startoftranscript|>, the languages, then translate, transcribe,
    startoflm, startofprev, nospeech, notimestamps and 1501 timestamps (at a
    toy vocabulary, what is left of it, at least 2)."""
    n_ts = 1501 if vocab_size > 50000 else max(2, vocab_size - 266)
    eot = vocab_size - (2 + n_langs + 6 + n_ts)
    lang0 = eot + 2
    return {
        "eot": eot, "sot": eot + 1, "lang0": lang0, "n_langs": n_langs,
        "translate": lang0 + n_langs, "transcribe": lang0 + n_langs + 1,
        "startoflm": lang0 + n_langs + 2, "startofprev": lang0 + n_langs + 3,
        "nospeech": lang0 + n_langs + 4, "notimestamps": lang0 + n_langs + 5,
        "ts0": lang0 + n_langs + 6, "blank": 220 if eot > 50000 else 32,
    }


def prompt(sp: dict, language_index: int) -> list[int]:
    """<|startoftranscript|><|lang|><|transcribe|>, timestamps on."""
    return [sp["sot"], sp["lang0"] + language_index, sp["transcribe"]]


def token_budget(n_samples: int, max_tokens: int) -> int:
    """The served path's budget for a window of ``n_samples`` at 16 kHz:
    12 tokens a second plus 12, at most 224, rounded up to 16, and at most
    what the slot pool's cache holds (``max_tokens``)."""
    seconds = n_samples / SAMPLE_RATE
    return min(-(-min(224, int(seconds * 12) + 12) // 16) * 16, max_tokens)


def _suppressed(sp: dict, vocab: int, device) -> torch.Tensor:
    mask = torch.zeros(vocab, dtype=torch.bool, device=device)
    always = [sp["sot"], sp["startofprev"], sp["startoflm"], sp["nospeech"],
              sp["translate"], sp["transcribe"], sp["notimestamps"]]
    mask[always] = True
    mask[sp["lang0"]: sp["lang0"] + sp["n_langs"]] = True
    return mask


def _ruled_rows(logits: torch.Tensor, served: list[int], sp: dict, n: int):
    """The first ``n`` rows of ``logits`` as the rules leave them after the
    tokens ``served`` before each: (row index, the row in float64 with every
    barred token at -inf)."""
    vocab = logits.shape[1]
    dev = logits.device
    cols = torch.arange(vocab, device=dev)
    is_ts = cols >= sp["ts0"]
    base = _suppressed(sp, vocab, dev)
    max_init = sp["ts0"] + round(MAX_INITIAL_TIMESTAMP_S / 0.02)
    for j in range(n):
        sampled = served[:j]
        barred = base.clone()
        last_ts = len(sampled) >= 1 and sampled[-1] >= sp["ts0"]
        penult_ts = len(sampled) < 2 or sampled[-2] >= sp["ts0"]
        if last_ts:
            barred |= is_ts if penult_ts else cols < sp["eot"]
        stamps = [t for t in sampled if t >= sp["ts0"]]
        if stamps:
            floor = max(stamps) if last_ts and not penult_ts else max(stamps) + 1
            barred |= is_ts & (cols < floor)
        if j == 0:
            barred[[sp["blank"], sp["eot"]]] = True
            barred |= ~is_ts | (cols > max_init)
        yield j, logits[j].double().masked_fill(barred, float("-inf"))


def rule_picks(logits: torch.Tensor, served: list[int], sp: dict, ended: bool) -> list[int]:
    """The token that ``logits`` put first at each row of a window under the
    rules, after the served tokens before it: greedy decoding's pick, read
    at the same positions without decoding."""
    is_ts = torch.arange(logits.shape[1], device=logits.device) >= sp["ts0"]
    picks = []
    for _, row in _ruled_rows(logits, served, sp, len(served) + int(ended)):
        logp = torch.log_softmax(row, dim=-1)
        forced = torch.logsumexp(logp[is_ts], dim=0) > logp[~is_ts].max()
        picks.append(int((row.masked_fill(~is_ts, float("-inf")) if forced else row).argmax()))
    return picks


def token_gaps(logits: torch.Tensor, served: list[int], sp: dict, ended: bool,
               picks: list[int] | None = None) -> list[float]:
    """The gap, in logits, by which each served token lies below what the
    reference would pick, over one window.

    ``logits`` [n, V] float32: row j is the reference's before sampled token
    j. ``served`` are the served tokens; with ``ended`` the window stopped
    before its budget, so row len(served) must pick <|endoftext|>. With
    ``picks``, row j judges ``picks[j]`` in the served token's place, after
    the same served tokens. Each row's gap is the least, over the two
    branches of the timestamp-probability rule, of the larger of (a) how far
    the reference's log-probabilities are from taking that branch and (b)
    how far the judged token lies below the best token the branch allows. A
    token that a discrete rule bars gives an infinite gap, and ends the
    window's judging."""
    is_ts = torch.arange(logits.shape[1], device=logits.device) >= sp["ts0"]
    chosen = served + [sp["eot"]] if ended else list(served)
    if picks is not None:
        chosen = picks
    gaps: list[float] = []
    for j, row in _ruled_rows(logits, served, sp, len(chosen)):
        tok = chosen[j]
        if not math.isfinite(row[tok].item()):
            return gaps + [math.inf]
        logp = torch.log_softmax(row, dim=-1)
        ts_mass = torch.logsumexp(logp[is_ts], dim=0).item()
        best_other = logp[~is_ts].max().item()
        best_all = row.max().item()
        best_ts = row[is_ts].max().item()
        here = row[tok].item()
        # how far the log-probabilities lie from each branch of the rule
        to_free = max(0.0, ts_mass - best_other)
        to_forced = max(0.0, best_other - ts_mass)
        options = [max(to_free, best_all - here)]
        if tok >= sp["ts0"]:
            options.append(max(to_forced, best_ts - here))
        gaps.append(min(options))
    return gaps
