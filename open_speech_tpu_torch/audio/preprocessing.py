"""STT input preprocessing: WAV bytes in, WAV bytes out.

Counterpart of ``open_speech_tpu/audio/preprocessing.py``: non-WAV input
passes through untouched, and RMS gain normalization to -18 dBFS is on by
default (``stt_normalize``). Noise reduction (``stt_noise_reduce``, off by
default) needs the optional ``noisereduce`` package and raises the JAX
package's error without it.
"""

from __future__ import annotations

import numpy as np

from open_speech_tpu_torch.ops import audio as codec


def normalize_gain(audio: np.ndarray, target_dbfs: float = -18.0) -> np.ndarray:
    rms = float(np.sqrt(np.mean(np.square(audio)))) if len(audio) else 0.0
    if rms <= 1e-8:
        return audio
    gain = 10 ** ((target_dbfs - 20 * np.log10(rms)) / 20)
    return np.clip(audio * gain, -1.0, 1.0)


def reduce_noise(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    try:
        import noisereduce as nr  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "Noise reduction requires optional dependency: "
            "pip install 'open-speech[noise]'"
        ) from e
    return nr.reduce_noise(y=audio, sr=sample_rate)


def preprocess_stt_audio(
    wav_bytes: bytes, *, normalize: bool = True, noise_reduce: bool = False
) -> bytes:
    try:
        audio, sr = codec.read_wav(wav_bytes)
    except Exception:
        # non-WAV bytes pass through (reference behavior for odd inputs)
        return wav_bytes
    if noise_reduce:
        audio = reduce_noise(audio, sr)
    if normalize:
        audio = normalize_gain(audio)
    return codec.write_wav(audio, sr)
