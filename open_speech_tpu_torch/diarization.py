"""Speaker diarization service (reference: src/diarization/pyannote_diarizer.py).

Counterpart of ``open_speech_tpu/diarization.py``: the reference's
enablement contract (``STT_DIARIZE_ENABLED``; a ``RuntimeError`` when
off), one diarizer shared by the process (``models/diarize.py:
TorchDiarizer``, on ``settings.stt_device``), and
``attach_text_to_speakers``, the reference's naive word allocation.
Uploads that are not 16 kHz go through ``ops/resample.py:resample_poly``
on the diarizer's device.
"""

from __future__ import annotations

import numpy as np
import torch

from open_speech_tpu_torch.models.diarize import TorchDiarizer
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.ops.resample import resample_poly

_shared: TorchDiarizer | None = None


class Diarizer:
    """The PyTorch diarizer behind the reference's enablement gate."""

    def __init__(self) -> None:
        from open_speech_tpu_torch.config import settings

        if not settings.stt_diarize_enabled:
            raise RuntimeError(
                "Diarization is disabled. Set STT_DIARIZE_ENABLED=true"
            )
        global _shared
        if _shared is None:
            _shared = TorchDiarizer()
        self._model = _shared

    def diarize(self, wav_bytes: bytes) -> list[dict]:
        """WAV bytes -> [{speaker, start, end}] turns."""
        audio, sr = codec.read_wav(wav_bytes)
        if len(audio) == 0:
            return []
        if sr != 16000:
            x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self._model.device)
            audio = resample_poly(x, 16000, sr).cpu().numpy()
        return self._model.diarize_audio(audio)


def attach_text_to_speakers(text: str, segments: list[dict]) -> list[dict]:
    """Naively distribute words across speaker turns (reference :35-55)."""
    words = text.split()
    if not segments or not words:
        return segments
    total_dur = sum(s["end"] - s["start"] for s in segments) or 1.0
    out = []
    idx = 0
    for seg in segments:
        share = (seg["end"] - seg["start"]) / total_dur
        count = max(1, int(round(share * len(words))))
        seg_words = words[idx : idx + count]
        idx += count
        out.append({**seg, "text": " ".join(seg_words)})
    if idx < len(words) and out:
        out[-1]["text"] = (out[-1]["text"] + " " + " ".join(words[idx:])).strip()
    return out
