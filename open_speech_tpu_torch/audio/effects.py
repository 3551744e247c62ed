"""Post-synthesis effects chain, run on the card.

Counterpart of ``open_speech_tpu/audio/effects.py``: the five effects and
their parameters (normalize: RMS to a LUFS-ish level; pitch: a
duration-preserving semitone shift; reverb: an exponential-decay FIR with
room presets; podcast_eq: an 80 Hz high-pass and a 3 kHz presence
resonator; robot: a 100 Hz ring modulator), unknown effect types skipped.

The DSP is ``ops/effects.py``. This module pads the signal to a
power-of-two bucket, threads one device tensor through the requested
stages, keeps the padded tail silent between stages (so a later masked or
spectral stage sees zeros, not a stage's artifacts), and copies float32
back to the host once at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from open_speech_tpu_torch.ops import effects as fx

SUPPORTED_EFFECTS = {"normalize", "pitch", "reverb", "podcast_eq", "robot"}

# Room presets: decay-tail length and default wet mix per room size.
_ROOM_TAIL_MS = {"small": 50, "medium": 120, "large": 300}
_ROOM_DEFAULT_MIX = {"small": 0.25, "medium": 0.4, "large": 0.55}
_FALLBACK_TAIL_MS = 50
_FALLBACK_MIX = 0.3


def _stage_normalize(x, n, sr, spec):
    target_db = float(spec.get("target_lufs", -16))
    return fx.masked_rms_normalize(x, n, 10.0 ** (target_db / 20.0))


def _stage_pitch(x, n, sr, spec):
    semitones = round(float(spec.get("semitones", 0)), 2)
    if semitones == 0.0:
        return x
    return fx.pitch_shift(x, n, semitones)


def _stage_reverb(x, n, sr, spec):
    room = spec.get("room", "small")
    tail_ms = _ROOM_TAIL_MS.get(room, _FALLBACK_TAIL_MS)
    mix = float(spec.get("mix", _ROOM_DEFAULT_MIX.get(room, _FALLBACK_MIX)))
    return fx.exp_decay_reverb(x, max(1, int(sr * tail_ms / 1000)), mix)


def _stage_podcast_eq(x, n, sr, spec):
    return fx.podcast_eq(x, sr)


def _stage_robot(x, n, sr, spec):
    return fx.ring_modulate(x, sr)


_STAGES = {
    "normalize": _stage_normalize,
    "pitch": _stage_pitch,
    "reverb": _stage_reverb,
    "podcast_eq": _stage_podcast_eq,
    "robot": _stage_robot,
}


def apply_chain(samples: np.ndarray, sample_rate: int, effects: list[dict] | None,
                device: torch.device | str | None = None) -> np.ndarray:
    """Run the ordered effect list over ``samples`` (float32 mono) on
    ``device`` (``settings.tts_effective_device`` when None).

    Each entry is ``{"type": <name>, ...params}``; unsupported types are
    skipped. Returns float32 host audio of the same length.
    """
    samples = np.asarray(samples, dtype=np.float32)
    stages = [(_STAGES[e.get("type")], e) for e in (effects or []) if e.get("type") in _STAGES]
    if not stages or samples.size == 0:
        return samples
    if device is None:
        from open_speech_tpu_torch.config import settings

        device = settings.tts_effective_device
    n = samples.shape[0]
    bucket = fx.length_bucket(n)
    x = torch.from_numpy(np.pad(samples, (0, bucket - n))).to(device)
    live = torch.arange(bucket, device=x.device) < n
    with torch.inference_mode():
        for stage, spec in stages:
            x = stage(x, n, sample_rate, spec)
            if x.shape[0] != bucket:  # the pitch resample can round off a sample
                x = torch.nn.functional.pad(x, (0, max(0, bucket - x.shape[0])))[:bucket]
            x = torch.where(live, x, 0.0)
        return x[:n].cpu().numpy()
