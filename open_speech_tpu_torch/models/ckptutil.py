"""Shared torch-checkpoint loading for model converters.

Every converter (GE2E, PyanNet segmentation, WeSpeaker, ...) accepts
either an in-memory state-dict mapping or a path to a torch checkpoint.
Released checkpoints vary in wrapping: plain state_dicts, {'state_dict':
...} (Lightning — pyannote's segmentation-3.0 and wespeaker bins),
{'model_state': ...} (resemblyzer), and DataParallel 'module.' prefixes.

Lightning checkpoints additionally pickle custom class references
(e.g. pyannote.audio.core.task.Specifications in hyper_parameters), which
``torch.load(weights_only=True)`` rejects. Weights-only is tried first;
on failure the load retries with full unpickling — the same trust model
as the reference, which hands these files to pyannote/torch directly
(its ``src/diarization/pyannote_diarizer.py``).

Counterpart of ``open_speech_tpu/models/ckptutil.py``: the code below this
docstring is that module's, character for character
(``tests/test_torch_isolation.py`` holds it so).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def load_state_dict(src, *, strip_prefixes=("module.", "model.")) -> dict:
    """Checkpoint path / mapping -> {name: np.ndarray} with prefixes removed."""
    if not isinstance(src, dict):
        import torch

        try:
            raw = torch.load(src, map_location="cpu", weights_only=True)
        except Exception:  # noqa: BLE001 — Lightning ckpts carry custom globals
            logger.info(
                "weights_only load failed for %s; retrying with full "
                "unpickling (Lightning-style checkpoint)", src,
            )
            raw = torch.load(src, map_location="cpu", weights_only=False)
        for key in ("state_dict", "model_state"):
            if isinstance(raw, dict) and key in raw and isinstance(raw[key], dict):
                raw = raw[key]
                break
        src = {
            k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in raw.items()
        }
    out = {}
    for k, v in src.items():
        for p in strip_prefixes:
            k = k.removeprefix(p)
        out[k] = np.asarray(v)
    return out


def find_checkpoint(env_var: str, hf_globs: tuple[str, ...] = ()) -> Path | None:
    """First hit among $env_var, then HF-hub cache glob patterns."""
    env = os.environ.get(env_var, "")
    candidates = [Path(env)] if env else []
    hf = Path(
        os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")
    ) / "hub"
    if hf.is_dir():
        for pattern in hf_globs:
            candidates += sorted(hf.glob(pattern))
    for c in candidates:
        if c.is_file():
            return c
    return None
