"""Parameter checkpoints of a fine-tuned model.

Counterpart of ``open_speech_tpu/runtime/checkpoint.py`` (orbax there) in
the port's own format: ``torch.save`` of the model's state dict, which
holds every parameter and buffer (the trainable ``encoder.pos`` included).
It is read back with ``weights_only=True``, so loading runs no pickled
code. The JAX format is not read.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import torch
from torch import nn

logger = logging.getLogger(__name__)


def save_params(path: str | Path, model: nn.Module) -> None:
    """Write the model's state dict to ``path`` (overwrites; the file is
    replaced whole, never left half written)."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    state = {k: v.detach() for k, v in model.state_dict().items()}
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    logger.info("Saved checkpoint to %s", path)


def load_params(path: str | Path, like: nn.Module | None = None, *, map_location=None):
    """Read a checkpoint: into ``like`` (a model of the same layout, every
    key required; returns it), or as a state dict when ``like`` is None.
    ``map_location`` defaults to ``like``'s device, else the CPU."""
    path = Path(path).resolve()
    if map_location is None:
        map_location = next(like.parameters()).device if like is not None else "cpu"
    state = torch.load(path, map_location=map_location, weights_only=True)
    if like is None:
        return state
    with torch.no_grad():
        like.load_state_dict(state, strict=True)
    return like
