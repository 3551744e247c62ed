"""API records of the served path.

Counterpart of ``open_speech_tpu/schemas.py``. The JAX package builds these
with pydantic, which the card's machine does not have; the port uses
dataclasses with the same fields and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LoadedModelInfo:
    model: str
    backend: str
    device: str
    compute_type: str
    loaded_at: float
    last_used_at: float | None = None
    is_default: bool = False
    ttl_remaining: float | None = None
