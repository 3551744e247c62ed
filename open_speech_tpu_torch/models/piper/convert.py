"""Piper checkpoint conversion helpers.

Counterpart of ``open_speech_tpu/models/piper/convert.py``. The Piper model
is a later slice of the port; Kokoro's converter already needs
``fold_weight_norms``, so it lives at the JAX package's path.
"""

from __future__ import annotations

import numpy as np


def fold_weight_norms(sd: dict) -> dict:
    """Fold weight_norm pairs into plain ``.weight`` arrays.

    Both key styles: ``weight_g``/``weight_v``
    (``torch.nn.utils.weight_norm``) and
    ``parametrizations.weight.original0/1``
    (``torch.nn.utils.parametrizations.weight_norm``). The norm runs over
    every axis but the first (weight_norm's default ``dim=0``), in float32
    numpy, as the JAX package folds it."""
    out = dict(sd)
    for key in list(out):
        if key.endswith(".weight_v"):
            base, g_key = key[: -len(".weight_v")], key[:-2] + "_g"
        elif key.endswith(".parametrizations.weight.original1"):
            base = key[: -len(".parametrizations.weight.original1")]
            g_key = base + ".parametrizations.weight.original0"
        else:
            continue
        v = np.asarray(out.pop(key), np.float32)
        g = np.asarray(out.pop(g_key), np.float32)
        axes = tuple(range(1, v.ndim))
        norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        out[base + ".weight"] = g * v / np.maximum(norm, 1e-12)
    return out
