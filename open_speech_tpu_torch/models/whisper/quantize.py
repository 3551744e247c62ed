"""Weight-only int8 quantization for whisper (``STT_COMPUTE_TYPE=int8``).

Counterpart of ``open_speech_tpu/models/whisper/quantize.py``: linear
weights and the token embedding are stored as int8 with float32 scales,
per output channel for the linears and per vocab row for the embedding,
and the primitives of ``model.py`` compute from the packs (the product
with the int8 weight cast to the activation dtype, then the scale).
Convolutions, layer norms, biases and position tables keep their dtype.

The packs live in the module tree (``QuantLinear``, ``QuantEmbedding``), in
the port's [out, in] layout: the transpose of the JAX package's [in, out]
packs, with the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from open_speech_tpu_torch.models.whisper.model import QuantEmbedding, QuantLinear, Whisper


# 1/127 rounded to float32. The JAX package makes its packs under jit, where
# XLA turns ``amax / 127.0`` into a product with this constant; the scales
# (and so the packs) are XLA's only when the port multiplies the same way.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_tensor(w: torch.Tensor, axis: int = -1) -> dict[str, torch.Tensor]:
    """Per-channel symmetric int8: {"q": int8, "s": float32 scales}, the
    scales reduced over ``axis`` (kept as a size-1 dim)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax * _INV_127, min=1e-8)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize(pack: dict[str, torch.Tensor]) -> torch.Tensor:
    return pack["q"].to(torch.bfloat16) * pack["s"].to(torch.bfloat16)


def is_quantized(module) -> bool:
    return isinstance(module, (QuantLinear, QuantEmbedding))


def _quantize_linear(lin: nn.Linear) -> QuantLinear:
    pack = quantize_tensor(lin.weight, axis=-1)  # over `in`: one scale per output
    return QuantLinear(pack["q"], pack["s"][:, 0], lin.bias)


@torch.no_grad()
def quantize_whisper_params(model: Whisper) -> Whisper:
    """Quantize every linear of the encoder and the decoder and the token
    embedding, in place: each module is replaced as it is packed, so its
    weight is freed before the next is quantized. Returns ``model``."""
    for blk in (*model.encoder.blocks, *model.decoder.blocks):
        owners = [(blk, ("mlp_in", "mlp_out"))] + [
            (getattr(blk, name), ("q", "k", "v", "o"))
            for name in ("attn", "cross") if hasattr(blk, name)
        ]
        for owner, names in owners:
            for name in names:
                lin = getattr(owner, name)
                if isinstance(lin, nn.Linear):
                    setattr(owner, name, _quantize_linear(lin))
    dec = model.decoder
    if not isinstance(dec.tok_emb, QuantEmbedding):
        pack = quantize_tensor(dec.tok_emb, axis=-1)  # one scale per vocab row
        del dec.tok_emb
        dec.tok_emb = QuantEmbedding(pack["q"], pack["s"])
    return model


def model_nbytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of ``model``."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def dequant_size_ratio(original_nbytes: int, qmodel: nn.Module) -> float:
    """Bytes(quantized) / bytes(original), for logging. The model is
    quantized in place, so the caller takes ``model_nbytes`` before."""
    return model_nbytes(qmodel) / max(1, original_nbytes)
