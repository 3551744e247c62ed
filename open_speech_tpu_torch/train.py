"""Whisper fine-tuning: teacher-forced loss and an AdamW step.

Counterpart of ``open_speech_tpu/train.py``, with its names in PyTorch's
idiom: the model is updated in place and AdamW keeps its moments in the
optimizer. On a CUDA model every attention of the step runs K1 forward
and its hand-written backward (``ops/attention.py:FlashAttentionFn``).

The trainable set is the JAX parameter tree's leaf set: every parameter
and the encoder's sinusoid table ``encoder.pos``, which the port keeps as
a buffer and the JAX tree as a leaf that optax updates. An int8 model
(``QuantLinear``/``QuantEmbedding``) is refused: the JAX package trains no
int8 pack.
"""

from __future__ import annotations

import torch

from open_speech_tpu_torch.models.whisper.model import (
    QuantEmbedding,
    QuantLinear,
    Whisper,
    WhisperConfig,
    decoder_forward,
    encode,
)


def trainable_params(model: Whisper) -> list[torch.Tensor]:
    """JAX's leaves: the parameters and ``encoder.pos``, with gradients
    enabled (``Whisper.empty`` freezes them for serving)."""
    if any(isinstance(m, (QuantLinear, QuantEmbedding)) for m in model.modules()):
        raise ValueError("an int8 model cannot be trained: quantize after fine-tuning")
    leaves = [*model.parameters(), model.encoder.pos]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def make_optimizer(model: Whisper, lr: float = 1e-5, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over ``trainable_params(model)``: optax's ``adamw`` (betas 0.9
    and 0.999, eps 1e-8, the decay applied to every leaf at its pre-update
    value), whose moments take each leaf's dtype."""
    return torch.optim.AdamW(trainable_params(model), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def loss_fn(model: Whisper, batch: dict, cfg: WhisperConfig) -> torch.Tensor:
    """Teacher-forced NLL. batch: {mel [B,M,T], tokens [B,S], mask [B,S]} on
    the model's device.

    tokens[:, :-1] are inputs, tokens[:, 1:] targets; mask marks real
    (non-pad) target positions; the mean is over max(sum(mask), 1).
    """
    tokens = batch["tokens"].long()
    enc_out = encode(model, batch["mel"], cfg)
    logits = decoder_forward(model, tokens[:, :-1], enc_out, cfg)
    mask = batch["mask"][:, 1:].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def train_step(model: Whisper, optimizer: torch.optim.Optimizer, batch: dict,
               cfg: WhisperConfig) -> torch.Tensor:
    """One update of ``model`` in place; returns the loss before it."""
    with torch.enable_grad():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, cfg)
        loss.backward()
    optimizer.step()
    return loss.detach()


def init_train_state(model: Whisper, optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict, the counterpart of JAX's
    ``optimizer.init(params)``: AdamW creates its moments at the first step,
    so it holds only the hyperparameters until then."""
    if {id(p) for g in optimizer.param_groups for p in g["params"]} != {
            id(t) for t in trainable_params(model)}:
        raise ValueError("the optimizer does not hold this model's trainable leaves")
    return optimizer.state_dict()
