"""Piper (VITS) in PyTorch. Counterpart of ``open_speech_tpu/models/piper``:
the synthesis graph (``model.py``) and checkpoint conversion (``convert.py``)."""

from open_speech_tpu_torch.models.piper.convert import (
    config_from_state_dict,
    convert_piper_onnx,
    convert_piper_state_dict,
    fold_weight_norms,
    load_voice_json,
    piper_params_from_jax,
)
from open_speech_tpu_torch.models.piper.model import (
    SAMPLE_RATE,
    PiperConfig,
    PiperModel,
    init_piper_params,
    synthesize_vits,
)

__all__ = [
    "SAMPLE_RATE",
    "PiperConfig",
    "PiperModel",
    "config_from_state_dict",
    "convert_piper_onnx",
    "convert_piper_state_dict",
    "fold_weight_norms",
    "init_piper_params",
    "load_voice_json",
    "piper_params_from_jax",
    "synthesize_vits",
]
