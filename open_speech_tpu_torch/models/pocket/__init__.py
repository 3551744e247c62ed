"""Pocket TTS (Kyutai) in PyTorch: the Mimi codec (``mimi.py``), the
delayed-streams LM (``lm.py``), the model and its generation loop
(``model.py``) and checkpoint conversion (``convert.py``). Counterpart of
``open_speech_tpu/models/pocket``."""

from open_speech_tpu_torch.models.pocket.convert import pocket_params_from_jax
from open_speech_tpu_torch.models.pocket.lm import (
    TEST_TINY_LM,
    ParamTree,
    PocketLMConfig,
    init_pocket_lm_params,
)
from open_speech_tpu_torch.models.pocket.mimi import (
    TEST_TINY as MIMI_TEST_TINY,
    MimiConfig,
    MimiStreamingDecoder,
    init_mimi_params,
    mimi_decode,
    mimi_encode,
)
from open_speech_tpu_torch.models.pocket.model import (
    SAMPLE_RATE,
    PocketTTS,
    PromptState,
)

__all__ = [
    "PocketLMConfig",
    "TEST_TINY_LM",
    "ParamTree",
    "init_pocket_lm_params",
    "MimiConfig",
    "MIMI_TEST_TINY",
    "MimiStreamingDecoder",
    "init_mimi_params",
    "mimi_decode",
    "mimi_encode",
    "pocket_params_from_jax",
    "SAMPLE_RATE",
    "PocketTTS",
    "PromptState",
]
