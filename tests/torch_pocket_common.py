"""Shared set-up of the Pocket parity tests (``tests/test_torch_pocket*.py``).

One set of weights for both packages at the backend's tiny preset
(``TEST_TINY_LM`` with max_ctx 512, ``MIMI_TEST_TINY``): the JAX trees
are laid out by ``jax.eval_shape`` of the JAX inits (no init compile) and
filled from a numpy seed with the inits' scales (normal times fan_in^-0.5,
embeddings x0.02, unit-normal codebooks), with gains, biases and layer
scales drawn too, so no leaf is a constant; ``pocket_params_from_jax``
carries them over to the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import open_speech_tpu.models.pocket.lm as JL
import open_speech_tpu.models.pocket.mimi as JMi
import open_speech_tpu.models.pocket.model as JMo
import open_speech_tpu_torch.models.pocket.lm as TL
import open_speech_tpu_torch.models.pocket.mimi as TMi
import open_speech_tpu_torch.models.pocket.model as TMo
from open_speech_tpu_torch.models.pocket import pocket_params_from_jax

JLM = dataclasses.replace(JL.TEST_TINY_LM, max_ctx=512)  # the backend's tiny preset
TLM = TL.PocketLMConfig(**dataclasses.asdict(JLM))
JMC = JMi.TEST_TINY
TMC = TMi.MimiConfig(**dataclasses.asdict(JMC))

_EMBEDDINGS = {"text_emb", "emb", "dep_text_emb", "dep_emb"}
_CONVS = {"encoder", "decoder", "downsample", "upsample"}


def _fill(rng: np.random.Generator, tree):
    def leaf(path, shape):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = keys[-1]
        n = rng.standard_normal(shape.shape).astype(np.float32)
        if name in ("a", "g"):
            return 1.0 + 0.1 * n
        if name == "b":
            return 0.1 * n
        if name in ("ls1", "ls2"):
            return 0.1 + 0.02 * n
        if name == "codebooks":
            return n
        if name in _EMBEDDINGS:
            return 0.02 * n
        dims = shape.shape
        fan = dims[0] * dims[1] if keys[0] in _CONVS else dims[-2]
        return n * np.float32(fan) ** -0.5

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_trees(seed: int = 11, lm_cfg=JLM, mimi_cfg=JMC) -> tuple[dict, dict]:
    """(LM tree, Mimi tree) of numpy arrays in the JAX layouts."""
    key = jax.random.PRNGKey(0)
    lm = jax.eval_shape(lambda: JL.init_pocket_lm_params(key, lm_cfg))
    mimi = jax.eval_shape(lambda: JMi.init_mimi_params(key, mimi_cfg))
    rng = np.random.default_rng(seed)
    return _fill(rng, lm), _fill(rng, mimi)


def models(seed: int = 11):
    """(JAX PocketTTS, port PocketTTS on the CPU) on the same weights."""
    lm, mimi = jax_trees(seed)
    jm = JMo.PocketTTS(jax.tree.map(jnp.asarray, lm), jax.tree.map(jnp.asarray, mimi), JLM, JMC)
    tlm, tmimi = pocket_params_from_jax(lm, mimi, device="cpu")
    return jm, TMo.PocketTTS(tlm, tmimi, TLM, TMC)


def one_thread():
    """A generator for a module fixture: one intra-op thread while the
    module runs (under the suite's xdist workers a full pool per worker
    makes these small ops spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
