"""Shared set-up of the Kokoro serving parity tests (``test_torch_tts.py``,
``test_torch_tts_batcher.py``): one Kokoro geometry, one JAX parameter tree
filled from a numpy seed and carried across to the port, the injected
harmonic features, and the two packages' backends on those weights.

The harmonic source draws its noise from ``jax.random`` on one side and
``torch.Generator`` on the other, so the audio tests inject the same
harmonic features into both packages (its only consumer of the noise).
The JAX package's first block asks ``har_features`` for the first
``nb1 + h + 1`` x-frames only, so the injected array is cut to the frames
the caller asks for; every row gets the same features.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from open_speech_tpu.models.kokoro import model as JM
from open_speech_tpu.tts.backends import kokoro_backend as JKB
from open_speech_tpu_torch.models.kokoro import model as TM
from open_speech_tpu_torch.tts.backends import kokoro_backend as TKB

# 48 phonemes, 128 frames: a sentence fills 60-128 frames, so the
# per-request path (64-frame blocks) and the batcher (16-frame first block,
# 32-frame blocks) both run their first and interior blocks
CFG = dataclasses.replace(JM.TINY_CONFIG, max_phonemes=48, max_frames=128)
TCFG = TM.KokoroConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)})
HPX = CFG.samples_per_frame // 2 // CFG.gen_hop
TOL_AUDIO = 2e-3  # tests/test_torch_kokoro.py's audio tolerance
TEXT = ("The quick brown fox jumps over the lazy dog. "
        "It was 42 degrees outside, said Dr. Smith!")
# the original of the port's harmonic features, for tests that run on
# their own features while a module holds the injection
REAL_TORCH_HAR = TM.har_features


def jax_tree(cfg, seed: int = 3) -> dict:
    """The JAX model's parameter tree as ``init_kokoro_params`` lays it out,
    filled from a numpy seed as ``tests/test_torch_kokoro.py`` fills it."""
    shapes = jax.eval_shape(lambda key: JM.init_kokoro_params(key, cfg), jax.random.PRNGKey(7))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = next(k.key for k in reversed(path) if isinstance(k, jax.tree_util.DictKey))
        shape = leaf.shape
        z = rng.standard_normal(shape)
        if name == "b":
            z = 0.02 * z
        elif name in ("g", "a1", "a2"):
            z = 1.0 + 0.05 * z
        elif name in ("word_emb", "pos_emb", "type_emb"):
            z = 0.02 * z
        elif name == "emb":
            z = z * shape[1] ** -0.5
        else:
            z = z * (shape[0] if len(shape) == 2 else shape[0] * shape[1]) ** -0.5
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def injected_har(jtree) -> np.ndarray:
    """The JAX model's harmonic features of a voiced F0 curve (80-160 Hz,
    an unvoiced stretch) over numpy-seeded noise: [1, frames, n_fft+2] for
    the whole frame bucket. (The random weights' own F0 is unvoiced.)"""
    rng = np.random.default_rng(17)
    nh = CFG.harmonics + 1
    rand_phase = np.concatenate([np.zeros((1, 1)), rng.random((1, nh - 1))], 1).astype(np.float32)
    sine_noise = rng.standard_normal((1, CFG.max_frames * CFG.samples_per_frame, nh)).astype(np.float32)
    t = np.arange(2 * CFG.max_frames) / 80.0
    f0 = (120.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t))[None]
    f0[:, 60:90] = 0.0
    fn = jax.jit(JM.har_features, static_argnums=1)
    return np.asarray(fn(jtree, CFG, jnp.asarray(f0, jnp.float32), jnp.asarray(rand_phase),
                         jnp.asarray(sine_noise)))


def inject_har(mp, har: np.ndarray) -> None:
    """Both packages' ``har_features`` return ``har`` (via ``mp``, a
    MonkeyPatch). The JAX programs that call it are re-jitted from fresh
    function objects, so no program traced before the patch is reused."""
    def jax_har(params, cfg, f0, rand_phase, sine_noise):
        h = jnp.asarray(har[:, : f0.shape[1] * HPX + 1])
        return jnp.broadcast_to(h, (f0.shape[0],) + h.shape[1:])

    def torch_har(model, cfg, f0, rand_phase, sine_noise):
        h = torch.from_numpy(np.ascontiguousarray(har[:, : f0.shape[1] * HPX + 1].transpose(0, 2, 1)))
        return h.expand(f0.shape[0], -1, -1)

    mp.setattr(JM, "har_features", jax_har)
    mp.setattr(TM, "har_features", torch_har)
    for name, static in (("_vocode_first", ("cfg", "nb", "h", "wire_i16")),
                         ("_vocode_rest", ("cfg", "nb", "h"))):
        fresh = functools.partial(getattr(JM, name).__wrapped__)
        mp.setattr(JM, name, jax.jit(fresh, static_argnames=static))


def jax_backend(jtree) -> JKB.KokoroBackend:
    """The JAX backend on the test weights (no load, no warmup)."""
    b = JKB.KokoroBackend()
    b._params, b._cfg = jtree, CFG
    return b


def torch_backend(model) -> TKB.KokoroBackend:
    b = TKB.KokoroBackend(device="cpu")
    b._model, b._cfg = model, TCFG
    return b


def voice_packs(tmp_path, voices=("af_heart", "af_bella", "af_sky")) -> str:
    """Voice packs [510, 1, 2*style_dim] from a numpy seed, one row per
    utterance length, as kokoro-82M's ``voices/<id>.pt``."""
    rng = np.random.default_rng(11)
    for v in voices:
        pack = (0.1 * rng.standard_normal((510, 1, CFG.voice_dim))).astype(np.float32)
        torch.save(torch.from_numpy(pack), tmp_path / f"{v}.pt")
    return str(tmp_path)


def one_torch_thread():
    """One intra-op thread while a module runs (see test_torch_kokoro.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
