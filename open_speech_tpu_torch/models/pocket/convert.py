"""Pocket-TTS checkpoint conversion for the port.

Counterpart of ``open_speech_tpu/models/pocket/convert.py``: a moshi-family
``state_dict`` (a Mimi codec, ``MimiModel``, and a delayed-streams
``LMModel``) becomes the port's ``ParamTree``s:

  - Mimi's convolutions keep PyTorch's layouts (``Conv1d`` [C_out, C_in,
    K], ``ConvTranspose1d`` [C_in, C_out/groups, K], unflipped); fused
    attention ``in_proj_weight`` and the other linears transpose to
    [in, out] and stack per layer; RVQ codebooks come from
    ``_codebook.embed_sum / cluster_usage`` (or a plain ``embed``);
  - the LM's per-layer weights stack on a leading axis and the
    depformer's per-stage weights (``in_projs.{s}``, ``gating.{s}``) on a
    stage axis, as the JAX tree stacks them.

Geometry is read from the tensor shapes (``*_config_from_state_dict``),
and ``load_checkpoint`` takes head counts, context, delays and the text
special ids from the release's ``config.json``. ``.safetensors`` files are
read by the port's own reader (``models/whisper/convert.py``), which
widens bf16 to float32; ``.pt`` files through ``torch.load``.

``pocket_params_from_jax`` carries the JAX package's LM and Mimi trees (as
numpy arrays) over to the port, transposing Mimi's convolution kernels:
the parity tests run both packages on one set of weights with it.
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from open_speech_tpu_torch.models.pocket.lm import ParamTree, PocketLMConfig
from open_speech_tpu_torch.models.pocket.mimi import MimiConfig
from open_speech_tpu_torch.models.whisper.convert import load_safetensors
from open_speech_tpu_torch.ops.vocoder import tts_device

logger = logging.getLogger(__name__)


def _np(state, key) -> np.ndarray:
    return np.asarray(state[key], np.float32)


def _lin_t(state, key) -> np.ndarray:
    return _np(state, key).T


def _rms(state, key) -> dict:
    return {"a": _np(state, key).reshape(-1)}


def _stack(items: list) -> dict:
    """Per-layer dicts -> one dict of arrays stacked on axis 0."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    return np.stack(items)


def _count(state, pattern: str) -> int:
    rx = re.compile(pattern)
    idx = {int(m.group(1)) for k in state if (m := rx.match(k))}
    return (max(idx) + 1) if idx else 0


def _codebook(state, prefix: str) -> np.ndarray:
    """RVQ codebook: embed_sum/cluster_usage (moshi) or embed (encodec)."""
    if f"{prefix}.embed_sum" in state:
        s = _np(state, f"{prefix}.embed_sum")
        u = np.maximum(_np(state, f"{prefix}.cluster_usage"), 1e-5)
        return s / u[:, None]
    if f"{prefix}.embed" in state:
        return _np(state, f"{prefix}.embed")
    raise KeyError(f"no codebook under {prefix}")


# ──────────────────────────────────────────────────────────────────────
# Mimi
# ──────────────────────────────────────────────────────────────────────


def mimi_config_from_state_dict(state, sample_rate: int = 24_000) -> MimiConfig:
    def shape(key):
        return tuple(np.shape(state[key]))

    n_filters, _, kernel_size = shape("encoder.model.0.conv.conv.weight")
    dimension, _, last_kernel = shape("encoder.model.14.conv.conv.weight")
    c1 = shape("encoder.model.1.block.1.conv.conv.weight")
    ratios = tuple(shape(f"decoder.model.{2 + 3 * i}.convtr.convtr.weight")[2] // 2 for i in range(4))
    cb = _codebook(state, "quantizer.rvq_first.vq.layers.0._codebook")
    return MimiConfig(
        sample_rate=sample_rate,
        n_filters=n_filters,
        dimension=dimension,
        ratios=ratios,
        kernel_size=kernel_size,
        last_kernel_size=last_kernel,
        residual_kernel_size=c1[2],
        compress=n_filters // c1[0],
        t_layers=_count(state, r"encoder_transformer\.transformer\.layers\.(\d+)\."),
        t_ff=shape("encoder_transformer.transformer.layers.0.linear1.weight")[0],
        n_q=1 + _count(state, r"quantizer\.rvq_rest\.vq\.layers\.(\d+)\."),
        card=cb.shape[0],
        q_dim=cb.shape[1],
        down_stride=shape("downsample.conv.conv.weight")[2] // 2,
    )


def _conv(state, name: str) -> dict:
    p = {"w": _np(state, f"{name}.weight")}
    if f"{name}.bias" in state:
        p["b"] = _np(state, f"{name}.bias")
    return p


def _mimi_tlayers(state, prefix: str, n_layers: int) -> dict:
    layers = []
    for i in range(n_layers):
        p = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": {"g": _np(state, f"{p}.norm1.weight"), "b": _np(state, f"{p}.norm1.bias")},
            "qkv": {"w": _lin_t(state, f"{p}.self_attn.in_proj_weight")},
            "out": {"w": _lin_t(state, f"{p}.self_attn.out_proj.weight")},
            "ls1": _np(state, f"{p}.layer_scale_1.scale"),
            "ln2": {"g": _np(state, f"{p}.norm2.weight"), "b": _np(state, f"{p}.norm2.bias")},
            "mlp_in": {"w": _lin_t(state, f"{p}.linear1.weight")},
            "mlp_out": {"w": _lin_t(state, f"{p}.linear2.weight")},
            "ls2": _np(state, f"{p}.layer_scale_2.scale"),
        })
    return {"layers": _stack(layers)}


def _rvq(state, prefix: str, n_levels: int) -> dict:
    return {
        "in_proj": {"w": _np(state, f"{prefix}.input_proj.weight")[:, :, 0].T},
        "out_proj": {"w": _np(state, f"{prefix}.output_proj.weight")[:, :, 0].T},
        "codebooks": np.stack([_codebook(state, f"{prefix}.vq.layers.{k}._codebook") for k in range(n_levels)]),
    }


def _mimi_tree(state, cfg: MimiConfig) -> dict:
    enc = {"conv_in": _conv(state, "encoder.model.0.conv.conv")}
    enc["stages"] = [
        {"res": {"c1": _conv(state, f"encoder.model.{1 + 3 * i}.block.1.conv.conv"),
                 "c2": _conv(state, f"encoder.model.{1 + 3 * i}.block.3.conv.conv")},
         "down": _conv(state, f"encoder.model.{3 + 3 * i}.conv.conv")}
        for i in range(4)
    ]
    enc["conv_out"] = _conv(state, "encoder.model.14.conv.conv")
    dec = {"conv_in": _conv(state, "decoder.model.0.conv.conv")}
    dec["stages"] = [
        {"up": _conv(state, f"decoder.model.{2 + 3 * i}.convtr.convtr"),
         "res": {"c1": _conv(state, f"decoder.model.{3 + 3 * i}.block.1.conv.conv"),
                 "c2": _conv(state, f"decoder.model.{3 + 3 * i}.block.3.conv.conv")}}
        for i in range(4)
    ]
    dec["conv_out"] = _conv(state, "decoder.model.14.conv.conv")
    return {
        "encoder": enc,
        "enc_t": _mimi_tlayers(state, "encoder_transformer.transformer", cfg.t_layers),
        "downsample": _conv(state, "downsample.conv.conv"),
        "quantizer": {"first": _rvq(state, "quantizer.rvq_first", 1),
                      "rest": _rvq(state, "quantizer.rvq_rest", cfg.n_q - 1)},
        "upsample": _conv(state, "upsample.convtr.convtr"),
        "dec_t": _mimi_tlayers(state, "decoder_transformer.transformer", cfg.t_layers),
        "decoder": dec,
    }


def convert_mimi(state, cfg: MimiConfig | None = None, device=None) -> tuple[ParamTree, MimiConfig]:
    """A moshi ``MimiModel`` state dict -> (the port's Mimi tree on ``device``,
    the card unless the caller names another; config)."""
    cfg = cfg or mimi_config_from_state_dict(state)
    return ParamTree(_mimi_tree(state, cfg), tts_device(device)).requires_grad_(False), cfg


# ──────────────────────────────────────────────────────────────────────
# LM
# ──────────────────────────────────────────────────────────────────────


def lm_config_from_state_dict(state, acoustic_delay: int = 2, max_ctx: int = 1536,
                              warn_on_guess: bool = True) -> PocketLMConfig:
    def shape(key):
        return tuple(np.shape(state[key]))

    d_model = shape("text_emb.weight")[1]
    dep_d = shape("depformer_in.0.weight")[0]
    # head counts are NOT derivable from fused in_proj shapes: a guess. A
    # wrong guess mis-splits the heads silently, so a real checkpoint must
    # carry the truth (config.json through load_checkpoint, or n_heads=)
    n_heads = 16 if d_model % 16 == 0 and d_model >= 512 else max(
        h for h in (1, 2, 4, 8) if d_model % h == 0 and (d_model // h) % 2 == 0)
    dep_heads = max(h for h in (1, 2, 4, 8) if dep_d % h == 0 and (dep_d // h) % 2 == 0)
    if warn_on_guess:
        logger.warning(
            "pocket LM head counts guessed from shapes: n_heads=%d dep_heads=%d (d_model=%d, dep_d=%d) — if the "
            "checkpoint ships a config.json, load via load_checkpoint so the real values are used; a wrong head "
            "count produces garbage audio with no error", n_heads, dep_heads, d_model, dep_d)
    return PocketLMConfig(
        d_model=d_model,
        n_heads=n_heads,
        n_layers=_count(state, r"transformer\.layers\.(\d+)\."),
        ff=3 * shape("transformer.layers.0.gating.linear_out.weight")[1] // 2,
        dep_d_model=dep_d,
        dep_heads=dep_heads,
        dep_layers=_count(state, r"depformer\.layers\.(\d+)\."),
        dep_ff=3 * shape("depformer.layers.0.gating.0.linear_out.weight")[1] // 2,
        n_q=_count(state, r"depformer_in\.(\d+)\.weight"),
        card=shape("emb.0.weight")[0] - 1,
        text_card=shape("text_linear.weight")[0],
        acoustic_delay=acoustic_delay,
        max_ctx=max_ctx,
    )


def _lm_tree(state, cfg: PocketLMConfig) -> dict:
    layers = []
    for i in range(cfg.n_layers):
        p = f"transformer.layers.{i}"
        layers.append({
            "ln1": _rms(state, f"{p}.norm1.alpha"),
            "qkv": {"w": _lin_t(state, f"{p}.self_attn.in_proj_weight")},
            "out": {"w": _lin_t(state, f"{p}.self_attn.out_proj.weight")},
            "ln2": _rms(state, f"{p}.norm2.alpha"),
            "gate_in": {"w": _lin_t(state, f"{p}.gating.linear_in.weight")},
            "gate_out": {"w": _lin_t(state, f"{p}.gating.linear_out.weight")},
        })
    stages = range(cfg.n_q)
    dep_layers = []
    for i in range(cfg.dep_layers):
        p = f"depformer.layers.{i}"
        dep_layers.append({
            "ln1": _rms(state, f"{p}.norm1.alpha"),
            "qkv": {"w": np.stack([_lin_t(state, f"{p}.self_attn.in_projs.{s}.weight") for s in stages])},
            "out": {"w": np.stack([_lin_t(state, f"{p}.self_attn.out_projs.{s}.weight") for s in stages])},
            "ln2": _rms(state, f"{p}.norm2.alpha"),
            "gate_in": {"w": np.stack([_lin_t(state, f"{p}.gating.{s}.linear_in.weight") for s in stages])},
            "gate_out": {"w": np.stack([_lin_t(state, f"{p}.gating.{s}.linear_out.weight") for s in stages])},
        })
    return {
        "text_emb": _np(state, "text_emb.weight"),
        "emb": np.stack([_np(state, f"emb.{k}.weight") for k in stages]),
        "layers": _stack(layers),
        "out_norm": _rms(state, "out_norm.alpha"),
        "text_linear": {"w": _lin_t(state, "text_linear.weight")},
        "dep_in": np.stack([_lin_t(state, f"depformer_in.{k}.weight") for k in stages]),
        "dep_text_emb": _np(state, "depformer_text_emb.weight"),
        "dep_emb": np.stack([_np(state, f"depformer_emb.{k}.weight") for k in range(cfg.n_q - 1)]),
        "dep_layers": _stack(dep_layers),
        "linears": np.stack([_lin_t(state, f"linears.{k}.weight") for k in stages]),
    }


def convert_pocket_lm(state, cfg: PocketLMConfig | None = None, n_heads: int | None = None,
                      dep_heads: int | None = None, device=None) -> tuple[ParamTree, PocketLMConfig]:
    """A moshi ``LMModel`` state dict -> (the port's LM tree on ``device``,
    the card unless the caller names another; config)."""
    cfg = cfg or lm_config_from_state_dict(state, warn_on_guess=not (n_heads and dep_heads))
    if n_heads or dep_heads:
        cfg = replace(cfg, n_heads=n_heads or cfg.n_heads, dep_heads=dep_heads or cfg.dep_heads)
    return ParamTree(_lm_tree(state, cfg), tts_device(device)).requires_grad_(False), cfg


# ──────────────────────────────────────────────────────────────────────
# files
# ──────────────────────────────────────────────────────────────────────


def _read_state(path) -> dict[str, np.ndarray]:
    """A torch or safetensors state dict as {name: float32-or-int array};
    bf16 (the dtype kyutai releases ship) widens to float32."""
    if str(path).endswith(".safetensors"):
        state = load_safetensors(str(path))
    else:
        raw = torch.load(str(path), map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and isinstance(raw.get("model"), dict):
            raw = raw["model"]
        state = {k: (v.detach().float() if v.dtype == torch.bfloat16 else v.detach()).numpy()
                 for k, v in raw.items()}
    # moshi exports sometimes prefix everything with "model."
    if state and all(k.startswith("model.") for k in state):
        state = {k[len("model."):]: v for k, v in state.items()}
    return state


def load_checkpoint(path, device=None):
    """A release directory (or an LM weight file) -> a ready ``PocketTTS``.

    Finds the LM weights, the Mimi codec (``mimi*`` or moshi's
    ``tokenizer-*.safetensors``), an optional sentencepiece tokenizer
    (``*.model``) and ``config.json`` beside them, as the JAX loader does.
    The weights go to ``device`` (``settings.tts_effective_device`` when None)."""
    from open_speech_tpu_torch.models.pocket.model import PocketTTS, SentencePieceTokenizer

    device = tts_device(device)

    path = Path(path)
    folder = path if path.is_dir() else path.parent

    def pick(patterns, exclude=()):
        for pat in patterns:
            hits = [p for p in sorted(folder.glob(pat)) if not any(x in p.name for x in exclude)]
            if hits:
                return hits[0]
        return None

    mimi_file = pick(("mimi*.safetensors", "tokenizer*-checkpoint*.safetensors", "tokenizer*.safetensors",
                      "mimi*.pt"))
    lm_file = path if path.is_file() else pick(("model*.safetensors", "*.safetensors", "model*.pt", "*.pt"),
                                                exclude=("mimi", "tokenizer"))
    if lm_file is None or mimi_file is None:
        raise FileNotFoundError(f"pocket-tts checkpoint incomplete under {folder}: lm={lm_file} mimi={mimi_file}")
    mimi, mimi_cfg = convert_mimi(_read_state(mimi_file), device=device)

    # the release config.json holds what shapes cannot say: head counts,
    # the context window, stream delays and the text special ids
    rc = {}
    cfg_file = pick(("config.json",))
    if cfg_file is not None:
        raw_cfg = json.loads(cfg_file.read_text())
        rc = raw_cfg.get("model", raw_cfg)  # kyutai TTS releases nest the LM geometry
    lm, lm_cfg = convert_pocket_lm(_read_state(lm_file), n_heads=rc.get("num_heads"),
                                   dep_heads=rc.get("depformer_num_heads"), device=device)
    overrides = {}
    if rc.get("context"):
        overrides["max_ctx"] = int(rc["context"])
    delays = rc.get("delays")
    if delays and len(delays) > 1:
        overrides["acoustic_delay"] = int(max(delays[1:]))
    spm = pick(("tokenizer*.model", "*.model"))
    if rc.get("existing_text_padding_id") is not None:
        overrides["text_pad_id"] = int(rc["existing_text_padding_id"])
    elif spm is not None:
        overrides["text_pad_id"] = 3  # sentencepiece convention: unk 0, bos 1, eos 2, pad 3
    if rc.get("text_bos_token_id") is not None:
        overrides["text_bos_id"] = int(rc["text_bos_token_id"])
    if rc.get("text_eos_token_id") is not None:
        overrides["text_eos_id"] = int(rc["text_eos_token_id"])
    if overrides:
        lm_cfg = replace(lm_cfg, **overrides)
    tokenizer = SentencePieceTokenizer(str(spm)) if spm else None
    return PocketTTS(lm, mimi, lm_cfg, mimi_cfg, tokenizer)


# ──────────────────────────────────────────────────────────────────────
# the JAX package's trees
# ──────────────────────────────────────────────────────────────────────


def _jax_conv(p: dict) -> dict:
    """JAX conv {"w": [K, C_in, C_out]} -> PyTorch's [C_out, C_in, K]."""
    out = {"w": np.asarray(p["w"], np.float32).transpose(2, 1, 0)}
    if "b" in p:
        out["b"] = np.asarray(p["b"], np.float32)
    return out


def _jax_convtr(p: dict) -> dict:
    """JAX transposed conv (kernel-flipped; dense [K, C_in, C_out],
    depthwise [K, 1, C]) -> PyTorch's unflipped [C_in, C_out/groups, K]."""
    w = np.asarray(p["w"], np.float32)[::-1]
    out = {"w": np.ascontiguousarray(w.transpose(2, 1, 0) if w.shape[1] == 1 and w.shape[2] > 1
                                     else w.transpose(1, 2, 0))}
    if "b" in p:
        out["b"] = np.asarray(p["b"], np.float32)
    return out


def _jax_seanet(tree: dict, up: bool) -> dict:
    out = {"conv_in": _jax_conv(tree["conv_in"]), "conv_out": _jax_conv(tree["conv_out"]), "stages": []}
    for st in tree["stages"]:
        stage = {"res": {"c1": _jax_conv(st["res"]["c1"]), "c2": _jax_conv(st["res"]["c2"])}}
        stage["up" if up else "down"] = _jax_convtr(st["up"]) if up else _jax_conv(st["down"])
        out["stages"].append(stage)
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree, np.float32)


def pocket_params_from_jax(lm_tree: dict, mimi_tree: dict, device=None) -> tuple[ParamTree, ParamTree]:
    """The JAX package's Pocket LM and Mimi trees (numpy arrays) -> the
    port's (LM, Mimi) ``ParamTree``s on ``device`` (``settings.tts_effective_device``
    when None) with the same weights."""
    device = tts_device(device)
    lm = _numpy_tree(lm_tree)
    m = _numpy_tree(mimi_tree)
    mimi = {
        "encoder": _jax_seanet(m["encoder"], up=False),
        "enc_t": m["enc_t"],
        "downsample": _jax_conv(m["downsample"]),
        "quantizer": m["quantizer"],
        "upsample": _jax_convtr(m["upsample"]),
        "dec_t": m["dec_t"],
        "decoder": _jax_seanet(m["decoder"], up=True),
    }
    return (ParamTree(lm, device).requires_grad_(False), ParamTree(mimi, device).requires_grad_(False))
