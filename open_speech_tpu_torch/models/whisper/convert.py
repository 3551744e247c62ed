"""Checkpoint conversion: HF / openai Whisper weights and JAX pytrees ->
the port's ``Whisper`` module.

Counterpart of ``open_speech_tpu/models/whisper/convert.py``. Every source
goes through the JAX package's stacked-layer layout (``params_from_jax_tree``:
layers stacked along a leading axis, linear ``w`` in [in, out], conv ``w`` in
[K, in, out]), so one mapping fills the module. Safetensors files are read
with a small numpy reader (8-byte little-endian header length, JSON header,
raw little-endian data), so the ``safetensors`` package is not needed.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch
from torch import nn

from open_speech_tpu_torch.models.whisper.model import (
    Attention,
    Block,
    LayerNorm,
    QuantEmbedding,
    QuantLinear,
    Whisper,
    WhisperConfig,
    sinusoids,
)

_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Read a .safetensors file into numpy arrays (BF16 widens to float32)."""
    with open(path, "rb") as f:
        (n_header,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n_header))
        data = f.read()
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = data[start:end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(raw, dtype=_ST_DTYPES[info["dtype"]]).copy()
        else:
            raise ValueError(f"{path}: unsupported safetensors dtype {info['dtype']}")
        out[name] = arr.reshape(shape)
    return out


def config_from_hf(model_dir: str) -> WhisperConfig:
    """Derive WhisperConfig from a HF config.json."""
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    n_vocab = hf["vocab_size"]
    return WhisperConfig(
        n_mels=hf.get("num_mel_bins", 80),
        n_vocab=n_vocab,
        n_audio_ctx=hf.get("max_source_positions", 1500),
        n_audio_state=hf["d_model"],
        n_audio_head=hf["encoder_attention_heads"],
        n_audio_layer=hf["encoder_layers"],
        n_text_ctx=hf.get("max_target_positions", 448),
        n_text_state=hf["d_model"],
        n_text_head=hf["decoder_attention_heads"],
        n_text_layer=hf["decoder_layers"],
        n_langs=100 if n_vocab >= 51866 else 99,
    )


def _load_state_dict(model_dir: str) -> dict[str, np.ndarray]:
    """Read safetensors shards (preferred) or a torch .pt/.bin checkpoint."""
    single = os.path.join(model_dir, "model.safetensors")
    index = os.path.join(model_dir, "model.safetensors.index.json")
    files: list[str] = []
    if os.path.exists(single):
        files = [single]
    elif os.path.exists(index):
        with open(index, encoding="utf-8") as f:
            files = sorted(
                {os.path.join(model_dir, v) for v in json.load(f)["weight_map"].values()}
            )
    if files:
        state: dict[str, np.ndarray] = {}
        for path in files:
            state.update(load_safetensors(path))
        return state
    for name in os.listdir(model_dir):
        if name.endswith(".pt") or name.endswith(".bin"):
            raw = torch.load(
                os.path.join(model_dir, name), map_location="cpu", weights_only=True
            )
            if isinstance(raw, dict) and "model_state_dict" in raw:
                raw = raw["model_state_dict"]
            return {k: v.float().numpy() for k, v in raw.items()}
    raise FileNotFoundError(f"no checkpoint found in {model_dir}")


# (our block name, HF name, openai name) — attention sub-layers and MLP
_LN_NAMES = {
    "ln1": ("self_attn_layer_norm", "attn_ln"),
    "ln_mlp": ("final_layer_norm", "mlp_ln"),
    "ln_cross": ("encoder_attn_layer_norm", "cross_attn_ln"),
}
_ATTN_NAMES = {
    "attn": ("self_attn", "attn"),
    "cross": ("encoder_attn", "cross_attn"),
}
_PROJ_NAMES = {"q": ("q_proj", "query"), "k": ("k_proj", "key"),
               "v": ("v_proj", "value"), "o": ("out_proj", "out")}
_MLP_NAMES = {"mlp_in": ("fc1", "mlp.0"), "mlp_out": ("fc2", "mlp.2")}


def _block_tree(state, prefix: str, cross: bool, hf: bool) -> dict:
    """One layer in the JAX layout (linear w as [in, out])."""
    s = 0 if hf else 1

    def lin(name, bias=True):
        p = {"w": state[f"{prefix}.{name}.weight"].T}
        if bias:
            p["b"] = state[f"{prefix}.{name}.bias"]
        return p

    block: dict = {}
    for ours, names in _LN_NAMES.items():
        if ours == "ln_cross" and not cross:
            continue
        block[ours] = {"g": state[f"{prefix}.{names[s]}.weight"],
                       "b": state[f"{prefix}.{names[s]}.bias"]}
    for ours, names in _ATTN_NAMES.items():
        if ours == "cross" and not cross:
            continue
        block[ours] = {
            p: lin(f"{names[s]}.{proj[s]}", bias=p != "k")
            for p, proj in _PROJ_NAMES.items()
        }
    for ours, names in _MLP_NAMES.items():
        block[ours] = lin(names[s])
    return block


def _stack(blocks: list[dict]) -> dict:
    first = blocks[0]
    return {
        k: _stack([b[k] for b in blocks]) if isinstance(first[k], dict)
        else np.stack([b[k] for b in blocks])
        for k in first
    }


def jax_tree_from_state_dict(state: dict[str, np.ndarray], cfg: WhisperConfig) -> dict:
    """HF or openai state dict -> the JAX package's stacked pytree (numpy)."""
    hf = any(k.startswith("model.encoder.layers.") for k in state)
    if hf:
        e, d = "model.encoder", "model.decoder"
        enc_layer, dec_layer = f"{e}.layers", f"{d}.layers"
        names = {
            "pos": f"{e}.embed_positions.weight", "ln_post": f"{e}.layer_norm",
            "tok_emb": f"{d}.embed_tokens.weight",
            "pos_emb": f"{d}.embed_positions.weight", "ln": f"{d}.layer_norm",
        }
    else:
        e, d = "encoder", "decoder"
        enc_layer, dec_layer = "encoder.blocks", "decoder.blocks"
        names = {
            "pos": "encoder.positional_embedding", "ln_post": "encoder.ln_post",
            "tok_emb": "decoder.token_embedding.weight",
            "pos_emb": "decoder.positional_embedding", "ln": "decoder.ln",
        }
    pos = state.get(names["pos"])
    if pos is None:
        pos = sinusoids(cfg.n_audio_ctx, cfg.n_audio_state)

    def ln(name):
        return {"g": state[f"{name}.weight"], "b": state[f"{name}.bias"]}

    def conv(name):  # torch [out, in, k] -> [k, in, out]
        return {"w": state[f"{e}.{name}.weight"].transpose(2, 1, 0),
                "b": state[f"{e}.{name}.bias"]}

    return {
        "encoder": {
            "conv1": conv("conv1"),
            "conv2": conv("conv2"),
            "pos": pos,
            "blocks": _stack([_block_tree(state, f"{enc_layer}.{i}", False, hf)
                              for i in range(cfg.n_audio_layer)]),
            "ln_post": ln(names["ln_post"]),
        },
        "decoder": {
            "tok_emb": state[names["tok_emb"]],
            "pos_emb": state[names["pos_emb"]],
            "blocks": _stack([_block_tree(state, f"{dec_layer}.{i}", True, hf)
                              for i in range(cfg.n_text_layer)]),
            "ln": ln(names["ln"]),
        },
    }


@torch.no_grad()
def params_from_jax_tree(
    tree: dict, cfg: WhisperConfig, dtype: torch.dtype = torch.float32, device="cpu"
) -> Whisper:
    """The JAX package's param pytree (leaves as numpy arrays) -> ``Whisper``.

    Layer norms stay float32; every other tensor takes ``dtype``. A tree
    quantized by the JAX package's ``quantize_whisper_params`` ({"q", "s"}
    leaves) gives an int8 model with the same packs: a linear's q [in, out]
    becomes ``QuantLinear.q`` [out, in] and its s [1, out] ``QuantLinear.s``
    [out]; the token embedding's pack carries over as it is.
    """
    model = Whisper.empty(cfg, dtype, device)

    def put(dst: torch.Tensor, src) -> None:
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))

    def put_ln(ln: LayerNorm, p: dict, i=None) -> None:
        put(ln.weight, p["g"] if i is None else p["g"][i])
        put(ln.bias, p["b"] if i is None else p["b"][i])

    def pack(p: dict, transpose: bool) -> tuple[torch.Tensor, torch.Tensor]:
        q = np.asarray(p["q"], np.int8)
        q = torch.from_numpy(np.array(q.T if transpose else q, order="C")).to(device)
        return q, torch.from_numpy(np.array(p["s"], dtype=np.float32)).to(device)

    def put_linear(owner: nn.Module, name: str, p: dict, i: int) -> None:
        lin = getattr(owner, name)
        if lin.bias is not None:
            put(lin.bias, p["b"][i])
        w = p["w"]
        if isinstance(w, dict):  # int8 pack: q [L, in, out], s [L, 1, out]
            q, s = pack({"q": w["q"][i], "s": w["s"][i][0]}, transpose=True)
            setattr(owner, name, QuantLinear(q, s, lin.bias))
        else:
            put(lin.weight, w[i].T)  # [in, out] -> [out, in]

    def put_block(blk: Block, p: dict, i: int) -> None:
        for name in ("ln1", "ln_mlp", "ln_cross"):
            if name in p:
                put_ln(getattr(blk, name), p[name], i)
        for name in ("attn", "cross"):
            if name in p:
                attn: Attention = getattr(blk, name)
                for proj in ("q", "k", "v", "o"):
                    put_linear(attn, proj, p[name][proj], i)
        put_linear(blk, "mlp_in", p["mlp_in"], i)
        put_linear(blk, "mlp_out", p["mlp_out"], i)

    enc, dec = tree["encoder"], tree["decoder"]
    for name in ("conv1", "conv2"):
        conv = getattr(model.encoder, name)
        put(conv.weight, np.asarray(enc[name]["w"]).transpose(2, 1, 0))
        put(conv.bias, enc[name]["b"])
    put(model.encoder.pos, enc["pos"])
    for i, blk in enumerate(model.encoder.blocks):
        put_block(blk, enc["blocks"], i)
    put_ln(model.encoder.ln_post, enc["ln_post"])
    if isinstance(dec["tok_emb"], dict):
        del model.decoder.tok_emb
        model.decoder.tok_emb = QuantEmbedding(*pack(dec["tok_emb"], transpose=False))
    else:
        put(model.decoder.tok_emb, dec["tok_emb"])
    put(model.decoder.pos_emb, dec["pos_emb"])
    for i, blk in enumerate(model.decoder.blocks):
        put_block(blk, dec["blocks"], i)
    put_ln(model.decoder.ln, dec["ln"])
    return model


def load_params(
    model_dir: str, cfg: WhisperConfig | None = None,
    dtype: torch.dtype = torch.bfloat16, device="cpu",
) -> tuple[Whisper, WhisperConfig]:
    """Load a checkpoint directory (and its config) into a ``Whisper``."""
    if cfg is None:
        cfg = config_from_hf(model_dir)
    tree = jax_tree_from_state_dict(_load_state_dict(model_dir), cfg)
    return params_from_jax_tree(tree, cfg, dtype, device), cfg
