"""Kokoro-82M checkpoint -> ``KModel``.

Counterpart of ``open_speech_tpu/models/kokoro/convert.py``. The published
checkpoint (``kokoro-v1_0.pth``) is a dict of module state dicts
({bert, bert_encoder, predictor, text_encoder, decoder}) with weight-normed
convolutions. ``KModel`` names its tensors as the checkpoint does, so the
conversion folds the weight norms, infers the geometry from tensor shapes
and loads the tensors as they are; the one renaming is the bidirectional
LSTMs', whose ``*_reverse`` tensors belong to ``BiLSTM.bw``. Voice packs
(tensors [510, 1, 256], one style row per utterance length) convert with
``convert_voice_pack``.

``kokoro_from_jax_tree`` carries the JAX package's parameter tree (as
numpy arrays) across to a ``KModel``, so the two models compute the same
thing in the parity tests. Its layout map is the inverse of the JAX
converter's: linears [in, out], convolutions [K, C_in, C_out], transposed
convolutions kernel-flipped, LSTMs [in, 4H] with one summed bias.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from open_speech_tpu_torch.models.kokoro.model import KModel, KokoroConfig, _tts_device
from open_speech_tpu_torch.models.piper.convert import _numpy, fold_weight_norms


def _flatten(state: dict) -> dict:
    """{module: state_dict} -> flat {module.name: array}; a flat dict passes.

    The shipped checkpoint's module state dicts carry DataParallel
    ``module.`` prefixes; they are stripped, so it converts as a clean one."""

    def _strip(k: str) -> str:
        k = k[len("module."):] if k.startswith("module.") else k
        return k.replace(".module.", ".")

    if any("." in k for k in state):
        return {_strip(k): _numpy(v) for k, v in state.items()}
    return {f"{mod}.{_strip(k)}": _numpy(v) for mod, sd in state.items() for k, v in sd.items()}


def _albert_prefix(sd: dict) -> str:
    return "bert.encoder.albert_layer_groups.0.albert_layers.0."


def config_from_checkpoint(sd: dict, **overrides) -> KokoroConfig:
    """The geometry from tensor shapes. Heads, layers and the hop are not
    in the shapes: kokoro-82M's are the defaults, ``overrides`` set others."""

    def shape(name):  # weight-normed tensors carry their shape in weight_v
        if f"{name}.weight_v" in sd:
            return sd[f"{name}.weight_v"].shape
        return sd[f"{name}.weight"].shape

    word = sd["bert.embeddings.word_embeddings.weight"]
    g = "decoder.generator"
    ups = sorted({int(k.split(".")[3]) for k in sd if k.startswith(f"{g}.ups.") and "weight" in k})
    up_kernels = tuple(shape(f"{g}.ups.{i}")[2] for i in ups)
    n_res = len({k.split(".")[3] for k in sd if k.startswith(f"{g}.resblocks.")})
    nk = n_res // len(ups)
    kwargs = dict(
        n_symbols=word.shape[0],
        plbert_emb=word.shape[1],
        plbert_hidden=shape("bert.encoder.embedding_hidden_mapping_in")[0],
        plbert_interm=shape(_albert_prefix(sd) + "ffn")[0],
        max_positions=sd["bert.embeddings.position_embeddings.weight"].shape[0],
        hidden=shape("bert_encoder")[0],
        style_dim=shape("predictor.F0.0.norm1.fc")[1],
        max_dur=shape("predictor.duration_proj.linear_layer")[0],
        text_kernel=shape("text_encoder.cnn.0.0")[2],
        text_depth=len({
            k.split(".")[2] for k in sd
            if k.startswith("text_encoder.cnn.") and "weight" in k and ".0." in k
        }),
        dur_layers=len({
            k.split(".")[3] for k in sd
            if k.startswith("predictor.text_encoder.lstms.") and "weight_ih_l0" in k
        }),
        dec_mid=shape("decoder.encode.conv1")[0],
        dec_blocks=len({k.split(".")[2] for k in sd if k.startswith("decoder.decode.")}),
        asr_res_dim=shape("decoder.asr_res.0")[0],
        upsample_kernels=up_kernels,
        upsample_rates=tuple(k // 2 for k in up_kernels),
        resblock_kernels=tuple(shape(f"{g}.resblocks.{j}.convs1.0")[2] for j in range(nk)),
        noise_res_kernels=tuple(shape(f"{g}.noise_res.{i}.convs1.0")[2] for i in range(len(ups))),
        gen_n_fft=shape(f"{g}.conv_post")[0] - 2,
        harmonics=shape(f"{g}.m_source.l_linear")[1] - 1,
    )
    kwargs.update(overrides)
    return KokoroConfig(**kwargs)


def _checkpoint_name(name: str) -> str:
    """``KModel`` tensor name -> checkpoint name (``X.fw.weight_ih_l0`` ->
    ``X.weight_ih_l0``, ``X.bw.weight_ih_l0`` -> ``X.weight_ih_l0_reverse``)."""
    name = re.sub(r"\.fw\.(\w+_l0)$", r".\1", name)
    return re.sub(r"\.bw\.(\w+_l0)$", r".\1_reverse", name)


def _load(sd: dict, cfg: KokoroConfig, device) -> KModel:
    """A ``KModel`` on ``device`` holding the flat checkpoint ``sd`` (weight
    norms folded); tensors the model does not hold are ignored."""
    model = KModel.empty(cfg, _tts_device(device))
    tensors = {}
    for name, want in model.state_dict().items():
        src = _checkpoint_name(name)
        if src not in sd:
            raise KeyError(f"checkpoint has no tensor {src}")
        arr = np.array(sd[src], np.float32)  # a writable copy
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{src}: shape {arr.shape}, the model expects {tuple(want.shape)}")
        tensors[name] = torch.from_numpy(arr)
    model.load_state_dict(tensors)
    return model


def convert_kokoro(state: dict, device=None, **cfg_overrides) -> tuple[KModel, KokoroConfig]:
    """Kokoro checkpoint ({module: state_dict} or flat; tensors or numpy)
    -> (model on ``device``, cfg). ``device`` defaults to
    ``settings.tts_effective_device``."""
    flat = _flatten(state)
    cfg = config_from_checkpoint(flat, **cfg_overrides)  # reads weight_v shapes
    return _load(fold_weight_norms(flat), cfg, device), cfg


def convert_kokoro_file(path: str | Path, device=None, **cfg_overrides):
    """Load a kokoro .pth checkpoint and convert it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "net" in state:
        state = state["net"]
    nested = {mod: sd for mod, sd in state.items() if isinstance(sd, dict)}
    return convert_kokoro(nested, device=device, **cfg_overrides)


def convert_voice_pack(src) -> np.ndarray:
    """Voice pack tensor, array or file [510, 1, 256] -> [510, 256] float32.

    Row i is the style for an utterance of i+1 phonemes."""
    if isinstance(src, (str, Path)):
        src = torch.load(src, map_location="cpu", weights_only=True)
    arr = _numpy(src).astype(np.float32)
    return arr[:, 0] if arr.ndim == 3 else arr


def select_voice_style(pack: np.ndarray, n_tokens: int) -> np.ndarray:
    """The style row for an utterance length (clamped to the pack)."""
    return pack[min(max(n_tokens, 1), pack.shape[0]) - 1]


def _checkpoint_from_jax_tree(tree: dict) -> dict:
    """The JAX package's parameter tree -> the flat checkpoint layout."""
    sd: dict = {}

    def lin(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(p["w"]).T, p["b"]

    def conv(name, p):  # [K, C_in, C_out] -> [C_out, C_in, K]
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(2, 1, 0)
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def conv_t(name, p):  # flipped [K, C_in, C_out] -> [C_in, C_out, K]
        sd[f"{name}.weight"] = np.asarray(p["w"])[::-1].transpose(1, 2, 0)
        sd[f"{name}.bias"] = p["b"]

    def norm(name, p, g="weight", b="bias"):
        sd[f"{name}.{g}"], sd[f"{name}.{b}"] = p["g"], p["b"]

    def lstm(name, p):
        for sfx, d in (("", p["fw"]), ("_reverse", p["bw"])):
            sd[f"{name}.weight_ih_l0{sfx}"] = np.asarray(d["wi"]).T
            sd[f"{name}.weight_hh_l0{sfx}"] = np.asarray(d["wh"]).T
            sd[f"{name}.bias_ih_l0{sfx}"] = d["b"]
            sd[f"{name}.bias_hh_l0{sfx}"] = np.zeros_like(d["b"])

    def adain_blk(name, p):
        conv(f"{name}.conv1", p["c1"])
        conv(f"{name}.conv2", p["c2"])
        lin(f"{name}.norm1.fc", p["n1"])
        lin(f"{name}.norm2.fc", p["n2"])
        if "pool" in p:  # depthwise, flipped [K, 1, C] -> [C, 1, K]
            sd[f"{name}.pool.weight"] = np.asarray(p["pool"]["w"])[::-1].transpose(2, 1, 0)
            sd[f"{name}.pool.bias"] = p["pool"]["b"]
        if "sc" in p:
            conv(f"{name}.conv1x1", p["sc"])

    def gen_blk(name, p):
        for i in range(len(p["c1"])):
            conv(f"{name}.convs1.{i}", p["c1"][i])
            conv(f"{name}.convs2.{i}", p["c2"][i])
            lin(f"{name}.adain1.{i}.fc", p["ad1"][i])
            lin(f"{name}.adain2.{i}.fc", p["ad2"][i])
            sd[f"{name}.alpha1.{i}"] = np.asarray(p["a1"][i])[None, :, None]
            sd[f"{name}.alpha2.{i}"] = np.asarray(p["a2"][i])[None, :, None]

    bp = tree["bert"]
    sd["bert.embeddings.word_embeddings.weight"] = bp["word_emb"]
    sd["bert.embeddings.position_embeddings.weight"] = bp["pos_emb"]
    sd["bert.embeddings.token_type_embeddings.weight"] = bp["type_emb"]
    norm("bert.embeddings.LayerNorm", bp["emb_ln"])
    lin("bert.encoder.embedding_hidden_mapping_in", bp["emb_map"])
    al = _albert_prefix(sd)
    for key, name in (("q", "attention.query"), ("k", "attention.key"), ("v", "attention.value"),
                      ("att_o", "attention.dense"), ("ffn", "ffn"), ("ffn_o", "ffn_output")):
        lin(al + name, bp[key])
    norm(al + "attention.LayerNorm", bp["att_ln"])
    norm(al + "full_layer_layer_norm", bp["out_ln"])
    lin("bert_encoder", tree["bert_encoder"])

    pred = tree["pred"]
    for i, layer in enumerate(pred["dur_enc"]):
        lstm(f"predictor.text_encoder.lstms.{2 * i}", layer["lstm"])
        lin(f"predictor.text_encoder.lstms.{2 * i + 1}.fc", layer["adaln"])
    lstm("predictor.lstm", pred["lstm"])
    lin("predictor.duration_proj.linear_layer", pred["dur_proj"])
    lstm("predictor.shared", pred["shared"])
    for head in ("F0", "N"):
        for i, blk in enumerate(pred[head]):
            adain_blk(f"predictor.{head}.{i}", blk)
        conv(f"predictor.{head}_proj", pred[f"{head}_proj"])

    te = tree["text_enc"]
    sd["text_encoder.embedding.weight"] = te["emb"]
    for i, blk in enumerate(te["cnn"]):
        conv(f"text_encoder.cnn.{i}.0", blk["conv"])
        norm(f"text_encoder.cnn.{i}.1", blk["ln"], g="gamma", b="beta")
    lstm("text_encoder.lstm", te["lstm"])

    dec = tree["dec"]
    adain_blk("decoder.encode", dec["encode"])
    for i, blk in enumerate(dec["decode"]):
        adain_blk(f"decoder.decode.{i}", blk)
    conv("decoder.F0_conv", dec["f0_conv"])
    conv("decoder.N_conv", dec["n_conv"])
    conv("decoder.asr_res.0", dec["asr_res"])
    gen, g = dec["gen"], "decoder.generator"
    lin(f"{g}.m_source.l_linear", gen["src_linear"])
    for i, p in enumerate(gen["ups"]):
        conv_t(f"{g}.ups.{i}", p)
    for j, p in enumerate(gen["res"]):
        gen_blk(f"{g}.resblocks.{j}", p)
    for i, p in enumerate(gen["noise_convs"]):
        conv(f"{g}.noise_convs.{i}", p)
    for i, p in enumerate(gen["noise_res"]):
        gen_blk(f"{g}.noise_res.{i}", p)
    conv(f"{g}.conv_post", gen["post"])
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def kokoro_from_jax_tree(tree: dict, device=None) -> KModel:
    """The JAX package's Kokoro parameter tree (numpy arrays) -> ``KModel``
    on ``device`` holding the same weights. Each LSTM's summed bias goes to
    ``bias_ih``, with ``bias_hh`` zero."""
    sd = _checkpoint_from_jax_tree(tree)
    return _load(sd, config_from_checkpoint(sd), device)
