"""Piper checkpoint -> ``PiperModel``.

Counterpart of ``open_speech_tpu/models/piper/convert.py``. Piper voices
ship as ONNX graphs whose initializers keep the piper_train (VITS
``SynthesizerTrn``) module paths; ``PiperModel`` names its tensors the same
way, so a conversion strips the training harness' prefixes, folds the
weight norms, infers every hyperparameter from tensor shapes (all piper
quality tiers convert without a table) and loads the tensors as they are.
The ONNX initializers are read by ``models/onnx_io.py`` (no onnxruntime);
the voice's JSON sidecar gives the sample rate, the inference noise
defaults and the phoneme -> id map.

``piper_params_from_jax`` carries the JAX package's parameter tree (as
numpy arrays) across to a ``PiperModel``, so the two models compute the
same thing in the parity tests. Its layout map is the inverse of the JAX
converter's: convolutions [K, C_in/groups, C_out], transposed convolutions
kernel-flipped [K, C_in, C_out], relative embeddings without their leading
axis, the duration flows' affine as two vectors.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from open_speech_tpu_torch.models.piper.model import PiperConfig, PiperModel
from open_speech_tpu_torch.ops.vocoder import tts_device


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


def _strip_prefixes(sd: dict) -> dict:
    """Remove training-harness prefixes (``model_g.``/``model.``/``_model.``/
    ``generator.``)."""
    for prefix in ("model_g.", "model.", "_model.", "generator."):
        if any(k.startswith(prefix + "enc_p.") for k in sd):
            return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def _layer_count(sd: dict, pattern: str) -> int:
    """Number of distinct layer indices matching ``pattern``.

    Counts, not max+1: VITS flow lists interleave parameterless Flip
    modules, so e.g. the duration predictor's ConvFlows sit at 1, 3, 5, 7.
    """
    rx = re.compile(pattern)
    return len({int(m.group(1)) for k in sd if (m := rx.match(k))})


def config_from_state_dict(sd: dict, **overrides) -> PiperConfig:
    """Infer the VITS geometry from checkpoint tensor shapes."""
    emb = sd["enc_p.emb.weight"]
    hidden = emb.shape[1]
    rel = sd["enc_p.encoder.attn_layers.0.emb_rel_k"]  # [1, 2w+1, hd]
    ffn1 = sd["enc_p.encoder.ffn_layers.0.conv_1.weight"]  # [F, H, K]
    sep0 = sd["dp.convs.convs_sep.0.weight"]  # [C, 1, K]
    cf_proj = sd["dp.flows.1.proj.weight"]  # [3*bins-1, F, 1]
    wn_in0 = sd["flow.flows.0.enc.in_layers.0.weight"]  # [2H, H, K]
    n_ups = _layer_count(sd, r"dec\.ups\.(\d+)\.weight")
    up_kernels = tuple(sd[f"dec.ups.{i}.weight"].shape[2] for i in range(n_ups))
    n_res = _layer_count(sd, r"dec\.resblocks\.(\d+)\.convs1\.0\.weight")
    n_kernels = n_res // max(n_ups, 1)
    res_kernels = tuple(sd[f"dec.resblocks.{j}.convs1.0.weight"].shape[2] for j in range(n_kernels))
    n_res_convs = _layer_count(sd, r"dec\.resblocks\.0\.convs1\.(\d+)\.weight")
    dilations = ((1, 3, 5) if n_res_convs == 3 else tuple(3**i for i in range(n_res_convs)),) * n_kernels

    kwargs = dict(
        n_phonemes=emb.shape[0],
        hidden=hidden,
        ffn_filter=ffn1.shape[0],
        n_heads=hidden // rel.shape[-1],
        n_layers=_layer_count(sd, r"enc_p\.encoder\.attn_layers\.(\d+)\."),
        kernel_size=ffn1.shape[2],
        rel_window=(rel.shape[1] - 1) // 2,
        dp_filter=sd["dp.pre.weight"].shape[0],
        dp_kernel=sep0.shape[2],
        dp_dds_layers=_layer_count(sd, r"dp\.convs\.convs_sep\.(\d+)\."),
        # dp.flows is [EA, CF, Flip, CF, Flip, ...]: the *.pre tensors count the ConvFlows
        dp_flows=_layer_count(sd, r"dp\.flows\.(\d+)\.pre\.weight"),
        dp_bins=(cf_proj.shape[0] + 1) // 3,
        flow_layers=_layer_count(sd, r"flow\.flows\.(\d+)\.pre\.weight"),
        wn_kernel=wn_in0.shape[2],
        wn_layers=_layer_count(sd, r"flow\.flows\.0\.enc\.in_layers\.(\d+)\."),
        upsample_kernels=up_kernels,
        upsample_rates=tuple(k // 2 for k in up_kernels),  # piper's convention
        upsample_initial=sd["dec.conv_pre.weight"].shape[0],
        resblock_kernels=res_kernels,
        resblock_dilations=dilations,
    )
    if "emb_g.weight" in sd:
        kwargs["n_speakers"], kwargs["gin"] = sd["emb_g.weight"].shape
    kwargs.update(overrides)
    return PiperConfig(**kwargs)


def _load(sd: dict, cfg: PiperConfig, device) -> PiperModel:
    """A ``PiperModel`` on ``device`` holding the flat state dict ``sd``
    (weight norms folded). Tensors the model does not hold (the training
    graph's posterior encoder and duration posterior) are ignored; piper's
    bias-free ``dec.conv_post`` gets a zero bias."""
    model = PiperModel.empty(cfg, tts_device(device))
    tensors = {}
    for name, want in model.state_dict().items():
        if name not in sd and name == "dec.conv_post.bias":
            arr = np.zeros(tuple(want.shape), np.float32)
        elif name not in sd:
            raise KeyError(f"checkpoint has no tensor {name}")
        else:
            arr = np.array(sd[name], np.float32)  # a writable copy
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {arr.shape}, the model expects {tuple(want.shape)}")
        tensors[name] = torch.from_numpy(arr)
    model.load_state_dict(tensors)
    return model


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def convert_piper_state_dict(sd: dict, device=None, **cfg_overrides) -> tuple[PiperModel, PiperConfig]:
    """piper_train/VITS state dict (name -> tensor or array) -> (model on
    ``device``, cfg). ``device`` defaults to ``settings.tts_effective_device``."""
    sd = fold_weight_norms(_strip_prefixes({k: _numpy(v) for k, v in sd.items()}))
    cfg = config_from_state_dict(sd, **cfg_overrides)
    return _load(sd, cfg, device), cfg


def load_voice_json(path: str | Path) -> dict:
    """Parse a piper voice config sidecar (``<voice>.onnx.json``)."""
    cfg = json.loads(Path(path).read_text())
    inference = cfg.get("inference", {})
    return {
        "sample_rate": cfg.get("audio", {}).get("sample_rate", 22050),
        "noise_scale": inference.get("noise_scale", 0.667),
        "length_scale": inference.get("length_scale", 1.0),
        "noise_scale_w": inference.get("noise_w", 0.8),
        "phoneme_id_map": cfg.get("phoneme_id_map", {}),
        "speaker_id_map": cfg.get("speaker_id_map", {}),
        "espeak_voice": cfg.get("espeak", {}).get("voice", "en-us"),
        "num_symbols": cfg.get("num_symbols"),
        "num_speakers": cfg.get("num_speakers", 1),
    }


def convert_piper_onnx(onnx_path: str | Path, json_path: str | Path | None = None, device=None,
                       **cfg_overrides) -> tuple[PiperModel, PiperConfig, dict]:
    """Piper ONNX voice + JSON sidecar -> (model, cfg, voice_meta).

    Works when the export kept module-path initializer names (weight-norm
    tensors are folded). Raises with a clear message when the graph was
    constant-folded into anonymous initializers: convert the piper_train
    checkpoint with ``convert_piper_state_dict`` then. ``cfg_overrides``
    win over the sidecar (the serving buckets, for instance).
    """
    from open_speech_tpu_torch.models.onnx_io import read_onnx_initializers

    onnx_path = Path(onnx_path)
    sd = _strip_prefixes(read_onnx_initializers(onnx_path))
    if not any(k.startswith("enc_p.emb") for k in sd):
        raise ValueError(
            f"{onnx_path.name}: initializer names are anonymized "
            "(constant-folded export); convert from the piper_train "
            "checkpoint with convert_piper_state_dict instead"
        )
    meta: dict = {}
    if json_path is None:
        cand = onnx_path.with_suffix(onnx_path.suffix + ".json")
        json_path = cand if cand.is_file() else None
    if json_path is not None:
        meta = load_voice_json(json_path)
    overrides = {k: meta[k] for k in ("sample_rate", "noise_scale", "noise_scale_w") if k in meta}
    model, cfg = convert_piper_state_dict(sd, device=device, **{**overrides, **cfg_overrides})
    return model, cfg, meta


def _state_dict_from_jax_tree(tree: dict, cfg: PiperConfig) -> dict:
    """The JAX package's parameter tree -> the flat piper_train layout."""
    sd: dict = {}

    def conv(name, p):  # [K, C_in/groups, C_out] -> [C_out, C_in/groups, K]
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(2, 1, 0)
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def conv_t(name, p):  # flipped [K, C_in, C_out] -> [C_in, C_out, K]
        sd[f"{name}.weight"] = np.asarray(p["w"])[::-1].transpose(1, 2, 0)
        sd[f"{name}.bias"] = p["b"]

    def norm(name, p):
        sd[f"{name}.gamma"], sd[f"{name}.beta"] = p["g"], p["b"]

    def dds(name, p):
        for i in range(len(p["sep"])):
            conv(f"{name}.convs_sep.{i}", p["sep"][i])
            conv(f"{name}.convs_1x1.{i}", p["c1x1"][i])
            norm(f"{name}.norms_1.{i}", p["n1"][i])
            norm(f"{name}.norms_2.{i}", p["n2"][i])

    sd["enc_p.emb.weight"] = tree["emb"]
    for i, lp in enumerate(tree["enc"]):
        a = f"enc_p.encoder.attn_layers.{i}"
        sd[f"{a}.emb_rel_k"] = np.asarray(lp["rel_k"])[None]
        sd[f"{a}.emb_rel_v"] = np.asarray(lp["rel_v"])[None]
        for key in "qkvo":
            conv(f"{a}.conv_{key}", lp[key])
        norm(f"enc_p.encoder.norm_layers_1.{i}", lp["ln1"])
        conv(f"enc_p.encoder.ffn_layers.{i}.conv_1", lp["ffn1"])
        conv(f"enc_p.encoder.ffn_layers.{i}.conv_2", lp["ffn2"])
        norm(f"enc_p.encoder.norm_layers_2.{i}", lp["ln2"])
    conv("enc_p.proj", tree["proj"])

    dp = tree["dp"]
    conv("dp.pre", dp["pre"])
    dds("dp.convs", dp["convs"])
    conv("dp.proj", dp["proj"])
    sd["dp.flows.0.m"] = np.asarray(dp["ea"]["m"])[:, None]
    sd["dp.flows.0.logs"] = np.asarray(dp["ea"]["logs"])[:, None]
    for i, cf in enumerate(dp["cf"]):
        f = f"dp.flows.{2 * i + 1}"
        conv(f"{f}.pre", cf["pre"])
        dds(f"{f}.convs", cf["convs"])
        conv(f"{f}.proj", cf["proj"])
    if "cond" in dp:
        conv("dp.cond", dp["cond"])

    for i, layer in enumerate(tree["flow"]):
        f = f"flow.flows.{2 * i}"
        conv(f"{f}.pre", layer["pre"])
        for j, p in enumerate(layer["in"]):
            conv(f"{f}.enc.in_layers.{j}", p)
        for j, p in enumerate(layer["rs"]):
            conv(f"{f}.enc.res_skip_layers.{j}", p)
        conv(f"{f}.post", layer["post"])
        if "cond" in layer:
            conv(f"{f}.enc.cond_layer", layer["cond"])

    dec, nk = tree["dec"], len(cfg.resblock_kernels)
    conv("dec.conv_pre", dec["pre"])
    for i, p in enumerate(dec["ups"]):
        conv_t(f"dec.ups.{i}", p)
        for j, blk in enumerate(dec["res"][i]):
            for d in range(len(cfg.resblock_dilations[j])):
                conv(f"dec.resblocks.{i * nk + j}.convs1.{d}", blk[f"c1_{d}"])
                conv(f"dec.resblocks.{i * nk + j}.convs2.{d}", blk[f"c2_{d}"])
    conv("dec.conv_post", dec["post"])
    if "cond" in dec:
        conv("dec.cond", dec["cond"])
    if "emb_g" in tree:
        sd["emb_g.weight"] = tree["emb_g"]
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def piper_params_from_jax(tree: dict, cfg: PiperConfig, device=None) -> PiperModel:
    """The JAX package's Piper parameter tree (numpy arrays) and its config
    -> a ``PiperModel`` on ``device`` holding the same weights."""
    return _load(_state_dict_from_jax_tree(tree, cfg), cfg, device)
