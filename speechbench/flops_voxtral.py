"""The work of Voxtral's calls that the benchmark reads: operations from
shapes (two per multiply-add) and bytes as each input read once and each
output written once, whatever a kernel reads again. The configuration is
the published ``config.json``'s keys (``audio_config``, ``text_config``).
"""

from __future__ import annotations

FRAMES_PER_POSITION = 4


def _text(cfg: dict) -> tuple:
    t = cfg["text_config"]
    return (t["hidden_size"], t["num_attention_heads"], t["num_key_value_heads"], t["head_dim"],
            t["intermediate_size"], t["num_hidden_layers"], t["vocab_size"])


def layer_params(cfg: dict) -> int:
    """Weights of one language-model layer: q, k, v, o, gate, up, down and
    the two RMSNorm gains."""
    d, h, h_kv, hd, ffn, _, _ = _text(cfg)
    return d * (h + 2 * h_kv) * hd + h * hd * d + 3 * d * ffn + 2 * d


def encoder_flops(cfg: dict) -> float:
    """One 30 s window through the audio tower and the adapter."""
    a = cfg["audio_config"]
    d, t, ffn = a["hidden_size"], a["max_source_positions"], a["intermediate_size"]
    conv = 2 * a["num_mel_bins"] * d * 3 * (2 * t) + 2 * d * d * 3 * t
    layer = 4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * ffn
    positions = t // FRAMES_PER_POSITION
    adapter = 2 * positions * (FRAMES_PER_POSITION * d + cfg["text_config"]["hidden_size"]) * (
        cfg["text_config"]["hidden_size"])
    return conv + a["num_hidden_layers"] * layer + adapter


def prefill_flops(cfg: dict, positions: int) -> float:
    """One window's prompt of ``positions`` through every layer, causal
    attention over the visible pairs (no head: the prefill makes no logits)."""
    d, h, h_kv, hd, ffn, layers, _ = _text(cfg)
    visible = positions * (positions + 1) // 2
    linears = 2 * positions * (layer_params(cfg) - 2 * d)
    return layers * (linears + 2 * 2 * h * hd * visible)


def position_flops(cfg: dict, length: float) -> float:
    """One decoded position attending to ``length`` positions (itself
    included), the head's logits included."""
    d, h, h_kv, hd, ffn, layers, vocab = _text(cfg)
    return layers * (2 * (layer_params(cfg) - 2 * d) + 2 * 2 * h * hd * length) + 2 * d * vocab


def step_weight_bytes(cfg: dict, itemsize: int = 2) -> int:
    """The weights a decode step reads: every layer, the final norm and the
    head (the embedding's rows of the step's tokens are left out)."""
    d, _, _, _, _, layers, vocab = _text(cfg)
    return itemsize * (layers * layer_params(cfg) + d + d * vocab)


def kv_bytes_per_position(cfg: dict, itemsize: int = 2) -> int:
    """K and V of one position over every layer."""
    _, _, h_kv, hd, _, layers, _ = _text(cfg)
    return layers * 2 * h_kv * hd * itemsize


def k1_gqa_bound_s(b: int, h: int, h_kv: int, t_q: int, t_k: int, d: int, peaks: dict,
                   causal: bool = True, itemsize: int = 2) -> float:
    """Least time of one grouped K1 call: the visible (q, k) pairs at the
    bf16 peak against q and the output of ``h`` heads and K and V of
    ``h_kv`` heads, read once."""
    if causal:
        visible = sum(min(max(i + t_k - t_q + 1, 0), t_k) for i in range(t_q))
    else:
        visible = t_q * t_k
    flops = 4 * b * h * visible * d
    nbytes = (2 * b * h * t_q + 2 * b * h_kv * t_k) * d * itemsize
    return max(flops / peaks["bf16_flops"], nbytes / peaks["bytes_per_s"])
