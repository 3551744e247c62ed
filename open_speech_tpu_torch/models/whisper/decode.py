"""Whisper decoding: greedy, sampled and beam search, timestamp rules, LID.

Counterpart of ``open_speech_tpu/models/whisper/decode.py``: token
suppression, blank suppression at sample begin, paired-timestamp
constraints, monotonic timestamps, the timestamp-vs-text probability rule,
<|nospeech|> probability capture, and average-logprob statistics for
temperature fallback.

The JAX version runs each decode as one jitted ``lax.while_loop``; here the
loop is a Python loop over ``decode_step`` that stops when every row has
emitted <|endoftext|> or the budget is spent (one host sync per step). The
self-KV cache is written in place.
"""

from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from open_speech_tpu_torch.models.whisper.model import (
    Whisper,
    WhisperConfig,
    _merge_heads,
    _split_heads,
    cross_attend,
    cross_layer,
    decode_step,
    embed_tokens,
    init_self_kv,
    layer_norm,
    linear,
    mlp,
    output_logits,
    precompute_cross_kv,
)
from open_speech_tpu_torch.models.whisper.tokenizer import SpecialTokens
from open_speech_tpu_torch.ops.attention import flash_attention

NEG_INF = -1e30


@dataclass(frozen=True)
class DecodeOptions:
    task: str = "transcribe"
    language: str | None = None
    temperature: float = 0.0
    beam_size: int = 5
    max_new_tokens: int = 224
    timestamps: bool = True
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    suppress_tokens: tuple[int, ...] = ()
    length_penalty: float = 1.0


@dataclass
class DecodeResult:
    tokens: np.ndarray  # [B, T] int32, right-padded with eot
    lengths: np.ndarray  # [B] sampled token count (pre-eot)
    avg_logprob: np.ndarray  # [B]
    no_speech_prob: np.ndarray  # [B]
    temperature: float = 0.0
    spec_rounds: int | None = None  # speculative decode: verify passes
    spec_accepted: int | None = None  # speculative decode: draft tokens accepted


def compression_ratio(text: str) -> float:
    """zlib ratio used by whisper's fallback heuristic (higher = loopier)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _suppress_mask(
    n_vocab: int, special: SpecialTokens, opts: DecodeOptions
) -> np.ndarray:
    """Static additive mask [V]: -inf on always-suppressed tokens."""
    mask = np.zeros((n_vocab,), np.float32)
    always = [
        special.sot,
        special.startofprev,
        special.startoflm,
        special.no_speech,
        special.translate,
        special.transcribe,
    ]
    always += [special.lang_begin + i for i in range(special.n_langs)]
    if opts.timestamps:
        always.append(special.no_timestamps)
    else:
        mask[special.timestamp_begin :] = NEG_INF
    for t in list(opts.suppress_tokens) + always:
        if 0 <= t < n_vocab:
            mask[t] = NEG_INF
    return mask


def _blank_tokens(special: SpecialTokens, opts: DecodeOptions) -> tuple[int, ...]:
    if not opts.suppress_blank:
        return ()
    # " " encodes as a single token in both real BPE (220) and byte fallback
    return (32 if special.eot <= 50000 else 220, special.eot)


def _apply_rules(
    logits: torch.Tensor,  # [B, V] f32
    *,
    step_idx,  # sampled-token count so far (0 = first sampled token): an int, or [B]
    last: torch.Tensor,  # [B] previous sampled token (or sot-seq tail at step 0)
    penult: torch.Tensor,  # [B]
    max_ts: torch.Tensor,  # [B] highest timestamp token sampled so far
    suppress: torch.Tensor,  # [V] additive mask
    special: SpecialTokens,
    timestamps: bool,
    max_initial_ts_tok: int,
    blank_tokens: tuple[int, ...],
) -> torch.Tensor:
    """Whisper's logit rules. ``step_idx`` is a Python int when every row is
    at the same step (greedy and beam lockstep), or a [B] tensor on the
    logits' device when each row is at its own step (the continuous
    batcher's slots); the begin rules then apply per row through a mask,
    with no host sync. Every mask here is built on the device: no index
    list is copied from the host."""
    b, v = logits.shape
    dev = logits.device
    cols = torch.arange(v, device=dev)[None, :]
    logits = logits + suppress[None, :]
    if isinstance(step_idx, torch.Tensor):
        sampled = step_idx.expand(b)
        begin = (sampled == 0)[:, None]  # [B, 1]
    else:
        sampled = int(step_idx)
        begin = sampled == 0  # the same for every row: skip when False

    # sample begin: suppress blank/eot regardless of timestamp mode
    if begin is not False and blank_tokens:
        blank = functools.reduce(torch.logical_or, (cols == t for t in blank_tokens))
        logits = torch.where(begin & blank, NEG_INF, logits)
    if not timestamps:
        return logits

    ts_begin = special.timestamp_begin
    is_ts_col = cols >= ts_begin
    is_text_col = cols < special.eot

    # openai semantics over *sampled* tokens only: with fewer than one/two
    # sampled tokens, last/penultimate count as not-a-timestamp/timestamp
    last_ts = (last >= ts_begin) & (sampled >= 1)
    penult_ts = (penult >= ts_begin) | (sampled < 2)
    # paired timestamps: after a closing ts, no ts; after an opening ts, no text
    mask_ts = (last_ts & penult_ts)[:, None] & is_ts_col
    mask_text = (last_ts & ~penult_ts)[:, None] & is_text_col
    # monotonicity: forbid timestamps below the running max
    ts_floor = torch.where(last_ts & ~penult_ts, max_ts, max_ts + 1)
    mask_mono = is_ts_col & (cols < ts_floor[:, None])
    logits = torch.where(mask_ts | mask_text | mask_mono, NEG_INF, logits)

    if begin is not False:
        # only timestamps may open a sequence, up to the max initial one
        logits = torch.where(
            begin & (~is_ts_col | (cols > max_initial_ts_tok)), NEG_INF, logits
        )

    # prob rule: if the total timestamp mass exceeds the best non-timestamp
    # token (eot included), force a timestamp
    logp = torch.log_softmax(logits, dim=-1)
    ts_mass = torch.logsumexp(torch.where(is_ts_col, logp, NEG_INF), dim=-1)
    max_text = torch.where(~is_ts_col, logp, NEG_INF).amax(dim=-1)
    force_ts = (ts_mass > max_text)[:, None]
    return torch.where(force_ts & ~is_ts_col, NEG_INF, logits)


# ──────────────────────────────────────────────────────────────────────
# Prefill: run the prompt through the cache
# ──────────────────────────────────────────────────────────────────────


@torch.no_grad()
def _prefill(
    model: Whisper, prompt: torch.Tensor, cross_kv,
    self_kv: torch.Tensor, cfg: WhisperConfig, enc_len=None,
):
    """Prefill prompt tokens [B, P] in one teacher-forced pass with causal
    flash attention, writing positions [0, P) of ``self_kv`` in place.
    ``cross_kv`` is either form (dense, or the int8 packs).

    Returns (all_logits [P, B, V], self_kv).
    """
    dec = model.decoder
    dh = cfg.text_head_dim
    b, p = prompt.shape
    x = embed_tokens(dec, prompt) + dec.pos_emb[:p]
    for i, blk in enumerate(dec.blocks):
        hn = layer_norm(x, blk.ln1)
        q = _split_heads(linear(hn, blk.attn.q), dh)
        k = _split_heads(linear(hn, blk.attn.k), dh)
        v = _split_heads(linear(hn, blk.attn.v), dh)
        attn = flash_attention(q, k, v, causal=True)
        x = x + linear(_merge_heads(attn), blk.attn.o)
        hc = layer_norm(x, blk.ln_cross)
        qc = _split_heads(linear(hc, blk.cross.q), dh)
        ckv = cross_layer(cross_kv, i)
        x = x + linear(_merge_heads(cross_attend(qc, ckv, b, enc_len)), blk.cross.o)
        x = x + mlp(layer_norm(x, blk.ln_mlp), blk)
        self_kv[i, 0, :, :, :p] = k
        self_kv[i, 1, :, :, :p] = v
    all_logits = output_logits(layer_norm(x, dec.ln), dec).transpose(0, 1)
    return all_logits, self_kv


def _cache_len(cfg: WhisperConfig, p_len: int, max_new: int) -> int:
    """Self-KV length bucketed to 64 and sized to the token budget."""
    need = p_len + max_new + 1
    return min(cfg.n_text_ctx, -(-need // 64) * 64)


def _no_speech_prob(prefill_logits, prompt, special: SpecialTokens) -> torch.Tensor:
    """P(<|nospeech|>) from the logits that follow the <|sot|> input."""
    b = prompt.shape[0]
    sot_pos = (prompt == special.sot).float().argmax(dim=1)  # [B]
    sot_logits = prefill_logits[sot_pos, torch.arange(b, device=prompt.device)]
    return torch.softmax(sot_logits, dim=-1)[:, special.no_speech]


def _setup(cfg, special, prompt, opts, enc_out, enc_len):
    dev = enc_out.device
    b, p_len = prompt.shape
    max_new = min(opts.max_new_tokens, cfg.n_text_ctx - p_len - 1)
    suppress = torch.from_numpy(_suppress_mask(cfg.n_vocab, special, opts)).to(dev)
    max_init_tok = special.timestamp_begin + int(round(opts.max_initial_timestamp / 0.02))
    prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
    enc_len_t = (
        None if enc_len is None
        else torch.as_tensor(np.asarray(enc_len), dtype=torch.long, device=dev)
    )
    return dev, max_new, suppress, max_init_tok, prompt_t, enc_len_t


# ──────────────────────────────────────────────────────────────────────
# Greedy / sampling decode
# ──────────────────────────────────────────────────────────────────────


@torch.no_grad()
def greedy_decode(
    model: Whisper,
    cfg: WhisperConfig,
    special: SpecialTokens,
    enc_out: torch.Tensor,
    prompt: np.ndarray,  # [B, P] int32 (sot sequence, maybe with prefix)
    opts: DecodeOptions = DecodeOptions(),
    generator: torch.Generator | None = None,
    enc_len: np.ndarray | None = None,  # [B] real encoder positions (mask)
) -> DecodeResult:
    """Greedy (temperature=0) or sampled decode with whisper logit rules.

    Sampling draws Gumbel noise from ``generator`` (on enc_out's device;
    seeded 0 when not given).
    """
    b, p_len = prompt.shape
    dev, max_new, suppress, max_init_tok, prompt_t, enc_len_t = _setup(
        cfg, special, prompt, opts, enc_out, enc_len
    )
    blank = _blank_tokens(special, opts)
    sampled = opts.temperature > 0
    if sampled and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    cross_kv = precompute_cross_kv(model, enc_out, cfg)
    kv = init_self_kv(cfg, b, _cache_len(cfg, p_len, max_new), enc_out.dtype, dev,
                      model.text_heads)
    prefill_logits, kv = _prefill(model, prompt_t, cross_kv, kv, cfg, enc_len_t)
    no_speech_prob = _no_speech_prob(prefill_logits, prompt_t, special)

    buf = torch.full((b, max_new), special.eot, dtype=torch.long, device=dev)
    cur_logits = prefill_logits[-1]
    last = prompt_t[:, -1]
    penult = prompt_t[:, -2] if p_len > 1 else prompt_t[:, -1]
    max_ts = torch.full((b,), special.timestamp_begin - 1, dtype=torch.long, device=dev)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)
    lengths = torch.zeros(b, dtype=torch.long, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for step in range(max_new):
        logits = _apply_rules(
            cur_logits, step_idx=step, last=last, penult=penult, max_ts=max_ts,
            suppress=suppress, special=special, timestamps=opts.timestamps,
            max_initial_ts_tok=max_init_tok, blank_tokens=blank,
        )
        logp = torch.log_softmax(logits, dim=-1)
        if sampled:
            # Gumbel-max draw from softmax(logits / T)
            u = torch.rand(logits.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
            tok = (logits / max(opts.temperature, 1e-3) + gumbel).argmax(dim=-1)
        else:
            tok = logits.argmax(dim=-1)
        tok = torch.where(finished, special.eot, tok)
        tok_lp = logp.gather(1, tok[:, None])[:, 0]
        sum_lp = sum_lp + torch.where(finished, 0.0, tok_lp)
        now_eot = tok == special.eot
        lengths = lengths + (~(finished | now_eot)).long()
        buf[:, step] = tok
        is_ts = tok >= special.timestamp_begin
        max_ts = torch.where(is_ts & ~finished, torch.maximum(max_ts, tok), max_ts)
        finished = finished | now_eot
        penult, last = last, tok
        # the logits after the last step are never read: stop before them
        if step + 1 == max_new or bool(finished.all()):
            break
        cur_logits, kv = decode_step(
            model, tok[:, None], p_len + step, kv, cross_kv, cfg, enc_len_t
        )

    tokens = buf.int().cpu().numpy()
    lengths = lengths.int().cpu().numpy()
    sum_lp = sum_lp.cpu().numpy()
    avg_lp = sum_lp / np.maximum(lengths + 1, 1)  # +1 counts eot
    return DecodeResult(
        tokens=tokens,
        lengths=lengths,
        avg_logprob=avg_lp,
        no_speech_prob=no_speech_prob.cpu().numpy(),
        temperature=opts.temperature,
    )


# ──────────────────────────────────────────────────────────────────────
# Beam search
# ──────────────────────────────────────────────────────────────────────


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, lowest index first among ties (the
    order of ``lax.top_k``; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_decode(
    model: Whisper,
    cfg: WhisperConfig,
    special: SpecialTokens,
    enc_out: torch.Tensor,
    prompt: np.ndarray,  # [B, P]
    opts: DecodeOptions = DecodeOptions(),
    enc_len: np.ndarray | None = None,  # [B] real encoder positions (mask)
    ancestry: bool = True,
) -> DecodeResult:
    """Beam search (default beam 5).

    Beams ride the batch axis: decode_step sees [B*K] rows and each step
    top-k's the [B, K*V] score table. The prompt is prefilled once per
    batch row and the self-KV fanned out to the beams; the cross-KV is never
    replicated (beams fold into the cross-attention query axis).
    ``ancestry=True`` keeps the self-KV cache un-permuted and tracks beam
    lineage in a [B*K, T] row_map that attention resolves at read time;
    ``ancestry=False`` gathers the cache to the surviving beams every step
    (the oracle for the first form).
    """
    b, p_len = prompt.shape
    k = opts.beam_size
    v = cfg.n_vocab
    dev, max_new, suppress, max_init_tok, prompt_t, enc_len_t = _setup(
        cfg, special, prompt, opts, enc_out, enc_len
    )
    blank = _blank_tokens(special, opts)

    cross_kv = precompute_cross_kv(model, enc_out, cfg)
    t_cache = _cache_len(cfg, p_len, max_new)
    kv_b = init_self_kv(cfg, b, t_cache, enc_out.dtype, dev, model.text_heads)
    prefill_logits, kv_b = _prefill(model, prompt_t, cross_kv, kv_b, cfg, enc_len_t)
    kv = kv_b.repeat_interleave(k, dim=2)
    del kv_b
    rows = torch.arange(b * k, device=dev)
    # ancestry init: every beam's history (the shared prompt) lives in its
    # own physical row
    row_map = rows[:, None].repeat(1, t_cache)
    no_speech_prob = _no_speech_prob(prefill_logits, prompt_t, special)

    buf = torch.full((b * k, max_new), special.eot, dtype=torch.long, device=dev)
    # first beam active, others start at -inf so step 0 fans out from beam 0
    beam_lp = torch.tensor([0.0] + [NEG_INF] * (k - 1), device=dev).repeat(b)
    eot_only = torch.full((v,), NEG_INF, device=dev)
    eot_only[special.eot] = 0.0
    cur_logits = prefill_logits[-1].repeat_interleave(k, dim=0)
    last = prompt_t[:, -1].repeat_interleave(k)
    penult = (prompt_t[:, -2] if p_len > 1 else prompt_t[:, -1]).repeat_interleave(k)
    max_ts = torch.full((b * k,), special.timestamp_begin - 1, dtype=torch.long, device=dev)
    lengths = torch.zeros(b * k, dtype=torch.long, device=dev)
    finished = torch.zeros(b * k, dtype=torch.bool, device=dev)
    batch_base = torch.arange(b, device=dev)[:, None] * k
    for step in range(max_new):
        logits = _apply_rules(
            cur_logits, step_idx=step, last=last, penult=penult, max_ts=max_ts,
            suppress=suppress, special=special, timestamps=opts.timestamps,
            max_initial_ts_tok=max_init_tok, blank_tokens=blank,
        )  # [B*K, V]
        logp = torch.log_softmax(logits, dim=-1)
        # finished beams may only emit eot at no cost
        logp = torch.where(finished[:, None], eot_only[None, :], logp)
        total = (beam_lp[:, None] + logp).reshape(b, k * v)
        top_lp, top_idx = _top_k(total, k)  # [B, K]
        flat_src = (batch_base + top_idx // v).reshape(-1)  # [B*K]
        tok = (top_idx % v).reshape(-1)
        buf = buf[flat_src]
        last_g = last[flat_src]
        max_ts = max_ts[flat_src]
        lengths = lengths[flat_src]
        finished = finished[flat_src]
        if ancestry:
            # inherit the chosen ancestor's lineage, then claim this step's
            # position: decode_step writes beam j's new K/V into row j
            row_map = row_map[flat_src]
            row_map[:, p_len + step] = rows
        else:
            kv = kv[:, :, flat_src]
        buf[:, step] = tok
        is_eot = tok == special.eot
        lengths = lengths + (~(finished | is_eot)).long()
        is_ts = tok >= special.timestamp_begin
        max_ts = torch.where(is_ts & ~finished, torch.maximum(max_ts, tok), max_ts)
        finished = finished | is_eot
        beam_lp = top_lp.reshape(-1)
        penult, last = last_g, tok
        if step + 1 == max_new or bool(finished.all()):
            break
        cur_logits, kv = decode_step(
            model, tok[:, None], p_len + step, kv, cross_kv, cfg, enc_len_t,
            beam=k, row_map=row_map if ancestry else None,
        )

    # pick the best beam per batch row by length-normalized score
    norm = beam_lp.reshape(b, k) / torch.clamp(
        lengths.reshape(b, k).float() + 1, min=1.0
    ) ** opts.length_penalty
    sel = torch.arange(b, device=dev) * k + norm.argmax(dim=1)
    lengths = lengths[sel].int().cpu().numpy()
    scores = beam_lp[sel].cpu().numpy()
    return DecodeResult(
        tokens=buf[sel].int().cpu().numpy(),
        lengths=lengths,
        avg_logprob=scores / np.maximum(lengths + 1, 1),
        no_speech_prob=no_speech_prob.cpu().numpy(),
        temperature=0.0,
    )


# ──────────────────────────────────────────────────────────────────────
# Language identification
# ──────────────────────────────────────────────────────────────────────


@torch.no_grad()
def detect_language(
    model: Whisper, cfg: WhisperConfig, special: SpecialTokens, enc_out: torch.Tensor
) -> tuple[list[str], np.ndarray]:
    """One prefill of <|sot|>; softmax over the language tokens.

    Returns (codes [B], probs [B]).
    """
    b = enc_out.shape[0]
    cross_kv = precompute_cross_kv(model, enc_out, cfg)
    self_kv = init_self_kv(cfg, b, 1, enc_out.dtype, enc_out.device, model.text_heads)
    prompt = torch.full((b, 1), special.sot, dtype=torch.long, device=enc_out.device)
    logits, _ = _prefill(model, prompt, cross_kv, self_kv, cfg)
    lang = logits[-1][:, special.lang_begin : special.lang_begin + special.n_langs]
    probs = torch.softmax(lang, dim=-1).cpu().numpy()
    idx = probs.argmax(axis=-1)
    codes = [special.lang_code(special.lang_begin + int(i)) for i in idx]
    return codes, probs.max(axis=-1)
