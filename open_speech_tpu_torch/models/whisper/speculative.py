"""Speculative greedy decoding: a draft model proposes, the target verifies.

Counterpart of ``open_speech_tpu/models/whisper/speculative.py``. A small
draft model proposes ``gamma`` tokens one step at a time; the target
scores ``[last_emitted, d_1 .. d_gamma]`` in ONE teacher-forced pass and
accepts the longest prefix that matches its own rule-constrained argmax,
plus one corrected (or bonus) token. Emitted tokens are those of the
target's ``greedy_decode`` under the same ``DecodeOptions``: the draft only
changes how many tokens a verify pass confirms, never which.

Token e_i is the model input at position P+i when predicting e_{i+1}; each
verify chunk feeds positions ``P-1+n .. P-1+n+gamma`` and overwrites the
stale K/V rows of rejected proposals before any query reads them (queries
see columns ``<= pos + row``).

The JAX version runs the whole loop as one ``lax.while_loop`` on the
device. Here the loop is on the host over device tensors: the draft steps,
the verify pass, the rule scans and the acceptance test are queued on the
device, and each round reads back one packed tensor (the accepted count
sets the next round's positions): one host sync per round.
"""

from __future__ import annotations

import numpy as np
import torch

from open_speech_tpu_torch.models.whisper.decode import (
    NEG_INF,
    DecodeOptions,
    DecodeResult,
    _apply_rules,
    _blank_tokens,
    _no_speech_prob,
    _prefill,
    _setup,
)
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


def _chunk_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """Self-attention for a G-token chunk over a padded cache.

    q: [B, H, G, D]; caches: [B, H, T_max, D]; ``pos``: the cache position
    of the chunk's first token. Query row i attends cache columns
    ``<= pos + i``: causal within the chunk, the whole history before it.
    """
    d = q.shape[-1]
    t_k = k_cache.shape[2]
    g = q.shape[2]
    logits = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * (d**-0.5)
    cols = torch.arange(t_k, device=q.device)[None, :]
    rows = torch.arange(g, device=q.device)[:, None]
    logits = torch.where((cols <= pos + rows)[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v_cache.float()).to(q.dtype)


@torch.no_grad()
def _verify_chunk(
    model: Whisper, tokens: torch.Tensor, pos: int, self_kv: torch.Tensor,
    cross_kv, cfg: WhisperConfig, pos_emb: torch.Tensor,
):
    """Teacher-forced target pass over ``tokens`` [B, G] at cache position
    ``pos``. Writes the chunk's K/V into ``self_kv`` in place (over any stale
    rows of rejected proposals) and returns the logits of every slot.

    ``pos_emb`` is the decoder position table padded by zero rows, so that
    a last chunk whose tail crosses n_text_ctx reads the live slots' rows
    unshifted; only dead slots read the zeros.

    Returns (logits [B, G, V] float32, self_kv).
    """
    dec = model.decoder
    n_head = cfg.n_text_head
    b, g = tokens.shape
    x = embed_tokens(dec, tokens) + pos_emb[pos : pos + g]
    for i, blk in enumerate(dec.blocks):
        hn = layer_norm(x, blk.ln1)
        q = _split_heads(linear(hn, blk.attn.q), n_head)
        self_kv[i, 0, :, :, pos : pos + g] = _split_heads(linear(hn, blk.attn.k), n_head)
        self_kv[i, 1, :, :, pos : pos + g] = _split_heads(linear(hn, blk.attn.v), n_head)
        attn = _chunk_attention(q, self_kv[i, 0], self_kv[i, 1], pos)
        x = x + linear(_merge_heads(attn), blk.attn.o)
        hc = layer_norm(x, blk.ln_cross)
        qc = _split_heads(linear(hc, blk.cross.q), n_head)
        ckv = cross_layer(cross_kv, i)
        x = x + linear(_merge_heads(cross_attend(qc, ckv, b)), blk.cross.o)
        x = x + mlp(layer_norm(x, blk.ln_mlp), blk)
    return output_logits(layer_norm(x, dec.ln), dec), self_kv


@torch.no_grad()
def speculative_greedy_decode(
    t_model: Whisper,
    t_cfg: WhisperConfig,
    d_model: Whisper,
    d_cfg: WhisperConfig,
    special: SpecialTokens,
    t_enc_out: torch.Tensor,
    d_enc_out: torch.Tensor,
    prompt: np.ndarray,  # [1, P] int32
    opts: DecodeOptions = DecodeOptions(),
    gamma: int = 4,
) -> DecodeResult:
    """Greedy decode via draft-and-verify; the tokens of ``greedy_decode``.

    Single-stream only (B == 1): rows accept different prefix lengths, so
    their cache positions would diverge. Temperature 0 only (the sampled
    fallback steps run the plain sampled decode), and the draft must share
    the target's vocabulary. The result carries ``spec_rounds`` (verify
    passes) and ``spec_accepted`` (draft tokens accepted).
    """
    b, p_len = prompt.shape
    if b != 1:
        raise ValueError("speculative decode is single-stream (B == 1)")
    if opts.temperature > 0:
        raise ValueError("speculative decode requires temperature == 0")
    if t_cfg.n_vocab != d_cfg.n_vocab:
        raise ValueError("draft/target vocab mismatch")
    dev, max_new, suppress, max_init_tok, prompt_t, _ = _setup(
        t_cfg, special, prompt, opts, t_enc_out, None
    )
    g1 = gamma + 1
    eot = special.eot
    rules = dict(
        suppress=suppress, special=special, timestamps=opts.timestamps,
        max_initial_ts_tok=max_init_tok, blank_tokens=_blank_tokens(special, opts),
    )

    t_cross = precompute_cross_kv(t_model, t_enc_out, t_cfg)
    d_cross = precompute_cross_kv(d_model, d_enc_out, d_cfg)
    # sized WITHOUT the n_text_ctx clamp of _cache_len: the last chunk's
    # tail may run gamma slots past the budget (dead slots, but their K/V
    # writes must land in the cache)
    cache = -(-(p_len + max_new + g1 + 1) // 64) * 64
    t_kv = init_self_kv(t_cfg, b, cache, t_enc_out.dtype, dev)
    d_kv = init_self_kv(d_cfg, b, cache, d_enc_out.dtype, dev)
    pe = t_model.decoder.pos_emb
    pad = max(0, p_len + max_new + g1 - pe.shape[0])
    pe_pad = torch.cat([pe, pe.new_zeros((pad, pe.shape[1]))])
    t_prefill_logits, t_kv = _prefill(t_model, prompt_t, t_cross, t_kv, t_cfg)
    _prefill(d_model, prompt_t, d_cross, d_kv, d_cfg)
    no_speech_prob = _no_speech_prob(t_prefill_logits, prompt_t, special)

    buf = torch.full((b, max_new + g1), eot, dtype=torch.long, device=dev)
    last = prompt_t[:, -1]
    penult = prompt_t[:, -2] if p_len > 1 else prompt_t[:, -1]
    max_ts = torch.full((b,), special.timestamp_begin - 1, dtype=torch.long, device=dev)
    sum_lp = torch.zeros(b, dtype=torch.float32, device=dev)
    lengths = torch.zeros(b, dtype=torch.long, device=dev)
    slot = torch.arange(g1, device=dev)
    n = rounds = accepted = 0
    finished = False
    while n < max_new and not finished:
        pos0 = p_len - 1 + n  # cache position of this chunk's first input

        # ── the draft proposes gamma tokens, one step at a time ─────────
        tok_in, dl, dp, dmt = last, last, penult, max_ts
        d_toks = []
        for j in range(gamma):
            logits, d_kv = decode_step(d_model, tok_in[:, None], pos0 + j, d_kv, d_cross, d_cfg)
            tok = _apply_rules(logits, step_idx=n + j, last=dl, penult=dp, max_ts=dmt,
                               **rules).argmax(dim=-1)
            dmt = torch.where(tok >= special.timestamp_begin, torch.maximum(dmt, tok), dmt)
            tok_in, dl, dp = tok, tok, dl
            d_toks.append(tok)
        d_toks = torch.stack(d_toks)  # [gamma, B]

        # ── the target verifies every slot in one pass ─────────────────
        chunk = torch.cat([last[:, None], d_toks.T], dim=1)  # [B, G+1]
        t_logits, t_kv = _verify_chunk(t_model, chunk, pos0, t_kv, t_cross, t_cfg, pe_pad)
        tl, tp, tmt = last, penult, max_ts
        t_toks, t_lps, s_last, s_penult, s_max_ts = [], [], [], [], []
        for j in range(g1):
            ruled = _apply_rules(t_logits[:, j], step_idx=n + j, last=tl, penult=tp,
                                 max_ts=tmt, **rules)
            tok = ruled.argmax(dim=-1)
            t_lps.append(torch.log_softmax(ruled, dim=-1).gather(1, tok[:, None])[:, 0])
            tmt = torch.where(tok >= special.timestamp_begin, torch.maximum(tmt, tok), tmt)
            tl, tp = tok, tl
            t_toks.append(tok)
            s_last.append(tl)
            s_penult.append(tp)
            s_max_ts.append(tmt)
        t_toks = torch.stack(t_toks)  # [G+1, B]

        # longest matching prefix (slot j verifies proposal j), then one
        # target token; an eot inside cuts emission at the eot, inclusive
        match = torch.cat([(t_toks[:gamma] == d_toks)[:, 0].int(), slot.new_zeros(1).int()])
        a_t = match.argmin()  # first mismatch, gamma if none
        emit_tok = t_toks[:, 0]  # [G+1] (B == 1)
        is_eot = emit_tok == eot
        first_eot = torch.cat([is_eot, is_eot.new_ones(1)]).int().argmax()
        eff_t = torch.minimum(a_t + 1, first_eot + 1)
        fin_t = (is_eot & (slot < eff_t)).any()
        live = (slot < eff_t) & (n + slot < max_new)
        buf[:, n : n + g1] = torch.where(live, emit_tok, eot)[None]
        sum_lp = sum_lp + torch.where(live, torch.stack(t_lps)[:, 0], 0.0).sum()
        lengths = lengths + (live & ~is_eot).sum()
        a, eff, fin = torch.stack([a_t, eff_t, fin_t.long()]).tolist()  # the round's one sync

        # the rule state after consuming slot a
        last, penult, max_ts = s_last[a], s_penult[a], s_max_ts[a]
        finished = bool(fin)
        n += eff
        rounds += 1
        accepted += a

    tokens = buf[:, :max_new].int().cpu().numpy()
    lengths = lengths.int().cpu().numpy()
    avg_lp = sum_lp.cpu().numpy() / np.maximum(lengths + 1, 1)
    return DecodeResult(
        tokens=tokens,
        lengths=lengths,
        avg_logprob=avg_lp,
        no_speech_prob=no_speech_prob.cpu().numpy(),
        temperature=0.0,
        spec_rounds=rounds,
        spec_accepted=accepted,
    )
