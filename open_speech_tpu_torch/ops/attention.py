"""Attention: the Hopper flash kernel and KV-cache decode attention.

Counterpart of ``open_speech_tpu/ops/attention.py``:

  - ``flash_attention``: tiled online-softmax attention, optionally over a
    per-example valid kv prefix (``kv_length``). A CUDA tensor runs the
    hand-written sm_90a kernels (``kernels/csrc/flash_attention.cu``: K1
    without lengths, K2 with them); a CPU tensor runs their plain versions
    ``flash_attention_reference`` and ``flash_attention_varlen_reference``.
    There is no fallback between the two: a CUDA call that cannot launch
    raises. At head dim 128 (a decoder-only language model's causal
    prefill) K1 is ``flash_fwd_gqa_bf16`` (``kernels/csrc/
    flash_attention_gqa.cu``, bf16 only), which also takes grouped KV heads:
    k and v with H / g heads, query head h reading KV head h // g, with no
    repeat of K or V. K2 splits the kv axis over more blocks (``plan_splits``) and
    ``flash_combine`` merges the splits' partials;
    ``flash_attention_partial_reference`` and ``flash_combine_reference``
    are the plain versions of the two passes. float32 runs on the tensor
    cores through split operands: ``split_operands`` writes each float32
    input as three bf16 pieces (plain version ``split_operands_reference``)
    and the kernels take every product as six piece products.
  - ``FlashAttentionFn``: K1 with its gradient, which ``flash_attention``
    takes when a gradient is wanted. On a CUDA tensor the backward is the
    hand-written sm_90a kernels of ``kernels/csrc/flash_attention_bwd.cu``
    (``flash_attention_backward``; no TPU kernel: the JAX package
    differentiates ``mha_reference``); on a CPU tensor both passes are the
    plain versions (``flash_attention_backward_reference``). K2 has no
    backward and raises ``FlashAttentionGradError`` under grad.
  - ``decode_attention``: single-position attention over a padded KV
    cache. A CUDA tensor with bf16 or float32 caches runs the hand-written
    sm_90a kernel (``kernels/csrc/decode_attention.cu``), which reads each
    cache entry once, splitting the key axis (``plan_decode_splits``) where
    too few (batch row, head) pairs fill the card and merging the splits
    through ``flash_combine``; int8 caches with their scales, and a CPU
    tensor, run the plain version.
  - ``beam_select_attention``: beam-search decode attention over
    un-permuted caches, as plain PyTorch on either device.

Layouts are the JAX package's: q/k/v [B, H, T, D].
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30
LOG2E = math.log2(math.e)

# launches of the flash kernels (K1, K2, K2's combine pass and the three
# passes of K1's backward), counted where each is launched; a float32
# launch also counts under the name + "_f32", and the float32 routes'
# operand split under "flash_split_f32"
BWD_STAGES = ("flash_attention_bwd_prep", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
F32_SUFFIX = "_f32"
_ROUTES = ("flash_attention", "flash_attention_varlen", "flash_combine", *BWD_STAGES)
# K1's launches at D = 128 (grouped KV heads or not) also count under this
GQA_ROUTE = "flash_attention_gqa"
# decode attention's launches: every kernel launch under "decode_attention",
# those with a key split (each followed by one combine) also under
# "decode_attention_split", and the calls of a CUDA tensor that the plain
# version served (int8 caches with scales) under "decode_attention_int8"
DECODE_ROUTES = ("decode_attention", "decode_attention_split", "decode_attention_int8")
launches = {**dict.fromkeys(_ROUTES, 0), **dict.fromkeys((n + F32_SUFFIX for n in _ROUTES), 0),
            "flash_split_f32": 0, GQA_ROUTE: 0, **dict.fromkeys(DECODE_ROUTES, 0)}

# the forward kernels' tiles (kBlockN keys and kBlockQ query rows per block
# in bf16, kFBlockN and kFBlockQ in float32, flash_attention.cu) and the
# card's SM count, which K2's split plan fills
BLOCK_N = 128
BLOCK_Q = 64
F32_BLOCK_N = 64
F32_BLOCK_Q = 128
N_SMS = 132


def tiles(dtype: torch.dtype) -> tuple[int, int]:
    """(query rows per block, keys per kv tile) of the forward kernel for
    ``dtype``."""
    return (F32_BLOCK_Q, F32_BLOCK_N) if dtype == torch.float32 else (BLOCK_Q, BLOCK_N)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_length: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. q: [B, H, T, D]; k, v: [B, H / g, T, D] (grouped KV
    heads: query head h reads KV head h // g); kv_length: [B] valid kv
    lengths.

    Computes in float32 (float64 for float64 inputs)."""
    group = q.shape[1] // k.shape[1]
    if group > 1:  # the plain version repeats the KV heads; the kernel reads them in place
        k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    acc = torch.promote_types(q.dtype, torch.float32)
    probs = _probs(q.to(acc), k.to(acc), causal, kv_length, scale)
    out = torch.matmul(probs.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def _probs(q, k, causal, kv_length=None, scale=None) -> torch.Tensor:
    """Softmax probabilities [B, H, Tq, Tk] of q, k (in their dtype), zero
    on the rows with no attendable key (the kernel's semantics)."""
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    t_q, t_k = q.shape[-2], k.shape[-2]
    dev = q.device
    if causal:
        # end-aligned: query row i attends keys <= i + (t_k - t_q)
        qi = torch.arange(t_q, device=dev)[:, None]
        ki = torch.arange(t_k, device=dev)[None, :]
        logits = torch.where(ki <= qi + (t_k - t_q), logits, NEG_INF)
    if kv_length is not None:
        ki = torch.arange(t_k, device=dev)[None, None, None, :]
        logits = torch.where(ki < kv_length[:, None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    any_valid = logits.amax(dim=-1, keepdim=True) > NEG_INF / 2
    return torch.where(any_valid, probs, 0.0)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """K1's plain version: ``mha_reference`` without kv_length."""
    return mha_reference(q, k, v, causal=causal, scale=scale)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    d_out: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's gradient, plain: (dq, dk, dv) of ``flash_attention_reference``
    at the upstream gradient ``d_out``, from the explicit formulas in
    float32 (float64 for float64 inputs), each cast to its input's dtype:

        P = softmax(scale * q k^T) (masked; zero rows stay zero)
        dv = P^T dO,  dP = dO v^T,  delta = rowsum(P * dP)
        dS = P * (dP - delta),  dq = scale * dS k,  dk = scale * dS^T q

    A row with no visible key has P = 0, so it contributes nothing. delta
    is rowsum(dO * O) with O = P v at the working precision, not the
    forward's output: from a bf16 output its rounding would not cancel in
    rowsum(dS) = 0, and dq would carry it times the keys' common component.
    """
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, d_out))
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    p = _probs(qf, kf, causal, scale=scale)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_varlen_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_length: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """K2's plain version: ``mha_reference`` with kv_length [B]."""
    return mha_reference(q, k, v, causal=causal, kv_length=kv_length, scale=scale)


@functools.lru_cache(maxsize=256)
def plan_splits(b: int, h: int, t_q: int, t_k: int, block_q: int = BLOCK_Q,
                block_n: int = BLOCK_N) -> tuple[int, int]:
    """K2's kv split: ``(splits, tiles_per_split)`` from the shape alone
    (the lengths stay on the card), for the kernel's tiles of ``block_q``
    query rows and ``block_n`` keys (``tiles(dtype)``; the defaults are
    bf16's). The fewest splits that give every SM a block, with at least
    two kv tiles per split; each split owns ``tiles_per_split`` whole tiles
    and none is empty."""
    n_tiles = max(1, -(-t_k // block_n))
    blocks = b * h * -(-t_q // block_q)  # query blocks
    splits = max(1, min(-(-N_SMS // blocks), n_tiles // 2))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


def split_ranges(t_k: int, tiles_per_split: int, block_n: int = BLOCK_N) -> list[tuple[int, int]]:
    """The kv ranges [begin, end) of the splits: whole tiles of ``block_n``
    keys, covering [0, Tk)."""
    step = tiles_per_split * block_n
    return [(lo, min(lo + step, t_k)) for lo in range(0, max(t_k, 1), step)]


def flash_attention_partial_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_begin: int,
    kv_end: int,
    *,
    causal: bool = False,
    kv_length: torch.Tensor | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One kv split of K2, plain: the keys in [kv_begin, kv_end) that each
    row sees (causal bound, ``kv_length``), in float32.

    With x_j = (q . k_j) * scale * log2(e): m [B,H,Tq] = max_j x_j (-inf
    where the row sees no key of the range), l = sum_j 2^(x_j - m) and the
    unnormalised o [B,H,Tq,D] = sum_j 2^(x_j - m) v_j. V rows at or past
    the length count as zeros, as the kernel zeroes them.
    """
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    scale = (d**-0.5) if scale is None else scale
    if kv_end <= kv_begin:
        return (q.new_zeros(b, h, t_q, d, dtype=torch.float32),
                q.new_full((b, h, t_q), -math.inf, dtype=torch.float32),
                q.new_zeros(b, h, t_q, dtype=torch.float32))
    keys = torch.arange(kv_begin, kv_end, device=q.device)
    x = torch.matmul(q.float(), k[:, :, kv_begin:kv_end].float().transpose(-1, -2))
    x = x * (scale * LOG2E)
    seen = torch.ones(1, 1, t_q, keys.numel(), dtype=torch.bool, device=q.device)
    vs = v[:, :, kv_begin:kv_end].float()
    if causal:
        rows = torch.arange(t_q, device=q.device)[:, None]
        seen = seen & (keys[None, :] <= rows + (t_k - t_q))
    if kv_length is not None:
        live = keys[None, :] < kv_length.to(q.device)[:, None]  # [B, n]
        seen = seen & live[:, None, None, :]
        vs = torch.where(live[:, None, :, None], vs, 0.0)
    x = torch.where(seen, x, -math.inf)
    m = x.amax(dim=-1)
    p = torch.exp2(x - torch.where(m == -math.inf, 0.0, m)[..., None])
    o = torch.matmul(p.to(v.dtype).float(), vs)
    return o, m, p.sum(dim=-1)


def flash_combine_reference(
    o_part: torch.Tensor, m_part: torch.Tensor, l_part: torch.Tensor
) -> torch.Tensor:
    """K2's combine pass, plain: merges S partials o_part [B,S,H,Tq,D],
    m_part and l_part [B,S,H,Tq] (``flash_attention_partial_reference``'s
    (o, m, l) per split) into [B,H,Tq,D] float32, with log-sum-exp weights
    2^(m_s - max m); zeros where every l_s is 0."""
    mx = m_part.amax(dim=1, keepdim=True)
    w = torch.exp2(m_part - torch.where(mx == -math.inf, 0.0, mx))
    live = (w > 0)[..., None]
    o = torch.where(live, w[..., None] * o_part, 0.0).sum(dim=1)
    l = (w * l_part).sum(dim=1)
    return o * torch.where(l > 0, 1.0 / l, 0.0)[..., None]


def split_operands_reference(x: torch.Tensor) -> torch.Tensor:
    """The split kernel's plain version: float32 ``x`` as its three bf16
    pieces [3, *x.shape], hi = rn(x), mid = rn(x - hi), lo = rn(x - hi -
    mid) (both differences are exact in float32), so that hi + mid + lo
    is x to within 2^-27 |x|."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return torch.stack([hi, mid, (rest - mid.float()).to(torch.bfloat16)])


def split_operands(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The float32 routes' operand split: each float32 [B,H,T,D] tensor (one
    B, H and D, up to four) as its bf16 pieces [3,B,H,T,D], one launch of
    the split kernel (counted as ``flash_split_f32``). A CPU tensor runs
    ``split_operands_reference``."""
    if not tensors[0].is_cuda:
        return [split_operands_reference(t) for t in tensors]
    b, h, _, d = tensors[0].shape
    dev = tensors[0].device
    if not (1 <= len(tensors) <= 4 and d in (32, 64) and all(
            t.dtype == torch.float32 and t.dim() == 4 and t.shape[:2] == (b, h) and t.shape[3] == d
            and t.is_contiguous() and t.device == dev for t in tensors)):
        raise ValueError("split_operands: up to four contiguous float32 [B,H,T,D] tensors of one "
                         "B, H and D (32 or 64) on one device")
    return _split(tensors, None, 0, torch.cuda.current_stream(dev).cuda_stream)


def _split(tensors, kv_length, len_mask: int, stream) -> list[torch.Tensor]:
    """Launches the split kernel on tensors ``split_operands`` (or the
    wrapper that calls this) checked; returns the pieces."""
    b, h, _, d = tensors[0].shape
    sizes = [3 * t.numel() for t in tensors]
    ws = torch.empty(sum(sizes), dtype=torch.bfloat16, device=tensors[0].device)
    out = [piece.view(3, *t.shape) for piece, t in zip(ws.split(sizes), tensors)]
    pad = 4 - len(tensors)
    err = _kernel("os_split_f32")(
        *(t.data_ptr() for t in tensors), *[None] * pad, *(o.data_ptr() for o in out), *[None] * pad,
        len(tensors), *(t.shape[2] for t in tensors), *[0] * pad, b * h, h, d,
        None if kv_length is None else kv_length.data_ptr(), len_mask, stream)
    if err != 0:
        raise RuntimeError(f"flash_split_f32 kernel launch failed: cudaError {err}")
    launches["flash_split_f32"] += 1
    return out


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {  # C entry -> argument types after the four tensor pointers
    "os_flash_attention_fwd": [_I] * 6 + [ctypes.c_float, _I, _P],
    "os_flash_attention_varlen_fwd": [_P] * 3 + [_I] * 8 + [ctypes.c_float, _I, _P],
    "os_flash_combine": [_I] * 6 + [_P],
    "os_flash_attention_bwd": [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _P],
    "os_split_f32": [_P] * 4 + [_I] * 8 + [_P, _I, _P],
    "os_decode_attention": [_P] * 3 + [_L] * 7 + [_I] * 10 + [ctypes.c_float, _P],
    "os_flash_attention_gqa_fwd": [_I] * 5 + [ctypes.c_float, _I, _P],
}
_SOURCE = {"os_flash_attention_bwd": "flash_attention_bwd",  # else flash_attention.cu
           "os_decode_attention": "decode_attention",
           "os_flash_attention_gqa_fwd": "flash_attention_gqa"}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        from open_speech_tpu_torch.kernels import build

        fn = getattr(build.load(_SOURCE.get(entry, "flash_attention")), entry)
        fn.argtypes = [_P] * 4 + _SIGNATURES[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


_hopper: set[int] = set()  # device indices checked


def _check_hopper(device: torch.device) -> None:
    if device.index in _hopper:
        return
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"flash_attention's kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has capability {cap}"
        )
    _hopper.add(device.index)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_length: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-head attention, [B, H, T, D] layout, any Tq.

    At D = 128, k and v may hold H / g heads (grouped KV heads, query head h
    reading KV head h // g); a CUDA call there takes bf16 without
    ``kv_length`` (``flash_fwd_gqa_bf16``). ``kv_length`` [B] (integer):
    keys at or past it are masked, per example.
    A CPU tensor runs the plain version. A CUDA tensor launches the sm_90a
    kernel on the current stream (K1, or K2 with ``kv_length``; K2 runs
    ``plan_splits`` kv splits and, when there is more than one, the combine
    pass), or raises on anything the kernel does not take; ``scale`` must be
    positive. bf16 inputs go to the tensor cores as they are, float32 inputs
    as three bf16 pieces each (``split_operands``, one more launch), every
    product taken as six piece products accumulated in float32: that keeps
    float32's accuracy to about 2^-24 of each product's terms, plus the
    float32 sums' rounding, in another order than the plain version's. Rows
    with zero attendable keys return zeros on both paths.

    When a gradient is wanted (grad mode on and an input that requires it),
    K1 goes through ``FlashAttentionFn`` and K2 raises
    ``FlashAttentionGradError``; otherwise no graph is recorded.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if kv_length is not None:
            raise FlashAttentionGradError(
                "flash_attention: a gradient was asked of K2 (kv_length), which has no "
                "backward; nothing trains through it"
            )
        return FlashAttentionFn.apply(q, k, v, causal, scale)
    if not q.is_cuda:
        if kv_length is not None:
            return flash_attention_varlen_reference(
                q, k, v, kv_length, causal=causal, scale=scale
            )
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
            "the kernel takes float32 or bfloat16, all the same"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}; want q [B,H,Tq,D] and k = v [B,H,Tk,D]"
        )
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if d == GQA_HEAD_DIM:
        return _flash_attention_gqa(q, k, v, causal, kv_length, scale)
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d or d not in (32, 64):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}; "
            "batch, heads and head dim must agree and D must be 32, 64 or 128"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on 16-byte boundaries")
    if kv_length is not None:
        if not (
            isinstance(kv_length, torch.Tensor)
            and kv_length.shape == (b,)
            and kv_length.device == q.device
            and not kv_length.dtype.is_floating_point
            and not kv_length.dtype.is_complex
            and kv_length.dtype != torch.bool
        ):
            raise ValueError(
                "flash_attention: kv_length must be an integer tensor of shape "
                f"[{b}] on {q.device}"
            )
        # int32 on the device; no host sync (the kernel clamps to [0, Tk])
        kv_length = kv_length.to(torch.int32).contiguous()
    _check_hopper(q.device)
    if q.numel() == 0:
        return torch.empty_like(q)
    scale = (d**-0.5) if scale is None else float(scale)
    if not scale > 0:
        raise ValueError(f"flash_attention: the kernel takes a positive scale, not {scale}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    f32 = q.dtype == torch.float32
    shape = (b, h, t_q, t_k, d, _DTYPE_CODES[q.dtype], scale, int(causal), stream)
    if f32:  # the kernels read the pieces; K2 skips the caches' rows past the length
        q, k, v = _split((q, k, v), kv_length, 0 if kv_length is None else 6, stream)
    out = torch.empty(b, h, t_q, d, dtype=torch.float32 if f32 else q.dtype, device=q.device)
    qkv = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if kv_length is None:
        err = _kernel("os_flash_attention_fwd")(*qkv, out.data_ptr(), *shape)
        _launched("flash_attention", err, f32)
        return out
    block_q, block_n = tiles(out.dtype)
    splits, per = plan_splits(b, h, t_q, t_k, block_q, block_n)
    varlen = _kernel("os_flash_attention_varlen_fwd")
    if splits == 1:
        err = varlen(*qkv, out.data_ptr(), kv_length.data_ptr(), None, None, 1, per, *shape)
        _launched("flash_attention_varlen", err, f32)
        return out
    # one f32 workspace [B,S,H,Tq] x (D + 2): the partial O, then m, then l
    rows = b * splits * h * t_q
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    o_part = ws.data_ptr()
    m_part, l_part = o_part + 4 * rows * d, o_part + 4 * rows * (d + 1)
    err = varlen(*qkv, o_part, kv_length.data_ptr(), m_part, l_part, splits, per, *shape)
    _launched("flash_attention_varlen", err, f32)
    err = _combine(o_part, m_part, l_part, out, (b, splits, h, t_q, d), stream)
    _launched("flash_combine", err, f32)
    return out


GQA_HEAD_DIM = 128  # the head dim K1 takes grouped KV heads at


def _flash_attention_gqa(q, k, v, causal: bool, kv_length, scale) -> torch.Tensor:
    """K1 at D = 128 on the card (``flash_attention``'s checks of device,
    dtype and rank done): checks what ``flash_fwd_gqa_bf16`` takes, then
    launches it on the current stream, counted under ``flash_attention``
    and ``flash_attention_gqa``."""
    b, h, t_q, d = q.shape
    h_kv, t_k = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h_kv < 1 or h % h_kv:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}; batch and head dim "
            "must agree and the KV heads divide the query heads"
        )
    if q.dtype != torch.bfloat16 or kv_length is not None:
        raise ValueError("flash_attention: at head dim 128 the kernel takes bfloat16 without "
                         "kv_length")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on 16-byte boundaries")
    _check_hopper(q.device)
    out = torch.empty_like(q)
    if q.numel() == 0 or t_k == 0:
        return out.zero_()
    scale = (d**-0.5) if scale is None else float(scale)
    if not scale > 0:
        raise ValueError(f"flash_attention: the kernel takes a positive scale, not {scale}")
    err = _kernel("os_flash_attention_gqa_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, h_kv, t_q, t_k, scale,
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _launched("flash_attention", err)
    launches[GQA_ROUTE] += 1
    return out


class FlashAttentionGradError(RuntimeError):
    """A gradient was asked of K2 (``flash_attention`` with ``kv_length``)."""


class FlashAttentionFn(torch.autograd.Function):
    """K1 with its gradient: ``FlashAttentionFn.apply(q, k, v, causal, scale)``.

    Forward is ``flash_attention`` (the K1 kernel on a CUDA tensor, its
    plain version on a CPU tensor); backward is ``flash_attention_backward``
    (the three backward kernels, or ``flash_attention_backward_reference``).
    The upstream gradient is made contiguous first: the one ``_merge_heads``
    hands back is a transposed view.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention(q, k, v, causal=causal, scale=scale)  # grad mode is off here

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, d_out.contiguous(), causal=ctx.causal, scale=ctx.scale
        )
        return dq, dk, dv, None, None


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    d_out: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K1(q, k, v) at the gradient ``d_out`` of its output.

    A CPU tensor runs ``flash_attention_backward_reference``. A CUDA tensor
    launches the three kernels of ``flash_attention_bwd.cu`` on the current
    stream (per-row log-sum-exp and delta, then dK/dV, then dQ), each
    counted in ``launches``, or raises on anything they do not take. At
    float32 the kernels read ``split_operands``' pieces of q, k, v and
    d_out (one launch before them) and take every product as six bf16
    piece products, as the forward does.
    """
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, d_out, causal=causal, scale=scale)
    tensors = (q, k, v, d_out)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention_backward: all tensors must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError("flash_attention_backward: float32 or bfloat16, all the same dtype")
    shapes_ok = q.dim() == 4 and k.dim() == 4
    if shapes_ok:
        b, h, t_q, d = q.shape
        t_k = k.shape[2]
        shapes_ok = (k.shape == (b, h, t_k, d) and v.shape == k.shape and d_out.shape == q.shape
                     and d in (32, 64))
    if not shapes_ok:
        raise ValueError(
            f"flash_attention_backward: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, d_out {tuple(d_out.shape)}; want q = d_out [B,H,Tq,D], "
            "k = v [B,H,Tk,D], D 32 or 64"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_backward: all tensors must be contiguous")
    _check_hopper(q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if t_q == 0 or t_k == 0 or b * h == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scale = (d**-0.5) if scale is None else float(scale)
    f32 = q.dtype == torch.float32
    operands = bwd_operands(*tensors)
    stats = torch.empty(2, b, h, t_q, dtype=torch.float32, device=q.device)  # lse2, delta
    for stage, name in enumerate(BWD_STAGES):
        _launched(name, _bwd_stage(stage, operands, (dq, dk, dv), stats, causal, scale), f32)
    return dq, dk, dv


def bwd_operands(q, k, v, d_out) -> tuple[torch.Tensor, ...]:
    """What the backward kernels read of checked inputs: the bf16 tensors as
    they are, or the float32 tensors' pieces (``split_operands``)."""
    if q.dtype == torch.float32:
        return tuple(_split((q, k, v, d_out), None, 0, torch.cuda.current_stream(q.device).cuda_stream))
    return q, k, v, d_out


def _bwd_stage(stage: int, operands, grads, stats: torch.Tensor, causal: bool, scale: float) -> int:
    """Launches pass ``stage`` of K1's backward on ``bwd_operands`` of
    tensors that ``flash_attention_backward`` checked: 0 writes lse2 and
    delta into ``stats`` [2,B,H,Tq], 1 dk and dv, 2 dq (``grads``, in the
    inputs' dtype). Returns its cudaError."""
    dq, dk = grads[0], grads[1]
    b, h, t_q, d = dq.shape
    ptrs = [t.data_ptr() for t in (*operands, *grads)] + [stats[0].data_ptr(), stats[1].data_ptr()]
    return _kernel("os_flash_attention_bwd")(
        *ptrs, stage, b, h, t_q, dk.shape[2], d, _DTYPE_CODES[dq.dtype], scale, int(causal),
        torch.cuda.current_stream(dq.device).cuda_stream)


def _launched(name: str, err: int, f32: bool = False) -> None:
    if err != 0:
        raise RuntimeError(f"{name}{F32_SUFFIX if f32 else ''} kernel launch failed: cudaError {err}")
    launches[name] += 1
    if f32:
        launches[name + F32_SUFFIX] += 1


def _combine(o_part: int, m_part: int, l_part: int, out: torch.Tensor, dims, stream) -> int:
    """Launches the combine kernel on partials given by device pointers
    (dims: B, S, H, Tq, D) into ``out`` (bfloat16 or float32): its one
    launch site, for ``flash_attention``'s and ``decode_attention``'s split
    paths and for ``flash_combine``. Returns its cudaError; the caller
    counts the launch."""
    return _kernel("os_flash_combine")(o_part, m_part, l_part, out.data_ptr(), *dims,
                                       _DTYPE_CODES[out.dtype], stream)


def flash_combine(
    o_part: torch.Tensor, m_part: torch.Tensor, l_part: torch.Tensor,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Merges K2's kv-split partials (o_part [B,S,H,Tq,D], m_part and
    l_part [B,S,H,Tq], float32, contiguous) into [B,H,Tq,D] of ``dtype``
    (bfloat16, or float32 for K2 at float32).

    A CPU tensor runs ``flash_combine_reference``; a CUDA tensor launches
    the combine kernel on the current stream or raises.
    """
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_combine: dtype {dtype}; bfloat16 or float32")
    if not o_part.is_cuda:
        return flash_combine_reference(o_part, m_part, l_part).to(dtype)
    if o_part.dim() != 5 or m_part.shape != o_part.shape[:4] or l_part.shape != m_part.shape:
        raise ValueError(
            f"flash_combine: shapes {tuple(o_part.shape)}, {tuple(m_part.shape)}, "
            f"{tuple(l_part.shape)}; want [B,S,H,Tq,D] and [B,S,H,Tq] twice"
        )
    b, splits, h, t_q, d = o_part.shape
    parts = (o_part, m_part, l_part)
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != o_part.device
           for t in parts) or d not in (32, 64) or o_part.data_ptr() % 16:
        raise ValueError(
            "flash_combine: partials must be contiguous float32 on one device, "
            "O 16-byte aligned, D 32 or 64"
        )
    _check_hopper(o_part.device)
    out = torch.empty(b, h, t_q, d, dtype=dtype, device=o_part.device)
    if out.numel() == 0:
        return out
    err = _combine(*(t.data_ptr() for t in parts), out, (b, splits, h, t_q, d),
                   torch.cuda.current_stream(o_part.device).cuda_stream)
    _launched("flash_combine", err, dtype == torch.float32)
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length: torch.Tensor,
    *,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-position attention over a padded KV cache.

    q: [B, H, Tq, D] (Tq is 1, or the folded beams); caches: [B, H, T_max, D];
    length: [B] valid prefix per batch row. A length of 0 softmaxes
    uniformly over the cache, as the reference does; callers clamp it.

    int8 caches come with per-position ``k_scale``/``v_scale`` [B, H, T_max,
    1]: the logits are multiplied by ``k_scale`` on the kv axis after the
    softmax scale, the probabilities by ``v_scale`` after the softmax, and
    the V product of float32 probabilities with the int8 cache is taken in
    float32, as in the JAX package.

    A CPU tensor runs the plain version, ``decode_attention_reference``, as
    does a CUDA tensor with int8 caches and their scales (counted as
    ``decode_attention_int8``). Any other CUDA call launches the decode
    kernel or raises on what it does not take: q float32 or bfloat16, caches
    both bfloat16 or both float32, D in ``DECODE_HEAD_DIMS``, q strided with
    unit stride on D, the caches with rows of D on T_max. Up to
    ``DECODE_ROWS`` query rows share one read of the caches; a longer q (the
    prefill's prompt) takes a block per ``DECODE_ROWS`` rows. The kernel
    keeps the probabilities in float32 where the plain version rounds them
    to the caches' dtype, and reads no cache row at or past a row's length
    (a length above T_max counts as T_max).
    """
    if q.is_cuda:
        if k_cache.dtype != torch.int8 or k_scale is None or v_scale is None:
            return _decode_attention_cuda(q, k_cache, v_cache, length, scale, k_scale, v_scale)
        launches["decode_attention_int8"] += 1
    return decode_attention_reference(q, k_cache, v_cache, length, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length: torch.Tensor,
    *,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """``decode_attention``'s plain version, on either device: the caches
    upcast to float32, the logits masked to ``NEG_INF`` at and past each
    row's length, the probabilities rounded to the V cache's dtype (not
    int8's) before the V product."""
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    logits = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * scale
    if k_scale is not None:
        logits = logits * k_scale[..., 0][:, :, None, :].float()
    t_k = k_cache.shape[2]
    mask = (
        torch.arange(t_k, device=q.device)[None, None, None, :]
        < length[:, None, None, None]
    )
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[..., 0][:, :, None, :].float()
    if v_cache.dtype != torch.int8:
        probs = probs.to(v_cache.dtype)
    out = torch.matmul(probs.float(), v_cache.float())
    return out.to(q.dtype)


DECODE_HEAD_DIMS = (16, 32, 64, 128)
DECODE_ROWS = 8  # query rows of a block: the folded beams share one read of the caches
DECODE_SPLIT_KEYS = 64  # a split owns whole ranges of this many keys


@functools.lru_cache(maxsize=256)
def plan_decode_splits(b: int, h: int, t_q: int, t_max: int) -> tuple[int, int]:
    """The decode kernel's key split: ``(splits, keys per split)`` from the
    shape alone (the lengths stay on the card). A block streams one (batch
    row, head), up to ``DECODE_ROWS`` of its query rows and one split of its
    keys; with B*H*ceil(Tq / DECODE_ROWS) blocks short of two a SM, the key
    axis splits into ranges of whole ``DECODE_SPLIT_KEYS`` keys, the fewest
    that give each SM two blocks, none empty."""
    blocks = max(1, b * h * -(-t_q // DECODE_ROWS))
    most = max(1, -(-t_max // DECODE_SPLIT_KEYS))  # one range of keys each
    splits = min(-(-2 * N_SMS // blocks), most)
    if splits <= 1:
        return 1, max(t_max, 1)
    per = -(-t_max // splits)
    per = -(-per // DECODE_SPLIT_KEYS) * DECODE_SPLIT_KEYS
    return -(-t_max // per), per


def _decode_attention_cuda(q, k_cache, v_cache, length, scale, k_scale, v_scale) -> torch.Tensor:
    """``decode_attention`` on the card: checks what the kernel takes (raises
    on anything else), then launches it on the current stream, and with a
    key split the combine kernel after it. ``length`` is read on the card
    only; no call here waits for the card."""
    q_code, kv_code = _DTYPE_CODES.get(q.dtype), _DTYPE_CODES.get(k_cache.dtype)
    if k_scale is not None or v_scale is not None:
        raise ValueError("decode_attention: k_scale and v_scale come with int8 caches only")
    if q_code is None or kv_code is None or v_cache.dtype != k_cache.dtype:
        raise ValueError(
            f"decode_attention: dtypes q {q.dtype}, caches {k_cache.dtype}/{v_cache.dtype}; the "
            "kernel takes float32 or bfloat16 q and caches of one of the two (int8 caches with "
            "their scales take the plain version)"
        )
    shape = k_cache.shape
    if q.dim() != 4 or len(shape) != 4 or v_cache.shape != shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches {tuple(shape)}/"
                         f"{tuple(v_cache.shape)}; want q [B,H,Tq,D] and caches [B,H,T_max,D]")
    b, h, t_q, d = q.shape
    t_max = shape[2]
    if (shape[0] != b or shape[1] != h or shape[3] != d or d not in DECODE_HEAD_DIMS
            or b > 65535 or h > 65535):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, caches {tuple(shape)}; batch, heads "
            f"and D must agree, D in {DECODE_HEAD_DIMS}"
        )
    dev = q.device
    if k_cache.device != dev or v_cache.device != dev:
        raise ValueError("decode_attention: q and the caches must be on one CUDA device")
    if not (isinstance(length, torch.Tensor) and length.shape == (b,) and length.device == dev
            and length.dtype in (torch.int32, torch.int64)):
        raise ValueError(
            f"decode_attention: length must be an int32 or int64 tensor of shape [{b}] on {dev}")
    length = length.contiguous()
    qs, ks, vs = q.stride(), k_cache.stride(), v_cache.stride()
    if qs[3] != 1:
        raise ValueError("decode_attention: q needs unit stride on D")
    if (ks[3] != 1 or vs[3] != 1 or (t_max > 1 and (ks[2] != d or vs[2] != d))
            or (k_cache.data_ptr() | v_cache.data_ptr()) % 16
            or (ks[0] | ks[1] | vs[0] | vs[1]) % (16 // k_cache.element_size())):
        raise ValueError(
            "decode_attention: each cache needs unit stride on D, rows of D on T_max, and "
            "16-byte aligned start and batch and head strides"
        )
    _check_hopper(dev)
    out = torch.empty(b, h, t_q, d, dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    scale = (d**-0.5) if scale is None else float(scale)
    splits, per = plan_decode_splits(b, h, t_q, t_max)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*qs[:3], ks[0], ks[1], vs[0], vs[1], b, h, t_q, t_max, d, kv_code, q_code,
            int(length.dtype == torch.int64), splits, per, scale, stream)
    kernel = _kernel("os_decode_attention")
    ptrs = q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()
    if splits == 1:
        err = kernel(*ptrs, out.data_ptr(), length.data_ptr(), None, None, *args)
        _launched("decode_attention", err)
        return out
    # one f32 workspace [B,S,H,Tq] x (D + 2): the partial O, then m, then l
    rows = b * splits * h * t_q
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=dev)
    o_part = ws.data_ptr()
    m_part, l_part = o_part + 4 * rows * d, o_part + 4 * rows * (d + 1)
    _launched("decode_attention", kernel(*ptrs, o_part, length.data_ptr(), m_part, l_part, *args))
    err = _combine(o_part, m_part, l_part, out, (b, splits, h, t_q, d), stream)
    _launched("decode_attention_split", err)
    return out


def beam_select_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    row_map: torch.Tensor,
    length: torch.Tensor,
    beam: int,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Beam-search decode attention over un-permuted caches.

    ``row_map`` [B*K, T] names, per (beam, position), the physical cache
    row that holds that beam's K/V (always inside the batch row's K-slot
    group). Scores of every query beam against every source beam are
    computed once, then the lineage entry is selected per position; the
    same one-hot selection folds into the probabilities for V.

    q: [B*K, H, 1, D]; caches: [B*K, H, T, D]; length: scalar or [B*K].
    Returns [B*K, H, 1, D].
    """
    bk, h, _, d = q.shape
    b = bk // beam
    t = k_cache.shape[2]
    scale = (d**-0.5) if scale is None else scale
    qf = q[:, :, 0, :].reshape(b, beam, h, d).float()
    kf = k_cache.reshape(b, beam, h, t, d).float()
    vf = v_cache.reshape(b, beam, h, t, d)
    logits_all = torch.einsum("bkhd,bmhtd->bkhmt", qf, kf) * scale
    sel = (row_map % beam).reshape(b, beam, t).long()  # local slot per position
    idx = sel[:, :, None, None, :].expand(b, beam, h, 1, t)
    logits = torch.gather(logits_all, 3, idx)[:, :, :, 0, :]  # [B, K, H, T]
    pos = torch.arange(t, device=q.device)
    if length.dim() == 0:
        mask = (pos < length)[None, None, None, :]
    else:
        mask = (pos[None, :] < length.reshape(b, beam)[..., None])[:, :, None, :]
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    onehot = sel[:, :, None, :] == torch.arange(beam, device=q.device)[None, None, :, None]
    probs_m = probs[:, :, :, None, :] * onehot[:, :, None, :, :].to(probs.dtype)
    out = torch.einsum(
        "bkhmt,bmhtd->bkhd", probs_m.to(vf.dtype).float(), vf.float()
    )
    return out.reshape(bk, h, 1, d).to(q.dtype)
