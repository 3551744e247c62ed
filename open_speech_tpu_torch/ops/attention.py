"""Attention: the Hopper flash kernel and KV-cache decode attention.

Counterpart of ``open_speech_tpu/ops/attention.py``:

  - ``flash_attention``: tiled online-softmax attention, optionally over a
    per-example valid kv prefix (``kv_length``). A CUDA tensor runs the
    hand-written sm_90a kernels (``kernels/csrc/flash_attention.cu``: K1
    without lengths, K2 with them); a CPU tensor runs their plain versions
    ``flash_attention_reference`` and ``flash_attention_varlen_reference``.
    There is no fallback between the two: a CUDA call that cannot launch
    raises. In bf16, K2 splits the kv axis over more blocks
    (``plan_splits``) and ``flash_combine`` merges the splits' partials;
    ``flash_attention_partial_reference`` and ``flash_combine_reference``
    are the plain versions of the two passes.
  - ``decode_attention`` and ``beam_select_attention``: single-position
    attention over a padded KV cache, as plain PyTorch on either device.

Layouts are the JAX package's: q/k/v [B, H, T, D].
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30
LOG2E = math.log2(math.e)

# launches of the flash kernels (K1, K2 and K2's combine pass), counted
# where each is launched
launches = {"flash_attention": 0, "flash_attention_varlen": 0, "flash_combine": 0}

# the bf16 kernel's tiles (kBlockN keys, kBlockQ query rows per block in
# flash_attention.cu) and the card's SM count, which K2's split plan fills
BLOCK_N = 128
BLOCK_Q = 64
N_SMS = 132


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_length: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. q,k,v: [B, H, T, D]; kv_length: [B] valid kv lengths."""
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
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
    # rows with no attendable key return zeros (the kernel's semantics)
    any_valid = logits.amax(dim=-1, keepdim=True) > NEG_INF / 2
    probs = torch.where(any_valid, probs, 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


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
def plan_splits(b: int, h: int, t_q: int, t_k: int) -> tuple[int, int]:
    """K2's kv split in bf16: ``(splits, tiles_per_split)`` from the shape
    alone (the lengths stay on the card). The fewest splits that give every
    SM a block, with at least two 128-key tiles per split; each split owns
    ``tiles_per_split`` whole tiles and none is empty."""
    tiles = max(1, -(-t_k // BLOCK_N))
    blocks = b * h * -(-t_q // BLOCK_Q)  # query blocks
    splits = max(1, min(-(-N_SMS // blocks), tiles // 2))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def split_ranges(t_k: int, tiles_per_split: int) -> list[tuple[int, int]]:
    """The kv ranges [begin, end) of the splits: whole tiles, covering [0, Tk)."""
    step = tiles_per_split * BLOCK_N
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


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # C entry -> argument types after the four tensor pointers
    "os_flash_attention_fwd": [_I] * 6 + [ctypes.c_float, _I, _P],
    "os_flash_attention_varlen_fwd": [_P] * 3 + [_I] * 8 + [ctypes.c_float, _I, _P],
    "os_flash_combine": [_I] * 5 + [_P],
}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _kernel(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        from open_speech_tpu_torch.kernels import build

        fn = getattr(build.load("flash_attention"), entry)
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

    ``kv_length`` [B] (integer): keys at or past it are masked, per example.
    A CPU tensor runs the plain version. A CUDA tensor launches the sm_90a
    kernel on the current stream (K1, or K2 with ``kv_length``; in bf16 K2
    runs ``plan_splits`` kv splits and, when there is more than one, the
    combine pass), or raises on anything the kernel does not take. Rows with
    zero attendable keys return zeros on both paths.
    """
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
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d or d not in (32, 64):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}; "
            "batch, heads and head dim must agree and D must be 32 or 64"
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
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"flash_attention: the bf16 kernel takes a positive scale, not {scale}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    shape = (b, h, t_q, t_k, d, _DTYPE_CODES[q.dtype], scale, int(causal), stream)
    if kv_length is None:
        out = torch.empty_like(q)
        err = _kernel("os_flash_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *shape
        )
        _launched("flash_attention", err)
        return out
    # f32 (the scalar kernel) runs one split over every tile
    tiles = max(1, -(-t_k // BLOCK_N))
    splits, per = plan_splits(b, h, t_q, t_k) if q.dtype == torch.bfloat16 else (1, tiles)
    out = torch.empty_like(q)
    qkv = q.data_ptr(), k.data_ptr(), v.data_ptr()
    varlen = _kernel("os_flash_attention_varlen_fwd")
    if splits == 1:
        err = varlen(*qkv, out.data_ptr(), kv_length.data_ptr(), None, None, 1, per, *shape)
        _launched("flash_attention_varlen", err)
        return out
    # one f32 workspace [B,S,H,Tq] x (D + 2): the partial O, then m, then l
    rows = b * splits * h * t_q
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    o_part = ws.data_ptr()
    m_part, l_part = o_part + 4 * rows * d, o_part + 4 * rows * (d + 1)
    err = varlen(*qkv, o_part, kv_length.data_ptr(), m_part, l_part, splits, per, *shape)
    _launched("flash_attention_varlen", err)
    _combine(o_part, m_part, l_part, out, (b, splits, h, t_q, d), stream)
    return out


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _combine(o_part: int, m_part: int, l_part: int, out: torch.Tensor, dims, stream) -> None:
    """Launches the combine kernel on partials given by device pointers
    (dims: B, S, H, Tq, D) into ``out``: its one launch site, for
    ``flash_attention``'s split path and for ``flash_combine``."""
    err = _kernel("os_flash_combine")(o_part, m_part, l_part, out.data_ptr(), *dims, stream)
    _launched("flash_combine", err)


def flash_combine(
    o_part: torch.Tensor, m_part: torch.Tensor, l_part: torch.Tensor
) -> torch.Tensor:
    """Merges K2's kv-split partials (o_part [B,S,H,Tq,D], m_part and
    l_part [B,S,H,Tq], float32, contiguous) into [B,H,Tq,D] bfloat16.

    A CPU tensor runs ``flash_combine_reference``; a CUDA tensor launches
    the combine kernel on the current stream or raises.
    """
    if not o_part.is_cuda:
        return flash_combine_reference(o_part, m_part, l_part).to(torch.bfloat16)
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
    out = torch.empty(b, h, t_q, d, dtype=torch.bfloat16, device=o_part.device)
    if out.numel() == 0:
        return out
    _combine(*(t.data_ptr() for t in parts), out, (b, splits, h, t_q, d),
             torch.cuda.current_stream(o_part.device).cuda_stream)
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
    """
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
