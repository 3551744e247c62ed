"""Attention: the Hopper flash kernel and KV-cache decode attention.

Counterpart of ``open_speech_tpu/ops/attention.py``:

  - ``flash_attention``: tiled online-softmax attention, optionally over a
    per-example valid kv prefix (``kv_length``). A CUDA tensor runs the
    hand-written sm_90a kernels (``kernels/csrc/flash_attention.cu``: K1
    without lengths, K2 with them); a CPU tensor runs their plain versions
    ``flash_attention_reference`` and ``flash_attention_varlen_reference``.
    There is no fallback between the two: a CUDA call that cannot launch
    raises.
  - ``decode_attention`` and ``beam_select_attention``: single-position
    attention over a padded KV cache, as plain PyTorch on either device.

Layouts are the JAX package's: q/k/v [B, H, T, D].
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

# launches of the flash kernels (K1, K2), counted where each is launched
launches = {"flash_attention": 0, "flash_attention_varlen": 0}


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


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # C entry -> argument types after the four tensor pointers
    "os_flash_attention_fwd": [_I] * 6 + [ctypes.c_float, _I, _P],
    "os_flash_attention_varlen_fwd": [_P] + [_I] * 6 + [ctypes.c_float, _I, _P],
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


def _check_hopper(device: torch.device) -> None:
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"flash_attention's kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has capability {cap}"
        )


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
    kernel on the current stream (K1, or K2 with ``kv_length``), or raises
    on anything the kernel does not take. Rows with zero attendable keys
    return zeros on both paths.
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = (d**-0.5) if scale is None else float(scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tensors = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (b, h, t_q, t_k, d, _DTYPE_CODES[q.dtype], scale, int(causal), stream)
    if kv_length is None:
        name, err = "flash_attention", _kernel("os_flash_attention_fwd")(*tensors, *shape)
    else:
        name = "flash_attention_varlen"
        err = _kernel("os_flash_attention_varlen_fwd")(
            *tensors, kv_length.data_ptr(), *shape
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    length: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """One-position attention over a padded KV cache.

    q: [B, H, Tq, D] (Tq is 1, or the folded beams); caches: [B, H, T_max, D];
    length: [B] valid prefix per batch row. A length of 0 softmaxes
    uniformly over the cache, as the reference does; callers clamp it.
    """
    d = q.shape[-1]
    scale = (d**-0.5) if scale is None else scale
    logits = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * scale
    t_k = k_cache.shape[2]
    mask = (
        torch.arange(t_k, device=q.device)[None, None, None, :]
        < length[:, None, None, None]
    )
    probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
    out = torch.matmul(probs.to(v_cache.dtype).float(), v_cache.float())
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
