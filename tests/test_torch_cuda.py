"""The port's flash kernels (K1, K2) and the streaming block encode on a
Hopper card against their plain versions.

These tests need an NVIDIA Hopper card and skip without one. On the card's
machine, which has no JAX, run them without the suite's conftest (it sets
up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only.
"""

from __future__ import annotations

import pytest
import torch

from open_speech_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

# bf16 is held relative to the output's scale (2e-2 of max|ref|), so a
# dropped kv tile or a mis-scaled row fails even where outputs are small;
# f32 differs only in summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _limit(dtype: torch.dtype, ref: torch.Tensor) -> float:
    if dtype == torch.bfloat16:
        return TOL[dtype] * ref.abs().max().item()
    return TOL[dtype]

# (B, H, Tq, Tk, D, causal): 1- and 3-token prefills, a ragged tail past
# one 64-row block, end-aligned rectangles both ways (Tq > Tk has zero rows),
# the test-tiny head dim
CASES = [
    (1, 2, 1, 1, 64, True),
    (1, 2, 3, 3, 64, True),
    (1, 3, 129, 129, 64, False),
    (2, 3, 37, 100, 64, True),
    (2, 3, 100, 37, 64, True),
    (1, 2, 60, 60, 32, False),
    (1, 2, 60, 60, 32, True),
]


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card; this host has no CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (capability 9.0)")
    return torch.device("cuda", 0)


def _qkv(card, b, h, t_q, t_k, d, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return tuple(
        torch.randn(b, h, t, d, generator=gen, device=card).to(dtype)
        for t in (t_q, t_k, t_k)
    )


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", CASES)
def test_kernel_matches_plain_version(card, b, h, t_q, t_k, d, causal, dtype):
    q, k, v = _qkv(card, b, h, t_q, t_k, d, dtype)
    before = A.launches["flash_attention"]
    out = A.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert A.launches["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype and out.is_cuda
    ref = A.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    assert (out.float() - ref).abs().max().item() <= _limit(dtype, ref)
    if causal and t_q > t_k:  # rows before the first visible key
        assert out[:, :, : t_q - t_k].abs().max().item() == 0.0


def test_kernel_takes_an_explicit_scale(card):
    q, k, v = _qkv(card, 1, 2, 70, 70, 64, torch.float32, seed=1)
    out = A.flash_attention(q, k, v, causal=True, scale=0.3)
    ref = A.flash_attention_reference(q, k, v, causal=True, scale=0.3)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(card, 1, 2, 8, 8, 64, torch.bfloat16)
    before = A.launches["flash_attention"]
    with pytest.raises(ValueError, match="dtypes"):
        A.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtypes"):
        A.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                          v[..., :48].contiguous())
    with pytest.raises(ValueError, match="one CUDA device"):
        A.flash_attention(q, k.cpu(), v)
    assert A.launches["flash_attention"] == before


# K2, (B, H, Tq, Tk, D, causal, lengths): the streaming block [.,128,1500]
# at short and full lengths, length 0 and Tk in one batch, causal with
# lengths, a ragged tail, the test-tiny block
VARLEN_CASES = [
    (1, 4, 128, 1500, 64, False, (128,)),
    (1, 4, 128, 1500, 64, False, (700,)),
    (1, 4, 128, 1500, 64, False, (1500,)),
    (2, 4, 37, 100, 64, False, (0, 53)),
    (2, 4, 37, 100, 64, True, (0, 53)),
    (3, 2, 5, 70, 64, True, (70, 69, 1)),
    (1, 2, 60, 60, 32, False, (17,)),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,lens", VARLEN_CASES)
def test_varlen_kernel_matches_plain_version(card, b, h, t_q, t_k, d, causal, lens, dtype):
    q, k, v = _qkv(card, b, h, t_q, t_k, d, dtype, seed=2)
    kv_length = torch.tensor(lens, device=card)  # int64: the wrapper converts
    before = dict(A.launches)
    out = A.flash_attention(q, k, v, causal=causal, kv_length=kv_length)
    torch.cuda.synchronize()
    assert A.launches["flash_attention_varlen"] == before["flash_attention_varlen"] + 1
    assert A.launches["flash_attention"] == before["flash_attention"]
    ref = A.flash_attention_varlen_reference(
        q.float(), k.float(), v.float(), kv_length, causal=causal
    )
    assert out.shape == q.shape and out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= _limit(dtype, ref)
    for i, n in enumerate(lens):
        if n == 0:  # no key at all: exact zeros
            assert out[i].abs().max().item() == 0.0


def test_varlen_kernel_ignores_keys_past_the_length(card):
    """Keys and values past the length are never read: NaN there changes
    nothing."""
    q, k, v = _qkv(card, 1, 2, 128, 300, 64, torch.bfloat16, seed=3)
    lens = torch.tensor([200], dtype=torch.int32, device=card)
    clean = A.flash_attention(q, k, v, kv_length=lens)
    k[:, :, 200:] = float("nan")
    v[:, :, 200:] = float("nan")
    dirty = A.flash_attention(q, k, v, kv_length=lens)
    assert torch.equal(clean, dirty)


def test_varlen_kernel_refuses_bad_lengths(card):
    q, k, v = _qkv(card, 2, 2, 8, 8, 64, torch.bfloat16)
    before = A.launches["flash_attention_varlen"]
    for bad in (torch.tensor([3, 4]),  # on the CPU
                torch.tensor([3.0, 4.0], device=card),  # not integer
                torch.tensor([3], device=card),  # not [B]
                [3, 4]):  # not a tensor
        with pytest.raises(ValueError, match="kv_length"):
            A.flash_attention(q, k, v, kv_length=bad)
    assert A.launches["flash_attention_varlen"] == before


def test_streaming_block_encode_card_matches_cpu(card, monkeypatch):
    """One committed block and one interim tail of the streaming encoder on
    the card (K2, float32) against the same on the CPU (plain version)."""
    import numpy as np

    from open_speech_tpu_torch.models.whisper.model import PRESETS, init_params
    from open_speech_tpu_torch.models.whisper.streaming import StreamingWhisperEncoder

    cfg = PRESETS["test-tiny"]
    model = init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # f32 conv stem
    audio = np.random.default_rng(0).uniform(-0.4, 0.4, 40 * 320).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        enc = StreamingWhisperEncoder(model.to(dev), cfg, block_pos=16)
        before = A.launches["flash_attention_varlen"]
        enc.append_audio(audio)
        states, bucket = enc.interim_states()
        launched = A.launches["flash_attention_varlen"] - before
        out[str(dev)] = (states.cpu(), enc._kc.cpu(), launched, enc.block_encodes)
    cpu, gpu = out["cpu"], out[str(card)]
    assert gpu[3] == cpu[3] == 2
    assert cpu[2] == 0 and gpu[2] == cfg.n_audio_layer * (2 + 1)  # 2 commits + 1 tail
    assert (gpu[0] - cpu[0]).abs().max().item() <= 1e-4
    assert (gpu[1] - cpu[1]).abs().max().item() <= 1e-4
