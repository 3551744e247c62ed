"""The port's flash kernel on a Hopper card against its plain version.

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

# bf16 output rounds O(1) values at ~4e-3; f32 differs only in summation order
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

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
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
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
