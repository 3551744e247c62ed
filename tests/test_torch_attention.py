"""Attention: the PyTorch port against the JAX package.

The flash kernels' plain versions (what a CPU tensor runs: K1 without
``kv_length``, K2 with it) are held against the JAX Pallas kernel run in
interpret mode (``_flash_call`` with small blocks, as
``tests/test_flash_attention.py`` runs it) and against ``mha_reference``;
``decode_attention`` and ``beam_select_attention`` against their JAX
versions. Inputs are numpy-seeded; float32; tolerance
1e-5 absolute (O(1) outputs, different summation orders).

The hand-written CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them against the plain versions there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.ops import attention as JA
from open_speech_tpu_torch.ops import attention as TA

TOL = 1e-5

# (B, H, Tq, Tk, D, causal): non-causal, causal square, end-aligned
# rectangular both ways (Tq > Tk leaves zero-key rows), Tq < 8, ragged T
FLASH_CASES = [
    (1, 2, 16, 16, 32, False),
    (1, 2, 16, 16, 64, True),
    (2, 2, 8, 24, 32, True),
    (2, 2, 24, 8, 32, True),
    (1, 2, 3, 3, 64, True),
    (1, 2, 1, 1, 64, True),
    (1, 1, 13, 29, 64, False),
    (1, 1, 29, 13, 32, False),
]


def _qkv(b, h, t_q, t_k, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, t_q, d)).astype(np.float32),
        rng.standard_normal((b, h, t_k, d)).astype(np.float32),
        rng.standard_normal((b, h, t_k, d)).astype(np.float32),
    )


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", FLASH_CASES)
def test_flash_plain_matches_jax_kernel_and_reference(b, h, t_q, t_k, d, causal):
    q, k, v = _qkv(b, h, t_q, t_k, d, seed=t_q * 31 + t_k)
    out = TA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    ).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = np.asarray(JA._flash_call(jq, jk, jv, None, causal, None, 8, 16, interpret=True))
    ref = np.asarray(JA.mha_reference(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(out, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    if causal and t_q > t_k:
        assert not out[:, :, : t_q - t_k].any(), "rows with no key must be zero"


def test_mha_reference_kv_length_matches_jax():
    q, k, v = _qkv(3, 2, 5, 12, 32, seed=3)
    lens = np.array([12, 4, 0], np.int32)
    out = TA.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_length=torch.from_numpy(lens),
    ).numpy()
    ref = np.asarray(JA.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_length=jnp.asarray(lens)
    ))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    assert not out[2].any()


@pytest.mark.parametrize("t_q", [1, 3])
def test_decode_attention_matches_jax_including_length_zero(t_q):
    q, k, v = _qkv(3, 2, t_q, 10, 32, seed=5)
    lens = np.array([10, 7, 0], np.int32)  # 0: uniform over the cache, as in JAX
    out = TA.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens),
    ).numpy()
    ref = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)
    ))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("scalar_len", [True, False])
def test_beam_select_attention_matches_jax(scalar_len):
    b, beam, h, t, d = 2, 3, 2, 6, 32
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b * beam, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b * beam, h, t, d)).astype(np.float32)
    v = rng.standard_normal((b * beam, h, t, d)).astype(np.float32)
    # lineage rows always inside the batch row's K-slot group
    row_map = (
        np.repeat(np.arange(b) * beam, beam)[:, None]
        + rng.integers(0, beam, (b * beam, t))
    ).astype(np.int32)
    lens = np.array(5, np.int32) if scalar_len else rng.integers(1, t + 1, b * beam).astype(np.int32)
    out = TA.beam_select_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(row_map), torch.from_numpy(lens), beam,
    ).numpy()
    ref = np.asarray(JA.beam_select_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(row_map),
        jnp.asarray(lens), beam,
    ))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)



# K2, (B, H, Tq, Tk, D, causal, lengths): lengths 0 and Tk, causal with
# lengths, Tq < 8, Tq > Tk, ragged T, the test-tiny streaming block
VARLEN_CASES = [
    (2, 2, 16, 40, 32, False, (0, 40)),
    (2, 2, 16, 40, 64, True, (17, 40)),
    (3, 1, 3, 24, 64, True, (24, 5, 0)),
    (1, 2, 1, 13, 32, False, (13,)),
    (2, 1, 29, 13, 32, True, (13, 7)),
    (1, 2, 20, 60, 32, False, (17,)),
]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,lens", VARLEN_CASES)
def test_flash_varlen_plain_matches_jax_kernel_and_reference(b, h, t_q, t_k, d, causal, lens):
    q, k, v = _qkv(b, h, t_q, t_k, d, seed=t_q * 7 + t_k)
    lens = np.asarray(lens, np.int32)
    out = TA.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_length=torch.from_numpy(lens),
    ).numpy()
    plain = TA.flash_attention_varlen_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), causal=causal,
    ).numpy()
    jq, jk, jv, jl = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)
    kern = np.asarray(JA._flash_call(jq, jk, jv, jl, causal, None, 8, 16, interpret=True))
    ref = np.asarray(JA.mha_reference(jq, jk, jv, causal=causal, kv_length=jl))
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_allclose(out, kern, atol=TOL, rtol=0)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    for i, n in enumerate(lens):
        if n == 0:
            assert not out[i].any(), "a length-0 example must give zeros"


def test_flash_launch_counters_name_both_kernels():
    assert set(TA.launches) == {"flash_attention", "flash_attention_varlen"}
    q = torch.zeros(1, 1, 4, 32)
    before = dict(TA.launches)
    TA.flash_attention(q, q, q, kv_length=torch.tensor([2]))
    assert TA.launches == before, "the plain version on the CPU launches nothing"
