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
    """K1, K2 and K2's combine pass each have a counter; the plain versions
    on the CPU launch nothing."""
    assert set(TA.launches) == {"flash_attention", "flash_attention_varlen", "flash_combine"}
    q = torch.zeros(1, 1, 4, 32)
    before = dict(TA.launches)
    TA.flash_attention(q, q, q, kv_length=torch.tensor([2]))
    TA.flash_combine(torch.zeros(1, 2, 1, 4, 32), torch.zeros(1, 2, 1, 4), torch.ones(1, 2, 1, 4))
    assert TA.launches == before, "the plain version on the CPU launches nothing"


# K2's kv split: (B, H, Tq, Tk, D, causal, tiles per split, lengths). Lengths
# 0 and 1, both sides of each 128-key split boundary, Tk; with one tile per
# split the later splits of the short lengths lie wholly past the length;
# causal with Tq > Tk leaves rows that see no key
SPLIT_CASES = [
    (9, 2, 5, 300, 32, False, 1, (0, 1, 127, 128, 129, 255, 256, 257, 300)),
    (9, 1, 20, 300, 64, True, 1, (0, 1, 127, 128, 129, 255, 256, 257, 300)),
    (4, 2, 7, 700, 32, False, 2, (1, 255, 256, 700)),
    (2, 1, 40, 30, 32, True, 1, (30, 29)),
]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,per,lens", SPLIT_CASES)
def test_split_partials_combine_to_the_reference(b, h, t_q, t_k, d, causal, per, lens):
    """Partials of each kv split (``flash_attention_partial_reference``)
    merged by ``flash_combine_reference`` equal ``mha_reference`` (f32), and
    rows with no key are exact zeros."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, t_q, t_k, d, seed=t_k + per))
    kv_length = torch.tensor(lens)
    parts = [
        TA.flash_attention_partial_reference(q, k, v, lo, hi, causal=causal, kv_length=kv_length)
        for lo, hi in TA.split_ranges(t_k, per)
    ]
    o_part, m_part, l_part = (torch.stack([p[i] for p in parts], dim=1) for i in range(3))
    out = TA.flash_combine_reference(o_part, m_part, l_part)
    ref = TA.mha_reference(q, k, v, causal=causal, kv_length=kv_length)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL, rtol=0)
    seen = torch.isfinite(m_part).any(dim=1)  # [B, H, Tq]: the row saw some key
    assert not out[~seen].any(), "rows with no key must be exact zeros"
    if 0 in lens:
        assert not out[lens.index(0)].any()


def test_split_partials_ignore_values_past_the_length():
    """V past the length counts as zeros in the split that holds it: NaN
    there leaves the merged output finite and unchanged."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 6, 300, 32, seed=1))
    kv_length = torch.tensor([150])
    def merged(v):
        parts = [TA.flash_attention_partial_reference(q, k, v, lo, hi, kv_length=kv_length)
                 for lo, hi in TA.split_ranges(300, 1)]
        return TA.flash_combine_reference(*(torch.stack([p[i] for p in parts], 1) for i in range(3)))
    clean = merged(v)
    v[:, :, 150:] = float("nan")
    assert torch.equal(merged(v), clean)


@pytest.mark.parametrize("t_k", [1, 37, 100, 128, 129, 1500])
@pytest.mark.parametrize("b,h,t_q", [(1, 20, 128), (1, 4, 128), (2, 1, 5)])
def test_split_plan_covers_the_keys_in_whole_tiles(b, h, t_q, t_k):
    splits, per = TA.plan_splits(b, h, t_q, t_k)
    ranges = TA.split_ranges(t_k, per)
    assert splits >= 1 and per >= 1 and len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == t_k
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(t_k, None)]):
        assert hi == nxt and lo % TA.BLOCK_N == 0 and lo < hi
        assert hi == t_k or hi - lo == per * TA.BLOCK_N
    tiles = -(-t_k // TA.BLOCK_N)
    blocks = b * h * -(-t_q // TA.BLOCK_Q) * splits
    # every SM gets a block, unless more splits would leave one below two tiles
    assert per >= 2 or tiles == 1
    assert blocks >= TA.N_SMS or per == 2 or tiles < 4


def test_split_plan_fills_the_card_at_the_streaming_block():
    """The streaming block [1,20,128,1500]: 4 splits of 3 tiles, 160 blocks
    on the 132 SMs."""
    assert TA.plan_splits(1, 20, 128, 1500) == (4, 3)
    assert 2 * 20 * 4 >= TA.N_SMS
