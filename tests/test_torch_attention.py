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

The float32 kernels take each operand as three bf16 pieces
(``split_operands_reference``) and each product as six piece products
accumulated in float32. ``_split_forward`` is that arithmetic in plain
PyTorch; held to the card's float32 gate (1e-4 absolute) against the JAX
package's ``mha_reference`` it passes with a margin of at least 10x, and
the controls, one bf16 piece per operand or each operand rounded once to
TF32, fail: they are what the six products buy.
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
    """K1, K2, K2's combine pass and the three passes of K1's backward each
    have a counter, and again under "_f32" for their float32 launches,
    beside the float32 routes' operand split, K1's launches at head dim 128
    (grouped KV heads) and decode attention's three (its kernel, its split
    launches with their combine, the plain int8 route);
    the plain versions on the CPU launch nothing."""
    routes = {"flash_attention", "flash_attention_varlen", "flash_combine",
              "flash_attention_bwd_prep", "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"}
    decode = {"decode_attention", "decode_attention_split", "decode_attention_int8"}
    assert set(TA.launches) == (routes | {r + "_f32" for r in routes} | {"flash_split_f32"}
                                | {"flash_attention_gqa"} | decode)
    q = torch.zeros(1, 1, 4, 32)
    before = dict(TA.launches)
    TA.flash_attention(q, q, q, kv_length=torch.tensor([2]))
    TA.flash_combine(torch.zeros(1, 2, 1, 4, 32), torch.zeros(1, 2, 1, 4), torch.ones(1, 2, 1, 4))
    TA.flash_attention_backward(q, q, q, q, causal=True)
    TA.flash_combine(torch.zeros(1, 2, 1, 4, 32), torch.zeros(1, 2, 1, 4), torch.ones(1, 2, 1, 4),
                     dtype=torch.float32)
    TA.split_operands(q)
    TA.decode_attention(q, q, q, torch.tensor([2]))
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


# ── float32: the kernels' split-operand arithmetic ──────────────────────

# the six piece products (A's piece, B's piece): hh, hm, mh, mm, hl, lh
SPLIT_PRODUCTS = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0)]
F32_GATE = 1e-4  # chip_smoke.py's TOL["float32"] and tests/test_torch_cuda.py's


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _split_matmul(a: torch.Tensor, b: torch.Tensor, mode: str = "split") -> torch.Tensor:
    """a @ b as the float32 kernels take it: the six piece products of
    a's and b's bf16 pieces, each exact in float32, summed in float32
    ("split"); or the controls, one bf16 piece each ("one") or each
    operand rounded to TF32 once ("tf32")."""
    if mode == "tf32":
        return torch.matmul(_tf32(a), _tf32(b))
    pa, pb = (TA.split_operands_reference(x.contiguous()).float() for x in (a, b))
    pairs = SPLIT_PRODUCTS if mode == "split" else [(0, 0)]
    return sum(torch.matmul(pa[i], pb[j]) for i, j in pairs)


def _split_forward(q, k, v, causal, kv_length=None, mode="split"):
    """K1/K2 at float32 in the kernel's arithmetic: S = Q K^T and the
    unnormalised P V through ``_split_matmul``, the softmax in float32,
    P = 2^(x - max) split as it stands, the row sum divided out last; rows
    with no visible key give zeros."""
    scale = q.shape[-1] ** -0.5
    s = _split_matmul(q, k.transpose(-1, -2), mode) * scale
    t_q, t_k = q.shape[2], k.shape[2]
    keys = torch.arange(t_k)
    seen = torch.ones(q.shape[0], 1, t_q, t_k, dtype=torch.bool)
    if causal:
        seen = seen & (keys[None, :] <= torch.arange(t_q)[:, None] + (t_k - t_q))
    if kv_length is not None:
        seen = seen & (keys[None, :] < kv_length[:, None])[:, None, None, :]
    s = torch.where(seen, s, -torch.inf)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(mx == -torch.inf, 0.0, mx))
    if kv_length is not None:  # V rows past the length are zeroed before P V
        v = torch.where((keys[None, :] < kv_length[:, None])[:, None, :, None], v, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return _split_matmul(p, v, mode) * torch.where(l > 0, 1.0 / l, 0.0)


# (B, H, Tq, Tk, D, causal, lengths): the encoder's square at 512, causal
# self attention, a cross attention over 512 keys, D 32, K2 at lengths
# 0 and inside a tile
F32_FORWARD_CASES = [
    (1, 2, 512, 512, 64, False, None),
    (1, 2, 256, 256, 64, True, None),
    (2, 2, 64, 512, 64, False, None),
    (1, 2, 256, 256, 32, False, None),
    (2, 2, 128, 300, 64, False, (0, 257)),
]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,lens", F32_FORWARD_CASES)
def test_f32_split_arithmetic_meets_the_f32_gate_and_the_controls_do_not(b, h, t_q, t_k, d, causal, lens):
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, t_q, t_k, d, seed=t_q + d))
    kv_length = None if lens is None else torch.tensor(lens)
    jl = None if lens is None else jnp.asarray(np.asarray(lens, np.int32))
    ref = np.asarray(JA.mha_reference(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                                      causal=causal, kv_length=jl))
    err = {mode: np.abs(_split_forward(q, k, v, causal, kv_length, mode).numpy() - ref).max()
           for mode in ("split", "one", "tf32")}
    assert err["split"] <= F32_GATE / 10, f"the split arithmetic: {err['split']:.3e}"
    assert err["one"] > F32_GATE and err["tf32"] > F32_GATE, f"a control passes: {err}"


def test_split_operands_reference_pieces_sum_to_the_input():
    """hi, mid and lo are bf16 values, each at most half an ulp of the
    rest, and hi + mid + lo is x to within 2^-24 |x| (to 2^-27 away from
    the ends of the range)."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 10.0 ** np.arange(
        -20, 20, 40 / 4096).astype(np.float32))
    p = TA.split_operands_reference(x)
    assert p.shape == (3, 4096) and p.dtype == torch.bfloat16
    whole = p.double().sum(dim=0)
    assert ((whole - x.double()).abs() <= x.double().abs() * 2.0 ** -24).all()
    assert (p[1].double().abs() <= p[0].double().abs() * 2.0 ** -8).all()
    assert (p[2].double().abs() <= p[1].double().abs() * 2.0 ** -8).all()


@pytest.mark.parametrize("t_k", [1, 37, 64, 65, 128, 300, 1500])
@pytest.mark.parametrize("b,h,t_q", [(1, 20, 128), (1, 4, 128), (2, 1, 5), (1, 20, 1500)])
def test_split_plan_f32_covers_the_keys_in_whole_f32_tiles(b, h, t_q, t_k):
    """At float32 the plan counts the f32 kernel's tiles: 128 query rows a
    block, 64 keys a tile."""
    block_q, block_n = TA.tiles(torch.float32)
    assert (block_q, block_n) == (TA.F32_BLOCK_Q, TA.F32_BLOCK_N) == (128, 64)
    splits, per = TA.plan_splits(b, h, t_q, t_k, block_q, block_n)
    ranges = TA.split_ranges(t_k, per, block_n)
    assert splits >= 1 and per >= 1 and len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == t_k
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(t_k, None)]):
        assert hi == nxt and lo % block_n == 0 and lo < hi
        assert hi == t_k or hi - lo == per * block_n
    tiles = -(-t_k // block_n)
    # at least two tiles per split, and no more splits than the SMs ask for
    assert per >= 2 or tiles == 1
    assert splits <= max(1, -(-TA.N_SMS // (b * h * -(-t_q // block_q))))


def test_split_plan_f32_at_the_streaming_block():
    """The streaming block [1,20,128,1500] at float32: 6 splits of 4 tiles
    of 64 keys, 120 blocks of 128 rows (one per SM); bf16 keeps 4 x 3."""
    assert TA.plan_splits(1, 20, 128, 1500, *TA.tiles(torch.float32)) == (6, 4)
    assert TA.plan_splits(1, 20, 128, 1500, *TA.tiles(torch.bfloat16)) == (4, 3)


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,lens", [
    (2, 2, 128, 1500, 64, False, (128, 1500)),
    (3, 1, 20, 300, 32, True, (0, 65, 300)),
])
def test_f32_split_partials_combine_to_jax_in_float32(b, h, t_q, t_k, d, causal, lens):
    """K2 at float32: the partials of the f32 plan's splits merged by
    ``flash_combine_reference`` and by ``flash_combine(dtype=float32)``
    (its plain version here) equal the JAX package's ``mha_reference``,
    as float32."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, t_q, t_k, d, seed=t_k))
    kv_length = torch.tensor(lens)
    _, per = TA.plan_splits(b, h, t_q, t_k, *TA.tiles(torch.float32))
    parts = [TA.flash_attention_partial_reference(q, k, v, lo, hi, causal=causal, kv_length=kv_length)
             for lo, hi in TA.split_ranges(t_k, per, TA.F32_BLOCK_N)]
    o_part, m_part, l_part = (torch.stack([p[i] for p in parts], dim=1) for i in range(3))
    merged = TA.flash_combine_reference(o_part, m_part, l_part)
    out = TA.flash_combine(o_part, m_part, l_part, dtype=torch.float32)
    ref = np.asarray(JA.mha_reference(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                                      causal=causal, kv_length=jnp.asarray(np.asarray(lens, np.int32))))
    assert out.dtype == torch.float32 and torch.equal(out, merged)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    assert TA.flash_combine(o_part, m_part, l_part).dtype == torch.bfloat16



# ── decode attention's kernel route, held on the CPU ─────────────────────
#
# The decode kernel runs only on the card (tests/test_torch_cuda.py holds it
# against ``decode_attention_reference`` there). What surrounds it is Python
# and is held here: the split plan, the partial layout its splits share with
# K2's combine, the wrapper's checks and what it hands the kernel.


@pytest.mark.parametrize("t_max", [0, 1, 32, 63, 64, 65, 256, 1500, 1536])
@pytest.mark.parametrize("b,h,t_q", [(64, 20, 1), (8, 20, 1), (1, 20, 1), (4, 16, 1), (1, 2, 1),
                                     (13, 20, 1), (14, 20, 1), (1, 20, 5), (1, 20, 36), (2, 20, 100)])
def test_decode_split_plan_covers_the_keys_from_the_shape_alone(b, h, t_q, t_max):
    """Every key in exactly one split, none empty; a split owns whole
    ranges of DECODE_SPLIT_KEYS keys; blocks (B*H times the query rows'
    blocks of DECODE_ROWS) of at least two a SM take one split, and no plan
    has more splits than two blocks a SM need."""
    blocks = b * h * -(-t_q // TA.DECODE_ROWS)
    splits, per = TA.plan_decode_splits(b, h, t_q, t_max)
    assert splits * per >= t_max and (splits - 1) * per < max(t_max, 1)
    if splits > 1:
        assert per % TA.DECODE_SPLIT_KEYS == 0
        assert blocks < 2 * TA.N_SMS
    if blocks >= 2 * TA.N_SMS:
        assert splits == 1
    assert splits <= -(-2 * TA.N_SMS // blocks)  # no more than two blocks a SM need


def test_decode_split_plan_at_the_served_shapes():
    """The batcher's 64 slots x 20 heads fill the card unsplit; the REST fold
    (B = 1, five beams) takes 12 splits of 128 keys, 240 blocks; a 36-token
    prompt's prefill over the cross cache 5 x 20 blocks of rows, so 3 splits
    of 512; the Pocket LM at B = 4 (16 heads, 1536 positions) 5 of 320."""
    assert TA.plan_decode_splits(64, 20, 1, 1500) == (1, 1500)
    assert TA.plan_decode_splits(64, 20, 1, 256) == (1, 256)
    assert TA.plan_decode_splits(1, 20, 5, 1500) == (12, 128)
    assert TA.plan_decode_splits(1, 20, 36, 1500) == (3, 512)
    assert TA.plan_decode_splits(4, 16, 1, 1536) == (5, 320)
    assert TA.plan_decode_splits(8, 20, 1, 1500) == (2, 768)


@pytest.mark.parametrize("b,h,t_q,t_max,d,lens", [
    (1, 20, 5, 1500, 64, (1500,)),
    (1, 4, 1, 700, 32, (129,)),
    (2, 2, 3, 300, 16, (1, 301)),
    (3, 1, 8, 200, 128, (64, 65, 199)),
    (1, 2, 19, 300, 64, (77,)),
])
def test_decode_split_partials_combine_to_the_plain_version(b, h, t_q, t_max, d, lens):
    """The kernel's split path in plain arithmetic: the partials of the plan's
    key ranges (``flash_attention_partial_reference`` with the lengths, K2's
    layout [B,S,H,Tq,D] and [B,S,H,Tq]) merged by ``flash_combine_reference``
    equal ``decode_attention_reference`` in float32 (a length past T_max
    counts as T_max; splits past the length see no key)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, h, t_q, t_max, d, seed=t_max + d))
    length = torch.tensor(lens)
    splits, per = TA.plan_decode_splits(b, h, t_q, t_max)
    assert splits > 1
    ranges = TA.split_ranges(t_max, 1, per)
    assert len(ranges) == splits
    parts = [TA.flash_attention_partial_reference(q, k, v, lo, hi, kv_length=length)
             for lo, hi in ranges]
    o_part, m_part, l_part = (torch.stack([p[i] for p in parts], dim=1) for i in range(3))
    merged = TA.flash_combine_reference(o_part, m_part, l_part)
    ref = TA.decode_attention_reference(q, k, v, length)
    np.testing.assert_allclose(merged.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_decode_attention_on_the_cpu_takes_the_plain_version():
    """A CPU tensor runs ``decode_attention_reference`` and launches nothing,
    int8 caches with their scales included."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 3, 1, 20, 16, seed=8))
    length = torch.tensor([0, 13])
    before = dict(TA.launches)
    assert torch.equal(TA.decode_attention(q, k, v, length),
                       TA.decode_attention_reference(q, k, v, length))
    k8, v8 = (torch.randint(-127, 128, (2, 3, 20, 16), dtype=torch.int8) for _ in range(2))
    ks, vs = torch.rand(2, 3, 20, 1) * 1e-2, torch.rand(2, 3, 20, 1) * 1e-2
    assert torch.equal(TA.decode_attention(q, k8, v8, length, k_scale=ks, v_scale=vs),
                       TA.decode_attention_reference(q, k8, v8, length, k_scale=ks, v_scale=vs))
    assert dict(TA.launches) == before


def _decode_args():
    """bf16 q [2,2,1,64] over bf16 caches [2,2,40,64], int64 lengths: what the
    kernel takes, before one thing is made wrong."""
    q, k, v = (torch.randn(2, 2, t, 64).to(torch.bfloat16) for t in (1, 40, 40))
    return q, k, v, torch.tensor([3, 40])


_BAD_DECODE_CALLS = {
    "q float16": lambda q, k, v, n: (q.half(), k, v, n, None, None),
    "caches float16": lambda q, k, v, n: (q, k.half(), v.half(), n, None, None),
    "K and V apart": lambda q, k, v, n: (q, k, v.float(), n, None, None),
    "int8 without scales": lambda q, k, v, n: (q, k.to(torch.int8), v.to(torch.int8), n, None, None),
    "scales on bf16 caches": lambda q, k, v, n: (q, k, v, n, k[..., :1].float(), v[..., :1].float()),
    "D 48": lambda q, k, v, n: (q[..., :48], k[..., :48], v[..., :48], n, None, None),
    "D 8": lambda q, k, v, n: (q[..., :8], k[..., :8], v[..., :8], n, None, None),
    "q 3-D": lambda q, k, v, n: (q[:, :, 0], k, v, n, None, None),
    "heads apart": lambda q, k, v, n: (q[:, :1], k, v, n, None, None),
    "D not unit stride": lambda q, k, v, n: (q, k.transpose(2, 3).contiguous().transpose(2, 3), v, n,
                                             None, None),
    "q D not unit stride": lambda q, k, v, n: (q.new_zeros(2, 2, 64, 2).transpose(2, 3)[:, :, :1],
                                               k, v, n, None, None),
    "T rows not of D": lambda q, k, v, n: (q, k[:, :, ::2], v[:, :, ::2], n, None, None),
    "length float": lambda q, k, v, n: (q, k, v, n.float(), None, None),
    "length bool": lambda q, k, v, n: (q, k, v, n > 0, None, None),
    "length int16": lambda q, k, v, n: (q, k, v, n.short(), None, None),
    "length not [B]": lambda q, k, v, n: (q, k, v, n[:1], None, None),
    "length a list": lambda q, k, v, n: (q, k, v, [3, 40], None, None),
}


@pytest.mark.parametrize("case", sorted(_BAD_DECODE_CALLS))
def test_decode_kernel_route_refuses_what_the_kernel_does_not_take(case, monkeypatch):
    """The CUDA route's checks (run here on CPU tensors, before anything
    needs a card) raise on each input the kernel does not take."""
    monkeypatch.setattr(TA, "_kernel", lambda entry: pytest.fail("launched"))
    q, k, v, length, k_scale, v_scale = _BAD_DECODE_CALLS[case](*_decode_args())
    with pytest.raises(ValueError, match="decode_attention"):
        TA._decode_attention_cuda(q, k, v, length, None, k_scale, v_scale)


def _record_launches(monkeypatch):
    calls = []

    def kernel(entry):
        return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(TA, "_kernel", kernel)
    monkeypatch.setattr(TA, "_check_hopper", lambda device: None)
    stream = type("Stream", (), {"cuda_stream": 7})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    return calls


def test_decode_kernel_route_hands_the_kernel_the_views_as_they_are(monkeypatch):
    """The beam fold's strided q and one layer's views of the batcher's pool
    reach the kernel with their strides, no copy; int64 lengths as they are,
    and one launch counted."""
    calls = _record_launches(monkeypatch)
    pool = torch.zeros(2, 2, 64, 20, 256, 64, dtype=torch.bfloat16)  # [L, 2, S, H, T, D]
    q = torch.randn(64, 1, 20, 64).to(torch.bfloat16).transpose(1, 2)  # [S, H, 1, D], strided
    length = torch.arange(64)
    before = dict(TA.launches)
    out = TA._decode_attention_cuda(q, pool[1, 0], pool[1, 1], length, None, None, None)
    assert out.shape == (64, 20, 1, 64) and out.dtype == torch.bfloat16 and out.is_contiguous()
    (entry, args), = calls
    assert entry == "os_decode_attention"
    assert args[:5] == (q.data_ptr(), pool[1, 0].data_ptr(), pool[1, 1].data_ptr(), out.data_ptr(),
                        length.data_ptr())
    assert args[5:7] == (None, None)
    assert args[7:14] == (*q.stride()[:3], *pool[1, 0].stride()[:2], *pool[1, 1].stride()[:2])
    # B, H, Tq, T_max, D, cache dtype, q dtype, int64 lengths, splits, keys per split
    assert args[14:24] == (64, 20, 1, 256, 64, 1, 1, 1, 1, 256)
    assert args[24] == pytest.approx(64**-0.5) and args[25] == 7
    assert TA.launches["decode_attention"] == before["decode_attention"] + 1
    assert TA.launches["decode_attention_split"] == before["decode_attention_split"]


def test_decode_kernel_route_splits_and_combines_where_heads_are_few(monkeypatch):
    """B = 1 with five folded beams: the kernel writes the float32 partials
    [1,12,20,5,64] and [1,12,20,5] into one workspace and the combine merges
    them into the float32 output; an int32 length goes as it is."""
    calls = _record_launches(monkeypatch)
    q = torch.randn(1, 5, 20, 64).transpose(1, 2)
    k, v = (torch.randn(1, 20, 1500, 64) for _ in range(2))
    before = dict(TA.launches)
    out = TA._decode_attention_cuda(q, k, v, torch.tensor([900], dtype=torch.int32), 0.5, None, None)
    assert out.dtype == torch.float32 and out.shape == (1, 20, 5, 64)
    (entry, args), (centry, cargs) = calls
    assert entry == "os_decode_attention" and centry == "os_flash_combine"
    rows = 12 * 20 * 5
    o_part, m_part, l_part = args[3], args[5], args[6]
    assert (m_part - o_part, l_part - m_part) == (4 * rows * 64, 4 * rows)
    assert args[14:24] == (1, 20, 5, 1500, 64, 0, 0, 0, 12, 128)
    assert args[24] == 0.5
    assert cargs[:4] == (o_part, m_part, l_part, out.data_ptr())
    assert cargs[4:] == (1, 12, 20, 5, 64, 0, 7)
    for name, n in (("decode_attention", 1), ("decode_attention_split", 1), ("flash_combine", 0)):
        assert TA.launches[name] == before[name] + n
