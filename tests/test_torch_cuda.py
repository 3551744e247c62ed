"""The port's flash kernels (K1, K1's backward, K2), the decode attention
kernel and the streaming block encode on a Hopper card against their plain
versions; Kokoro, Piper, the effects chain and the diarizer (no hand kernel)
on the card against the CPU.

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
# f32 runs every product as six bf16 piece products summed in f32 (about
# 2^-24 of each product's terms, then the sums' rounding in another order)
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _limit(dtype: torch.dtype, ref: torch.Tensor) -> float:
    if dtype == torch.bfloat16:
        return TOL[dtype] * ref.abs().max().item()
    return TOL[dtype]

# (B, H, Tq, Tk, D, causal): 1- and 3-token prefills, a ragged tail past
# one 64-row block, end-aligned rectangles both ways (Tq > Tk has zero rows),
# the test-tiny head dim; the encoder's 1500 (12 128-key tiles, the last
# ragged; 24 blocks of 64 rows per head), a causal diagonal one row into a
# second 64-row block, cross attention one row past two 64-row blocks, the
# beam-5 prefill of 36
CASES = [
    (1, 2, 1, 1, 64, True),
    (1, 2, 3, 3, 64, True),
    (1, 3, 129, 129, 64, False),
    (2, 3, 37, 100, 64, True),
    (2, 3, 100, 37, 64, True),
    (1, 2, 60, 60, 32, False),
    (1, 2, 60, 60, 32, True),
    (1, 2, 1500, 1500, 64, False),
    (1, 2, 65, 65, 64, True),
    (1, 3, 129, 1500, 64, False),
    (5, 20, 36, 36, 64, True),
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
    with pytest.raises(ValueError, match="positive scale"):  # both fold it into ex2
        A.flash_attention(q, k, v, scale=-0.125)
    with pytest.raises(ValueError, match="positive scale"):
        A.flash_attention(q.float(), k.float(), v.float(), scale=0.0)
    assert A.launches["flash_attention"] == before


# K1 at the batch widths of batched long-form and the batcher's admission:
# the encoder at 8 and 16 windows (B*H = 160 and 320 heads in the 3-D
# tensor maps) and the batched beam-free prefill of a prompted upload
@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", [
    (8, 20, 1500, 1500, 64, False),
    (16, 20, 1500, 1500, 64, False),
    (16, 20, 36, 36, 64, True),
])
def test_kernel_at_batched_shapes(card, b, h, t_q, t_k, d, causal):
    q, k, v = _qkv(card, b, h, t_q, t_k, d, torch.bfloat16, seed=b)
    out = A.flash_attention(q, k, v, causal=causal)
    ref = A.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    assert out.shape == q.shape
    assert (out.float() - ref).abs().max().item() <= _limit(torch.bfloat16, ref)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 127, 128, 129, 255, 256, 1499, 1500])
def test_varlen_kernel_at_split_and_tile_edges(card, length, dtype):
    """The streaming block shape at lengths around K2's 128-key tiles and
    its split boundaries (bf16: 6 splits of 256 keys)."""
    q, k, v = _qkv(card, 1, 4, 128, 1500, 64, dtype, seed=length)
    kv_length = torch.tensor([length], dtype=torch.int32, device=card)
    out = A.flash_attention(q, k, v, kv_length=kv_length)
    ref = A.flash_attention_varlen_reference(q.float(), k.float(), v.float(), kv_length)
    assert out.shape == q.shape and out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= _limit(dtype, ref)


def test_varlen_kernel_ignores_keys_past_the_length_in_an_inner_split(card):
    """NaN past a length that ends inside a split other than the last: that
    split zeroes V there, and the later splits load nothing."""
    assert A.plan_splits(1, 2, 128, 1500) == (6, 2)  # splits of 256 keys
    q, k, v = _qkv(card, 1, 2, 128, 1500, 64, torch.bfloat16, seed=4)
    lens = torch.tensor([300], dtype=torch.int32, device=card)  # inside split 1
    clean = A.flash_attention(q, k, v, kv_length=lens)
    k[:, :, 300:] = float("nan")
    v[:, :, 300:] = float("nan")
    dirty = A.flash_attention(q, k, v, kv_length=lens)
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("kv", [None, 700])
def test_kernels_are_deterministic(card, kv):
    """Two launches give the same bits: K1 at the encoder shape, K2 with its
    fixed-order combine at the streaming block."""
    t_q = 1500 if kv is None else 128
    q, k, v = _qkv(card, 1, 20, t_q, 1500, 64, torch.bfloat16, seed=5)
    lens = None if kv is None else torch.tensor([kv], dtype=torch.int32, device=card)
    first = A.flash_attention(q, k, v, kv_length=lens)
    second = A.flash_attention(q, k, v, kv_length=lens)
    assert torch.equal(first, second)


def test_combine_launches_are_counted(card):
    """The streaming block runs K2 over its split plan and one combine: in
    bf16 4 splits of 128-key tiles, in f32 6 splits of 64-key tiles (its
    launches also counted under the "_f32" names, beside one operand
    split); a one-split shape launches no combine."""
    assert A.plan_splits(1, 20, 128, 1500) == (4, 3)
    assert A.plan_splits(1, 20, 128, 1500, *A.tiles(torch.float32)) == (6, 4)
    lens = torch.tensor([900], dtype=torch.int32, device=card)
    before = dict(A.launches)
    for dtype, t_k, n_combine in ((torch.bfloat16, 1500, 1), (torch.float32, 1500, 1),
                                  (torch.bfloat16, 200, 0), (torch.float32, 100, 0)):
        q, k, v = _qkv(card, 1, 20, 128, t_k, 64, dtype, seed=6)
        A.flash_attention(q, k, v, kv_length=lens.clamp(max=t_k))
        torch.cuda.synchronize()
        f32 = int(dtype == torch.float32)
        assert A.launches["flash_combine"] == before["flash_combine"] + n_combine
        assert A.launches["flash_combine_f32"] == before["flash_combine_f32"] + f32 * n_combine
        assert A.launches["flash_attention_varlen_f32"] == before["flash_attention_varlen_f32"] + f32
        assert A.launches["flash_split_f32"] == before["flash_split_f32"] + f32
        before = dict(A.launches)


# K1's backward: the turbo encoder's head count at 1500 rows, ragged tiles
# both ways, causal end-aligned rectangles (Tq > Tk has rows with no key),
# the decoder's self and cross attention of a training batch, D 32; one row
# and one key; a ragged kv tail under causal Tq < Tk; D 32 at 1500; many
# heads (B*H = 80 slices of the TMA maps)
BWD_CASES = [
    (1, 2, 1500, 1500, 64, False),
    (2, 3, 37, 100, 64, True),
    (2, 3, 100, 37, 64, True),
    (1, 2, 65, 129, 64, False),
    (2, 4, 64, 64, 64, True),
    (2, 4, 64, 1500, 64, False),
    (1, 2, 60, 60, 32, True),
    (1, 2, 7, 60, 32, False),
    (1, 2, 1, 1, 64, True),
    (1, 2, 1, 1, 64, False),
    (1, 2, 100, 1500, 64, True),
    (1, 4, 1500, 1500, 32, False),
    (4, 20, 128, 1500, 64, False),
]


def _grad_close(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """``got`` against the plain version in f32 on the same inputs. f32:
    within 1e-4 of max(max|ref|, 1) (six bf16 piece products per product,
    about 2^-24 of its terms, and f32 sums over up to Tq or Tk terms in
    another order). bf16: the kernel accumulates in f32, takes P and dS as two
    bf16 halves each and rounds only its outputs, so within half a bf16 ulp
    of ref plus 1e-4 of max|ref| (a kernel that rounded P or dS to bf16
    once reads about 1e-3 there)."""
    err = (got.float() - ref).abs()
    if got.dtype == torch.float32:
        return err.max().item() <= TOL[torch.float32] * max(ref.abs().max().item(), 1.0)
    _, exp = torch.frexp(ref)  # |ref| in [2^(exp-1), 2^exp): bf16's ulp there is 2^(exp-8)
    half_ulp = torch.ldexp(torch.ones_like(ref), exp - 9) * (ref != 0)
    return (err - half_ulp).max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", BWD_CASES)
def test_backward_kernels_match_plain_version(card, b, h, t_q, t_k, d, causal, dtype):
    q, k, v = _qkv(card, b, h, t_q, t_k, d, dtype, seed=7)
    d_out = torch.randn(b, h, t_q, d, generator=torch.Generator(device=card).manual_seed(8),
                        device=card).to(dtype)
    before = dict(A.launches)
    got = A.flash_attention_backward(q, k, v, d_out, causal=causal)
    torch.cuda.synchronize()
    assert all(A.launches[n] == before[n] + 1 for n in A.BWD_STAGES)
    want = A.flash_attention_backward_reference(*(t.float() for t in (q, k, v, d_out)), causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert _grad_close(g, w)
    if causal and t_q > t_k:
        assert got[0][:, :, : t_q - t_k].abs().max().item() == 0.0


def test_backward_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(card, 1, 2, 8, 8, 64, torch.bfloat16)
    out = A.flash_attention(q, k, v)
    before = dict(A.launches)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention_backward(q, k, v, out.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention_backward(q, k, v, out.float())
    with pytest.raises(ValueError, match="D 32 or 64"):
        A.flash_attention_backward(q, k, v[:, :, :4].contiguous(), out)
    with pytest.raises(ValueError, match="one CUDA device"):
        A.flash_attention_backward(q, k.cpu(), v, out)
    assert A.launches == before


def test_gradients_route_through_the_backward_kernels(card):
    """Under grad, K1 goes through ``FlashAttentionFn`` (the upstream
    gradient arrives transposed, as ``_merge_heads`` hands it back) and K2
    raises; without grad no graph is recorded and no backward runs; the
    backward is deterministic."""
    q, k, v = (t.requires_grad_(True) for t in _qkv(card, 2, 4, 64, 64, 64, torch.bfloat16, seed=9))
    before = dict(A.launches)
    out = A.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    merged = out.transpose(1, 2).reshape(2, 64, 256)
    grad = torch.randn_like(merged)
    merged.backward(grad)
    first = [t.grad.clone() for t in (q, k, v)]
    want = A.flash_attention_backward_reference(
        *(t.detach().float() for t in (q, k, v)),
        grad.reshape(2, 64, 4, 64).transpose(1, 2).float().contiguous(), causal=True)
    for g, w in zip(first, want):
        assert _grad_close(g, w)
    for t in (q, k, v):
        t.grad = None
    A.flash_attention(q, k, v, causal=True).transpose(1, 2).reshape(2, 64, 256).backward(grad)
    assert all(torch.equal(t.grad, f) for t, f in zip((q, k, v), first))
    assert A.launches["flash_attention"] == before["flash_attention"] + 2
    assert all(A.launches[n] == before[n] + 2 for n in A.BWD_STAGES)
    with pytest.raises(A.FlashAttentionGradError):
        A.flash_attention(q, k, v, kv_length=torch.tensor([3, 64], device=card))
    with torch.no_grad():
        assert A.flash_attention(q, k, v).grad_fn is None
    assert all(A.launches[n] == before[n] + 2 for n in A.BWD_STAGES)


def test_combine_kernel_matches_plain_version(card):
    """The combine kernel on random partials, one split with no key
    (m = -inf, l = 0, O = 0), against ``flash_combine_reference``."""
    gen = torch.Generator(device=card).manual_seed(7)
    b, s, h, t_q, d = 1, 4, 20, 128, 64
    o_part = torch.randn(b, s, h, t_q, d, generator=gen, device=card)
    m_part = 4 * torch.randn(b, s, h, t_q, generator=gen, device=card)
    l_part = torch.rand(b, s, h, t_q, generator=gen, device=card) + 0.5
    o_part[:, 3], m_part[:, 3], l_part[:, 3] = 0.0, float("-inf"), 0.0
    before = A.launches["flash_combine"]
    out = A.flash_combine(o_part, m_part, l_part)
    torch.cuda.synchronize()
    assert A.launches["flash_combine"] == before + 1
    ref = A.flash_combine_reference(o_part, m_part, l_part)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, t_q, d)
    assert (out.float() - ref).abs().max().item() <= _limit(torch.bfloat16, ref)


def test_f32_combine_kernel_matches_plain_version(card):
    """The combine kernel writing float32 (K2 at float32), one split with no
    key, against ``flash_combine_reference`` within the f32 bound."""
    gen = torch.Generator(device=card).manual_seed(8)
    b, s, h, t_q, d = 2, 6, 4, 128, 64
    o_part = torch.randn(b, s, h, t_q, d, generator=gen, device=card)
    m_part = 4 * torch.randn(b, s, h, t_q, generator=gen, device=card)
    l_part = torch.rand(b, s, h, t_q, generator=gen, device=card) + 0.5
    o_part[:, 5], m_part[:, 5], l_part[:, 5] = 0.0, float("-inf"), 0.0
    before = dict(A.launches)
    out = A.flash_combine(o_part, m_part, l_part, dtype=torch.float32)
    torch.cuda.synchronize()
    assert A.launches["flash_combine"] == before["flash_combine"] + 1
    assert A.launches["flash_combine_f32"] == before["flash_combine_f32"] + 1
    ref = A.flash_combine_reference(o_part, m_part, l_part)
    assert out.dtype == torch.float32 and out.shape == (b, h, t_q, d)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


def test_f32_routes_count_their_launches_and_are_deterministic(card):
    """A float32 call launches the operand split, then its kernel, each
    counted under its "_f32" name beside the shared one; two calls give
    the same bits (K1, K2 with its combine, the backward)."""
    q, k, v = _qkv(card, 1, 4, 300, 300, 64, torch.float32, seed=10)
    d_out = torch.randn_like(q)
    lens = torch.tensor([257], dtype=torch.int32, device=card)
    before = dict(A.launches)
    runs = [(A.flash_attention(q, k, v, causal=True), A.flash_attention(q[:, :, :128].contiguous(), k, v, kv_length=lens),
             *A.flash_attention_backward(q, k, v, d_out, causal=True)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    for name, n in (("flash_attention", 2), ("flash_attention_varlen", 2), ("flash_split_f32", 6),
                    *((stage, 2) for stage in A.BWD_STAGES)):
        assert A.launches[name] == before[name] + n, name
        if name != "flash_split_f32":
            assert A.launches[name + "_f32"] == before[name + "_f32"] + n, name


def test_f32_varlen_kernel_ignores_keys_past_the_length(card):
    """At float32 the split leaves the caches' rows past the length
    unwritten and the kernel never reads them as values: NaN there changes
    nothing, in the last split and in an inner one."""
    q, k, v = _qkv(card, 1, 2, 128, 1500, 64, torch.float32, seed=11)
    for n in (200, 1300):
        lens = torch.tensor([n], dtype=torch.int32, device=card)
        clean = A.flash_attention(q, k, v, kv_length=lens)
        kd, vd = k.clone(), v.clone()
        kd[:, :, n:] = float("nan")
        vd[:, :, n:] = float("nan")
        assert torch.equal(clean, A.flash_attention(q, kd, vd, kv_length=lens))


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


# ── decode attention ─────────────────────────────────────────────────────

# (B, H, Tq, T_max, D, cache dtype, q dtype): the batcher's cross and self
# caches; the REST path's folded beams (B*H = 20 takes the key split); the
# REST prefill's prompts over the cross cache (Tq past one block's 8 rows);
# the Pocket LM's float32 caches; the test-tiny head dim with float32 q over
# the batcher's bf16 pools (the fixture's model); D 16 and 128 at both dtypes
DECODE_CASES = [
    (64, 20, 1, 1500, 64, torch.bfloat16, torch.bfloat16),
    (64, 20, 1, 256, 64, torch.bfloat16, torch.bfloat16),
    (1, 20, 5, 1500, 64, torch.bfloat16, torch.bfloat16),
    (1, 20, 36, 1500, 64, torch.bfloat16, torch.bfloat16),
    (5, 20, 12, 1500, 64, torch.bfloat16, torch.bfloat16),
    (2, 2, 9, 60, 32, torch.float32, torch.float32),
    (4, 16, 1, 1536, 64, torch.float32, torch.float32),
    (3, 2, 1, 32, 32, torch.bfloat16, torch.float32),
    (2, 2, 3, 40, 16, torch.float32, torch.bfloat16),
    (3, 4, 8, 300, 128, torch.bfloat16, torch.bfloat16),
    (2, 3, 2, 700, 128, torch.float32, torch.float32),
]


def _decode_limit(out_dtype, cache_dtype, ref) -> float:
    """Largest max-abs gap between the kernel and the plain version. Where a
    bf16 rounding is in play (the plain version rounds the probabilities to
    bf16 caches' dtype, the kernel keeps them float32; a bf16 output rounds
    both to 2^-9 of the value) 1e-2 of max|ref|; with float32 caches and
    output only the order of the sums and exp2 of pre-scaled logits against
    exp differ: 1e-5 of max|ref|."""
    if torch.bfloat16 in (out_dtype, cache_dtype):
        return 1e-2 * ref.abs().max().item()
    return 1e-5 * ref.abs().max().item()


def _decode_inputs(card, b, h, t_q, t_max, d, dtype, q_dtype, seed=0):
    """q as a strided view (the beam fold's [B,K,H,D] transposed, every other
    head of a wider tensor), caches contiguous, lengths over the rows in turn
    0, 1, T_max, above T_max and ragged ones."""
    gen = torch.Generator(device=card).manual_seed(seed)
    wide = torch.randn(b, t_q, 2 * h, d, generator=gen, device=card).to(q_dtype)
    q = wide[:, :, ::2].transpose(1, 2)
    k, v = (torch.randn(b, h, t_max, d, generator=gen, device=card).to(dtype) for _ in range(2))
    ragged = torch.randint(2, max(t_max, 3), (b,), generator=gen, device=card)
    fixed = torch.tensor([0, 1, t_max, t_max + 7], device=card).repeat(-(-b // 4))[:b]
    lens = torch.where(torch.arange(b, device=card) % 8 < 4, fixed, ragged)
    return q, k, v, lens


@pytest.mark.parametrize("b,h,t_q,t_max,d,dtype,q_dtype", DECODE_CASES)
def test_decode_kernel_matches_plain_version(card, b, h, t_q, t_max, d, dtype, q_dtype):
    q, k, v, lens = _decode_inputs(card, b, h, t_q, t_max, d, dtype, q_dtype)
    assert not q.is_contiguous()
    splits, _ = A.plan_decode_splits(b, h, t_q, t_max)
    before = dict(A.launches)
    out = A.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert A.launches["decode_attention"] == before["decode_attention"] + 1
    assert A.launches["decode_attention_split"] == before["decode_attention_split"] + (splits > 1)
    assert A.launches["flash_combine"] == before["flash_combine"]
    ref = A.decode_attention_reference(q, k, v, lens)
    err = (out.float() - ref.float()).abs().max().item()
    assert out.shape == (b, h, t_q, d) and out.dtype == q_dtype and out.is_contiguous()
    assert err <= _decode_limit(q_dtype, dtype, ref), err


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 129, 700, 1499, 1500, 1501])
def test_decode_kernel_split_path_at_each_length(card, n):
    """The REST fold (B = 1, five beams, 12 splits of 128 keys) at lengths
    around the splits' edges, int32 and int64 lengths alike."""
    q, k, v, _ = _decode_inputs(card, 1, 20, 5, 1500, 64, torch.bfloat16, torch.bfloat16, seed=n)
    assert A.plan_decode_splits(1, 20, 5, 1500) == (12, 128)
    for dtype in (torch.int32, torch.int64):
        lens = torch.tensor([n], dtype=dtype, device=card)
        out = A.decode_attention(q, k, v, lens)
        ref = A.decode_attention_reference(q, k, v, lens)
        assert (out.float() - ref.float()).abs().max().item() <= _decode_limit(
            torch.bfloat16, torch.bfloat16, ref)


@pytest.mark.parametrize("b,h,t_q,t_max", [(64, 20, 1, 256), (1, 20, 5, 1500), (1, 20, 36, 1500)])
def test_decode_kernel_reads_no_key_past_the_length(card, b, h, t_q, t_max):
    """NaN in every cache row at or past its length changes no bit, on the
    one-split and the split path (a length of 0 reads the whole cache, so it
    is left out here)."""
    q, k, v, lens = _decode_inputs(card, b, h, t_q, t_max, 64, torch.bfloat16, torch.bfloat16, seed=3)
    lens = lens.clamp(min=1)
    clean = A.decode_attention(q, k, v, lens)
    past = torch.arange(t_max, device=card)[None, :] >= lens[:, None]  # [B, T]
    kd, vd = k.clone(), v.clone()
    kd[past[:, None, :, None].expand_as(kd)] = float("nan")
    vd[past[:, None, :, None].expand_as(vd)] = float("nan")
    assert torch.equal(clean, A.decode_attention(q, kd, vd, lens))


def test_decode_kernel_is_deterministic_and_serves_the_batcher_views(card):
    """Two launches give the same bits; the layer views of the batcher's
    pools ([L, 2, S, H, T, D], one layer's K and V) need no copy."""
    pool = torch.randn(2, 2, 64, 20, 256, 64, device=card).to(torch.bfloat16)
    q = torch.randn(64, 20, 1, 64, device=card).to(torch.bfloat16)
    lens = torch.randint(1, 300, (64,), device=card)
    first = A.decode_attention(q, pool[1, 0], pool[1, 1], lens)
    assert torch.equal(first, A.decode_attention(q, pool[1, 0], pool[1, 1], lens))
    ref = A.decode_attention_reference(q, pool[1, 0], pool[1, 1], lens)
    assert (first.float() - ref.float()).abs().max().item() <= _decode_limit(
        torch.bfloat16, torch.bfloat16, ref)


# K1 at D = 128 with grouped KV heads (B, H, H_kv, Tq, Tk, causal): Voxtral's
# prefill of 8 windows, one row, a ragged causal diagonal, no grouping, a
# rectangle past two 128-key tiles
GQA_CASES = [
    (8, 32, 8, 383, 383, True),
    (1, 32, 8, 1, 1, True),
    (2, 8, 2, 65, 65, True),
    (1, 4, 4, 129, 129, True),
    (2, 8, 1, 37, 300, False),
]


@pytest.mark.parametrize("b,h,h_kv,t_q,t_k,causal", GQA_CASES)
def test_gqa_kernel_matches_plain_version(card, b, h, h_kv, t_q, t_k, causal):
    gen = torch.Generator(device=card).manual_seed(t_q)
    q = torch.randn(b, h, t_q, 128, generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn(b, h_kv, t_k, 128, generator=gen, device=card).to(torch.bfloat16)
            for _ in range(2))
    before = dict(A.launches)
    out = A.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert A.launches[A.GQA_ROUTE] == before[A.GQA_ROUTE] + 1
    assert A.launches["flash_attention"] == before["flash_attention"] + 1
    ref = A.flash_attention_reference(q.float(), k.float(), v.float(), causal=causal)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() <= _limit(torch.bfloat16, ref)


def test_gqa_kernel_refuses_what_it_does_not_take(card):
    q = torch.randn(1, 6, 8, 128, device=card).to(torch.bfloat16)
    k = torch.randn(1, 4, 8, 128, device=card).to(torch.bfloat16)
    with pytest.raises(ValueError, match="divide"):
        A.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_attention(q.float(), k[:, :3].float(), k[:, :3].float())


def test_decode_kernel_takes_grouped_heads_folded_into_rows(card):
    """The audio-LLM tick's attention: each KV head's 4 query heads as its
    query rows, q [64, 8, 4, 128] against the [64, 8, 576, 128] layer views
    of the pool, with no copy of the caches."""
    gen = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(64, 32, 128, generator=gen, device=card).to(torch.bfloat16).view(64, 8, 4, 128)
    pool = torch.randn(2, 2, 64, 8, 576, 128, generator=gen, device=card).to(torch.bfloat16)
    lens = torch.randint(383, 529, (64,), generator=gen, device=card)
    out = A.decode_attention(q, pool[1, 0], pool[1, 1], lens)
    ref = A.decode_attention_reference(q, pool[1, 0], pool[1, 1], lens)
    assert (out.float() - ref.float()).abs().max().item() <= _decode_limit(
        torch.bfloat16, torch.bfloat16, ref)


def test_decode_int8_caches_with_scales_take_the_plain_route(card):
    gen = torch.Generator(device=card).manual_seed(4)
    q = torch.randn(2, 3, 1, 64, generator=gen, device=card)
    k, v = (torch.randint(-127, 128, (2, 3, 50, 64), generator=gen, device=card).to(torch.int8)
            for _ in range(2))
    ks, vs = (torch.rand(2, 3, 50, 1, generator=gen, device=card) * 1e-2 for _ in range(2))
    lens = torch.tensor([20, 50], device=card)
    before = dict(A.launches)
    out = A.decode_attention(q, k, v, lens, k_scale=ks, v_scale=vs)
    assert A.launches["decode_attention_int8"] == before["decode_attention_int8"] + 1
    assert A.launches["decode_attention"] == before["decode_attention"]
    assert torch.equal(out, A.decode_attention_reference(q, k, v, lens, k_scale=ks, v_scale=vs))


def test_decode_kernel_refuses_what_it_does_not_take(card):
    q, k, v, lens = _decode_inputs(card, 2, 2, 1, 40, 64, torch.bfloat16, torch.bfloat16)
    before = A.launches["decode_attention"]
    bad_calls = [
        (q.to(torch.float16), k, v, lens),  # q dtype
        (q, k.to(torch.float16), v.to(torch.float16), lens),  # cache dtype
        (q, k, v.float(), lens),  # K and V apart
        (q, k.to(torch.int8), v.to(torch.int8), lens),  # int8 without scales
        (q[..., :48], k[..., :48], v[..., :48], lens),  # D 48
        (q, k.transpose(2, 3).contiguous().transpose(2, 3), v, lens),  # D not unit stride
        (q, k[:, :, ::2], v[:, :, ::2], lens),  # T rows not of D
        (q, k, v, lens.cpu()),  # length on the host
        (q, k, v, lens.float()),  # length not integer
        (q, k, v, lens[:1]),  # length not [B]
    ]
    for args in bad_calls:
        with pytest.raises(ValueError, match="decode_attention"):
            A.decode_attention(*args)
    with pytest.raises(ValueError, match="int8"):
        A.decode_attention(q, k, v, lens, k_scale=k[..., :1].float(), v_scale=v[..., :1].float())
    assert A.launches["decode_attention"] == before


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


def _fixture_model(card):
    from pathlib import Path

    from open_speech_tpu_torch.models.whisper.convert import load_params
    from open_speech_tpu_torch.models.whisper.tokenizer import get_tokenizer

    path = str(Path(__file__).parent / "fixtures" / "test-tiny-eot")
    model, cfg = load_params(path, dtype=torch.float32)
    return model, cfg, get_tokenizer(path, n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)


def _beep_windows(n: int, seconds: float = 1.2):
    import numpy as np

    rng = np.random.default_rng(31)
    out = []
    for i in range(n):
        t = int(seconds * 16000)
        clip = rng.normal(0, 0.003, t)
        dur = 2400
        for start in range(800 * (i + 1), t - dur, 7000):
            clip[start : start + dur] += 0.5 * np.sin(
                2 * np.pi * 440.0 * np.arange(dur) / 16000) * np.hanning(dur)
        out.append(clip.astype(np.float32))
    return out


def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def test_batcher_card_matches_cpu(card, monkeypatch):
    """Three concurrent windows through the continuous batcher on the card
    (float32, TF32 off) give the CPU batcher's tokens."""
    import asyncio

    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
    from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

    _no_tf32(monkeypatch)
    model, cfg, tok = _fixture_model(card)
    mels = [log_mel_spectrogram(torch.from_numpy(w), n_mels=cfg.n_mels)
            for w in _beep_windows(3)]

    async def serve(m):
        b = ContinuousBatcher(m, cfg, tok.special, slots=4, max_new_tokens=24,
                              suppress_tokens=tuple(tok.non_speech_tokens))
        b.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(b.transcribe_window(x) for x in mels)), 120)
        finally:
            await b.stop()

    cpu = asyncio.run(serve(model))
    gpu = asyncio.run(serve(model.to(card)))
    assert gpu == cpu and any(cpu)


def test_batched_longform_card_matches_cpu(card, monkeypatch):
    """A 9 s upload in batches of four chunks (beam 5, temperature 0) on
    the card (float32, TF32 off) gives the CPU's segments."""
    import numpy as np

    from open_speech_tpu_torch.models.whisper.batched import transcribe_batched
    from open_speech_tpu_torch.models.whisper.transcribe import TranscribeOptions

    _no_tf32(monkeypatch)
    model, cfg, tok = _fixture_model(card)
    audio = np.concatenate(_beep_windows(6, seconds=1.5))
    opts = TranscribeOptions(language="en", beam_size=5, temperature=(0.0,), max_new_tokens=24)
    cpu, _ = transcribe_batched(model, cfg, tok, audio, opts, max_batch=4)
    gpu, _ = transcribe_batched(model.to(card), cfg, tok, audio, opts, max_batch=4)
    key = lambda segs: [(s.seek, s.start, s.end, s.tokens) for s in segs]  # noqa: E731
    assert key(gpu) == key(cpu) and cpu


# ── Kokoro (no hand kernel: cuDNN, cuBLAS, cuFFT in float32) ─────────────


def _kokoro(card):
    from open_speech_tpu_torch.models.kokoro import model as K

    cfg = K.TINY_CONFIG
    host = K.init_kokoro_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    dev = K.KModel.empty(cfg, card)
    dev.load_state_dict(host.state_dict())
    g = torch.Generator().manual_seed(5)
    lengths = (40, 9)
    ph = torch.zeros(len(lengths), cfg.max_phonemes, dtype=torch.long)
    for i, n in enumerate(lengths):
        ph[i, :n] = torch.randint(1, cfg.n_symbols, (n,), generator=g)
    style = torch.randn(len(lengths), cfg.voice_dim, generator=g) * 0.1
    args = (ph, torch.tensor(lengths), style, torch.ones(len(lengths)))
    return K, cfg, host, dev, args


def test_kokoro_card_matches_cpu(card):
    """TINY_CONFIG on the card against the CPU, the same weights and
    host-drawn noise: frame counts equal, the encoder's outputs and the
    decoder's within the CPU parity tests' tolerances, the generator on the
    CPU's harmonic features within 2e-3 of the audio's scale. The process's
    cuDNN TF32 flag is left as it was found."""
    K, cfg, host, dev, args = _kokoro(card)
    flag = torch.backends.cudnn.allow_tf32
    out = {}
    for name, m in (("cpu", host), ("card", dev)):
        a = tuple(t.to(m.device) for t in args)
        (asr, f0, n, s_dec), frames = K.encode_utterance(m, cfg, *a)
        noise = K._source_noise([torch.Generator().manual_seed(s) for s in (1, 2)], 2,
                                cfg.harmonics + 1, cfg.max_frames * cfg.samples_per_frame,
                                m.device)
        with K._inference():
            x, _ = K.decode_audio(m, cfg, asr, f0, n, s_dec, frames)
            har = out["cpu"]["har"].to(m.device) if name == "card" else K.har_features(
                m, cfg, f0, *noise)
            audio = K.generate_waveform(m, cfg, x, s_dec, f0, frames, *noise, har_feat=har)
        out[name] = {k: v.cpu() for k, v in dict(frames=frames, asr=asr, f0=f0, n=n, x=x,
                                                 har=har, audio=audio).items()}
    assert torch.backends.cudnn.allow_tf32 == flag
    cpu, gpu = out["cpu"], out["card"]
    assert torch.equal(gpu["frames"], cpu["frames"])
    for key, tol in (("asr", 2e-5), ("f0", 3e-4), ("n", 3e-4), ("x", 3e-4), ("audio", 2e-3)):
        scale = max(1.0, cpu[key].abs().max().item())
        assert (gpu[key] - cpu[key]).abs().max().item() <= tol * scale, key


def test_kokoro_blocks_cover_the_utterance_on_the_card(card):
    """The streamed blocks on the card cover n_frames x samples_per_frame
    of the longest row, and equal one-shot ``vocode`` where the utterance
    fits one block."""
    import numpy as np

    K, cfg, _, dev, args = _kokoro(card)
    spf = cfg.samples_per_frame
    for rows, block_frames in ((slice(0, 2), 16), (slice(1, 2), 64)):
        a = tuple(t[rows].to(card) for t in args)
        g, frames = K.encode_utterance(dev, cfg, *a)
        total = int(frames.max())
        blocks = list(K.vocode_streaming(dev, cfg, g, frames, block_frames=block_frames,
                                         rng=torch.Generator(device=card).manual_seed(3)))
        joined = np.concatenate(blocks, axis=1)
        assert joined.shape == (len(frames), total * spf) and np.isfinite(joined).all()
        assert len(blocks) == -(-total // block_frames)
    assert len(blocks) == 1
    full = K.vocode(dev, cfg, g, frames, rng=torch.Generator(device=card).manual_seed(3))
    full = full[:, : total * spf].cpu().numpy()
    assert np.abs(joined - full).max() <= 2e-3 * max(1.0, np.abs(full).max())


# ── Piper and the effects chain (no hand kernel) ────────────────────────


def _piper(card):
    from open_speech_tpu_torch.models.piper import PiperConfig, PiperModel, init_piper_params

    cfg = PiperConfig(hidden=32, ffn_filter=64, n_layers=2, dp_filter=32, flow_layers=2,
                      upsample_rates=(4, 4), upsample_kernels=(8, 8), upsample_initial=64,
                      resblock_kernels=(3, 5), resblock_dilations=((1, 3), (1, 3)),
                      n_speakers=3, gin=8, max_phonemes=16, max_frames=64)
    host = init_piper_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    with torch.no_grad():  # live flows: VITS starts their post convolutions at zero
        for name, p in host.named_parameters():
            if name.startswith("flow.") and ".post." in name:
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(4)) * 0.05)
    dev = PiperModel.empty(cfg, card)
    dev.load_state_dict(host.state_dict())
    return cfg, host, dev


def test_piper_card_matches_cpu(card):
    """A small Piper with speakers on the card against the CPU, the same
    weights and host-drawn noise: n_frames equal, the audio within 1e-4.
    The process's cuDNN TF32 flag is left as it was found."""
    from open_speech_tpu_torch.models.piper import synthesize_vits

    cfg, host, dev = _piper(card)
    g = torch.Generator().manual_seed(5)
    ph = torch.randint(1, cfg.n_phonemes, (2, cfg.max_phonemes), generator=g)
    ph[1, 9:] = 0
    args = (ph, torch.tensor([16, 9]), torch.tensor([1, 2]), torch.tensor([1.0, 1.3]))
    noise = dict(dp_noise=torch.randn(2, 2, cfg.max_phonemes, generator=g) * cfg.noise_scale_w,
                 z_noise=torch.randn(2, cfg.hidden, cfg.max_frames, generator=g))
    flag = torch.backends.cudnn.allow_tf32
    want, n_want = synthesize_vits(host, cfg, *args, **noise)
    got, n_got = synthesize_vits(dev, cfg, *args, **noise)
    assert torch.backends.cudnn.allow_tf32 == flag
    assert got.device.type == "cuda" and torch.equal(n_got.cpu(), n_want)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_piper_batcher_rows_on_the_card_match_the_cpu(card):
    """The batcher's rows draw their noise on the host from their seeds, so
    a card row equals the CPU row."""
    from open_speech_tpu_torch.runtime.tts_batcher import _piper_rows

    cfg, host, dev = _piper(card)
    ph = torch.zeros(2, cfg.max_phonemes, dtype=torch.long)
    ph[0, :7], ph[1, :12] = torch.arange(1, 8), torch.arange(3, 15)
    args = (ph, torch.tensor([7, 12]), torch.tensor([0, 2]), torch.tensor([1.0, 0.9]), [11, 12])
    want, n_want = _piper_rows(host, cfg, *args)
    got, n_got = _piper_rows(dev, cfg, *args)
    assert torch.equal(n_got.cpu(), n_want) and (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("effect", [
    [{"type": "normalize"}], [{"type": "pitch", "semitones": 3}], [{"type": "reverb", "room": "large"}],
    [{"type": "podcast_eq"}], [{"type": "robot"}],
    [{"type": "podcast_eq"}, {"type": "pitch", "semitones": -2}, {"type": "reverb"}, {"type": "robot"},
     {"type": "normalize"}]])
def test_effects_on_the_card_match_the_cpu(card, effect):
    """Each effect and a chain on 3 s at 24 kHz: the card's samples within
    the CPU's (1e-5; pitch, and the chain through it, 2e-3: the phase
    vocoder's float32 cumulative phase sums in another order on the card)."""
    import numpy as np

    from open_speech_tpu_torch.audio.effects import apply_chain

    rng = np.random.default_rng(0)
    t = np.arange(72_000) / 24000
    x = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    want = apply_chain(x, 24000, effect, device="cpu")
    got = apply_chain(x, 24000, effect, device=card)
    tol = 1e-4 if any(e["type"] == "pitch" for e in effect) else 1e-5
    assert got.shape == want.shape and np.abs(got - want).max() <= tol


# ── the diarizer (no hand kernel) ───────────────────────────────────────

DIARIZE_FIXTURES = "tests/fixtures/diarize/"


def _speakers() -> "np.ndarray":
    """25 s of three harmonic 'speakers' (220, 520, 340 Hz), two at once
    for 3 s."""
    import numpy as np

    def voice(freq: float, seconds: float, seed: int):
        t = np.arange(int(16000 * seconds)) / 16000
        sig = sum((0.3 / k) * np.sin(2 * np.pi * freq * k * t) for k in range(1, 4))
        return sig + 0.02 * np.random.default_rng(seed).standard_normal(t.size)

    return np.concatenate([voice(220, 6, 1), voice(520, 6, 2), voice(220, 3, 7) + voice(520, 3, 8),
                           voice(340, 6, 5), voice(220, 4, 9)]).astype(np.float32)


def test_diarizer_stages_on_the_card_match_the_cpu(card):
    """The committed PyanNet and WeSpeaker fixtures, a small GE2E and the
    conv embedder on the card against the CPU: log-probs, fbank and
    embeddings within relative L2 1e-4. The process's cuDNN TF32 flag is
    left as it was found."""
    from open_speech_tpu_torch.models import diarize as D
    from open_speech_tpu_torch.models import ge2e as G
    from open_speech_tpu_torch.models import segmentation as S
    from open_speech_tpu_torch.models import wespeaker as W
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram

    def rel(got, want):
        return ((got.cpu() - want).norm() / want.norm()).item()

    audio = torch.from_numpy(_speakers())
    flag = torch.backends.cudnn.allow_tf32
    chunks = torch.stack([audio[:160000], audio[80000:240000]])
    host, _ = S.convert_segmentation(DIARIZE_FIXTURES + "segmentation.bin", device="cpu")
    dev, _ = S.convert_segmentation(DIARIZE_FIXTURES + "segmentation.bin", device=card)
    assert rel(S.segment_chunks(dev, chunks), S.segment_chunks(host, chunks)) <= 1e-4
    windows = torch.stack([audio[i * 12000 : i * 12000 + 24000] for i in range(8)])
    fb = W.kaldi_fbank(windows)
    assert rel(W.kaldi_fbank(windows.to(card)), fb) <= 1e-4
    host, _ = W.convert_wespeaker(DIARIZE_FIXTURES + "wespeaker.bin", device="cpu")
    dev, _ = W.convert_wespeaker(DIARIZE_FIXTURES + "wespeaker.bin", device=card)
    assert rel(W.wespeaker_embed(dev, fb.to(card)), W.wespeaker_embed(host, fb)) <= 1e-4
    cfg = G.GE2EConfig(hidden=64, embed_dim=32)
    mels = G.ge2e_mel(windows)
    host = G.init_ge2e_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    dev = G.init_ge2e_params(torch.Generator().manual_seed(1), cfg, device=card)
    assert rel(G.ge2e_embed(dev, mels.to(card)), G.ge2e_embed(host, mels)) <= 1e-4
    lm = log_mel_spectrogram(windows, n_mels=80)[..., :150]
    host, dev = D.init_diarizer_params(device="cpu"), D.init_diarizer_params(device=card)
    assert rel(D.embed_windows(dev, lm.to(card)), D.embed_windows(host, lm)) <= 1e-4
    assert torch.backends.cudnn.allow_tf32 == flag


@pytest.mark.parametrize("pipeline", ["segmented", "energy-gated"])
def test_diarized_turns_on_the_card_equal_the_cpu(card, monkeypatch, tmp_path, pipeline):
    """The whole diarization on the card: the fixtures' segmented path
    (least powerset margin on this clip ~0.08) and the energy-gated conv
    embedder give the CPU's turns."""
    from open_speech_tpu_torch.models.diarize import TorchDiarizer

    for var in ("OS_SEGMENTATION_CKPT_PATH", "OS_WESPEAKER_CKPT_PATH", "OS_DIARIZER_CKPT_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    if pipeline == "segmented":
        monkeypatch.setenv("OS_SEGMENTATION_CKPT_PATH", DIARIZE_FIXTURES + "segmentation.bin")
        monkeypatch.setenv("OS_WESPEAKER_CKPT_PATH", DIARIZE_FIXTURES + "wespeaker.bin")
    audio = _speakers()
    dev, host = TorchDiarizer(device=card), TorchDiarizer(device="cpu")
    assert (dev.seg is not None) == (pipeline == "segmented")
    want = host.diarize_audio(audio)
    assert want and dev.diarize_audio(audio) == want
