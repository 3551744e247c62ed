"""K1's backward on the CPU: the plain version against JAX, and a model of
the Hopper kernel's numerics.

(a) ``flash_attention_backward_reference`` against ``jax.vjp`` of the JAX
package's ``mha_reference`` in float32 on numpy-seeded inputs: causal
Tq < Tk, causal Tq > Tk (rows with no key get no gradient), rectangular
non-causal, D 32 and 64, an explicit scale. Tolerance 1e-5 of
max(max|ref|, 1): the two sum the same float32 products in different
orders (XLA's einsums and softmax against PyTorch's matmuls).

(b) The bf16 kernels (``kernels/csrc/flash_attention_bwd.cu``) feed P and
dS to the tensor cores as two bf16 operands each, hi = rn(x) and
lo = rn(x - hi), and accumulate in f32; q, k, v and dO are bf16 already.
``_split_backward`` is that arithmetic in plain PyTorch. Held to the bound
of ``tests/test_torch_cuda.py``'s ``_grad_close`` and ``chip_smoke.py``
18a (each element within half a bf16 ulp of the f32 gradient plus 1e-4 of
max|ref|), it passes, and the bf16-P control (P and dS rounded once, as a
plain bf16 MMA takes them) fails: this is why the kernel splits, and the
test fails if the split loses its ``lo`` half.

(c) The float32 kernels take q, k, v and dO as three bf16 pieces each
(``split_operands_reference``), split S-derived P and dS in registers the
same way, and run every product as six piece products (hh, hm, mh, mm,
hl, lh) accumulated in f32. ``_split_backward(..., f32=True)`` is that
arithmetic; against ``jax.vjp`` of the JAX package's ``mha_reference`` it
meets the float32 gate of ``_grad_close`` and 18a (1e-4 of max(max|ref|,
1)) with a margin of at least 10x, and the controls (one bf16 piece per
operand; each operand rounded once to TF32) fail it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.ops.attention import mha_reference as jax_mha_reference
from open_speech_tpu_torch.ops import attention as TA

# the bf16 bound of _grad_close and 18a, over max|ref|
BF16_EXCESS = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in ``test_torch_train.py``: under the suite's
    six workers a full pool per worker makes small CPU ops spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, t_q, t_k, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, h, t_q, d), (b, h, t_k, d), (b, h, t_k, d), (b, h, t_q, d))]


# (B, H, Tq, Tk, D, causal, scale)
JAX_CASES = [
    (1, 2, 37, 100, 64, True, None),
    (2, 2, 100, 37, 64, True, None),
    (1, 3, 65, 129, 64, False, None),
    (1, 2, 60, 60, 32, True, None),
    (2, 2, 7, 60, 32, False, 0.3),
]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,scale", JAX_CASES)
def test_backward_reference_matches_jax_vjp(b, h, t_q, t_k, d, causal, scale):
    q, k, v, d_out = _inputs(b, h, t_q, t_k, d, seed=t_q + t_k)
    _, vjp = jax.vjp(lambda q, k, v: jax_mha_reference(q, k, v, causal=causal, scale=scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(d_out))]
    got = TA.flash_attention_backward_reference(
        *(torch.from_numpy(t) for t in (q, k, v, d_out)), causal=causal, scale=scale)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1.0), f"d{name}: {err:.3e}"
    if causal and t_q > t_k:  # rows before the first visible key
        assert not got[0][:, :, : t_q - t_k].any() and not want[0][:, :, : t_q - t_k].any()


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x as the kernel feeds it to wgmma: hi = rn(x), lo = rn(x - hi), both
    bf16-valued, in f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


# the float32 kernels' six piece products (A's piece, B's piece)
SPLIT_PRODUCTS = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0)]
F32_GATE = 1e-4  # of max(max|ref|, 1): _grad_close's and 18a's float32 bound


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _matmul3(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b as the float32 kernels take it ("split": the six products of
    a's and b's three bf16 pieces, summed in f32), or a control: one bf16
    piece each ("one"), each operand rounded to TF32 once ("tf32")."""
    if mode == "tf32":
        return torch.matmul(_tf32(a), _tf32(b))
    pa, pb = (TA.split_operands_reference(x.contiguous()).float() for x in (a, b))
    pairs = SPLIT_PRODUCTS if mode == "split" else [(0, 0)]
    return sum(torch.matmul(pa[i], pb[j]) for i, j in pairs)


def _split_backward(q, k, v, d_out, causal, *, split=True, f32=False, mode="split"):
    """The kernel's arithmetic on bf16-valued inputs: every product in f32
    with P and dS as the sum of their two bf16 halves (``split``), or
    rounded once to bf16 (the bf16-P control); outputs in bf16. With
    ``f32`` the float32 kernels' arithmetic on float32 inputs instead,
    every product through ``_matmul3`` (``mode``), outputs in float32."""
    if f32:
        return _split_backward_f32(q, k, v, d_out, causal, mode)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, d_out))
    scale = q.shape[-1] ** -0.5
    p = TA._probs(qf, kf, causal, scale=scale)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    p_parts = _split(p) if split else (p.bfloat16().float(),)
    ds_parts = _split(ds) if split else (ds.bfloat16().float(),)
    dv = sum(torch.matmul(x.transpose(-1, -2), gf) for x in p_parts)
    dq = sum(torch.matmul(x, kf) for x in ds_parts) * scale
    dk = sum(torch.matmul(x.transpose(-1, -2), qf) for x in ds_parts) * scale
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def _split_backward_f32(q, k, v, d_out, causal, mode):
    """``_split_backward``'s float32 arithmetic: S and dP of the pieces, P =
    2^(S' - lse2) and delta = rowsum(P dP) in f32, dS = P (dP - delta),
    then dV = P^T dO, dK = dS^T Q and dQ = dS K of the pieces."""
    scale = q.shape[-1] ** -0.5
    t_q, t_k = q.shape[2], k.shape[2]
    s = _matmul3(q, k.transpose(-1, -2), mode) * scale
    if causal:
        s = torch.where(torch.arange(t_k)[None, :] <= torch.arange(t_q)[:, None] + (t_k - t_q), s, -torch.inf)
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(mx == -torch.inf, 0.0, mx))
    l = e.sum(dim=-1, keepdim=True)
    p = e * torch.where(l > 0, 1.0 / l, 0.0)
    dp = _matmul3(d_out, v.transpose(-1, -2), mode)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = _matmul3(ds, k, mode) * scale
    dk = _matmul3(ds.transpose(-1, -2), q, mode) * scale
    dv = _matmul3(p.transpose(-1, -2), d_out, mode)
    return dq, dk, dv


def _beyond_bf16_rounding(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max(|got - ref| - half a bf16 ulp of ref) over max|ref|: 18a's and
    ``_grad_close``'s measure."""
    _, exp = torch.frexp(ref)  # |ref| in [2^(exp-1), 2^exp): bf16's ulp there is 2^(exp-8)
    half_ulp = torch.ldexp(torch.ones_like(ref), exp - 9) * (ref != 0)
    excess = ((got.float() - ref).abs() - half_ulp).clamp_min(0).max().item()
    return excess / ref.abs().max().item()


# (B, H, Tq, Tk, D, causal): the encoder's square at 512, causal self
# attention, a cross attention over 512 keys, D 32
SPLIT_CASES = [
    (1, 2, 512, 512, 64, False),
    (1, 2, 256, 256, 64, True),
    (2, 2, 64, 512, 64, False),
    (1, 2, 256, 256, 32, False),
]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", SPLIT_CASES)
def test_split_operands_meet_the_bf16_bound_and_rounded_ones_do_not(b, h, t_q, t_k, d, causal):
    q, k, v, d_out = (torch.from_numpy(t).bfloat16() for t in _inputs(b, h, t_q, t_k, d, seed=d + t_k))
    want = TA.flash_attention_backward_reference(*(t.float() for t in (q, k, v, d_out)), causal=causal)
    split = _split_backward(q, k, v, d_out, causal)
    control = _split_backward(q, k, v, d_out, causal, split=False)
    for name, s, c, w in zip("qkv", split, control, want):
        assert _beyond_bf16_rounding(s, w) <= BF16_EXCESS / 10, f"d{name}: the split"
        assert _beyond_bf16_rounding(c, w) > BF16_EXCESS, f"d{name}: the bf16-P control"


# (B, H, Tq, Tk, D, causal): the encoder's square at 512, causal self
# attention with Tq < Tk and Tq > Tk (rows with no key), a cross attention
# over 512 keys, D 32
F32_CASES = [
    (1, 2, 512, 512, 64, False),
    (1, 2, 100, 256, 64, True),
    (2, 2, 256, 100, 64, True),
    (2, 2, 64, 512, 64, False),
    (1, 2, 256, 256, 32, False),
]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", F32_CASES)
def test_f32_split_backward_meets_the_f32_gate_and_the_controls_do_not(b, h, t_q, t_k, d, causal):
    q, k, v, d_out = _inputs(b, h, t_q, t_k, d, seed=3 * t_q + t_k)
    _, vjp = jax.vjp(lambda q, k, v: jax_mha_reference(q, k, v, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(d_out))]
    tensors = [torch.from_numpy(t) for t in (q, k, v, d_out)]
    worst = {}
    for mode in ("split", "one", "tf32"):
        got = _split_backward(*tensors, causal, f32=True, mode=mode)
        worst[mode] = max(np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1.0) for g, w in zip(got, want))
    assert worst["split"] <= F32_GATE / 10, f"the split arithmetic: {worst['split']:.3e}"
    assert worst["one"] > F32_GATE and worst["tf32"] > F32_GATE, f"a control passes: {worst}"

