"""Fine-tuning: the port's ``train.py`` against ``open_speech_tpu.train``.

Both packages run test-tiny in float32 on the CPU with the weights of
``init_params(PRNGKey(0))`` (carried over with ``params_from_jax_tree``)
and ``tests/test_train.py``'s numpy-seeded ``_batch()``. The loss must
agree within relative 1e-5 and every gradient within relative L2 1e-4
(JAX's gradient tree has the parameters' structure, so it converts with
the same function; the encoder's ``pos`` is among them): the two sides sum
the same float32 products in different orders. After one AdamW step the
parameters must agree as set out in ``test_one_adamw_step_matches_optax``.

The attention's gradient: ``flash_attention_backward_reference`` against
autograd of ``flash_attention_reference`` in float64, and
``torch.autograd.gradcheck`` of ``FlashAttentionFn`` (the CPU's plain
forward and backward). The CUDA kernels are held against the same
reference on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 18).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu import train as JT
from open_speech_tpu.models.whisper import model as JM
from open_speech_tpu_torch import train as TT
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.models.whisper.convert import params_from_jax_tree
from open_speech_tpu_torch.models.whisper.quantize import quantize_whisper_params
from open_speech_tpu_torch.ops import attention as TA
from open_speech_tpu_torch.runtime.checkpoint import load_params, save_params
from tests.test_train import _batch

CFG = JM.PRESETS["test-tiny"]
TCFG = TM.PRESETS["test-tiny"]
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: under the suite's six workers a
    full pool per worker made its small CPU ops wait on spinning threads
    (about 15 s alone, 158 s in a full run; 33 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params():
    return JM.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)


def _port(params) -> TM.Whisper:
    return params_from_jax_tree(jax.tree.map(np.asarray, params), TCFG)


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves(model: TM.Whisper) -> dict[str, torch.Tensor]:
    """JAX's leaf set by the port's names: the parameters and encoder.pos."""
    return {**dict(model.named_parameters()), "encoder.pos": model.encoder.pos}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def jax_grads():
    params, batch = _jax_params(), _batch()
    loss, grads = jax.value_and_grad(JT.loss_fn)(params, batch, CFG)
    return params, batch, float(loss), grads


# ── JAX's three tests, on the port ──────────────────────────────────────


def test_loss_is_finite_scalar():
    loss = TT.loss_fn(_port(_jax_params()), _torch_batch(_batch()), TCFG)
    assert loss.shape == ()
    assert np.isfinite(float(loss))
    assert abs(float(loss) - np.log(TCFG.n_vocab)) < 2.0  # random model ~ uniform


def test_train_step_reduces_loss():
    model = _port(_jax_params())
    opt = TT.make_optimizer(model, lr=LR)
    TT.init_train_state(model, opt)
    batch = _torch_batch(_batch())
    losses = [float(TT.train_step(model, opt, batch, TCFG)) for _ in range(5)]
    assert losses[-1] < losses[0]  # overfits a fixed batch


def test_mask_excludes_padding():
    model = _port(_jax_params())
    batch = _torch_batch(_batch())
    full = float(TT.loss_fn(model, batch, TCFG))
    mask = batch["mask"].clone()
    mask[:, 4:] = 0
    partial = float(TT.loss_fn(model, {**batch, "mask": mask}, TCFG))
    assert partial != full and np.isfinite(partial)
    empty = float(TT.loss_fn(model, {**batch, "mask": torch.zeros_like(mask)}, TCFG))
    assert empty == 0.0  # the mean over max(sum(mask), 1)


# ── against JAX ─────────────────────────────────────────────────────────


def test_loss_and_every_gradient_match_jax(jax_grads):
    params, batch, want_loss, grads = jax_grads
    model = _port(params)
    leaves = _leaves(model)
    for t in TT.trainable_params(model):
        assert t.requires_grad
    loss = TT.loss_fn(model, _torch_batch(batch), TCFG)
    loss.backward()
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)
    want = _leaves(_port(grads))
    assert set(leaves) == set(want) and "encoder.pos" in leaves
    for name, t in leaves.items():
        assert t.grad is not None, name
        err = _rel_l2(t.grad, want[name])
        assert err <= 1e-4, f"{name}: relative L2 {err:.3e}"
    assert float(leaves["encoder.pos"].grad.abs().sum()) > 0


def test_one_adamw_step_matches_optax(jax_grads):
    """One step moves each leaf by about -lr * sign(g) - lr * wd * p
    (m_hat = g, v_hat = g^2 at step 1), so a gradient element near 0 flips
    the update. Where |g_jax| > 1e-6 the new value must agree within 1e-6;
    where it is smaller, within 2 * lr (the most two updates can differ)."""
    params, batch, _, grads = jax_grads
    opt = JT.make_optimizer(lr=LR)
    state = JT.init_train_state(params, opt)
    new_params, _, _ = JT.train_step(jax.tree.map(jnp.array, params), state, batch, CFG, opt)
    model = _port(params)
    topt = TT.make_optimizer(model, lr=LR)
    TT.train_step(model, topt, _torch_batch(batch), TCFG)
    got, want, g = _leaves(model), _leaves(_port(new_params)), _leaves(_port(grads))
    for name, t in got.items():
        tol = torch.where(g[name].abs() > 1e-6, 1e-6, 2 * LR)
        diff = (t.detach() - want[name]).abs()
        assert bool((diff <= tol).all()), f"{name}: max diff {float(diff.max()):.3e}"


def test_int8_model_is_refused():
    model = quantize_whisper_params(_port(_jax_params()))
    with pytest.raises(ValueError, match="int8"):
        TT.make_optimizer(model)


def test_serving_builds_no_graph():
    model = TM.init_params(torch.Generator().manual_seed(0), TCFG)
    mel = torch.randn(1, TCFG.n_mels, 2 * TCFG.n_audio_ctx)
    enc = TM.encode(model, mel, TCFG)
    logits = TM.decoder_forward(model, torch.zeros(1, 3, dtype=torch.long), enc, TCFG)
    assert not enc.requires_grad and not logits.requires_grad


# ── the attention's gradient ────────────────────────────────────────────

# (B, H, Tq, Tk, D, causal): causal with Tq < Tk, causal with Tq > Tk (the
# first Tq - Tk rows see no key), non-causal rectangular
GRAD_CASES = [
    (2, 2, 5, 9, 8, True),
    (1, 2, 9, 5, 8, True),
    (2, 1, 6, 11, 4, False),
]


def _qkv(b, h, t_q, t_k, d, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)) for s in
            ((b, h, t_q, d), (b, h, t_k, d), (b, h, t_k, d), (b, h, t_q, d))]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", GRAD_CASES)
def test_backward_reference_equals_autograd_of_the_reference(b, h, t_q, t_k, d, causal):
    q, k, v, d_out = _qkv(b, h, t_q, t_k, d)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = TA.flash_attention_reference(*leaves, causal=causal)
    out.backward(d_out)
    got = TA.flash_attention_backward_reference(q, k, v, d_out, causal=causal)
    for name, g, t in zip("qkv", got, leaves):
        torch.testing.assert_close(g, t.grad, atol=1e-10, rtol=0, msg=name)
    if t_q > t_k and causal:
        assert not got[0][:, :, : t_q - t_k].any(), "rows with no key have no gradient"


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal", GRAD_CASES)
def test_flash_attention_fn_passes_gradcheck(b, h, t_q, t_k, d, causal):
    q, k, v, _ = _qkv(b, h, t_q, t_k, d, seed=1)
    inputs = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: TA.FlashAttentionFn.apply(q, k, v, causal, 0.7), inputs)


def test_flash_attention_routes_gradients_and_refuses_k2():
    q, k, v, _ = _qkv(1, 2, 4, 6, 8)
    q.requires_grad_(True)
    before = dict(TA.launches)
    out = TA.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.sum().backward()
    assert TA.launches == before, "the plain versions on the CPU launch nothing"
    with torch.no_grad():
        assert TA.flash_attention(q, k, v).grad_fn is None
    with pytest.raises(TA.FlashAttentionGradError):
        TA.flash_attention(q, k, v, kv_length=torch.tensor([3]))


# ── checkpoints ─────────────────────────────────────────────────────────


def test_checkpoint_round_trip_is_exact_and_overwrites(tmp_path):
    model = _port(_jax_params())
    opt = TT.make_optimizer(model, lr=LR)
    path = tmp_path / "ckpt" / "params.pt"
    save_params(path, model)
    TT.train_step(model, opt, _torch_batch(_batch()), TCFG)
    save_params(path, model)  # overwrites
    state = load_params(path)
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(state[name], t), name
    fresh = load_params(path, like=_port(_jax_params()))
    for name, t in _leaves(model).items():
        assert torch.equal(_leaves(fresh)[name], t), name
    assert sorted(p.name for p in path.parent.iterdir()) == ["params.pt"]
