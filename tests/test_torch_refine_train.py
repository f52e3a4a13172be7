"""Port's refine-head training path vs the JAX package, f32 on the CPU.

* The training forward's outputs ``(out, pre, a2)`` (the port's plain
  version) against the JAX ``_fwd_pallas(save_residuals=True)`` in
  interpret mode.
* All seven gradients (dy, dW1, db1, dW2, db2, dgamma, dbeta) of the
  port's ``fused_refine_head`` under ``torch.autograd`` (its
  ``autograd.Function`` with the plain forward and backward on the CPU)
  against ``jax.vjp`` of the JAX ``fused_refine_head``, at the shapes of
  ``tests/test_torch_refine_head.py``.
* The plain backward against ``torch.autograd`` of the plain forward.

Tolerances: forward atol 5e-5 (each conv output sums 1152 products in
another order); gradients atol = rtol = 1e-4 (the parameter gradients
sum every pixel's contribution, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import fused_refine_head as jax_frh
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_refine_head

NAMES = ("y", "w1", "b1", "w2", "b2", "gamma", "beta")
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_frh, "INTERPRET", True)


def _inputs(b, ht, wt, c=128, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randn(b, ht, wt, 16 * c).astype(np.float32) * 0.5
    w1 = rng.randn(3, 3, c, c).astype(np.float32) * 0.05
    b1 = rng.randn(c).astype(np.float32) * 0.1
    w2 = rng.randn(3, 3, c, c).astype(np.float32) * 0.05
    b2 = rng.randn(c).astype(np.float32) * 0.1
    g = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    be = (0.1 * rng.randn(c)).astype(np.float32)
    return [y, w1, b1, w2, b2, g, be]


def _torch(arrays):
    """Torch tensors, conv weights HWIO -> OIHW."""
    out = [torch.from_numpy(a.copy()) for a in arrays]
    for i in (1, 3):
        out[i] = out[i].permute(3, 2, 0, 1).contiguous()
    return out


@pytest.mark.parametrize("b,ht,wt", [(2, 8, 8), (3, 4, 8)])
def test_training_forward_matches_jax(b, ht, wt):
    arrs = _inputs(b, ht, wt)
    want = jax_frh._fwd_pallas(*map(jnp.asarray, arrs), save_residuals=True)
    got = fused_refine_head.refine_head_res_reference(*_torch(arrs))
    for g, w, name in zip(got, want, ("out", "pre", "a2")):
        assert g.shape == (b, 4 * ht, 4 * wt, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=0, err_msg=name)


def test_gradients_match_jax_vjp():
    arrs = _inputs(2, 8, 8, seed=1)
    dout = np.random.RandomState(2).randn(2, 32, 32, 128).astype(np.float32)
    _, vjp = jax.vjp(jax_frh.fused_refine_head, *map(jnp.asarray, arrs))
    want = list(vjp(jnp.asarray(dout)))
    for i in (1, 3):  # HWIO -> OIHW
        want[i] = np.asarray(want[i]).transpose(3, 2, 0, 1)
    t = [a.requires_grad_() for a in _torch(arrs)]
    out = fused_refine_head.fused_refine_head(*t)
    out.backward(torch.from_numpy(dout))
    for ti, w, name in zip(t, want, NAMES):
        assert ti.grad.dtype == torch.float32
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_plain_backward_matches_autograd():
    t = [a.requires_grad_() for a in _torch(_inputs(1, 4, 4, seed=3))]
    out, pre, a2 = fused_refine_head.refine_head_res_reference(*t)
    dout = torch.from_numpy(np.random.RandomState(4).randn(*out.shape).astype(np.float32))
    want = torch.autograd.grad(out, t, dout)
    got = fused_refine_head.refine_head_bwd_reference(
        t[0].detach(), pre.detach(), a2.detach(), dout, t[1].detach(), t[3].detach(),
        t[5].detach())
    order = (0, 1, 2, 3, 4, 5, 6)  # dy, dw1, db1, dw2, db2, dgamma, dbeta
    for i, g in zip(order, got):
        np.testing.assert_allclose(g.numpy(), want[i].numpy(), err_msg=NAMES[i], **GRAD_TOL)
