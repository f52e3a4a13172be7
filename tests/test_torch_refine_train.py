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
* At ``(1, 3, 6)``, an odd number of token rows, which the JAX kernel's
  gate does not take: the training forward and all seven gradients against
  the JAX composed head and its ``jax.vjp``.
* The pure-Python functions that size and lay out what the CUDA kernels
  read: the partial-sum counts at a ragged shape against counts worked out
  by hand, and the two conv-weight layouts against their index formulas.

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
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import patch_ops as jax_patch_ops
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_refine_head

NAMES = ("y", "w1", "b1", "w2", "b2", "gamma", "beta")
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_frh, "INTERPRET", True)


@pytest.fixture(autouse=True)
def _one_thread():
    """oneDNN splits the conv weight gradient's float32 sum over its
    threads, and not the same way in every process (two of eight processes
    gave dW 1e-3 away from the others, against an atol of 1e-4).  With one
    thread the order of the sum is fixed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_composed(y, w1, b1, w2, b2, g, be):
    """The JAX composed head: ``(out, pre, a2)``."""
    dn = ("NHWC", "HWIO", "NHWC")
    x = jax_patch_ops.depth_to_space(jax.nn.gelu(y, approximate=True), 4)
    pre = jax.lax.conv_general_dilated(x, w1, (1, 1), "SAME", dimension_numbers=dn) + b1
    a2 = jax.lax.conv_general_dilated(jax.nn.gelu(pre, approximate=True), w2, (1, 1), "SAME",
                                      dimension_numbers=dn) + b2
    mu = jnp.mean(a2, -1, keepdims=True)
    va = jnp.mean(a2 * a2, -1, keepdims=True) - mu * mu
    return (a2 - mu) * jax.lax.rsqrt(va + jax_frh.LN_EPS) * g + be, pre, a2


def test_training_forward_odd_rows_matches_jax_composed():
    arrs = _inputs(1, 3, 6, seed=5)
    assert not jax_frh.supported(arrs[0].shape, True)
    want = _jax_composed(*map(jnp.asarray, arrs))
    got = fused_refine_head.refine_head_res_reference(*_torch(arrs))
    for g, w, name in zip(got, want, ("out", "pre", "a2")):
        assert g.shape == (1, 12, 24, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=0, err_msg=name)


def test_gradients_odd_rows_match_jax_composed_vjp():
    arrs = _inputs(1, 3, 6, seed=6)
    dout = np.random.RandomState(7).randn(1, 12, 24, 128).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _jax_composed(*a)[0], *map(jnp.asarray, arrs))
    want = list(vjp(jnp.asarray(dout)))
    for i in (1, 3):  # HWIO -> OIHW
        want[i] = np.asarray(want[i]).transpose(3, 2, 0, 1)
    t = [a.requires_grad_() for a in _torch(arrs)]
    fused_refine_head.fused_refine_head(*t).backward(torch.from_numpy(dout))
    for ti, w, name in zip(t, want, NAMES):
        np.testing.assert_allclose(ti.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("dtype,want", [
    # (3, 52, 84) output pixels, y (3, 13, 21, 2048).  bfloat16 conv tiles are
    # 8 x 16 pixels: ceil(52/8) = 7 by ceil(84/16) = 6, 42 an image, 126;
    # float32 blocks are 64-pixel row segments: ceil(84/64) = 2 a row, 52
    # rows, 104 an image, 312.  LayerNorm-backward blocks of 256 pixels:
    # 3*52*84 = 13104 = 51*256 + 48, so 52.  Weight-gradient chunks of 32
    # of the 3*52 = 156 pixel rows: 4*32 + 28, so 5.
    (torch.bfloat16, (126, 52, 5)),
    (torch.float32, (312, 52, 5)),
])
def test_partial_counts_ragged(dtype, want):
    assert fused_refine_head.partial_counts(3, 52, 84, dtype) == want


def test_partial_counts_smallest():
    # one token row of three tokens: (1, 4, 12) pixels, every tile ragged
    assert fused_refine_head.partial_counts(1, 4, 12, torch.bfloat16) == (1, 1, 1)
    assert fused_refine_head.partial_counts(1, 4, 12, torch.float32) == (4, 1, 1)


@pytest.mark.parametrize("transposed", [False, True])
def test_conv_weight_layouts(transposed):
    """float32: (kh, kw, Cin, Cout); bfloat16: (kh, kw, Cout, Cin); the
    transposed conv's weight has the taps flipped and in/out swapped."""
    rng = np.random.RandomState(8)
    w = torch.from_numpy(rng.randn(5, 7, 3, 3).astype(np.float32))  # (Cout, Cin, 3, 3)
    f32 = fused_refine_head._conv_weight(w, torch.float32, transposed)
    b16 = fused_refine_head._conv_weight(w, torch.bfloat16, transposed)
    cin, cout = (5, 7) if transposed else (7, 5)
    assert f32.shape == (3, 3, cin, cout) and f32.dtype == torch.float32
    assert b16.shape == (3, 3, cout, cin) and b16.dtype == torch.bfloat16
    assert f32.is_contiguous() and b16.is_contiguous()
    for u, v, ci, co in [(0, 0, 0, 0), (2, 1, 3, 4), (1, 2, 4, 2), (0, 2, 1, 3)]:
        ref = w[ci, co, 2 - u, 2 - v] if transposed else w[co, ci, u, v]
        assert f32[u, v, ci, co] == ref
        assert b16[u, v, co, ci] == ref.bfloat16()
