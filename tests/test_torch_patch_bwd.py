"""Port's patch merge / expand backwards vs the JAX package, f32 on the CPU.

* Every cotangent of the port's ``fused_patch_merge`` / ``fused_patch_expand``
  (``autograd.Function``s running their plain forward and backward on the
  CPU) against ``jax.vjp`` of the JAX ``fused_patch_merge`` /
  ``fused_patch_expand`` with the Pallas kernels in interpret mode, at
  ``tests/test_torch_patch.py``'s shapes plus Swin-T widths (merge C = 96,
  expand C = 192 and 384), shapes whose rows are ragged against the card
  kernels' tiles, and widths the card routes to its CUDA-core kernels.
* Each plain backward against ``torch.autograd`` of its plain forward.
* The weight gradient of a bfloat16 call is rounded to bfloat16 on its way
  to the float32 parameter, as the JAX package's ``dw.astype(w.dtype)``
  of the weight cast to the compute dtype.

Tolerance: atol = rtol = 1e-4 (the parameter gradients sum every row's
contribution, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import fused_patch as jax_fp
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_patch

TOL = dict(atol=1e-4, rtol=1e-4)
# the last rows: shapes whose rows are ragged against the card's row tiles
# and split-K chunks, and widths the routing sends to the CUDA-core kernels
# (merge C = 48, expand C = 128)
MERGE = [(2, 8, 8, 128), (1, 4, 6, 128), (2, 4, 4, 256), (1, 2, 2, 256), (2, 4, 4, 96),
         (1, 6, 10, 128), (1, 2, 2, 512), (1, 4, 4, 48)]
EXPAND = [(2, 4, 4, 256), (1, 3, 5, 256), (2, 2, 2, 512), (1, 1, 1, 512), (2, 4, 4, 192),
          (1, 2, 2, 384), (1, 1, 1, 1024), (1, 2, 2, 128)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fp, "INTERPRET", True)


def _arrays(seed, x_shape, w_shape, ln_dim, dy_shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32) * 0.5
    w = rng.standard_normal(w_shape).astype(np.float32) * 0.05
    sc = (1 + 0.1 * rng.standard_normal(ln_dim)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(ln_dim)).astype(np.float32)
    dy = rng.standard_normal(dy_shape).astype(np.float32)
    return x, w, sc, lb, dy


def _merge_arrays(shape, seed=0):
    b, h, w, c = shape
    return _arrays(seed, shape, (4 * c, 2 * c), 4 * c, (b, h // 2, w // 2, 2 * c))


def _expand_arrays(shape, seed=1):
    b, h, w, c = shape
    return _arrays(seed, shape, (c, 2 * c), c // 2, (b, 2 * h, 2 * w, c // 2))


def _leaves(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


@pytest.mark.parametrize("shape", MERGE)
def test_merge_vjp_matches_jax(shape):
    x, w, sc, lb, dy = _merge_arrays(shape)
    _, vjp = jax.vjp(jax_fp.fused_patch_merge, *map(jnp.asarray, (x, sc, lb, w)))
    want = vjp(jnp.asarray(dy))
    tx, tsc, tlb, tw = _leaves(x, sc, lb, w.T)
    fused_patch.fused_patch_merge(tx, tsc, tlb, tw).backward(torch.from_numpy(dy))
    for got, w_, name in ((tx.grad, want[0], "dx"), (tsc.grad, want[1], "dscale"),
                          (tlb.grad, want[2], "dbias"), (tw.grad.T, want[3], "dweight")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", EXPAND)
def test_expand_vjp_matches_jax(shape):
    x, w, sc, lb, dy = _expand_arrays(shape)
    _, vjp = jax.vjp(jax_fp.fused_patch_expand, *map(jnp.asarray, (x, w, sc, lb)))
    want = vjp(jnp.asarray(dy))
    tx, tw, tsc, tlb = _leaves(x, w.T, sc, lb)
    fused_patch.fused_patch_expand(tx, tw, tsc, tlb).backward(torch.from_numpy(dy))
    for got, w_, name in ((tx.grad, want[0], "dx"), (tw.grad.T, want[1], "dweight"),
                          (tsc.grad, want[2], "dscale"), (tlb.grad, want[3], "dbias")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", [(2, 4, 6, 96), (1, 8, 8, 128)])
def test_merge_plain_backward_matches_autograd(shape):
    x, w, sc, lb, dy = _merge_arrays(shape, seed=2)
    t = _leaves(x, sc, lb, w.T)
    out = fused_patch.patch_merge_reference(*t)
    want = torch.autograd.grad(out, t, torch.from_numpy(dy))
    got = fused_patch.patch_merge_bwd_reference(
        t[0].detach(), torch.from_numpy(dy), *(a.detach() for a in t[1:]))
    for g, w_, name in zip(got, want, ("dx", "dscale", "dbias", "dweight")):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", [(2, 3, 4, 192), (1, 2, 2, 256)])
def test_expand_plain_backward_matches_autograd(shape):
    x, w, sc, lb, dy = _expand_arrays(shape, seed=3)
    t = _leaves(x, w.T, sc, lb)
    out = fused_patch.patch_expand_reference(*t)
    want = torch.autograd.grad(out, t, torch.from_numpy(dy))
    got = fused_patch.patch_expand_bwd_reference(
        t[0].detach(), torch.from_numpy(dy), t[1].detach(), t[2].detach())
    for g, w_, name in zip(got, want, ("dx", "dweight", "dscale", "dbias")):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("op", ["merge", "expand"])
def test_bf16_weight_gradient_is_rounded_to_bf16(op):
    shape = (1, 4, 4, 96) if op == "merge" else (1, 2, 2, 192)
    x, w, sc, lb, dy = (_merge_arrays if op == "merge" else _expand_arrays)(shape)
    tx = torch.from_numpy(x).bfloat16()
    tw, tsc, tlb = _leaves(w.T, sc, lb)
    tdy = torch.from_numpy(dy).bfloat16()
    if op == "merge":
        out = fused_patch.fused_patch_merge(tx, tsc, tlb, tw)
        raw = fused_patch.patch_merge_bwd(tx, tdy, tsc.detach(), tlb.detach(), tw.detach())[3]
    else:
        out = fused_patch.fused_patch_expand(tx, tw, tsc, tlb)
        raw = fused_patch.patch_expand_bwd(tx, tdy, tw.detach(), tsc.detach())[1]
    assert out.dtype == torch.bfloat16
    out.backward(tdy)
    assert tw.grad.dtype == torch.float32 and tsc.grad.dtype == torch.float32
    assert torch.equal(tw.grad, raw.bfloat16().float())
    assert not torch.equal(raw, raw.bfloat16().float())


def test_dw_chunk_rows_cover_every_row():
    for m, k, n in ((32768, 512, 256), (2048, 2048, 1024), (32768, 384, 192), (7, 64, 128)):
        rows = fused_patch.dw_chunk_rows(m, k, n)
        chunks = -(-m // rows)
        assert rows % 16 == 0 and rows * chunks >= m and rows * (chunks - 1) < m
