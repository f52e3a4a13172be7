"""Port's refine head vs the JAX package's fused kernel, f32 on the CPU.

The port's kernel wrapper (its plain version on the CPU) is held against
``fused_refine_head`` with the Pallas kernel in interpret mode, on the
shapes of ``tests/test_fused_refine_head.py``.  Tolerance: atol 5e-5,
because each conv output sums 1152 products in another order.

An odd number of token rows, ``(1, 3, 6)``, lies outside the JAX kernel's
gate (``supported`` wants two token rows a tile), so there the port is
held against the JAX composed head (GELU, depth-to-space, two convs,
LayerNorm), same tolerance for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import fused_refine_head as jax_frh
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import patch_ops as jax_patch_ops
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_refine_head


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
    return y, w1, b1, w2, b2, g, be


@pytest.mark.parametrize("b,ht,wt", [(2, 8, 8), (3, 4, 8)])
def test_refine_head_matches_jax_kernel(b, ht, wt):
    y, w1, b1, w2, b2, g, be = _inputs(b, ht, wt)
    want = jax_frh.fused_refine_head(*map(jnp.asarray, (y, w1, b1, w2, b2, g, be)))
    t = torch.from_numpy
    oihw = lambda w: t(w).permute(3, 2, 0, 1)  # noqa: E731  HWIO -> OIHW
    got = fused_refine_head.fused_refine_head(t(y), oihw(w1), t(b1), oihw(w2), t(b2),
                                              t(g), t(be))
    assert got.shape == (b, 4 * ht, 4 * wt, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


def _jax_composed(y, w1, b1, w2, b2, g, be):
    dn = ("NHWC", "HWIO", "NHWC")
    x = jax_patch_ops.depth_to_space(jax.nn.gelu(y, approximate=True), 4)
    h = jax.nn.gelu(jax.lax.conv_general_dilated(x, w1, (1, 1), "SAME", dimension_numbers=dn)
                    + b1, approximate=True)
    o = jax.lax.conv_general_dilated(h, w2, (1, 1), "SAME", dimension_numbers=dn) + b2
    mu = jnp.mean(o, -1, keepdims=True)
    va = jnp.mean(o * o, -1, keepdims=True) - mu * mu
    return (o - mu) * jax.lax.rsqrt(va + jax_frh.LN_EPS) * g + be


def test_refine_head_odd_rows_matches_jax_composed():
    b, ht, wt = 1, 3, 6
    y, w1, b1, w2, b2, g, be = _inputs(b, ht, wt, seed=5)
    assert not jax_frh.supported(y.shape, True)
    want = _jax_composed(*map(jnp.asarray, (y, w1, b1, w2, b2, g, be)))
    t = torch.from_numpy
    oihw = lambda w: t(w).permute(3, 2, 0, 1)  # noqa: E731  HWIO -> OIHW
    got = fused_refine_head.fused_refine_head(t(y), oihw(w1), t(b1), oihw(w2), t(b2),
                                              t(g), t(be))
    assert got.shape == (b, 4 * ht, 4 * wt, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
