"""Port's patch merge / expand vs the JAX package, f32 on the CPU.

The port's kernel wrappers (their plain versions on the CPU) are held
against ``fused_patch_merge``/``fused_patch_expand`` with the Pallas
kernels in interpret mode, and the port's composed modules against the
JAX package's ``PatchMerging``/``PatchExpand`` on their XLA path.
Tolerance: atol = rtol = 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.models import layers as jax_layers
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import fused_patch as jax_fp
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models import layers
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_patch

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fp, "INTERPRET", True)


def _arrays(seed, x_shape, w_shape, ln_dim):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32) * 0.5
    w = rng.standard_normal(w_shape).astype(np.float32) * 0.05
    sc = (1 + 0.1 * rng.standard_normal(ln_dim)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(ln_dim)).astype(np.float32)
    return x, w, sc, lb


# the last rows: the card's forward corner cases -- rows ragged against the
# tensor-core kernels' tiles (15 merged rows, one merged row at 4C = 2048, one
# row at C/2 = 512; 15 rows is (1, 3, 5, 256) above) and widths routed to
# the CUDA-core kernels (merge C = 48, expand C/2 = 64)
MERGE = [(2, 8, 8, 128), (1, 4, 6, 128), (2, 4, 4, 256), (1, 2, 2, 256),
         (1, 6, 10, 128), (1, 2, 2, 512), (1, 4, 4, 48)]
EXPAND = [(2, 4, 4, 256), (1, 3, 5, 256), (2, 2, 2, 512), (1, 1, 1, 512),
          (1, 1, 1, 1024), (1, 2, 2, 128)]


@pytest.mark.parametrize("shape", MERGE)
def test_merge_matches_jax(shape):
    c = shape[-1]
    x, w, sc, lb = _arrays(0, shape, (4 * c, 2 * c), 4 * c)
    want = jax_fp.fused_patch_merge(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(lb),
                                    jnp.asarray(w))
    t = torch.from_numpy
    got = fused_patch.fused_patch_merge(t(x), t(sc), t(lb), t(w).T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    params = {"norm": {"scale": sc, "bias": lb}, "reduction": {"kernel": w}}
    want_c = jax_layers.PatchMerging(dim=c).apply({"params": params}, jnp.asarray(x))
    mod = layers.PatchMerging(c, fused=False, dtype=torch.float32)
    mod.load_state_dict({"norm.weight": t(sc), "norm.bias": t(lb),
                         "reduction.weight": t(w).T.contiguous()})
    with torch.no_grad():
        got_c = mod(t(x))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)


@pytest.mark.parametrize("shape", EXPAND)
def test_expand_matches_jax(shape):
    c = shape[-1]
    x, w, sc, lb = _arrays(1, shape, (c, 2 * c), c // 2)
    want = jax_fp.fused_patch_expand(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
                                     jnp.asarray(lb))
    t = torch.from_numpy
    got = fused_patch.fused_patch_expand(t(x), t(w).T, t(sc), t(lb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    params = {"expand": {"kernel": w}, "norm": {"scale": sc, "bias": lb}}
    want_c = jax_layers.PatchExpand(dim=c).apply({"params": params}, jnp.asarray(x))
    mod = layers.PatchExpand(c, fused=False, dtype=torch.float32)
    mod.load_state_dict({"expand.weight": t(w).T.contiguous(), "norm.weight": t(sc),
                         "norm.bias": t(lb)})
    with torch.no_grad():
        got_c = mod(t(x))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
