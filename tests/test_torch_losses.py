"""Port's losses vs the JAX package's, f32 on the CPU.

Every function of ``losses/losses.py`` and the multiclass pair of
``losses/multiclass.py``, on the same numpy-seeded logits and targets
(float {0,1} and uint8 {0,255} targets, an empty mask in the batch so the
Dynamic loss's BCE-only branch runs, 3-D and 4-D shapes).  Tolerance
1e-6 abs, the loss bar of PARITY.md.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.losses import losses as jl
from semantic_segmentation_of_stylegan2_artifacts_tpu.losses import multiclass as jm
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.losses import losses as tl
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.losses import multiclass as tm

ATOL = 1e-6


def _binary(uint8: bool, four_d: bool, seed=0):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((3, 16, 16))).astype(np.float32)
    t = (rng.random((3, 16, 16)) > 0.7).astype(np.float32)
    t[1] = 0.0  # an empty mask: BCE only
    if uint8:
        t = (t * 255).astype(np.uint8)
    if four_d:
        logits, t = logits[..., None], t[..., None]
    return logits, t


def _check(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().numpy(), np.float64),
                               np.asarray(want, np.float64), atol=ATOL, rtol=0)


@pytest.mark.parametrize("uint8,four_d", [(False, False), (True, True)])
@pytest.mark.parametrize("name,kw", [
    ("dynamic_loss", dict(alpha=0.2, beta=0.8, tversky_bce_mix=0.45)),
    ("dynamic_loss_per_sample", dict(alpha=0.4, beta=0.6, tversky_bce_mix=0.5)),
    ("symmetric_unified_focal_loss", dict(delta=0.75, gamma=0.7, weight=0.5)),
])
def test_binary_losses_match_jax(name, kw, uint8, four_d):
    logits, t = _binary(uint8, four_d)
    _check(getattr(tl, name)(torch.from_numpy(logits), torch.from_numpy(t), **kw),
           getattr(jl, name)(jnp.asarray(logits), jnp.asarray(t), **kw))


@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("name,kw", [
    ("bce_with_logits", {}),
    ("tversky_loss", dict(alpha=0.7, beta=0.3)),
    ("focal_tversky_loss", dict(alpha=0.7, beta=0.3, gamma=1.1)),
])
def test_elementary_losses_match_jax(name, kw, axis):
    logits, t = _binary(False, False, seed=1)
    lf, tf = logits.reshape(3, -1), t.reshape(3, -1)
    _check(getattr(tl, name)(torch.from_numpy(lf), torch.from_numpy(tf), axis=axis, **kw),
           getattr(jl, name)(jnp.asarray(lf), jnp.asarray(tf), axis=axis, **kw))


def test_tversky_index_matches_jax():
    logits, t = _binary(False, False, seed=2)
    p = 1.0 / (1.0 + np.exp(-logits))
    _check(tl.tversky_index(torch.from_numpy(p), torch.from_numpy(t), 0.3, 0.7),
           jl.tversky_index(jnp.asarray(p), jnp.asarray(t), 0.3, 0.7))


@pytest.mark.parametrize("name", ["dynamic_loss_multiclass",
                                  "dynamic_loss_multiclass_per_sample"])
def test_multiclass_losses_match_jax(name):
    rng = np.random.default_rng(3)
    logits = (2.0 * rng.standard_normal((2, 12, 12, 3))).astype(np.float32)
    t = (rng.random((2, 12, 12, 3)) > 0.6).astype(np.float32)
    t[0, ..., 1] = 0.0  # an empty (sample, class) mask
    kw = dict(alpha=0.2, beta=0.8, tversky_bce_mix=0.45)
    _check(getattr(tm, name)(torch.from_numpy(logits), torch.from_numpy(t), **kw),
           getattr(jm, name)(jnp.asarray(logits), jnp.asarray(t), **kw))
    with pytest.raises(ValueError):
        getattr(tm, name)(torch.from_numpy(logits[..., 0]), torch.from_numpy(t[..., 0]))
