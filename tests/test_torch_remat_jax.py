"""The port's recomputed train step against the JAX package's, f32 on the
CPU: with drop rates 0 (no noise is drawn), the loss and every parameter
gradient of ``make_train_step`` under ``full`` and under ``dots`` against
``jax.value_and_grad`` of JAX's train-step loss under the same policy
(``MSUNet(use_remat=True, remat_policy=...)``), from the same weights and
batch, with the attention knob on (the JAX kernel in interpret mode, the
port's plain version).  Loss within 1e-6; each gradient within 1e-5 of
max(1, max|g|), with one torch thread (as ``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.losses import dynamic_loss as jax_loss
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import (
    fused_window_attention as jax_fwa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import state as jax_state
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import default_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import state

TINY = dict(img_size=32, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
            window_size=4, gelu_tanh=True, drop_path_rate=0.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jm = JaxMSUNet(**TINY)  # the parameters do not depend on the policy or knobs
    return jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(1)},
                                   jnp.zeros((1, 32, 32, 3)), True))()["params"]


def _batch():
    rng = np.random.default_rng(4)
    return (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
            (rng.random((2, 32, 32)) > 0.7).astype(np.uint8))


def _jax_loss_and_grads(jm, params, img, lbl):
    """Value and gradient of the loss JAX's ``make_train_step`` differentiates."""
    def loss_fn(p):
        logits = jm.apply({"params": p}, jax_state.normalize_images(jnp.asarray(img)),
                          False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss(logits, jnp.asarray(lbl, jnp.float32), 0.2, 0.8, 0.45)

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recomputed_step_matches_jax(policy, params, monkeypatch):
    monkeypatch.setattr(jax_fwa, "INTERPRET", True)
    remat = dict(use_remat=True, remat_policy="dots" if policy == "dots" else "")
    img, lbl = _batch()
    jloss, jgrads = _jax_loss_and_grads(JaxMSUNet(use_pallas=True, **remat, **TINY),
                                        params, img, lbl)

    model = MSUNet(fused_attention=True, **remat, **TINY)
    model.ms_unet.load_state_dict(flax_to_state_dict(params), strict=True)
    st = state.create_train_state(model, default_config(), device="cpu")
    loss = state.make_train_step(model, 0.2, 0.8, 0.45)(st, img, lbl, 1e-4)
    assert abs(loss.item() - float(jloss)) <= 1e-6
    got = dict(_flat(state_dict_to_flax(
        {n.split(".", 1)[1]: p.grad for n, p in model.named_parameters()})))
    for k, want in _flat(jgrads):
        err = np.abs(got[k] - want).max() / max(1.0, np.abs(want).max())
        assert err <= 1e-5, ("/".join(k), err)
