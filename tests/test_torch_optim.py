"""Port's optimizer and schedule vs the JAX package, f32 on the CPU.

* ``decay_mask`` equals JAX ``decay_mask_fn`` on the params of a small
  MS-UNet, with flax paths mapped by ``models/weights.py``'s
  ``flax_path_to_torch_key``.
* Two AdamW updates (``build_optimizer``, learning rate set per call)
  from equal params and gradients match optax's; tolerance 1e-6 abs on
  the params (updates of size lr = 1e-3; float32 arithmetic in another
  order).
* ``CosineWarmupSchedule`` gives the JAX schedule's lr at every epoch,
  exactly (the same float arithmetic).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import traverse_util

from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import optim as jax_optim
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.schedule import (
    CosineWarmupSchedule as JaxSchedule,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNetSys
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_path_to_torch_key,
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import optim
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.schedule import (
    CosineWarmupSchedule,
)

TINY = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4)
CONFIG = SimpleNamespace(TRAIN=SimpleNamespace(
    BASE_LR=1e-3, WEIGHT_DECAY=0.05,
    OPTIMIZER=SimpleNamespace(BETAS=(0.9, 0.999), EPS=1e-8)))


@pytest.fixture(scope="module")
def params():
    jm = JaxMSUNet(**TINY)
    return jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                   jnp.zeros((1, 32, 32, 3)), True))()["params"]


def _model(params):
    model = MSUNetSys(**TINY)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def test_decay_mask_matches_jax(params):
    want = {flax_path_to_torch_key(k[1:]): bool(v) for k, v in
            traverse_util.flatten_dict(jax_optim.decay_mask_fn(params)).items()}
    got = optim.decay_mask(_model(params))
    assert got == want
    assert got["layers.0.blocks.0.attn.relative_position_bias_table"]
    assert not got["layers.0.blocks.0.norm1.weight"]


def test_adamw_updates_match_optax(params):
    rng = np.random.default_rng(0)
    flat = traverse_util.flatten_dict(params)
    grads = [traverse_util.unflatten_dict(
        {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()})
        for _ in range(2)]
    tx = jax_optim.build_optimizer(CONFIG, params)
    state = tx.init(params)
    p = params
    for g, lr in zip(grads, (1e-3, 5e-4)):
        state = jax_optim.set_learning_rate(state, lr)
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)

    model = _model(params)
    opt = optim.build_optimizer(CONFIG, model)
    named = dict(model.named_parameters())
    for g, lr in zip(grads, (1e-3, 5e-4)):
        for key, value in flax_to_state_dict(g).items():
            named[key].grad = value
        optim.set_learning_rate(opt, lr)
        assert optim.current_learning_rate(opt) == lr
        opt.step()
    got = traverse_util.flatten_dict(state_dict_to_flax(model.state_dict()))
    for k, v in traverse_util.flatten_dict(p).items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-6, rtol=0,
                                   err_msg="/".join(k))


@pytest.mark.parametrize("max_epochs,warmup,prefix", [(60, 20, True), (150, 5, False),
                                                     (30, 0, True)])
def test_schedule_matches_jax(max_epochs, warmup, prefix):
    cfg = SimpleNamespace(TRAIN=SimpleNamespace(
        MAX_EPOCHS=max_epochs, WARMUP_EPOCHS=warmup, BASE_LR=1e-5, MIN_LR=1e-6,
        WARMUP_LR=1e-6, LR_SCHEDULER=SimpleNamespace(WARMUP_PREFIX=prefix)))
    got, want = CosineWarmupSchedule.from_config(cfg), JaxSchedule.from_config(cfg)
    for epoch in range(max_epochs + 5):
        assert got.lr_at_epoch(epoch) == want.lr_at_epoch(epoch), epoch
