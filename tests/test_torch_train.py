"""The slice as a whole: the port's train step vs the JAX package's, f32 on
the CPU.

Three train steps (``make_train_step``: on-device normalisation, forward,
Dynamic loss (0.2, 0.8, 0.45), backward, AdamW with the lr passed per
call) from equal params (the JAX init through the weight bridge) and
equal uint8 batches, drop-path 0 so no noise is drawn:

* a tiny config with the attention knob on (JAX kernel in interpret
  mode; the port's ``autograd.Function`` with its plain versions), with
  accumulation 1 and 2;
* embed 128 at 32^2 with the attention and head knobs on, where the
  refine-head path runs (its training forward and backward);
* embed 128 at 32^2 with ``FUSED_PATCH`` on (the config of
  ``tests/test_fused_patch.py::test_train_step_with_fused_patch``): the
  merge and expand ``autograd.Function``s, forward and backward;
* embed 16 with ``FUSED_HEAD`` and tanh GELU, where the refine-head gate
  fails and both packages run the GELU+depth-to-space kernel.

Tolerances: the per-step loss 1e-5 abs (a float32 mean over the batch's
pixels after 0-2 updates); the final params 1e-5 abs for 99.9 % of the
elements, and 2*lr per step for all of them, because Adam answers a
near-zero gradient with an update of about +-lr whose sign float32
round-off can flip.  Also: ``make_eval_step`` matches the JAX eval step
(probs and the per-sample losses, 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    default_config as jax_default_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import (
    fused_head as jax_fh,
    fused_patch as jax_fp,
    fused_refine_head as jax_frh,
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

TINY = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4, gelu_tanh=True)
HEAD = dict(img_size=32, embed_dim=128, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            window_size=7, gelu_tanh=True)
LR = 1e-4
STEPS = 3


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (jax_fwa, jax_frh, jax_fp, jax_fh):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _batches(b, size, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
             (rng.random((b, size, size)) > 0.7).astype(np.uint8)) for _ in range(STEPS)]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _run(kw, jax_kw, port_kw, acc, batch=2):
    cfg = jax_default_config()
    jm = JaxMSUNet(drop_path_rate=0.0, **jax_kw, **kw)
    jstate = jax_state.create_train_state(jm, cfg, jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3)))
    model = MSUNet(drop_path_rate=0.0, **port_kw, **kw)
    model.ms_unet.load_state_dict(flax_to_state_dict(jstate.params), strict=True)
    tstate = state.create_train_state(model, default_config(), device="cpu")
    jstep = jax_state.make_train_step(jm, 0.2, 0.8, 0.45, donate=False,
                                      accumulation_steps=acc)
    tstep = state.make_train_step(model, 0.2, 0.8, 0.45, accumulation_steps=acc)
    for img, lbl in _batches(batch, 32):
        jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(lbl),
                              jnp.asarray(LR, jnp.float32))
        tloss = tstep(tstate, img, lbl, LR)
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5, rtol=0)
    assert tstate.step == STEPS
    got = dict(_flat(state_dict_to_flax(model.ms_unet.state_dict())))
    for k, want in _flat(jstate.params):
        diff = np.abs(got[k] - want)
        assert diff.max() <= 2 * LR * STEPS, ("/".join(k), diff.max())
        assert (diff > 1e-5).mean() <= 1e-3, ("/".join(k), (diff > 1e-5).mean())


@pytest.mark.parametrize("acc", [1, 2])
def test_train_steps_match_jax_attention_kernel(acc):
    _run(TINY, dict(use_pallas=True), dict(fused_attention=True), acc)


def test_train_steps_match_jax_refine_head_kernel():
    _run(HEAD, dict(use_pallas=True, fused_head=True),
         dict(fused_attention=True, fused_head=True), 1, batch=1)


def test_train_steps_match_jax_fused_patch():
    _run(HEAD, dict(use_fused_patch=True), dict(fused_patch=True), 1, batch=1)


def test_train_steps_match_jax_gelu_d2s_head():
    _run(TINY, dict(use_pallas=True, fused_head=True),
         dict(fused_attention=True, fused_head=True), 1)


def test_eval_step_matches_jax():
    jm = JaxMSUNet(**TINY)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(1)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    model = MSUNet(**TINY)
    model.ms_unet.load_state_dict(flax_to_state_dict(params), strict=True)
    img, lbl = _batches(3, 32, seed=1)[0]
    jp, jl = jax_state.make_eval_step(jm, 0.2, 0.8, 0.45, per_sample=True)(
        params, jnp.asarray(img), jnp.asarray(lbl))
    tp, tl = state.make_eval_step(model, 0.2, 0.8, 0.45, per_sample=True, device="cpu")(
        img, lbl)
    assert tl.shape == (3,)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


def test_encode_labels_matches_jax():
    lbl = np.random.default_rng(2).integers(0, 4, (2, 5, 5), dtype=np.uint8)
    for c in (1, 3):
        np.testing.assert_array_equal(
            state.encode_labels(torch.from_numpy(lbl), c).numpy(),
            np.asarray(jax_state.encode_labels(jnp.asarray(lbl), c)))
