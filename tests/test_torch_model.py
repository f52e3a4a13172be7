"""Port's MS-UNet vs the JAX package's, f32 on the CPU.

* The weight bridge: flax -> port -> flax is bit-exact, and a port state
  dict loads ``strict=True`` into a fresh port model; at the published
  Swin-T width (embed 96, depths 2/2/6/2, heads 3/6/12/24) the port's
  seeded weights map onto the JAX model's parameter tree shape for shape
  and come back bit-exact.
* Composed-path logits against JAX ``MSUNet`` at ``tests/test_model.py``'s
  SMALL config, for erf and tanh GELU.
* Kernel-knob logits with all three knobs and tanh GELU on, JAX kernels
  in interpret mode, at the config ``tests/test_fused_patch.py`` runs
  (img 32, embed 128, depths 1,1,1,1), where every JAX gate passes.

Tolerance 5e-4 abs, the assembled-graph bar of ``PARITY.md``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import (
    fused_patch as jax_fp,
    fused_refine_head as jax_frh,
    fused_window_attention as jax_fwa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
    MSUNet,
    MSUNetSys,
    init_weights,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)

SMALL = dict(img_size=64, embed_dim=16, depths=(2, 2, 4, 2), num_heads=(2, 2, 2, 2),
             window_size=4)
KERNEL = dict(img_size=32, embed_dim=128, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
              window_size=7)
SWIN_T = dict(img_size=32, embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
              window_size=7)
ATOL = 5e-4


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jax_params(model, size):
    x = jnp.zeros((1, size, size, 3))
    return jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)}, x, True))()["params"]


def _image(size, b=2, seed=3):
    return np.random.default_rng(seed).random((b, size, size, 3)).astype(np.float32)


def _port_logits(params, x, **kw):
    model = MSUNet(**kw)
    model.ms_unet.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def small_params():
    """One init serves every SMALL test: GELU's form changes no parameter."""
    return _jax_params(JaxMSUNet(**SMALL), 64)


def test_bridge_round_trip_is_bit_exact(small_params):
    params = small_params
    sd = flax_to_state_dict(params)
    back = dict(_flat(state_dict_to_flax(sd)))
    want = dict(_flat(params))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    fresh = MSUNetSys(**SMALL)
    fresh.load_state_dict(sd, strict=True)
    again = MSUNetSys(**SMALL)
    again.load_state_dict(fresh.state_dict(), strict=True)


def test_bridge_carries_swin_t_width():
    model = MSUNetSys(**SWIN_T)
    init_weights(model, 120)
    sd = model.state_dict()
    tree = state_dict_to_flax(sd)
    jm = JaxMSUNet(**SWIN_T)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 32, 32, 3)), True))["params"]
    want = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(k): v.shape
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    back = MSUNetSys(**SWIN_T)
    back.load_state_dict(flax_to_state_dict(tree), strict=True)
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("gelu_tanh", [False, True])
def test_composed_logits_match_jax(gelu_tanh, small_params):
    jm = JaxMSUNet(gelu_tanh=gelu_tanh, **SMALL)
    params = small_params
    x = _image(64)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, True))(params, x))
    got = _port_logits(params, x, gelu_tanh=gelu_tanh, **SMALL)
    assert got.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_kernel_knob_logits_match_jax(monkeypatch):
    for mod in (jax_fwa, jax_fp, jax_frh):
        monkeypatch.setattr(mod, "INTERPRET", True)
    jm = JaxMSUNet(use_pallas=True, use_fused_patch=True, fused_head=True,
                   gelu_tanh=True, drop_path_rate=0.0, **KERNEL)
    params = _jax_params(jm, 32)
    x = _image(32, b=1)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, True))(params, x))
    got = _port_logits(params, x, fused_attention=True, fused_patch=True,
                       fused_head=True, gelu_tanh=True, **KERNEL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
