"""The slice of window 12 as a whole: a small window-12 MS-UNet, the port
against the JAX package, f32 on the CPU.

Window 12 (144 tokens a window) is the geometry of Swin-B 384
(``swin_base_patch4_window12_384``) and of mmsegmentation's UperNet
Swin-B 512x512 config.  At 96^2 the stage grids 24/12/6/3 pad to
24/12/12/12: stage 0 has four windows with the shift 6 in its second
block, the others one window each (shift dropped).  The JAX kernels take
every stage (interpret mode); the port runs its plain versions here, and
on the card its tiled attention kernels (``chip_smoke.py`` phase 18).

* Logits with every kernel knob on (attention, patch merge/expand, the
  refine head; tanh GELU), embed 128 as the JAX patch kernels need, heads
  4/8/16/32 (head width 32 at every stage, as Swin-B), within 5e-4 abs
  (``tests/test_torch_model.py``'s ``ATOL``, the assembled-graph bar of
  ``PARITY.md``).
* One float32 train step of the port with the attention knob on (its
  ``autograd.Function`` at 144 tokens, plain forward and backward): the loss
  within 1e-5 (``tests/test_torch_train.py``'s per-step bar) and every
  parameter gradient within 1e-5 of max(1, max |g|)
  (``tests/test_torch_remat_jax.py``'s bar) of ``jax.value_and_grad`` of
  JAX's train-step loss on its XLA attention path (its interpret-mode
  kernel's backward at window 12 is held in
  ``tests/test_torch_attention_bwd.py``; here it would double the JAX
  compile), with one torch thread (as those files).
* The kernel plan names the tiled kernels at every stage: the tiled
  ``mma.sync`` kernels in bfloat16, the CUDA-core ones in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.losses import dynamic_loss as jax_loss
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import (
    fused_patch as jax_fp,
    fused_refine_head as jax_frh,
    fused_window_attention as jax_fwa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import state as jax_state
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import default_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
    MSUNet,
    attention_plan,
    init_weights,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import state

IMG = 96
KNOBS = dict(img_size=IMG, embed_dim=128, depths=(2, 1, 1, 1), num_heads=(4, 8, 16, 32),
             window_size=12, gelu_tanh=True, drop_path_rate=0.0)
TRAIN = dict(img_size=IMG, embed_dim=32, depths=(2, 1, 1, 1), num_heads=(1, 2, 4, 8),
             window_size=12, gelu_tanh=True, drop_path_rate=0.0)
ATOL = 5e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (jax_fwa, jax_fp, jax_frh):
        monkeypatch.setattr(mod, "INTERPRET", True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(kw, seed):
    """The port's seeded weights (truncated-normal bias tables) as JAX's
    parameter tree (the bridge is bit-exact, ``tests/test_torch_model.py``):
    no JAX init to trace and compile."""
    model = MSUNet(**kw)
    init_weights(model.ms_unet, seed)
    return model, state_dict_to_flax(model.ms_unet.state_dict())


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_jax_kernel_takes_every_window_12_stage():
    """The JAX gate keeps its kernel on every stage of the logits' model (so
    they are held against the TPU kernel, not JAX's composed path), and
    would on the train step's."""
    for kw in (KNOBS, TRAIN):
        for i, heads in enumerate(kw["num_heads"]):
            g = IMG // 4 >> i
            assert jax_fwa.supported((1, g, g, kw["embed_dim"] << i), (12, 12), heads,
                                     dtype=jnp.float32)


def test_window_12_logits_match_jax_every_knob():
    jm = JaxMSUNet(use_pallas=True, use_fused_patch=True, fused_head=True, **KNOBS)
    model, params = _params(dict(fused_attention=True, fused_patch=True, fused_head=True,
                                 **KNOBS), 0)
    x = np.random.default_rng(3).random((1, IMG, IMG, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, True))(params, x))
    assert model.ms_unet.up.fused_refine
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (1, IMG, IMG, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_window_12_train_step_matches_jax():
    jm = JaxMSUNet(use_pallas=False, **TRAIN)
    model, params = _params(dict(fused_attention=True, **TRAIN), 1)
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (1, IMG, IMG, 3), dtype=np.uint8)
    lbl = (rng.random((1, IMG, IMG)) > 0.7).astype(np.uint8)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jax_state.normalize_images(jnp.asarray(img)),
                          False, rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss(logits, jnp.asarray(lbl, jnp.float32), 0.2, 0.8, 0.45)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    st = state.create_train_state(model, default_config(), device="cpu")
    loss = state.make_train_step(model, 0.2, 0.8, 0.45)(st, img, lbl, 1e-4)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    got = dict(_flat(state_dict_to_flax(
        {n.split(".", 1)[1]: p.grad for n, p in model.named_parameters()})))
    for k, want in _flat(jgrads):
        err = np.abs(got[k] - want).max() / max(1.0, np.abs(want).max())
        assert err <= GRAD_TOL, ("/".join(k), err)


@pytest.mark.parametrize("dtype,family", [(torch.float32, "tiled"),
                                          (torch.bfloat16, "tiled mma.sync")])
def test_window_12_plan_names_the_tiled_kernels(dtype, family):
    """bfloat16 (head width 32) takes the tiled ``mma.sync`` kernels, float32
    the tiled kernels on the CUDA cores."""
    lines = attention_plan(MSUNet(fused_attention=True, dtype=dtype, **KNOBS))
    assert lines[:4] == [f"attention stage {i}: grid {24 >> i}x{24 >> i} c{128 << i} -> "
                         f"kernel ({family}, 144 tokens a window)" for i in range(4)]


def test_window_12_flops_count_the_full_windows_on_unpadded_tokens():
    """``utils/flops.py`` (the MFU of ``chip_smoke.py`` phase 18): at window 12
    the scores and context products count 144 keys for every unpadded token
    (128^2 at stage 0, not the 132^2 padded grid), as JAX's count does."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu.utils import flops as jax_flops
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils import flops

    kw = dict(params=150_000_000)
    f7, f12 = (flops.train_step_flops(512, 8, window_size=w, **kw) for w in (7, 12))
    assert f12 == jax_flops.train_step_flops(512, 8, window_size=12, **kw)
    blocks = (8, 6, 36, 2)  # Swin blocks a forward at each stage, all decoders
    extra = sum(n * 2 * 2.0 * (128 >> i) ** 2 * (144 - 49) * (128 << i)
                for i, n in enumerate(blocks))
    assert f12 - f7 == pytest.approx(3 * 8 * extra, rel=1e-12)
