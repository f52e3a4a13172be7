"""Data parallelism: the port's DDP train step over two ``gloo`` ranks
against the JAX package's step over a 2-device mesh, on the CPU.

The model is tiny (embed 16, depths 2/2/2/2, heads 2, window 4, 32^2,
float32, the kernel knobs off, drop rates 0: noise drawn over another
split of the batch cannot match).  Both packages build it from one YAML;
the port starts from the JAX init through the weight bridge.  The global
batch is 8 rows, 4 a rank; the ranks are spawned by
``tools/dp_check.py::spawn_steps`` with a ``file://`` rendezvous under
``tmp_path``.  Cases: accumulation 1 and accumulation 2 (each rank splits
its rows in two micro-batches, the first under ``no_sync``).

Tolerances (JAX ``tests/test_parallel.py::test_dp_matches_single_device``):
each step's loss 1e-5 absolute; the parameters 1e-5 absolute for all but
1e-3 of the elements, and for all of them Adam's bound of lr a step
(``2 * lr * steps``, as ``tests/test_torch_train.py``): Adam answers a
near-zero gradient with an update of about +-lr whose sign float32
round-off can flip.  The ranks end every case with equal parameters in
bits (``check_replicas``), and both report the mean loss over the ranks.

The frozen-encoder case is ``tests/test_torch_dp_unfreeze.py``.  Also the
noise: at world size 1 the seeds are the one-process seeds, at
world size 2 the ranks draw different drop-path masks; and the mesh's
validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    load_config as jax_load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.parallel import (
    make_mesh,
    replicate_state,
    shard_batch,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import optim as jax_optim
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import state as jax_state
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
    default_config,
    load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.layers import (
    noise_generator,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import dp_check
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import state as port_state

YAML = """\
DATA:
  IMG_SIZE: 32
MODEL:
  DROP_RATE: 0.0
  ATTN_DROP_RATE: 0.0
  DROP_PATH_RATE: 0.0
  PRETRAIN_WEIGHTS: none
  SWIN:
    EMBED_DIM: 16
    DEPTHS: [2, 2, 2, 2]
    NUM_HEADS: [2, 2, 2, 2]
    WINDOW_SIZE: 4
TPU:
  COMPUTE_DTYPE: float32
  USE_PALLAS_ATTENTION: false
  FUSED_HEAD: false
  FUSED_PATCH: false
  REMAT: none
"""
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: conv weight gradients sum in one order (fault 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp") / "tiny.yaml"
    path.write_text(YAML)
    return str(path)


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
             (rng.random((8, 32, 32)) > 0.7).astype(np.uint8)) for _ in range(n)]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_init(cfg_path):
    """The JAX model, config and train state (init from ``PRNGKey(0)``)."""
    cfg = jax_load_config(cfg_path)
    model = JaxMSUNet.from_config(cfg)
    state = jax_state.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 32, 32, 3)))
    return cfg, model, state


def jax_mesh_steps(jax_init, batches, acc=1, frozen=(), unfreeze=None):
    """The JAX step over a 2-device mesh (``make_mesh(n_data=2)``); returns
    the final params and the losses."""
    cfg, model, state = jax_init
    if frozen:
        tx = jax_optim.build_optimizer(cfg, state.params, set(frozen), 0 in frozen)
        state = state.replace(tx=tx, opt_state=tx.init(state.params))
    m = make_mesh(n_data=2)
    state = replicate_state(state, m)
    step = jax_state.make_train_step(model, float(cfg.TRAIN.TVERSKY_LOSS_ALPHA),
                                     float(cfg.TRAIN.TVERSKY_LOSS_BETA),
                                     float(cfg.TRAIN.LOSS_TVERSKY_BCE_MIX), donate=False,
                                     accumulation_steps=acc)
    losses = []
    for i, (img, lbl) in enumerate(batches):
        if i in (unfreeze or {}):
            left = set(unfreeze[i])
            tx = jax_optim.build_optimizer(cfg, state.params, left, 0 in left)
            state = state.replace(tx=tx, opt_state=jax_optim.carry_opt_state(
                state.opt_state, tx.init(state.params)))
        placed = shard_batch({"image": img, "label": lbl}, m)
        state, loss = step(state, placed["image"], placed["label"],
                           jnp.asarray(LR, jnp.float32))
        losses.append(float(loss))
    return jax.device_get(state.params), losses


def assert_params_close(got, want, steps, skip=()):
    """``got`` (a port state dict) against ``want`` (flax params): 1e-5
    for all but 1e-3 of the elements, Adam's bound for all; keys under a
    prefix of ``skip`` are left out."""
    got = dict(_flat(state_dict_to_flax(got)))
    n_far = n_all = 0
    for k, w in _flat(want):
        if "/".join(k).startswith(tuple(skip)):
            continue
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * LR * steps, ("/".join(k), diff.max())
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


def spawn_ranks(cfg_path, jax_init, batches, workdir, **kw):
    """The port's steps over two spawned ``gloo`` ranks from the JAX init;
    checks that both ranks report the same (mean) losses."""
    spec = dp_check.make_spec(cfg_path, batches, LR, device="cpu",
                              state_dict=flax_to_state_dict(jax_init[2].params), **kw)
    ranks = dp_check.spawn_steps(spec, 2, str(workdir))
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    return spec, ranks[0]


@pytest.mark.parametrize("acc", [1, 2])
def test_ddp_step_matches_jax_mesh(acc, cfg_path, jax_init, tmp_path):
    batches = _batches(1, seed=acc)
    want, want_losses = jax_mesh_steps(jax_init, batches, acc=acc)
    _, got = spawn_ranks(cfg_path, jax_init, batches, tmp_path, accumulation=acc)
    np.testing.assert_allclose(got["losses"], want_losses, atol=1e-5, rtol=0)
    assert_params_close(got["state_dict"], want, steps=1)


def test_world_size_one_keeps_the_noise_seeds():
    """Rank 0 (every one-process run) draws from the one-process seeds,
    which ``tests/test_torch_remat.py`` holds in bits; rank 1 does not."""
    import numpy.random as npr

    for step, micro in ((0, 0), (5, 1)):
        want = int(npr.SeedSequence([7, step, micro]).generate_state(1)[0])
        assert port_state._noise_seed(7, step, micro) == want
        assert port_state._noise_seed(7, step, micro, 0) == want
        assert port_state._noise_seed(7, step, micro, 1) != want


def test_ranks_draw_different_drop_path_masks():
    """The drop-path masks of one block under rank 0's and rank 1's seed."""
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4, drop_path_rate=0.5).train()
    x = torch.rand(8, 32, 32, 3)
    outs = []
    for rank in (0, 1):
        gen = torch.Generator().manual_seed(port_state._noise_seed(0, 0, 0, rank))
        with torch.no_grad(), noise_generator(gen):
            outs.append(model(x))
    assert not torch.equal(outs[0], outs[1])
    gen = torch.Generator().manual_seed(port_state._noise_seed(0, 0, 0, 0))
    with torch.no_grad(), noise_generator(gen):
        assert torch.equal(model(x), outs[0])


def test_mesh_validation():
    cfg = default_config()
    assert mesh.world_size_for(cfg) == 1
    cfg.defrost()
    cfg.HARDWARE.N_GPU = 4
    cfg.TPU.MESH_SHAPE = [4]
    assert mesh.world_size_for(cfg) == 4
    for shape in ([2, 2], [1, 1, 2]):
        cfg.TPU.MESH_SHAPE = shape
        with pytest.raises(NotImplementedError, match="model or space axis"):
            mesh.world_size_for(cfg)
        with pytest.raises(NotImplementedError):
            MSUNet.from_config(cfg, device="cpu")
    cfg.TPU.MESH_SHAPE = [0]
    cfg.TPU.MODEL_AXIS = "model"
    with pytest.raises(NotImplementedError, match="MODEL_AXIS"):
        mesh.world_size_for(cfg)
    # JAX make_mesh's text for too few devices; ranks on one card need a backend
    with pytest.raises(ValueError, match=r"mesh 2x1x1 needs 2 devices, have 0"):
        mesh.check_world(2, "cuda")
    with pytest.raises(ValueError, match="explicit backend"):
        mesh.check_world(2, "cuda:0")
    mesh.check_world(2, "cuda:0", backend="gloo")
    mesh.check_world(8, "cpu")
    assert mesh.rank_device(1, "cuda") == torch.device("cuda", 1)
    assert mesh.rank_device(1, "cuda:0") == torch.device("cuda", 0)
    assert mesh.rank_device(3, "cpu") == torch.device("cpu")


def test_n_gpu_builds_the_model(tmp_path):
    """``HARDWARE.N_GPU > 1`` no longer raises in ``from_config``."""
    path = tmp_path / "n_gpu.yaml"
    path.write_text(YAML + "HARDWARE:\n  N_GPU: 2\n")
    model = MSUNet.from_config(load_config(str(path)), device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0
