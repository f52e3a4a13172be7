"""Tensor parallelism: the port's dp x tp train step over 2 x 2 ``gloo``
ranks against the JAX package's step on ``make_mesh(n_data=2, n_model=2)``
after ``shard_state_tp``, on the CPU.

The model is tiny (embed 16, depths 2/2/2/2, heads 2, window 4, 32^2,
float32, drop rates 0: noise drawn over another split of the batch cannot
match).  The port's YAML sets ``TPU.MODEL_AXIS: model`` with every kernel
knob on, which the axis routes off (JAX
``tests/test_parallel.py::test_dp_tp_with_kernels_requested_gates_to_xla``);
JAX's has neither.  The port starts from the JAX init through the weight
bridge; the global batch is 8 rows, 4 a data rank; the four ranks are
spawned by ``tools/dp_check.py::spawn_steps`` (ranks ``(d, m)`` =
``(0, 0), (0, 1), (1, 0), (1, 1)``).  Cases: accumulation 1, accumulation
2, and ``TPU.REMAT: full`` (held against the accumulation-1 JAX step on the
same batch).

Tolerances (JAX ``tests/test_parallel.py::test_hybrid_dp_tp_matches_single_device``):
each step's loss 1e-5 absolute; the parameters 1e-5 absolute for all but
1e-3 of the elements, and for all of them Adam's bound of ``2 * lr *
steps`` (``tests/test_torch_parallel.py``).  Every rank reports the same
loss; the replicated parameters are equal in bits on the four ranks (and
``dp_check.run_steps`` raises unless the data, model and space groups
agree).  Also in-process: the qkv split by heads and its inverse in bits,
the AdamW moments cut as their parameters, the divisibility check, the
model ranks' equal drop-path masks, ``attention_plan``'s reasons,
``make_mesh``'s validation and ``make_spec``'s default device.
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
    make_mesh as jax_make_mesh,
    shard_batch as jax_shard_batch,
    shard_state_tp as jax_shard_state_tp,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import state as jax_state
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.layers import (
    noise_generator,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
    MSUNet,
    attention_plan,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh, tp
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
  USE_PALLAS_ATTENTION: {kernels}
  FUSED_HEAD: {kernels}
  FUSED_PATCH: {kernels}
  GELU_TANH: false
  REMAT: {remat}
  MODEL_AXIS: '{axis}'
"""
LR = 1e-3
CASES = {"acc1": (1, "none"), "acc2": (2, "none"), "remat_full": (1, "full")}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: conv weight gradients sum in one order (fault 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yaml(path, **kw):
    path.write_text(YAML.format(**kw))
    return str(path)


def _batches(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
             (rng.random((8, 32, 32)) > 0.7).astype(np.uint8))]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    cfg = jax_load_config(_yaml(tmp_path_factory.mktemp("tp") / "jax.yaml", kernels="false",
                                remat="none", axis=""))
    model = JaxMSUNet.from_config(cfg)
    state = jax_state.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 32, 32, 3)))
    return cfg, model, state


def jax_tp_step(jax_init, batches, acc):
    """JAX's step on a 2 x 2 dp x tp mesh after ``shard_state_tp``."""
    cfg, model, state = jax_init
    m = jax_make_mesh(n_data=2, n_model=2)
    state = jax_shard_state_tp(state, m)
    step = jax_state.make_train_step(model, float(cfg.TRAIN.TVERSKY_LOSS_ALPHA),
                                     float(cfg.TRAIN.TVERSKY_LOSS_BETA),
                                     float(cfg.TRAIN.LOSS_TVERSKY_BCE_MIX), donate=False,
                                     accumulation_steps=acc)
    losses = []
    for img, lbl in batches:
        placed = jax_shard_batch({"image": img, "label": lbl}, m)
        state, loss = step(state, placed["image"], placed["label"],
                           jnp.asarray(LR, jnp.float32))
        losses.append(float(loss))
    return jax.device_get(state.params), losses


@pytest.fixture(scope="module")
def runs(jax_init, tmp_path_factory):
    """Each case's JAX result and the four port ranks' results, spawned once."""
    work = tmp_path_factory.mktemp("tp_runs")
    init = flax_to_state_dict(jax_init[2].params)
    jax_runs, out = {}, {}
    for name, (acc, remat) in CASES.items():
        batches = _batches(seed=acc)
        if acc not in jax_runs:
            jax_runs[acc] = jax_tp_step(jax_init, batches, acc)
        path = _yaml(work / f"{name}.yaml", kernels="true", remat=remat, axis="model")
        spec = dp_check.make_spec(path, batches, LR, accumulation=acc, state_dict=init,
                                  device="cpu", n_model=2)
        out[name] = (jax_runs[acc], dp_check.spawn_steps(spec, 4, str(work / name)))
    return out


def assert_params_close(got, want, steps=1):
    got = dict(_flat(state_dict_to_flax(got)))
    n_far = n_all = 0
    for k, w in _flat(want):
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * LR * steps, ("/".join(k), diff.max())
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_jax_mesh(case, runs):
    (want, want_losses), ranks = runs[case]
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, atol=1e-5, rtol=0)
    assert_params_close(ranks[0]["state_dict"], want)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_parameters_equal_in_bits(case, runs):
    """The replicated parameters on the two model ranks of each data shard,
    and across the shards, after the steps."""
    _, ranks = runs[case]
    for r in ranks[1:]:
        assert torch.equal(r["digest"], ranks[0]["digest"])


def test_qkv_split_by_heads_round_trip():
    """Rank ``m`` holds the q, k and v rows of its heads; the shards
    reassemble the full tensors in bits; T must divide heads and 4C."""
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(4, 4, 4, 4),
                   window_size=4)
    g = torch.Generator().manual_seed(0)
    full = {k: torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}
    name = "ms_unet.layers.0.blocks.0.attn.qkv.weight"
    c, hd = 16, 4
    for size in (1, 2, 4):
        shards = [tp.shard_state_dict_tp(full, size, r) for r in range(size)]
        for r, shard in enumerate(shards):
            heads = range(r * 4 // size, (r + 1) * 4 // size)
            rows = [p * c + h * hd + i for p in range(3) for h in heads for i in range(hd)]
            assert torch.equal(shard[name], full[name][rows])
            assert torch.equal(shard[name.replace("weight", "bias")],
                               full[name.replace("weight", "bias")][rows])
        for key, t in full.items():
            if tp.tp_spec(key) is None:
                assert all(s[key] is t for s in shards)
            else:
                assert torch.equal(tp.unshard_tensor(key, [s[key] for s in shards]), t), key
    assert tp.tp_spec("ms_unet.layers_cent1.1.blocks.0.mlp.0.bias") == "column"
    assert tp.tp_spec("ms_unet.layers_up.2.blocks.1.mlp.3.weight") == "row"
    assert tp.tp_spec("ms_unet.layers_up.2.blocks.1.mlp.3.bias") is None
    assert tp.tp_spec("ms_unet.layers.0.blocks.0.attn.relative_position_bias_table") is None
    tp.check_divisible(model, 4)
    with pytest.raises(ValueError, match="4 heads do not split over 8"):
        tp.check_divisible(model, 8)
    swin_b = MSUNet(img_size=224, embed_dim=128, depths=(1, 1, 1, 1),
                    num_heads=(4, 8, 16, 32), window_size=7)
    tp.check_divisible(swin_b, 4)
    with pytest.raises(ValueError, match="heads do not split over 8"):
        tp.check_divisible(swin_b, 8)


def test_adamw_moments_follow_the_shards():
    """After a step, each sharded parameter's moments are cut as the
    parameter is; the replicated parameters' moments stay whole."""
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4)
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    g = torch.Generator().manual_seed(1)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    names = dict(model.named_parameters())
    full = {n: {k: opt.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")}
            for n, p in names.items()}
    tp.shard_moments_tp(opt, model, 2, 1)
    for n, p in names.items():
        for key, want in full[n].items():
            cut = tp.shard_state_dict_tp({n: want}, 2, 1)[n]
            assert torch.equal(opt.state[p][key], cut), (n, key)
            assert (cut.shape != want.shape) == (tp.tp_spec(n) is not None), n


def test_model_ranks_draw_equal_drop_path_masks():
    """The seed folds in the data rank: the two model ranks of a data shard
    draw one drop-path mask, the two data shards different ones."""
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4, drop_path_rate=0.5).train()
    x = torch.rand(4, 32, 32, 3)
    outs = []
    for rank in range(4):
        data, _, _ = mesh.mesh_coords(rank, 2, 1)
        gen = torch.Generator().manual_seed(port_state._noise_seed(0, 0, 0, data))
        with torch.no_grad(), noise_generator(gen):
            outs.append(model(x))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3])
    assert not torch.equal(outs[0], outs[2])
    assert [mesh.mesh_coords(r, 2, 2) for r in range(8)] == [
        (d, m, s) for d in range(2) for m in range(2) for s in range(2)]


def test_attention_plan_reasons():
    """With kernels requested, a model or space axis routes every kernel
    off with JAX's reason (JAX ``attention_plan``)."""
    kw = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
              window_size=4, fused_attention=True, fused_patch=True, fused_head=True,
              gelu_tanh=True)
    plain = attention_plan(MSUNet(**kw))
    assert plain[0] == "attention stage 0: grid 8x8 c16 -> kernel (CUDA-core, 16 tokens a window)"
    assert plain[-2:] == ["patch merge/expand: kernel", "head: kernel"]
    for axis, reason in (("model_axis", "tensor parallel"),
                         ("spatial_axis", "spatial sharding")):
        model = MSUNet(**kw, **{axis: "x"})
        lines = attention_plan(model)
        assert [ln.split(" -> ")[1] for ln in lines[:4]] == [f"composed ({reason})"] * 4
        assert lines[4:] == ["patch merge/expand: composed (sharded)",
                             "head: composed (sharded)"]
        sys = model.ms_unet
        assert not any(getattr(m, "fused", False) for m in sys.modules())
        assert not sys.up.fused_refine and not sys.up.fused_gelu_d2s
    off = attention_plan(MSUNet(**{**kw, "fused_attention": False, "fused_patch": False,
                                   "fused_head": False}))
    assert off == [f"attention stage {i}: grid {8 >> i}x{8 >> i} c{16 << i} -> composed "
                   "(disabled)" for i in range(4)]


def test_shard_needs_the_model_axis():
    """Sharding a model whose kernels are not routed off raises."""
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4)
    with pytest.raises(ValueError, match="model_axis"):
        tp.shard_params_tp(model, None)


def test_make_mesh_validation(tmp_path):
    """JAX ``make_mesh``'s text for too few ranks; every rank needs a place;
    a one-rank mesh."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "rdv"),
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="mesh 2x2x1 needs 4 devices, have 1"):
            mesh.make_mesh(n_data=2, n_model=2)
        with pytest.raises(ValueError, match="mesh 1x1x2 needs 2 devices, have 1"):
            mesh.make_mesh(n_space=2)
        m = mesh.make_mesh()
        assert (m.n_data, m.n_model, m.n_space, m.data, m.model, m.space) == (1, 1, 1, 0, 0, 0)
    finally:
        dist.destroy_process_group()


def test_make_spec_defaults_to_the_card():
    """An entry point runs on the card unless asked for the CPU: with no
    GPU, ``make_spec`` without a device raises."""
    if torch.cuda.is_available():
        assert dp_check.make_spec("c.yaml", [], LR)["device"] == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp_check.make_spec("c.yaml", [], LR)
    assert dp_check.make_spec("c.yaml", [], LR, device="cpu")["device"] == "cpu"
