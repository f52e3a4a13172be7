"""Spatial sharding: the port's H-slab exchange, and its dp x sp train step
over 2 x 2 and 2 x 4 ``gloo`` ranks against the JAX package's step, on the
CPU.

In-process: the exchange plan of ``parallel/spatial.py`` (pure), and
``pack`` / ``unpack`` / ``pack_back`` / ``unpack_back`` routed between
emulated ranks as ``all_to_all`` would route them, against plain slicing of
the whole map (rows that wrap modulo the period, zero rows past the height,
empty slabs, rows asked for by several ranks), forward in bits and
backward against autograd of the plain slicing to 1e-12 in float64; the
window-aligned slabs of
Swin-B's 512^2 grids and of the small models below; a spatial forward with
no space group raises; the patch embedding on an empty slab (a space rank
with no pixel rows) keeps its parameters in the graph with zero gradients,
and the train step's one space-group gradient buffer lists every trainable
parameter on an empty rank as on a rank with rows (the other ranks'
rows emulated as zeros).

Spawned (``tools/dp_check.py::spawn_steps``, ranks ``(d, s)`` = ``(0, 0),
(0, 1), (1, 0), (1, 1)``, or ``(0, 0)`` to ``(1, 3)`` with four space
ranks, the port's YAML with ``TPU.SPATIAL_AXIS: space`` and every kernel
knob on, which the axis routes off), from the JAX init
through the weight bridge, drop rates 0, global batch 4 (2 a data rank),
against JAX's step on the whole batch (JAX
``tests/test_parallel.py::test_spatial_sharded_step_matches_unsharded``
holds its spatial step to that one to 2e-5):

* JAX ``test_parallel.py``'s model (32^2, embed 16, depths 1/1/1/1, heads
  2, window 4): the stage grids 8/4/2/1 pad to 8/4/4/4, so at stages 1-3
  space rank 1 holds zero rows;
* ``__graft_entry__._dryrun_impl``'s dp x sp model (64^2, embed 32, depths
  2/2/2/2, heads 2/2/4/4, window 7): grids 16/8/4/2 pad to 21/14/7/7, the
  slabs are uneven and the shifted windows of stage 0 cross the ranks;
* JAX's own mesh for that test's model, data 2 x space 4 (8 ranks): stage
  0's 8 rows make two windows of 4, so space ranks 2 and 3 hold no pixel
  rows and run every module on empty slabs.

Each case holds the loss to 2e-5 and the parameters to 1e-5 for all but
1e-3 of the elements and to Adam's bound ``2 * lr * steps`` for all.

Every rank reports the same loss, and the ranks end with equal
parameters in bits.  JAX's step is computed once per model and shared by
its cases.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    load_config as jax_load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import state as jax_state
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.layers import PatchEmbed
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
    MSUNet,
    init_weights,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh, spatial
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import dp_check

YAML = """\
DATA:
  IMG_SIZE: {img}
MODEL:
  DROP_RATE: 0.0
  ATTN_DROP_RATE: 0.0
  DROP_PATH_RATE: 0.0
  PRETRAIN_WEIGHTS: none
  SWIN:
    EMBED_DIM: {embed}
    DEPTHS: {depths}
    NUM_HEADS: {heads}
    WINDOW_SIZE: {window}
TPU:
  COMPUTE_DTYPE: float32
  USE_PALLAS_ATTENTION: {kernels}
  FUSED_HEAD: {kernels}
  FUSED_PATCH: {kernels}
  GELU_TANH: false
  REMAT: none
  SPATIAL_AXIS: '{axis}'
"""
SETTINGS = {
    "jax_test": dict(img=32, embed=16, depths=[1, 1, 1, 1], heads=[2, 2, 2, 2], window=4),
    "dryrun": dict(img=64, embed=32, depths=[2, 2, 2, 2], heads=[2, 2, 4, 4], window=7),
}
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: conv weight gradients sum in one order (fault 4)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain_rows(full, height, period, lo, hi):
    """Rows ``[lo, hi)`` of ``full``, wrapping modulo ``period``, zero rows
    at or past ``height``."""
    padded = torch.cat([full, torch.zeros_like(full[:, :1])], 1)
    idx = [g % period if g % period < height else height for g in range(lo, hi)]
    return padded[:, idx]


def emulate(full, bounds, period, requests):
    """Each rank's fetched rows and plan, routed between emulated ranks as
    ``all_to_all`` routes them."""
    n, height = len(bounds), full.shape[1]
    plans = [spatial.exchange_plan(bounds, height, period, requests, r) for r in range(n)]
    sends = [spatial.pack(full[:, lo:hi], p) for (lo, hi), p in zip(bounds, plans)]
    pieces = [list(torch.split(s, list(p.send_counts), dim=1)) for s, p in zip(sends, plans)]
    outs = [spatial.unpack(torch.cat([pieces[s][d] for s in range(n)], 1), plans[d])
            for d in range(n)]
    return outs, plans


def emulate_back(grads, bounds, plans):
    """The slabs' gradients for the fetched rows' ``grads``, routed back."""
    n = len(bounds)
    backs = [spatial.pack_back(g, p) for g, p in zip(grads, plans)]
    pieces = [list(torch.split(b, list(p.recv_counts), dim=1)) for b, p in zip(backs, plans)]
    return [spatial.unpack_back(torch.cat([pieces[d][s] for d in range(n)], 1), plans[s],
                                hi - lo) for s, (lo, hi) in enumerate(bounds)]


CASES = [
    # bounds, height, period, requests
    (((0, 3), (3, 5)), 5, 5, ((0, 3), (3, 5))),                 # own rows: nothing moves
    (((0, 3), (3, 5)), 5, 7, ((1, 4), (4, 9))),                 # a shift: wraps, zero rows
    (((0, 5), (5, 5)), 5, 7, ((2, 9), (0, 0))),                 # an empty slab
    (((0, 2), (2, 2), (2, 6)), 6, 7, ((-1, 3), (1, 3), (1, 7))),  # halos, shared rows
    (((0, 4), (4, 6)), 6, 6, ((0, 6), (0, 6))),                 # everything everywhere
    (((0, 0), (0, 3)), 3, 4, ((2, 2), (-2, 5))),                # longer than the map
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_exchange_against_plain_slicing(case):
    bounds, height, period, requests = CASES[case]
    g = torch.Generator().manual_seed(case)
    full = torch.randn(2, height, 3, 4, generator=g, dtype=torch.float64, requires_grad=True)
    outs, plans = emulate(full.detach(), bounds, period, requests)
    wants = [plain_rows(full, height, period, lo, hi) for lo, hi in requests]
    for out, want, plan in zip(outs, wants, plans):
        assert torch.equal(out, want.detach())
        assert plan.size == out.shape[1]
    remote = any(s != d for d in range(len(bounds))
                 for s, (lo, hi) in enumerate(bounds)
                 if any(lo <= r % period < hi for r in range(*requests[d])))
    assert all(p.remote == remote for p in plans)
    grads = [torch.randn(w.shape, generator=g, dtype=torch.float64) for w in wants]
    slab_grads = emulate_back(grads, bounds, plans)
    want_grad, = torch.autograd.grad(wants, full, grads)
    # a row several ranks asked for sums their gradients in another order
    torch.testing.assert_close(torch.cat(slab_grads, 1), want_grad, rtol=0, atol=1e-12)


def test_exchange_plan_by_hand():
    """Two ranks hold rows [0, 3) and [3, 5) of 5, padded to 7; rank 0 asks
    for rows [1, 4), rank 1 for [4, 9) (a shift by 1 of rows [3, 8))."""
    bounds, requests = ((0, 3), (3, 5)), ((1, 4), (4, 9))
    p0 = spatial.exchange_plan(bounds, 5, 7, requests, 0)
    p1 = spatial.exchange_plan(bounds, 5, 7, requests, 1)
    # rank 0 sends its rows 1, 2 to itself and 0, 1 (global 7 -> 0, 8 -> 1) to rank 1
    assert (p0.send_index, p0.send_counts) == ((1, 2, 0, 1), (2, 2))
    assert (p0.recv_pos, p0.recv_counts, p0.size) == ((0, 1, 2), (2, 1), 3)
    # rank 1 sends its row 0 (global 3) to rank 0 and row 1 (global 4) to itself;
    # global rows 5 and 6 are padding: zeros at positions 1 and 2
    assert (p1.send_index, p1.send_counts) == ((0, 1), (1, 1))
    assert (p1.recv_pos, p1.recv_counts, p1.size) == ((3, 4, 0), (2, 1), 5)
    assert p0.remote and p1.remote
    with pytest.raises(ValueError, match="do not cover"):
        spatial.exchange_plan(((0, 2), (3, 5)), 5, 5, ((0, 1), (0, 1)), 0)


def test_window_slabs():
    """Swin-B 512^2 over two space ranks: uneven slabs, one window row
    apart; the small models' deep stages leave a rank empty."""
    got = [spatial.window_slabs(g, 7, 2).bounds for g in (128, 64, 32, 16)]
    assert got == [((0, 70), (70, 128)), ((0, 35), (35, 64)), ((0, 21), (21, 32)),
                   ((0, 14), (14, 16))]
    assert [spatial.window_slabs(g, 4, 2).bounds for g in (8, 4, 2, 1)] == [
        ((0, 4), (4, 8)), ((0, 4), (4, 4)), ((0, 2), (2, 2)), ((0, 1), (1, 1))]
    assert spatial.window_slabs(16, 7, 4).bounds == ((0, 7), (7, 14), (14, 16), (16, 16))
    for grid, window, size in itertools.product((1, 5, 16, 33), (4, 7), (1, 2, 3, 4)):
        slabs = spatial.window_slabs(grid, window, size)
        assert slabs.bounds[0][0] == 0 and slabs.bounds[-1][1] == grid
        assert all(a[1] == b[0] for a, b in zip(slabs.bounds, slabs.bounds[1:]))
    assert spatial.window_slabs(16, 7, 2).scaled(4).bounds == ((0, 56), (56, 64))


def test_spatial_forward_without_a_group_raises():
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4, spatial_axis="space")
    with pytest.raises(RuntimeError, match="no space group is attached"):
        model(torch.zeros(1, 32, 32, 3))
    with pytest.raises(ValueError, match="spatial_axis"):
        spatial.attach_space(MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1),
                                    num_heads=(2,) * 4, window_size=4), None)


def test_patch_embed_on_an_empty_slab():
    """No pixel rows: ``(B, 0, W/4, E)``, and every parameter of the conv
    and the norm gets a zero gradient (not ``None``)."""
    embed = PatchEmbed(4, 3, 16, True, torch.float32)
    init_weights(embed, 0)
    y = embed(torch.rand(2, 0, 32, 3))
    assert y.shape == (2, 0, 8, 16)
    y.sum().backward()
    for name, p in embed.named_parameters():
        assert p.grad is not None and torch.equal(p.grad, torch.zeros_like(p)), name
    rows = embed(torch.rand(2, 4, 32, 3))  # a slab with rows is unchanged
    assert rows.shape == (2, 1, 8, 16) and bool(rows.abs().sum() > 0)


def _space_buffer(me, monkeypatch):
    """One train step of JAX's 32^2 model as space rank ``me`` of four, the
    other ranks' rows emulated as zeros: the parameters the step sums over
    the space group in its one buffer, and those left without a gradient
    by the backward alone."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import default_config
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
        create_train_state,
        make_train_step,
    )

    monkeypatch.setattr(spatial.dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(spatial.dist, "get_rank", lambda group=None: me)
    monkeypatch.setattr(spatial, "_all_to_all", lambda send, out_counts, in_counts, group:
                        send.new_zeros((send.shape[0], sum(out_counts)) + send.shape[2:]))
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4, spatial_axis="space")
    space = spatial.attach_space(model, None)
    state = create_train_state(model, default_config(), device="cpu")
    state.mesh = mesh.Mesh(1, 1, 4, 0, 0, me, None, None, None)
    listed, untouched = [], []
    names = {id(p): n for n, p in model.named_parameters()}

    def record(params, group, src=None):
        untouched.extend(n for n, p in model.named_parameters()
                         if p.grad is not None and p.grad.count_nonzero() == 0)
        listed.extend(names[id(p)] for p in params)

    monkeypatch.setattr(mesh, "_reduce_grads", record)
    rng = np.random.default_rng(0)
    step = make_train_step(model, 0.2, 0.8, 0.45)
    step(state, rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8),
         (rng.random((1, 32, 32)) > 0.8).astype(np.uint8), 1e-3)
    return space.rows(8), listed, untouched


def test_an_empty_space_rank_lists_every_gradient(monkeypatch):
    """Space rank 3 of four at 32^2 holds no rows at any stage; rank 0
    holds rows at every stage.  Both sum every trainable parameter's
    gradient over the space group in one buffer, in the same order (the
    train step gives a parameter the backward left without one a zero
    gradient), so the buffers line up across the ranks."""
    rows0, listed0, _ = _space_buffer(0, monkeypatch)
    rows3, listed3, zeros3 = _space_buffer(3, monkeypatch)
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4)
    assert rows0 == (0, 4) and rows3 == (8, 8)
    assert listed0 == listed3 == [n for n, _ in model.named_parameters()]
    assert {"ms_unet.patch_embed.proj.weight", "ms_unet.up.refine1.weight"} <= set(zeros3)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def jax_step(cfg_path, img, lbl):
    """JAX's step on the whole batch, from ``PRNGKey(0)``'s init."""
    cfg = jax_load_config(cfg_path)
    model = JaxMSUNet.from_config(cfg)
    size = int(cfg.DATA.IMG_SIZE)
    state = jax_state.create_train_state(model, cfg, jax.random.PRNGKey(0),
                                         jnp.zeros((1, size, size, 3)))
    init = flax_to_state_dict(state.params)
    step = jax_state.make_train_step(model, float(cfg.TRAIN.TVERSKY_LOSS_ALPHA),
                                     float(cfg.TRAIN.TVERSKY_LOSS_BETA),
                                     float(cfg.TRAIN.LOSS_TVERSKY_BCE_MIX), donate=False)
    state, loss = step(state, jnp.asarray(img), jnp.asarray(lbl), jnp.asarray(LR, jnp.float32))
    return init, jax.device_get(state.params), float(loss)


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """``reference(setting)``: the setting's batch and JAX's step on it,
    computed once for the module."""
    cache = {}

    def reference(setting):
        if setting not in cache:
            kw = SETTINGS[setting]
            size = kw["img"]
            rng = np.random.default_rng(3)
            img = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
            lbl = (rng.random((4, size, size)) > 0.8).astype(np.uint8)
            path = tmp_path_factory.mktemp(setting) / "jax.yaml"
            path.write_text(YAML.format(kernels="false", axis="", **kw))
            cache[setting] = (img, lbl) + jax_step(str(path), img, lbl)
        return cache[setting]

    return reference


@pytest.mark.parametrize("setting,n_space", [
    pytest.param("jax_test", 2, id="jax_test"),
    pytest.param("dryrun", 2, id="dryrun"),
    pytest.param("jax_test", 4, id="jax_test-2x4"),
])
def test_sp_step_matches_jax(setting, n_space, jax_reference, tmp_path):
    img, lbl, init, want, want_loss = jax_reference(setting)
    port_path = tmp_path / "sp.yaml"
    port_path.write_text(YAML.format(kernels="true", axis="space", **SETTINGS[setting]))
    spec = dp_check.make_spec(str(port_path), [(img, lbl)], LR, state_dict=init,
                              device="cpu", n_space=n_space)
    ranks = dp_check.spawn_steps(spec, 2 * n_space, str(tmp_path / "ranks"))
    assert [r["coords"] for r in ranks] == [(d, 0, s) for d in range(2) for s in range(n_space)]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert all(torch.equal(r["digest"], ranks[0]["digest"]) for r in ranks)
    assert abs(ranks[0]["losses"][0] - want_loss) <= 2e-5
    got = dict(_flat(state_dict_to_flax(ranks[0]["state_dict"])))
    n_far = n_all = 0
    for k, w in _flat(want):
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * LR, ("/".join(k), diff.max())
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
