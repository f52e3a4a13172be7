"""Recomputation (``TPU.REMAT``, ``TRAIN.USE_CHECKPOINT``) in the port, on
the CPU:

* (a) ``MSUNet.from_config`` resolves the memory policy and each stage's
  recompute flag as JAX ``MSUNet.from_config`` / ``MSUNetSys._stage_remat``
  do, over a grid of modes, sizes, drop rates and the attention knob; the
  shipped ``config.yaml`` resolves to ``high_res`` in both;
* (b) with dropout, attention dropout and stochastic depth on, a train step
  under ``full``, ``dots`` and ``high_res`` gives the loss, every gradient
  and the generator's final state of the ``none`` step, in bits, with the
  same ``state_dict()`` keys; a recompute that drew from the live generator
  would not; ``dots`` keeps the blocks' linears and ``full`` recomputes
  them; the recomputed stages keep fewer bytes for the backward;
* (d) a frozen encoder stays bit-unchanged under recomputation.

(c), the recomputed train step against JAX's, is
``tests/test_torch_remat_jax.py``.
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    default_config as jax_default_config,
    load_config as jax_load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.models.msunet import (
    MSUNetSys as JaxMSUNetSys,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
    default_config,
    load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models import layers
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
    MSUNet,
    init_weights,
    resolve_remat,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import optim, state

MODES = ("auto", "none", "full", "dots", "high_res", "unknown")
# (ATTN_DROP_RATE, DROP_RATE): the attention kernel trains only with both 0
RATES = ((0.0, 0.0), (0.05, 0.0), (0.0, 0.1))
# widths 64/128/256/512: high_res recomputes the first three, not the last
SMALL = dict(img_size=64, embed_dim=64, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
             window_size=4, gelu_tanh=True)
NOISE = {"all": dict(drop_rate=0.1, attn_drop_rate=0.05, drop_path_rate=0.1),
         "drop_path": dict(drop_path_rate=0.1)}  # the second trains the kernels
POLICIES = {"none": {}, "full": dict(use_remat=True),
            "dots": dict(use_remat=True, remat_policy="dots"),
            "high_res": dict(remat_high_res=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread (the test workers share the machine's cores), set
    before the module's ``none`` steps are taken: a step's float32 sums
    follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set(cfg, values):
    for key, value in values.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[leaf] = value


def _stages(model):
    u = model.ms_unet
    return [st for st in itertools.chain(u.layers, u.layers_up[1:], u.layers_cent1[1:],
                                         u.layers_cent2[1:])]


@pytest.mark.parametrize("size", [512, 1024])
@pytest.mark.parametrize("mode", MODES)
def test_remat_flags_match_jax(mode, size):
    built = set()  # the stages' flags follow from the resolved triple alone
    for use_ckpt, (attn_drop, drop), kernel in itertools.product(
            (False, True), RATES, (True, False)):
        values = {"DATA.IMG_SIZE": size, "TPU.REMAT": mode,
                  "TRAIN.USE_CHECKPOINT": use_ckpt, "MODEL.ATTN_DROP_RATE": attn_drop,
                  "MODEL.DROP_RATE": drop, "TPU.USE_PALLAS_ATTENTION": kernel,
                  "MODEL.SWIN.EMBED_DIM": 64, "MODEL.SWIN.DEPTHS": [1, 1, 1, 1],
                  "MODEL.SWIN.NUM_HEADS": [2, 2, 2, 2], "MODEL.SWIN.WINDOW_SIZE": 4}
        jcfg = jax_default_config()
        jcfg.defrost()
        _set(jcfg, values)
        jm = JaxMSUNet.from_config(jcfg)
        cfg = default_config()
        _set(cfg, values)
        case = (mode, size, use_ckpt, attn_drop, drop, kernel)
        flags = resolve_remat(cfg)
        assert flags == (jm.use_remat, jm.remat_high_res, jm.remat_policy), case
        if flags in built:
            continue
        built.add(flags)
        model = MSUNet.from_config(cfg, device="cpu")
        jsys = JaxMSUNetSys(embed_dim=64, use_remat=jm.use_remat,
                            remat_high_res=jm.remat_high_res)
        for st in _stages(model):
            dim = st.blocks[0].norm1.weight.shape[0]
            assert st.remat == jsys._stage_remat(dim), (case, dim)
            assert st.remat_policy == jm.remat_policy, case


def test_shipped_config_resolves_to_high_res():
    jm = JaxMSUNet.from_config(jax_load_config("config.yaml"))
    flags = resolve_remat(load_config("config.yaml"))
    assert flags == (jm.use_remat, jm.remat_high_res, jm.remat_policy) == (False, True, "")


def _batch(seed=0, b=2, size=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            (rng.random((b, size, size)) > 0.7).astype(np.uint8))


def _step(policy, noise, kernels=True):
    model = MSUNet(**SMALL, **NOISE[noise], **POLICIES[policy],
                   fused_attention=kernels, fused_patch=kernels, fused_head=kernels)
    init_weights(model, 3)
    st = state.create_train_state(model, default_config(), device="cpu")
    loss = state.make_train_step(model, 0.2, 0.8, 0.45)(st, *_batch(), 1e-4)
    return (loss, {n: p.grad for n, p in model.named_parameters()},
            st.generator.get_state(), list(model.state_dict()))


@pytest.fixture(scope="module")
def none_steps():
    return {noise: _step("none", noise) for noise in NOISE}


@pytest.mark.parametrize("noise", sorted(NOISE))
@pytest.mark.parametrize("policy", ["full", "dots", "high_res"])
def test_recomputed_step_equals_none_in_bits(policy, noise, none_steps):
    loss, grads, gen_state, keys = _step(policy, noise)
    want_loss, want_grads, want_state, want_keys = none_steps[noise]
    assert torch.equal(loss, want_loss)
    assert keys == want_keys
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name
    assert torch.equal(gen_state, want_state)


def test_replay_from_the_live_generator_would_differ(monkeypatch, none_steps):
    """The check above is sensitive: a recompute that draws on from the live
    generator (masks other than the forward's) moves the gradients and the
    generator's final state."""

    @contextlib.contextmanager
    def live(recompute, generator, state_):
        with recompute, layers.noise_generator(generator):
            yield

    want_loss, want_grads, want_state, _ = none_steps["all"]
    monkeypatch.setattr(layers, "_replaying", live)
    loss, grads, gen_state, _ = _step("full", "all")
    assert torch.equal(loss, want_loss)  # the forward is the same
    assert any(not torch.equal(grads[n], g) for n, g in want_grads.items())
    assert not torch.equal(gen_state, want_state)


class _CountAddmm(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.addmm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["none", "full", "dots"])
def test_dots_keeps_the_linears_full_recomputes_them(policy):
    """The blocks' linears (all with a bias: ``addmm``) run again in the
    backward under ``full`` only; ``dots`` keeps their outputs."""
    model = MSUNet(**SMALL, **NOISE["all"], **POLICIES[policy])
    init_weights(model, 3)
    model.train()
    x = torch.from_numpy(_batch()[0]).float() / 255.0
    gen = torch.Generator().manual_seed(0)
    with layers.noise_generator(gen):
        fwd = _CountAddmm()
        with fwd:
            out = model(x)
    bwd = _CountAddmm()
    with bwd:
        out.float().square().mean().backward()
    # 4 linears a block, 20 blocks, and 6 skip reductions outside them; the
    # last stage of each cent decoder (2 + 2 blocks) reaches no loss, so no
    # backward recomputes it
    assert fwd.n == 4 * 20 + 6
    assert bwd.n == (4 * (20 - 4) if policy == "full" else 0)


def _saved_bytes(policy):
    model = MSUNet(**SMALL, **NOISE["drop_path"], **POLICIES[policy])
    init_weights(model, 3)
    model.train()
    x = torch.from_numpy(_batch()[0]).float() / 255.0
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with layers.noise_generator(torch.Generator().manual_seed(0)), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x)
    return total[0]


def test_recomputed_stages_keep_less_for_the_backward():
    """Bytes the autograd graph keeps outside the recomputed blocks (a block
    under checkpoint keeps its input through its own hooks)."""
    none, high, full = (_saved_bytes(p) for p in ("none", "high_res", "full"))
    assert full < high < none, (full, high, none)


def test_frozen_encoder_is_unchanged_under_recomputation():
    model = MSUNet(**SMALL, **NOISE["all"], **POLICIES["full"])
    init_weights(model, 3)
    cfg = default_config()
    st = state.create_train_state(model, cfg, device="cpu")
    st.optimizer = optim.build_optimizer(cfg, model, {0, 1, 2, 3})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = state.make_train_step(model, 0.2, 0.8, 0.45)
    for i in range(2):
        step(st, *_batch(i), 1e-2)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert any(n.startswith("ms_unet.layers.0.blocks.") for n in frozen)
    for n, p in model.named_parameters():
        if n in frozen:
            assert p.grad is None and torch.equal(p, before[n]), n
        elif ".layers_up.1.blocks.0." in n and n.endswith("qkv.weight"):
            assert not torch.equal(p, before[n]), n
