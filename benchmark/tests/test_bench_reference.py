"""The plain reference against the port's composed path (float32, every
kernel knob off) at 64^2 on seeded weights, on the CPU: the forward, and
three train steps with dropout and stochastic depth (loss, gradients,
AdamW), whole and in blocks of rows."""

import copy

import pytest
import torch

from benchmark import spec, weights
from benchmark.reference import train as ref_train
from benchmark.reference.msunet import Arch, Net, Noise, param_shapes
from conftest import tiny_cell

COMPOSED_F32 = {"COMPUTE_DTYPE": "float32", "SOFTMAX_DTYPE": "float32",
                "USE_PALLAS_ATTENTION": False, "FUSED_HEAD": False, "FUSED_PATCH": False,
                "REMAT": "none"}


def _setup(window: int, attn_drop: float = 0.05, drop: float = 0.0):
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet

    conf = copy.deepcopy(tiny_cell("train", WINDOW_SIZE=window).config)
    conf["TPU"].update(COMPOSED_F32)
    conf["MODEL"]["ATTN_DROP_RATE"] = attn_drop
    conf["MODEL"]["DROP_RATE"] = drop
    conf["TRAIN"]["BASE_LR"] = 1e-3
    conf["TRAIN"]["WEIGHT_DECAY"] = 0.01
    arch = Arch.from_config(conf)
    w = weights.make(param_shapes(arch), 3, "cpu")
    model = MSUNet.from_config(spec.port_config(conf, 5), device="cpu")
    weights.load_into(model, w)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (4, 64, 64, 3), generator=g, dtype=torch.uint8)
    masks = (torch.rand(4, 64, 64, generator=g) > 0.7).to(torch.uint8) * 255
    masks[1] = 0
    return conf, arch, w, model, images, masks


def test_parameters_match_the_port():
    conf, arch, w, model, _, _ = _setup(4)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: tuple(s) for n, s in param_shapes(arch)}


@pytest.mark.parametrize("window", [4, 3])
def test_forward_matches_composed_path(window):
    _, arch, w, model, images, _ = _setup(window)
    with torch.no_grad():
        got = model.eval()(images.float() / 255)
        want = Net(arch, w).forward(images.float() / 255, Noise(None, 4))
    assert (got - want).abs().max().item() < 1e-5


@pytest.mark.parametrize("window,rows,drop", [(4, 4, 0.0), (3, 1, 0.0), (4, 2, 0.1)])
def test_train_steps_match_composed_path(window, rows, drop):
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
        create_train_state,
        make_train_step,
    )

    conf, arch, w, model, images, masks = _setup(window, drop=drop)
    node = spec.port_config(conf, 5)
    state = create_train_state(model, node, device="cpu")
    step = make_train_step(model, 0.2, 0.8, 0.45)
    batches = [(images, masks), (images.flip(0), masks.flip(0)),
               (images.roll(1, 0), masks.roll(1, 0))]
    losses, first = [], None
    for k, (x, y) in enumerate(batches):
        losses.append(float(step(state, x, y, 1e-3)))
        if k == 0:
            first = {n: float((state.optimizer.state[p]["exp_avg"] / 0.1).norm())
                     for n, p in model.named_parameters()}
    change = {n: float((p.detach() - w[n]).norm()) for n, p in model.named_parameters()}
    ref = ref_train.train_readings(
        arch, {k: v.clone() for k, v in w.items()}, batches, lr=1e-3, seed=5, ranks=1,
        loss_abc=(0.2, 0.8, 0.45), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
        rows_per_pass=rows)
    assert losses == pytest.approx(ref["loss"], rel=1e-6)
    for n in first:
        assert first[n] == pytest.approx(ref["grad_norm"][n], rel=1e-5, abs=1e-9), n
        assert change[n] == pytest.approx(ref["change_norm"][n], rel=1e-4, abs=1e-9), n


def test_two_ranks_match_one_process_of_both_shards():
    """The reference's data-parallel mean: two shards with their own noise
    equal the mean of two one-shard runs' losses."""
    conf, arch, w, _, images, masks = _setup(4)
    kw = dict(lr=1e-3, seed=5, loss_abc=(0.2, 0.8, 0.45), betas=(0.9, 0.999), eps=1e-8,
              weight_decay=0.01)
    both = ref_train.train_readings(arch, {k: v.clone() for k, v in w.items()},
                                    [(images, masks)], ranks=2, **kw)
    a = ref_train.train_readings(arch, {k: v.clone() for k, v in w.items()},
                                 [(images[:2], masks[:2])], ranks=1, **kw)
    # rank 1 folds its rank into the noise seed: run it as rank 1 of 2 alone
    b_noise = ref_train.noise_seed(5, 0, 0, 1)
    g = torch.Generator().manual_seed(b_noise)
    logits = Net(arch, {k: v.clone() for k, v in w.items()}).forward(
        images[2:].float() / 255, Noise(g, 2))
    b = ref_train.dynamic_loss_per_image(logits, masks[2:], 0.2, 0.8, 0.45).mean().item()
    assert both["loss"][0] == pytest.approx((a["loss"][0] + b) / 2, rel=1e-6)


def test_fp8_control_rounds():
    from benchmark.reference.msunet import Numerics

    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = Numerics(fp8=True)(x)
    assert 0 < (y - x).abs().max().item() < 0.2
    y.sum().backward()
    assert torch.allclose(x.grad, torch.ones_like(x))
