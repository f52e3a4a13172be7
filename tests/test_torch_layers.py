"""Port's training features of the layers, on the CPU.

Noise cannot match JAX's random bits, so draws are checked statistically
(bounds of 5 standard deviations of a binomial count), and everything
else deterministically:

* stochastic depth ("row"): whole samples kept with probability 1-p and
  scaled by 1/(1-p) in the input dtype; identity in eval mode;
* dropout: elements kept with probability 1-p, scaled by 1/(1-p);
  identity in eval mode; a generator is required in training;
* with attention dropout > 0 in train mode the attention kernel wrapper
  is not called (the composed op runs, JAX ``models/layers.py:257-262``),
  and in eval mode it is;
* the drop-path schedule equals JAX ``_dpr``/``_stage_slice``, with
  decoder and cent stages on their mirrored encoder stage's slice.
"""

import math

import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.models import msunet as jax_msunet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models import layers
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models import msunet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_window_attention


def _within(count: int, n: int, p: float) -> bool:
    return abs(count - n * p) <= 5 * math.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stochastic_depth_rows(dtype):
    sd = layers.StochasticDepth(0.3).train()
    x = torch.ones((4000, 2, 3, 4), dtype=dtype)
    with layers.noise_generator(torch.Generator().manual_seed(0)):
        y = sd(x)
    assert y.dtype == dtype
    rows = y.reshape(4000, -1)
    assert (rows == rows[:, :1]).all()  # one draw per sample
    scale = torch.tensor(1.0, dtype=dtype) / 0.7  # 1/keep, rounded as the dtype
    kept = rows[:, 0] != 0
    assert torch.equal(rows[kept, 0], torch.full_like(rows[kept, 0], scale.item()))
    assert _within(int(kept.sum()), 4000, 0.7)
    assert torch.equal(sd.eval()(x), x)
    assert torch.equal(layers.StochasticDepth(0.0).train()(x), x)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(20000)
    with layers.noise_generator(torch.Generator().manual_seed(1)):
        y = layers.dropout(x, 0.25, True)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert _within(int(kept.sum()), 20000, 0.75)
    assert torch.equal(layers.dropout(x, 0.25, False), x)
    with pytest.raises(ValueError, match="Generator"):
        layers.dropout(x, 0.25, True)


def test_mlp_dropout_only_in_training():
    torch.manual_seed(0)
    mlp = layers.Mlp(8, 16, True, torch.float32, drop=0.5)
    x = torch.randn(64, 8)
    want = mlp.eval()(x)
    with layers.noise_generator(torch.Generator().manual_seed(2)):
        got = mlp.train()(x)
    assert not torch.allclose(got, want)
    assert torch.equal(mlp.eval()(x), want)


def test_attention_dropout_gates_the_kernel(monkeypatch):
    calls = []
    real = fused_window_attention.window_attention

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused_window_attention, "window_attention", spy)
    attn = layers.WindowAttention(16, 2, 4, 2, fused=True, attention_dropout=0.1)
    x = torch.randn(2, 8, 8, 16)
    with layers.noise_generator(torch.Generator().manual_seed(3)):
        attn.train()(x)
    assert calls == []
    attn.eval()(x)
    assert calls == [1]
    # no dropout: the kernel runs in training too
    layers.WindowAttention(16, 2, 4, 2, fused=True).train()(x)
    assert calls == [1, 1]


def test_drop_path_schedule_matches_jax():
    depths = (2, 2, 18, 2)
    dpr = msunet._dpr(0.1, depths)
    assert dpr == jax_msunet._dpr(0.1, depths)
    for s in range(4):
        assert msunet._stage_slice(dpr, depths, s) == jax_msunet._stage_slice(dpr, depths, s)
    m = msunet.MSUNetSys(img_size=32, embed_dim=8, depths=(1, 2, 3, 1),
                         num_heads=(1, 1, 1, 1), window_size=4, drop_path_rate=0.2)
    d = msunet._dpr(0.2, (1, 2, 3, 1))

    def rates(stage):
        return [b.stochastic_depth.rate for b in stage.blocks]

    for i, layer in enumerate(m.layers):
        assert rates(layer) == msunet._stage_slice(d, (1, 2, 3, 1), i)
    for mod, first in ((m.layers_up, 3), (m.layers_cent1, 2), (m.layers_cent2, 1)):
        for i, stage in enumerate(mod):
            if i:  # stage 0 is a PatchExpand
                assert rates(stage) == msunet._stage_slice(d, (1, 2, 3, 1), first - i)
    assert np.isclose(rates(m.layers[3])[-1], 0.2)
