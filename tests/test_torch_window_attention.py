"""Port's window attention vs the JAX package, f32 on the CPU.

The port's kernel-path op (its plain version on the CPU) is held against
``fused_shifted_window_attention`` with the Pallas kernel in interpret
mode, and its composed op against ``shifted_window_attention``, on the
cases of ``tests/test_fused_window_attention.py``: divisible and padded
grids, shifted blocks, window 5, a single window (shift dropped),
multi-strip and wide grids.  Tolerance: atol = rtol = 2e-5 (float32
sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import (
    fused_window_attention as jax_fwa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops.window_attention import (
    shifted_window_attention as jax_swa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import (
    fused_window_attention as fwa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops.window_attention import (
    shifted_window_attention,
)

TOL = dict(atol=2e-5, rtol=2e-5)

CASES = [
    # (H, W, C, heads, window, shift)
    (14, 14, 16, 2, (7, 7), (0, 0)),
    (14, 14, 16, 2, (7, 7), (3, 3)),
    (16, 16, 16, 2, (7, 7), (0, 0)),
    (16, 16, 16, 2, (7, 7), (3, 3)),
    (10, 12, 24, 3, (5, 5), (2, 2)),
    (7, 7, 16, 2, (7, 7), (3, 3)),
    (7, 77, 16, 2, (7, 7), (3, 0)),
    (28, 98, 16, 2, (7, 7), (3, 3)),
    (14, 147, 16, 2, (7, 7), (0, 3)),
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fwa, "INTERPRET", True)


def _inputs(h, w, c, heads, window, seed=0):
    rng = np.random.default_rng(seed)
    table = (2 * window[0] - 1) * (2 * window[1] - 1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(2, h, w, c) * 0.5, qkv_kernel=f(c, 3 * c) * 0.1,
                qkv_bias=f(3 * c) * 0.1, proj_kernel=f(c, c) * 0.1,
                proj_bias=f(c) * 0.1, bias_table=f(table, heads) * 0.1)


def _jax_args(inp):
    return [jnp.asarray(inp[k]) for k in ("x", "qkv_kernel", "qkv_bias",
                                           "proj_kernel", "proj_bias", "bias_table")]


def _torch_args(inp):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    return [t["x"], t["qkv_kernel"].T, t["qkv_bias"], t["proj_kernel"].T,
            t["proj_bias"], t["bias_table"]]


@pytest.mark.parametrize("h,w,c,heads,window,shift", CASES)
def test_kernel_path_matches_jax_kernel(h, w, c, heads, window, shift):
    inp = _inputs(h, w, c, heads, window)
    kw = dict(window_size=window, shift_size=shift, num_heads=heads)
    want = jax_fwa.fused_shifted_window_attention(*_jax_args(inp), **kw)
    got = fwa.fused_shifted_window_attention(*_torch_args(inp), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,w,c,heads,window,shift", CASES)
def test_composed_matches_jax_composed(h, w, c, heads, window, shift):
    inp = _inputs(h, w, c, heads, window, seed=1)
    kw = dict(window_size=window, shift_size=shift, num_heads=heads)
    want = jax_swa(*_jax_args(inp), **kw)
    got = shifted_window_attention(*_torch_args(inp), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
