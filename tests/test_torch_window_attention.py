"""Port's window attention vs the JAX package, f32 on the CPU.

The port's kernel-path op (its plain version on the CPU) is held against
``fused_shifted_window_attention`` with the Pallas kernel in interpret
mode, and its composed op against ``shifted_window_attention``, on the
cases of ``tests/test_fused_window_attention.py``: divisible and padded
grids, shifted blocks, window 5, a single window (shift dropped),
multi-strip and wide grids, and windows above 64 tokens: window 12 on a
padded grid (144 tokens, shift 6) and window 22 (484 tokens, shift 11),
which the JAX kernel takes (up to 512 tokens) and the card's tiled kernels
run.  Tolerance: atol = rtol = 2e-5 (float32 sums taken in another
order).

Further, for the card's kernels, what the CPU can reach of them: the
launch plan of the ``mma.sync`` kernels (blocks per head, the runs of
windows) as a pure function, the routing of a (dtype, head width,
tokens) to one of the four kernel families, ``_check_shape``, and the
plain forward against the JAX package at the ragged shapes the card's
corner-case phase uses (through the Pallas kernel in interpret mode
where the JAX gate takes the shape, else through the composed JAX path;
float32, max abs error <= 1e-5).
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
    (30, 26, 16, 2, (12, 12), (6, 6)),
    (44, 44, 16, 2, (22, 22), (11, 11)),
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


# ---------------------------------------------------------------------------
# The launch plan, the routing and the ragged shapes of the card's kernels
# ---------------------------------------------------------------------------
# (batch, windows per image, heads): every attention shape of the 512^2
# batch-8 paths at Swin-B and Swin-T width, then the ragged shapes
PLAN_SHAPES = [(8, 361, 4), (8, 100, 8), (8, 25, 16), (8, 9, 32),
               (8, 361, 3), (8, 100, 6), (8, 25, 12), (8, 9, 24),
               (1, 10, 2), (3, 12, 1), (5, 132, 1), (2, 2, 8), (1, 1, 32), (3, 6, 3),
               (2, 6, 4), (3, 6, 2), (7, 13, 5), (1, 1, 1), (64, 361, 4), (2, 3, 700)]


def check_plan(batch, n_win, heads, sms, per_sm):
    """Every (image, window, head) is walked by exactly one block; returns
    the blocks per head."""
    chunks = fwa.launch_plan(batch, n_win, heads, sms, per_sm)
    total = batch * n_win
    assert 1 <= chunks <= total
    grid = chunks * heads
    assert grid >= 1
    # one wave of resident blocks at most, unless the heads alone exceed it
    assert grid <= max(heads, sms * per_sm)
    seen = np.zeros((heads, total), dtype=np.int64)
    sizes = []
    for block in range(grid):
        chunk, head = divmod(block, heads)
        begin, end = fwa.chunk_range(chunk, chunks, total)
        assert 0 <= begin < end <= total  # no idle block
        seen[head, begin:end] += 1
        sizes.append(end - begin)
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1  # balanced runs
    return chunks


@pytest.mark.parametrize("sms", [132, 108, 1])
@pytest.mark.parametrize("batch,n_win,heads", PLAN_SHAPES)
def test_forward_launch_plan_covers_every_window_once(batch, n_win, heads, sms):
    check_plan(batch, n_win, heads, sms, fwa.FWD_BLOCKS_PER_SM)


def test_launch_plan_rejects_empty_launches():
    for args in [(0, 4, 2, 132, 4), (1, 0, 2, 132, 4), (1, 4, 0, 132, 4), (1, 4, 2, 0, 4),
                 (1, 4, 2, 132, 0)]:
        with pytest.raises(ValueError):
            fwa.launch_plan(*args)


ROUTES = [
    # dtype, head width, tokens, shift inside the window, route
    (torch.float32, 32, 49, True, fwa.ROUTE_CORE),
    (torch.float32, 16, 64, True, fwa.ROUTE_CORE),
    (torch.float32, 7, 25, False, fwa.ROUTE_CORE),
    (torch.bfloat16, 24, 49, True, fwa.ROUTE_CORE),
    (torch.bfloat16, 8, 16, True, fwa.ROUTE_CORE),
    (torch.bfloat16, 16, 49, True, fwa.ROUTE_MMA),
    (torch.bfloat16, 32, 49, True, fwa.ROUTE_MMA),
    (torch.bfloat16, 64, 49, True, fwa.ROUTE_MMA),
    (torch.bfloat16, 32, 64, True, fwa.ROUTE_MMA),
    (torch.bfloat16, 32, 1, True, fwa.ROUTE_MMA),
    (torch.bfloat16, 32, 49, False, fwa.ROUTE_WMMA),
    (torch.bfloat16, 48, 49, True, fwa.ROUTE_WMMA),
    (torch.bfloat16, 96, 25, True, fwa.ROUTE_WMMA),
    (torch.bfloat16, 128, 49, True, fwa.ROUTE_WMMA),
    # windows of more than 64 tokens: the tiled kernels, whatever the shift
    (torch.bfloat16, 32, 65, True, fwa.ROUTE_TILED),
    (torch.float32, 32, 81, True, fwa.ROUTE_TILED),
    (torch.float32, 16, 65, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 32, 144, True, fwa.ROUTE_TILED),
    (torch.float32, 32, 144, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 32, 144, False, fwa.ROUTE_TILED),
    (torch.bfloat16, 64, 484, True, fwa.ROUTE_TILED),
    (torch.float32, 64, 484, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 128, 576, True, fwa.ROUTE_TILED),
    (torch.float32, 24, 144, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 8, 4096, True, fwa.ROUTE_TILED),
]


@pytest.mark.parametrize("dtype,hd,n,inside,route", ROUTES)
def test_kernel_route(dtype, hd, n, inside, route):
    assert fwa.kernel_route(dtype, hd, n, inside) == route


@pytest.mark.parametrize("dtype,hd,n", [
    (torch.float16, 32, 49), (torch.float64, 32, 49), (torch.float16, 32, 144),
    (torch.bfloat16, 129, 144), (torch.float32, 256, 65), (torch.bfloat16, 32, 0),
    (torch.float32, 0, 49), (torch.float32, 0, 144)])
def test_kernel_route_raises_where_no_kernel_takes_the_shape(dtype, hd, n):
    with pytest.raises(ValueError):
        fwa.kernel_route(dtype, hd, n)


@pytest.mark.parametrize("shape,window,heads,ok", [
    ((2, 14, 21, 96), (7, 7), 2, True),
    ((1, 16, 24, 192), (8, 8), 4, True),
    ((2, 18, 18, 96), (9, 9), 2, True),    # 81 tokens: the tiled kernels
    ((1, 26, 36, 96), (13, 12), 2, True),  # 156 tokens, a window of 13 x 12
    ((2, 14, 21, 96), (7, 7), 5, False),   # heads do not divide C
    ((2, 15, 21, 96), (7, 7), 2, False),   # rows not a multiple of the window
    ((2, 14, 20, 96), (7, 7), 2, False),   # columns not a multiple of the window
])
def test_check_shape(shape, window, heads, ok):
    qkv = torch.zeros(shape)
    if ok:
        fwa._check_shape(qkv, *window, heads)
        want = ((fwa.ROUTE_TILED,) if window[0] * window[1] > 64
                else (fwa.ROUTE_MMA, fwa.ROUTE_WMMA, fwa.ROUTE_CORE))
        assert fwa._route(qkv.bfloat16(), *window, heads, 3, 3) in want
    else:
        with pytest.raises(ValueError):
            fwa._route(qkv, *window, heads, 0, 0)


def test_route_of_a_shift_as_wide_as_the_window():
    qkv = torch.zeros((1, 14, 14, 3 * 64), dtype=torch.bfloat16)
    assert fwa._route(qkv, 7, 7, 2, 3, 3) == fwa.ROUTE_MMA
    assert fwa._route(qkv, 7, 7, 2, 7, 3) == fwa.ROUTE_WMMA
    assert fwa._route(qkv.float(), 7, 7, 2, 3, 3) == fwa.ROUTE_CORE
    qkv = torch.zeros((1, 24, 24, 3 * 64), dtype=torch.bfloat16)
    assert fwa._route(qkv, 12, 12, 2, 12, 6) == fwa.ROUTE_TILED


# (B, H, W, C, heads, window, shift): small versions of the shapes of the
# card's corner-case phase
RAGGED = [
    (1, 14, 35, 64, 2, (7, 7), (3, 0)),    # Hp != Wp, one image, shift on one axis
    (3, 21, 28, 32, 1, (7, 7), (0, 0)),    # one head, unshifted
    (2, 7, 14, 32, 2, (7, 7), (0, 3)),     # head width 16
    (1, 7, 7, 128, 2, (7, 7), (0, 0)),     # head width 64, one window
    (3, 21, 14, 128, 2, (7, 7), (2, 3)),   # head width 64, sh != sw
    (2, 16, 24, 64, 2, (8, 8), (4, 3)),    # 64 tokens
    (3, 8, 12, 64, 2, (4, 4), (2, 2)),     # 16 tokens
    (2, 10, 15, 96, 2, (5, 5), (2, 2)),    # head width 48
    (2, 14, 14, 24, 2, (7, 7), (3, 3)),    # head width 12: the JAX gate refuses it
    (2, 13, 16, 32, 2, (7, 7), (3, 3)),    # padded on both axes
]


def ragged_inputs(b, h, w, c, heads, window, seed):
    rng = np.random.default_rng(seed)
    table = (2 * window[0] - 1) * (2 * window[1] - 1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(x=f(b, h, w, c) * 0.5, qkv_kernel=f(c, 3 * c) * 0.1,
               qkv_bias=f(3 * c) * 0.1, proj_kernel=f(c, c) * 0.1,
               proj_bias=f(c) * 0.1, bias_table=f(table, heads) * 0.1)
    return inp, f(b, h, w, c)


def jax_op(shape, window, heads):
    """The JAX function the port's kernel path is held against: the kernel
    op where its gate takes the shape, else the composed op."""
    if jax_fwa.supported(shape, window, heads, dtype=jnp.float32):
        return jax_fwa.fused_shifted_window_attention
    return jax_swa


@pytest.mark.parametrize("b,h,w,c,heads,window,shift", RAGGED)
def test_ragged_forward_matches_jax(b, h, w, c, heads, window, shift):
    inp, _ = ragged_inputs(b, h, w, c, heads, window, seed=3)
    kw = dict(window_size=window, shift_size=shift, num_heads=heads)
    want = jax_op((b, h, w, c), window, heads)(*_jax_args(inp), **kw)
    got = fwa.fused_shifted_window_attention(*_torch_args(inp), **kw)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
