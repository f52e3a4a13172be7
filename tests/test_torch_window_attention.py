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
windows) and of the tiled ``mma.sync`` backward (every window and key band
once) as pure functions, the routing of a (dtype, head width, tokens) to
one of the five kernel families, ``_check_shape``, and the
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
    # windows of more than 64 tokens, whatever the shift: the tiled mma.sync
    # kernels in bfloat16 at head widths that are a multiple of 16, the tiled
    # kernels on the CUDA cores in float32 and at the other widths
    (torch.bfloat16, 32, 65, True, fwa.ROUTE_TILED_MMA),
    (torch.float32, 32, 81, True, fwa.ROUTE_TILED),
    (torch.float32, 16, 65, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 32, 144, True, fwa.ROUTE_TILED_MMA),
    (torch.float32, 32, 144, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 32, 144, False, fwa.ROUTE_TILED_MMA),
    (torch.bfloat16, 64, 484, True, fwa.ROUTE_TILED_MMA),
    (torch.float32, 64, 484, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 128, 576, True, fwa.ROUTE_TILED_MMA),
    (torch.float32, 24, 144, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 8, 4096, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 24, 144, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 8, 144, True, fwa.ROUTE_TILED),
    (torch.float32, 128, 144, True, fwa.ROUTE_TILED),
    (torch.bfloat16, 16, 65, True, fwa.ROUTE_TILED_MMA),
    (torch.bfloat16, 48, 144, True, fwa.ROUTE_TILED_MMA),
    (torch.bfloat16, 112, 81, False, fwa.ROUTE_TILED_MMA),
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
        want = ((fwa.ROUTE_TILED_MMA,) if window[0] * window[1] > 64
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
    assert fwa._route(qkv, 12, 12, 2, 12, 6) == fwa.ROUTE_TILED_MMA
    assert fwa._route(qkv.float(), 12, 12, 2, 12, 6) == fwa.ROUTE_TILED


# (batch, windows per image, heads, tokens, head width) of the tiled
# mma.sync backward: the window-12 stage shapes of the Swin-B 512^2 batch-8
# paths, then the shapes of chip_smoke.py's W12_CORNERS that take the route
TILED_MMA_PLANS = [(8, 121, 4, 144, 32), (8, 36, 8, 144, 32), (8, 9, 16, 144, 32),
                   (8, 4, 32, 144, 32), (2, 4, 2, 65, 32), (1, 6, 1, 144, 32),
                   (2, 4, 6, 144, 16), (2, 4, 2, 144, 64), (1, 6, 2, 144, 128),
                   (1, 4, 2, 144, 48), (4, 64, 4, 81, 128), (1, 4, 2, 484, 64),
                   (1, 1, 2, 576, 128)]


def tiled_mma_bwd_blocks(plan, batch, n_win, n, hd):
    """The work of each backward block of one head, ``(first window, end
    window, first key, end key)`` in block order, as
    ``csrc/fused_window_attention_tiled.cu`` indexes its grids: the one-block
    kernel's block ``c`` (``tm_run``) takes the run ``chunk_range`` gives it
    and every key; the split kernel's block ``g * chunks + k``
    (``window_attention_bwd_ts_kernel``) takes the ``plan`` windows of group
    ``g`` and the keys of 64-token chunk ``k``.  A copy of the kernels'
    indexing: the card's comparisons show that the kernels follow it."""
    total = batch * n_win
    if fwa.tiled_mma_one_block(n, hd, True):
        return [(*fwa.chunk_range(c, plan, total), 0, n) for c in range(plan)]
    chunks = -(-n // fwa.TILED_MMA_SPLIT)
    return [(g * plan, min(total, (g + 1) * plan), k * fwa.TILED_MMA_SPLIT,
             min(n, (k + 1) * fwa.TILED_MMA_SPLIT))
            for g in range(-(-total // plan)) for k in range(chunks)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("batch,n_win,heads,n,hd", TILED_MMA_PLANS)
def test_tiled_mma_backward_plan_covers_every_window_and_key_band_once(
        batch, n_win, heads, n, hd, sms):
    """Every (window, 16-key band) pair of a head is the work of exactly one
    block of the kernels' indexing at the plan :func:`fwa.bwd_plan` gives;
    the one-block kernel's grid is one wave, the split kernel's scratch
    holds its partials, statistics and dq partials."""
    plan, scratch = fwa.bwd_plan(fwa.ROUTE_TILED_MMA, batch, n_win, heads, n, sms, hd)
    blocks = tiled_mma_bwd_blocks(plan, batch, n_win, n, hd)
    total, bands = batch * n_win, -(-n // 16)
    seen = np.zeros((total, bands), dtype=np.int64)
    for w0, w1, k0, k1 in blocks:
        assert 0 <= w0 < w1 <= total and 0 <= k0 < k1 <= n and k0 % 16 == 0
        seen[w0:w1, k0 // 16:-(-k1 // 16)] += 1
    assert (seen == 1).all()
    if fwa.tiled_mma_one_block(n, hd, True):
        assert len(blocks) == plan and plan * heads <= max(heads, sms)
        assert scratch == (plan, heads, n, fwa.TILED_MMA_CHUNK)
    else:
        chunks = -(-n // fwa.TILED_MMA_SPLIT)
        groups = -(-total // plan)
        assert len(blocks) == groups * chunks
        assert scratch[0] >= groups * heads * n * n + total * heads * n * 4 \
            + chunks * total * n * heads * hd


def test_tiled_mma_backward_scratch_at_window_12_stage_0():
    """Swin-B 512^2 b8 window 12, stage 0 on a 132-SM card: 33 blocks a head
    walk the 968 windows, each with a 144 x 144 float32 partial a head."""
    assert fwa.bwd_plan(fwa.ROUTE_TILED_MMA, 8, 121, 4, 144, 132, 32) == \
        (33, (33, 4, 144, 144))
    assert [fwa.tiled_mma_one_block(n, hd, bwd) for n, hd, bwd in [
        (144, 32, True), (144, 64, True), (144, 64, False), (144, 128, False),
        (145, 16, False), (65, 16, True)]] \
        == [True, False, True, True, False, True]


# (route, batch, windows per image, heads, tokens, head width, SMs, plan):
# blocks per head for the mma.sync kernels and the one-block tiled mma.sync
# forward (one wave), 1 for the kernels that take no plan
FWD_PLANS = [
    (fwa.ROUTE_MMA, 8, 324, 4, 49, 32, 132, 132),
    (fwa.ROUTE_MMA, 1, 1, 32, 49, 64, 132, 1),
    (fwa.ROUTE_TILED_MMA, 8, 121, 4, 144, 32, 132, 33),
    (fwa.ROUTE_TILED_MMA, 8, 4, 32, 144, 32, 132, 4),
    (fwa.ROUTE_TILED_MMA, 2, 4, 2, 144, 64, 132, 8),
    (fwa.ROUTE_TILED_MMA, 1, 6, 2, 144, 128, 132, 6),
    (fwa.ROUTE_TILED_MMA, 1, 4, 2, 484, 64, 132, 1),
    (fwa.ROUTE_TILED, 8, 121, 4, 144, 32, 132, 1),
    (fwa.ROUTE_WMMA, 8, 324, 4, 49, 48, 132, 1),
    (fwa.ROUTE_CORE, 8, 324, 4, 49, 24, 132, 1),
]


@pytest.mark.parametrize("route,batch,n_win,heads,n,hd,sms,want", FWD_PLANS)
def test_forward_plan(route, batch, n_win, heads, n, hd, sms, want):
    assert fwa.fwd_plan(route, batch, n_win, heads, n, sms, hd) == want


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
