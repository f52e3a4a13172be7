"""The patch kernels' routing and launch plan, as pure functions.

* ``merge_route`` / ``expand_route``: the kernel family a (dtype, C) takes,
  forward and backward, decided before any launch -- the tensor-core
  kernels for bfloat16 at every Swin-B and Swin-T width, the CUDA-core
  kernels for float32 and the other widths that launched before,
  ``ValueError`` where no kernel takes the shape.
* The forward wrappers' launch, captured on ``meta`` tensors: the entry
  point each (dtype, C) takes, its integer arguments, and the bfloat16
  scratch of the tensor-core route (merge's ``n``, M x 4C; expand's ``z``,
  M x 2C); every width routed there has rows of whole 16-byte chunks.
* ``merge_bwd_plan`` / ``expand_bwd_plan``: the split-K chunks cover every
  row exactly once, the grid is never empty, and the scratch the wrapper
  hands the C entry point has the plan's shapes (the wrapper runs on
  ``meta`` tensors with the launch captured, so no card is needed).
"""

import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import _build
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_patch as fp

BF16, F32 = torch.bfloat16, torch.float32
# merge C and expand C of the Swin-B (embed 128) and Swin-T (embed 96) paths
MERGE_WIDTHS = [128, 256, 512, 96, 192, 384]
EXPAND_WIDTHS = [1024, 512, 256, 768, 384, 192]


@pytest.mark.parametrize("dtype,c,want", [
    *[(BF16, c, fp.ROUTE_MMA) for c in MERGE_WIDTHS],
    *[(F32, c, fp.ROUTE_CORE) for c in MERGE_WIDTHS],
    (BF16, 48, fp.ROUTE_CORE), (BF16, 16, fp.ROUTE_CORE), (BF16, 640, fp.ROUTE_CORE),
    (F32, 48, fp.ROUTE_CORE),
])
def test_merge_route(dtype, c, want):
    assert fp.merge_route(dtype, c) == want


@pytest.mark.parametrize("dtype,c,want", [
    *[(BF16, c, fp.ROUTE_MMA) for c in EXPAND_WIDTHS],
    *[(F32, c, fp.ROUTE_CORE) for c in EXPAND_WIDTHS],
    (BF16, 128, fp.ROUTE_CORE), (BF16, 64, fp.ROUTE_CORE), (BF16, 640, fp.ROUTE_CORE),
    (F32, 128, fp.ROUTE_CORE),
])
def test_expand_route(dtype, c, want):
    assert fp.expand_route(dtype, c) == want


@pytest.mark.parametrize("route,dtype,c", [
    (fp.merge_route, BF16, 40), (fp.merge_route, BF16, 8), (fp.merge_route, F32, 0),
    (fp.merge_route, torch.float16, 128),
    (fp.expand_route, BF16, 96), (fp.expand_route, BF16, 1088), (fp.expand_route, F32, 32),
    (fp.expand_route, torch.float16, 256),
])
def test_route_raises_where_no_kernel_takes_the_shape(route, dtype, c):
    with pytest.raises(ValueError):
        route(dtype, c)


def _cdiv(a, b):
    return -(-a // b)


# (M, C, SMs): the 512^2 batch-8 stage shapes, ragged row counts (fewer
# rows than a row tile, a split-K step or a chunk), and other card sizes
PLAN_MERGE = [(32768, 128, 132), (8192, 256, 132), (2048, 512, 132), (32768, 96, 132),
              (8192, 192, 132), (2048, 384, 132), (15, 128, 132), (1, 512, 132),
              (32768, 128, 114), (100_003, 96, 1)]
PLAN_EXPAND = [(2048, 1024, 132), (8192, 512, 132), (32768, 256, 132), (2048, 768, 132),
               (8192, 384, 132), (32768, 192, 132), (15, 256, 132), (1, 1024, 132),
               (8192, 512, 114), (70_001, 192, 1)]


def _check_plan(plan, m, k, n, ln_rows, ln):
    assert plan.rows % fp.MMA_STEP == 0 and plan.rows >= fp.MMA_STEP
    assert plan.chunks == _cdiv(m, plan.rows)
    # chunk z takes rows [z * rows, min(m, (z + 1) * rows)): each row once
    covered = [min(m, (z + 1) * plan.rows) - z * plan.rows for z in range(plan.chunks)]
    assert all(c > 0 for c in covered) and sum(covered) == m
    assert plan.dw_grid == (_cdiv(k, fp.MMA_TILE), _cdiv(n, fp.MMA_TILE), plan.chunks)
    assert min(plan.dw_grid) >= 1
    assert plan.part_dw == (plan.chunks, k, n)
    assert plan.part_ln == (ln_rows, 2, ln) and ln_rows >= 1


@pytest.mark.parametrize("m,c,sms", PLAN_MERGE)
def test_merge_bwd_plan(m, c, sms):
    plan = fp.merge_bwd_plan(m, c, sms)
    _check_plan(plan, m, 4 * c, 2 * c, _cdiv(m, fp.MERGE_ROWS), 4 * c)


@pytest.mark.parametrize("m,c,sms", PLAN_EXPAND)
def test_expand_bwd_plan(m, c, sms):
    plan = fp.expand_bwd_plan(m, c, sms)
    assert fp.dz_rows(c) in (32, 64, 128)
    _check_plan(plan, m, c, 2 * c, 4 * _cdiv(m, fp.dz_rows(c)), c // 2)


def test_dw_split_fills_about_one_wave():
    # the Swin-B stage shapes: at most two resident blocks an SM of 132
    for m, k, n in ((32768, 512, 256), (8192, 1024, 512), (2048, 2048, 1024),
                    (32768, 256, 512), (8192, 512, 1024), (2048, 1024, 2048)):
        rows, chunks = fp.dw_split(m, k, n, 132)
        blocks = chunks * _cdiv(k, fp.MMA_TILE) * _cdiv(n, fp.MMA_TILE)
        assert 132 <= blocks <= fp.MMA_BLOCKS_PER_SM * 132


def _capture(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch",
                        lambda counter, fn, tensors, ints, dt: calls.append((counter, fn,
                                                                             tensors, ints)))
    return calls


@pytest.mark.parametrize("dtype,shape", [(BF16, (8, 128, 128, 128)), (BF16, (1, 6, 10, 96)),
                                         (BF16, (2, 4, 4, 48)), (F32, (2, 8, 8, 128))])
def test_merge_wrapper_scratch_matches_plan(monkeypatch, dtype, shape):
    calls = _capture(monkeypatch)
    b, h, w, c = shape
    meta = dict(device="meta")
    x = torch.empty(shape, dtype=dtype, **meta)
    dy = torch.empty((b, h // 2, w // 2, 2 * c), dtype=dtype, **meta)
    fp.patch_merge_bwd(x, dy, torch.empty(4 * c, **meta), torch.empty(4 * c, **meta),
                       torch.empty((2 * c, 4 * c), **meta))
    (counter, fn, t, ints), = calls
    m = b * (h // 2) * (w // 2)
    assert counter == "patch_merge_bwd" and ints[:4] == [b, h, w, c]
    assert t[5].shape == (m, 4 * c)  # dn
    if fp.merge_route(dtype, c) == fp.ROUTE_MMA:
        plan = fp.merge_bwd_plan(m, c, 132)
        assert fn == "ssa_patch_merge_bwd_mma" and ints[4] == plan.rows
        assert t[6].shape == (m, 4 * c)  # n, the weight gradient's A operand
        assert (tuple(t[7].shape), tuple(t[8].shape)) == (plan.part_dw, plan.part_ln)
    else:
        assert fn == "ssa_patch_merge_bwd" and ints[4] == fp.dw_chunk_rows(m, 4 * c, 2 * c)
        assert t[6].shape == (m, 2)  # the row stats


@pytest.mark.parametrize("dtype,shape", [(BF16, (8, 64, 64, 256)), (BF16, (1, 3, 5, 1024)),
                                         (BF16, (2, 2, 2, 128)), (F32, (2, 4, 4, 256))])
def test_expand_wrapper_scratch_matches_plan(monkeypatch, dtype, shape):
    calls = _capture(monkeypatch)
    b, h, w, c = shape
    meta = dict(device="meta")
    x = torch.empty(shape, dtype=dtype, **meta)
    dy = torch.empty((b, 2 * h, 2 * w, c // 2), dtype=dtype, **meta)
    fp.patch_expand_bwd(x, dy, torch.empty((2 * c, c), **meta), torch.empty(c // 2, **meta))
    (counter, fn, t, ints), = calls
    m = b * h * w
    assert counter == "patch_expand_bwd" and ints[:4] == [b, h, w, c]
    assert t[5].shape == (m, 2 * c)  # dz
    if fp.expand_route(dtype, c) == fp.ROUTE_MMA:
        plan = fp.expand_bwd_plan(m, c, 132)
        assert fn == "ssa_patch_expand_bwd_mma" and ints[4] == plan.rows
        assert (tuple(t[6].shape), tuple(t[7].shape)) == (plan.part_ln, plan.part_dw)
    else:
        assert fn == "ssa_patch_expand_bwd" and ints[4] == fp.dw_chunk_rows(m, c, 2 * c)


# (B, H, W): a 512^2 batch-8 stage grid is covered by the plan tests; here
# rows ragged against every tile (15 merged rows, one row)
FWD_GRIDS = [(2, 4, 6), (1, 6, 10), (1, 2, 2)]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("c", MERGE_WIDTHS)
@pytest.mark.parametrize("grid", FWD_GRIDS)
def test_merge_fwd_wrapper_launch(monkeypatch, dtype, c, grid):
    calls = _capture(monkeypatch)
    b, h, w = grid
    meta = dict(device="meta")
    x = torch.empty((b, h, w, c), dtype=dtype, **meta)
    out = fp._merge_fwd(x, torch.empty(4 * c, **meta), torch.empty(4 * c, **meta),
                        torch.empty((2 * c, 4 * c), **meta))
    (counter, fn, t, ints), = calls
    m = b * (h // 2) * (w // 2)
    assert counter == "patch_merge" and ints == [b, h, w, c]
    assert t[0] is x and t[-1] is out and out.shape == (b, h // 2, w // 2, 2 * c)
    assert t[3].shape == (4 * c, 2 * c) and t[3].dtype == dtype  # input-major weight
    assert all(v.shape == (4 * c,) and v.dtype == F32 for v in t[1:3])
    if dtype == BF16:
        assert fp.merge_route(dtype, c) == fp.ROUTE_MMA
        assert fn == "ssa_patch_merge_fwd_mma" and len(t) == 6
        assert t[4].shape == (m, 4 * c) and t[4].dtype == BF16  # n
    else:
        assert fn == "ssa_patch_merge_fwd" and len(t) == 5


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("c", EXPAND_WIDTHS)
@pytest.mark.parametrize("grid", FWD_GRIDS)
def test_expand_fwd_wrapper_launch(monkeypatch, dtype, c, grid):
    calls = _capture(monkeypatch)
    b, h, w = grid
    meta = dict(device="meta")
    x = torch.empty((b, h, w, c), dtype=dtype, **meta)
    out = fp._expand_fwd(x, torch.empty((2 * c, c), **meta), torch.empty(c // 2, **meta),
                         torch.empty(c // 2, **meta))
    (counter, fn, t, ints), = calls
    m = b * h * w
    assert counter == "patch_expand" and ints == [b, h, w, c]
    assert t[0] is x and t[-1] is out and out.shape == (b, 2 * h, 2 * w, c // 2)
    assert t[1].shape == (c, 2 * c) and t[1].dtype == dtype  # input-major weight
    assert all(v.shape == (c // 2,) and v.dtype == F32 for v in t[2:4])
    if dtype == BF16:
        assert fp.expand_route(dtype, c) == fp.ROUTE_MMA
        assert fn == "ssa_patch_expand_fwd_mma" and len(t) == 6
        assert t[4].shape == (m, 2 * c) and t[4].dtype == BF16  # z
    else:
        assert fn == "ssa_patch_expand_fwd" and len(t) == 5


@pytest.mark.parametrize("is_merge,c", [(True, 48), (True, 16), (False, 128)])
def test_fwd_wrapper_other_widths_take_the_cuda_core_kernel(monkeypatch, is_merge, c):
    calls = _capture(monkeypatch)
    meta = dict(device="meta")
    x = torch.empty((1, 4, 4, c), dtype=BF16, **meta)
    if is_merge:
        fp._merge_fwd(x, torch.empty(4 * c, **meta), torch.empty(4 * c, **meta),
                      torch.empty((2 * c, 4 * c), **meta))
    else:
        fp._expand_fwd(x, torch.empty((2 * c, c), **meta), torch.empty(c // 2, **meta),
                       torch.empty(c // 2, **meta))
    (_, fn, t, _), = calls
    assert fn == ("ssa_patch_merge_fwd" if is_merge else "ssa_patch_expand_fwd")
    assert len(t) == 5


def test_tensor_core_rows_are_whole_chunks():
    """The row passes' gather, scatter and groups copy 16-byte chunks: every
    width routed to the tensor cores passes the wrapper's check, and a width
    whose groups are not whole chunks raises."""
    for c in range(16, 1025, 16):
        if fp.merge_route(BF16, c) == fp.ROUTE_MMA:
            fp._check_rows_aligned(c, BF16)
            assert (c * 2) % 16 == 0
    for c in range(64, 1025, 64):
        if fp.expand_route(BF16, c) == fp.ROUTE_MMA:
            fp._check_rows_aligned(c, BF16)
            assert (c // 2 * 2) % 16 == 0
    with pytest.raises(ValueError):
        fp._check_rows_aligned(24, BF16)
