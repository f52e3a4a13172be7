"""PatchMerging / PatchExpand, forward and backward each one kernel call on
the card.

Counterpart of the JAX package's ``ops/fused_patch.py``.  Merge is
``Linear(LN(merge_2x2(x)))``: ``(B,H,W,C) -> (B,H/2,W/2,2C)``; expand is
``LN(depth_to_space(Linear(x), 2))``: ``(B,H,W,C) -> (B,2H,2W,C/2)``;
both bias-free, LayerNorm with float32 fast-variance stats clamped at 0
(``models/layers.py:58-69`` of the JAX package).  The kernels live in
``csrc/fused_patch.cu`` (forwards) and ``csrc/fused_patch_bwd.cu``
(backwards).  Forward and backward each take one of two kernel families,
decided from (dtype, C) before the launch (:func:`merge_route`,
:func:`expand_route`): the bfloat16 tensor-core kernels at every Swin-B and
Swin-T width (the forwards two CUDA launches a call, a row pass and the
product, with a bfloat16 scratch of ``n`` or ``z``; the backwards sized by
:func:`merge_bwd_plan` / :func:`expand_bwd_plan`), or the CUDA-core kernels
(float32 and the other widths).

The plain versions below follow the kernels' numerics and run for CPU
tensors only.  Forwards: merge rounds the LN output to the input dtype
before the product; expand rounds the product before the LN.  Backwards
work from the saved ``x`` alone (JAX ``_merge_bwd_kernel`` /
``_expand_bwd_kernel``): merge recomputes the LN, rounds ``n``, takes
``dW = n^T dy`` in float32 and ``dn = dy W^T`` rounded, ``dscale = sum
dn*xhat``, ``dbias = sum dn`` and the LN backward rounded into ``dx``;
expand recomputes ``z = x W`` rounded, each group's LN stats, ``dz`` = the
groups' LN backwards rounded, ``dW = x^T dz`` and ``dx = dz W^T`` rounded.

:func:`fused_patch_merge` and :func:`fused_patch_expand` are
``torch.autograd.Function``s that save only ``x`` (and the parameters they
were given).  As in the JAX package, which casts the weight to the compute
dtype before the kernel, the weight gradient is rounded to that dtype
before it reaches the float32 parameter; the LayerNorm parameters'
gradients stay float32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _build
from .patch_ops import depth_to_space, merge_2x2, space_to_depth, unmerge_2x2

LN_EPS = 1e-5
# weight-gradient blocks to aim for (four per SM of an H100); mirrors the
# split-K tiling of the CUDA-core backwards in csrc/fused_patch_bwd.cu
# (32 x 128 or 32 x 32 tiles)
_DW_TARGET_BLOCKS = 528
_DW_MIN_ROWS = 256

# The backwards' two kernel families, chosen from (dtype, C) before a launch.
ROUTE_CORE, ROUTE_MMA = 0, 1
# Group widths C/2 of the tensor-core expand backward (its template
# instances, SSA_EXPAND_MMA_NT in csrc/fused_patch_bwd.cu).
_EXPAND_MMA_GROUPS = (96, 128, 192, 256, 384, 512)
_MERGE_MMA_MAX_C = 512  # 4C channels of a merged row: one 8-channel chunk a thread
# The tensor-core product core (csrc/fused_patch.cuh): 128 x 128 output
# tiles, 64 reduction rows a stage, two blocks an SM; split-K chunks of at
# least 512 rows.
MMA_TILE = 128
MMA_STEP = 64
MMA_BLOCKS_PER_SM = 2
_MMA_MIN_ROWS = 512
MERGE_ROWS = 16  # merged rows per block of the tensor-core merge's row pass


def _ln_stats(xf: torch.Tensor):
    """float32 fast-variance LayerNorm over the last axis: ``(xhat, rsig)``."""
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    rsig = torch.rsqrt(var + LN_EPS)
    return (xf - mean) * rsig, rsig


def _ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return _ln_stats(x.float())[0] * scale.float() + bias.float()


def _ln_bwd(dn, xhat, rsig, scale):
    """LayerNorm VJP in float32 (JAX ``fused_patch._ln_bwd``)."""
    dxh = dn * scale
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return (dxh - m1 - xhat * m2) * rsig


def patch_merge_reference(x, ln_scale, ln_bias, weight):
    """Plain version; ``weight`` is torch layout ``(2C, 4C)``."""
    dt = x.dtype
    n = _ln_f32(merge_2x2(x), ln_scale, ln_bias).to(dt)
    return torch.matmul(n.float(), weight.to(dt).float().t()).to(dt)


def patch_expand_reference(x, weight, ln_scale, ln_bias):
    """Plain version; ``weight`` is torch layout ``(2C, C)``."""
    dt = x.dtype
    z = torch.matmul(x.float(), weight.to(dt).float().t()).to(dt)
    return _ln_f32(depth_to_space(z, 2), ln_scale, ln_bias).to(dt)


def patch_merge_bwd_reference(x, dy, ln_scale, ln_bias, weight):
    """Plain backward: ``(dx, dscale, dbias, dweight)``, dx in x's dtype, the
    rest float32, dweight in torch layout ``(2C, 4C)``."""
    dt = x.dtype
    b, h, w, c = x.shape
    xhat, rsig = _ln_stats(merge_2x2(x).reshape(-1, 4 * c).float())
    n = (xhat * ln_scale.float() + ln_bias.float()).to(dt).float()
    dyf = dy.reshape(-1, 2 * c).float()
    dw = dyf.t() @ n
    dn = (dyf @ weight.to(dt).float()).to(dt).float()
    dm = _ln_bwd(dn, xhat, rsig, ln_scale.float()).to(dt)
    dx = unmerge_2x2(dm.reshape(b, h // 2, w // 2, 4 * c))
    return dx, (dn * xhat).sum(0), dn.sum(0), dw


def patch_expand_bwd_reference(x, dy, weight, ln_scale):
    """Plain backward: ``(dx, dweight, dscale, dbias)``, dx in x's dtype, the
    rest float32, dweight in torch layout ``(2C, C)``."""
    dt = x.dtype
    b, h, w, c = x.shape
    xf = x.reshape(-1, c).float()
    wf = weight.to(dt).float()
    z = (xf @ wf.t()).to(dt).float().reshape(-1, 4, c // 2)  # groups g = 2*p1 + p2
    xhat, rsig = _ln_stats(z)
    dn = space_to_depth(dy, 2).reshape(-1, 4, c // 2).float()
    dz = _ln_bwd(dn, xhat, rsig, ln_scale.float()).reshape(-1, 2 * c).to(dt).float()
    dx = (dz @ wf).to(dt).reshape(b, h, w, c)
    return dx, dz.t() @ xf, (dn * xhat).sum((0, 1)), dn.sum((0, 1))


def merge_supported(shape) -> bool:
    _, h, w, c = shape
    return h % 2 == 0 and w % 2 == 0 and c % 16 == 0


def expand_supported(shape) -> bool:
    """C/2 a multiple of 32 up to 512."""
    c = shape[-1]
    return c % 64 == 0 and 1 <= c // 64 <= 16


def dw_chunk_rows(m: int, k: int, n: int) -> int:
    """Rows per chunk of the split-K weight gradient ``(k, n)`` over ``m``
    rows: enough chunks that the blocks fill the card, each chunk at least
    ``_DW_MIN_ROWS`` rows, a multiple of 16."""
    tiles = (k // 32) * (n // (128 if n % 128 == 0 else 32))
    chunks = max(1, min(-(-_DW_TARGET_BLOCKS // tiles), -(-m // _DW_MIN_ROWS)))
    rows = -(-m // chunks)
    return -(-rows // 16) * 16


def merge_route(dtype: torch.dtype, c: int) -> int:
    """The kernels a merge of ``c`` input channels takes, forward and
    backward: the tensor-core kernels for bfloat16 at C a multiple of 32 up
    to 512, the CUDA-core kernels for float32 and the other multiples of 16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"patch merge kernel: float32 or bfloat16, got {dtype}")
    if c < 16 or c % 16:
        raise ValueError(f"patch merge kernel: no kernel takes C = {c}")
    if dtype == torch.bfloat16 and c % 32 == 0 and c <= _MERGE_MMA_MAX_C:
        return ROUTE_MMA
    return ROUTE_CORE


def expand_route(dtype: torch.dtype, c: int) -> int:
    """The kernels an expand of ``c`` input channels takes, forward and
    backward: the tensor-core kernels for bfloat16 at C/2 in
    :data:`_EXPAND_MMA_GROUPS`, the CUDA-core kernels for float32 and the
    other C/2 multiples of 32 up to 512."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"patch expand kernel: float32 or bfloat16, got {dtype}")
    if not expand_supported((c,)):
        raise ValueError(f"patch expand kernel: no kernel takes C = {c}")
    if dtype == torch.bfloat16 and c // 2 in _EXPAND_MMA_GROUPS:
        return ROUTE_MMA
    return ROUTE_CORE


def dz_rows(c: int) -> int:
    """Rows per block of the tensor-core expand's dz kernel (``DzTile::BM``),
    a block over a whole group of C/2 columns."""
    return 128 if c // 2 <= 128 else 64 if c // 2 <= 256 else 32


class BwdPlan(NamedTuple):
    """Launch plan and float32 scratch of a tensor-core backward."""
    rows: int                         # rows per split-K chunk of the weight gradient
    chunks: int                       # ceil(M / rows)
    dw_grid: Tuple[int, int, int]     # (k tiles, n tiles, chunks) of the dW product
    part_dw: Tuple[int, int, int]     # (chunks, K, N)
    part_ln: Tuple[int, int, int]     # (partial rows, 2, LN width): dscale | dbias


def dw_split(m: int, k: int, n: int, sm_count: int) -> Tuple[int, int]:
    """``(rows, chunks)`` of the tensor-core split-K weight gradient
    ``(k, n)`` over ``m`` rows: about one wave of resident blocks, chunks of
    at least :data:`_MMA_MIN_ROWS` rows, a multiple of :data:`MMA_STEP`."""
    if min(m, k, n, sm_count) < 1:
        raise ValueError("dw_split: every size must be at least 1")
    tiles = _cdiv(k, MMA_TILE) * _cdiv(n, MMA_TILE)
    chunks = max(1, min(MMA_BLOCKS_PER_SM * sm_count // tiles, _cdiv(m, _MMA_MIN_ROWS)))
    rows = _cdiv(_cdiv(m, chunks), MMA_STEP) * MMA_STEP
    return rows, _cdiv(m, rows)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(m, k, n, sm_count, part_rows, ln) -> BwdPlan:
    rows, chunks = dw_split(m, k, n, sm_count)
    return BwdPlan(rows, chunks, (_cdiv(k, MMA_TILE), _cdiv(n, MMA_TILE), chunks),
                   (chunks, k, n), (part_rows, 2, ln))


def merge_bwd_plan(m: int, c: int, sm_count: int) -> BwdPlan:
    """Plan of the tensor-core merge backward over ``m`` merged rows."""
    return _plan(m, 4 * c, 2 * c, sm_count, _cdiv(m, MERGE_ROWS), 4 * c)


def expand_bwd_plan(m: int, c: int, sm_count: int) -> BwdPlan:
    """Plan of the tensor-core expand backward over ``m`` rows: dscale /
    dbias partials for every (row block, group) of the dz kernel."""
    return _plan(m, c, 2 * c, sm_count, 4 * _cdiv(m, dz_rows(c)), c // 2)


def _check_rows_aligned(c: int, dtype: torch.dtype) -> None:
    """The tensor-core row passes copy 16-byte chunks from and to rows of
    ``c`` (gather, scatter) and ``c / 2`` values (expand's groups): both must
    be whole chunks.  Every width the routes send there is."""
    if (c // 2 * dtype.itemsize) % 16:
        raise ValueError(f"patch kernel: rows of C = {c} are not 16-byte aligned")


def _merge_fwd(x, ln_scale, ln_bias, weight):
    """Forward wrapper: plain version on the CPU, the kernel (one count; two
    CUDA launches on the tensor-core route, one on the CUDA-core route) on
    the card."""
    if x.device.type == "cpu":
        return patch_merge_reference(x, ln_scale, ln_bias, weight)
    b, h, w, c = x.shape
    if not merge_supported(x.shape):
        raise ValueError(f"patch merge kernel: unsupported shape {tuple(x.shape)}")
    route = merge_route(x.dtype, c)
    dt = x.dtype
    _build.check_cuda(x, "x")
    wk = weight.to(dt).t().contiguous()  # (4C, 2C), input-major
    sc = ln_scale.float().contiguous()
    lb = ln_bias.float().contiguous()
    _build.check_cuda(wk, "weight", (4 * c, 2 * c), dt)
    _build.check_cuda(sc, "ln_scale", (4 * c,))
    _build.check_cuda(lb, "ln_bias", (4 * c,))
    out = torch.empty((b, h // 2, w // 2, 2 * c), dtype=dt, device=x.device)
    if route == ROUTE_MMA:
        _check_rows_aligned(c, dt)
        n = torch.empty((b * (h // 2) * (w // 2), 4 * c), dtype=dt, device=x.device)
        _build.launch("patch_merge", "ssa_patch_merge_fwd_mma", [x, sc, lb, wk, n, out],
                      [b, h, w, c], dt)
    else:
        _build.launch("patch_merge", "ssa_patch_merge_fwd", [x, sc, lb, wk, out],
                      [b, h, w, c], dt)
    return out


def patch_merge_bwd(x, dy, ln_scale, ln_bias, weight):
    """Backward wrapper: plain version on the CPU, the kernel (one count;
    four CUDA launches on the tensor-core route, seven on the CUDA-core
    route) on the card.  Returns ``(dx, dscale, dbias, dweight)`` as
    :func:`patch_merge_bwd_reference`."""
    if x.device.type == "cpu":
        return patch_merge_bwd_reference(x, dy, ln_scale, ln_bias, weight)
    b, h, w, c = x.shape
    if not merge_supported(x.shape):
        raise ValueError(f"patch merge backward kernel: unsupported shape {tuple(x.shape)}")
    route = merge_route(x.dtype, c)
    dt, dev = x.dtype, x.device
    m, k, n = b * (h // 2) * (w // 2), 4 * c, 2 * c
    wt = weight.to(dt).contiguous()  # (2C, 4C), torch layout
    sc = ln_scale.float().contiguous()
    lb = ln_bias.float().contiguous()
    _build.check_cuda(x, "x")
    _build.check_cuda(dy, "dy", (b, h // 2, w // 2, n), dt)
    _build.check_cuda(wt, "weight", (n, k), dt)
    _build.check_cuda(sc, "ln_scale", (k,))
    _build.check_cuda(lb, "ln_bias", (k,))
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dw = torch.empty((k, n), **f32)  # input-major
    dsc, dlb = torch.empty(k, **f32), torch.empty(k, **f32)
    dn = torch.empty((m, k), dtype=dt, device=dev)
    if route == ROUTE_MMA:
        plan = merge_bwd_plan(m, c, _build.sm_count(dev.index))
        _build.launch("patch_merge_bwd", "ssa_patch_merge_bwd_mma",
                      [x, dy, sc, lb, wt, dn, torch.empty((m, k), dtype=dt, device=dev),
                       torch.empty(plan.part_dw, **f32), torch.empty(plan.part_ln, **f32),
                       dx, dw, dsc, dlb], [b, h, w, c, plan.rows], dt)
        return dx, dsc, dlb, dw.t()
    rows = dw_chunk_rows(m, k, n)
    chunks = -(-m // rows)
    stats = torch.empty((m, 2), **f32)
    part_dw = torch.empty((chunks, k, n), **f32)
    part_cs = torch.empty((chunks, 2, k), **f32)
    _build.launch("patch_merge_bwd", "ssa_patch_merge_bwd",
                  [x, dy, sc, lb, wt, dn, stats, part_dw, part_cs, dx, dw, dsc, dlb],
                  [b, h, w, c, rows], dt)
    return dx, dsc, dlb, dw.t()


def _expand_fwd(x, weight, ln_scale, ln_bias):
    """Forward wrapper: plain version on the CPU, the kernel (one count; two
    CUDA launches on the tensor-core route, one on the CUDA-core route) on
    the card."""
    if x.device.type == "cpu":
        return patch_expand_reference(x, weight, ln_scale, ln_bias)
    b, h, w, c = x.shape
    if not expand_supported(x.shape):
        raise ValueError(f"patch expand kernel: unsupported shape {tuple(x.shape)}")
    route = expand_route(x.dtype, c)
    dt = x.dtype
    _build.check_cuda(x, "x")
    wk = weight.to(dt).t().contiguous()  # (C, 2C), input-major
    sc = ln_scale.float().contiguous()
    lb = ln_bias.float().contiguous()
    _build.check_cuda(wk, "weight", (c, 2 * c), dt)
    _build.check_cuda(sc, "ln_scale", (c // 2,))
    _build.check_cuda(lb, "ln_bias", (c // 2,))
    out = torch.empty((b, 2 * h, 2 * w, c // 2), dtype=dt, device=x.device)
    if route == ROUTE_MMA:
        _check_rows_aligned(c, dt)
        z = torch.empty((b * h * w, 2 * c), dtype=dt, device=x.device)
        _build.launch("patch_expand", "ssa_patch_expand_fwd_mma", [x, wk, sc, lb, z, out],
                      [b, h, w, c], dt)
    else:
        _build.launch("patch_expand", "ssa_patch_expand_fwd", [x, wk, sc, lb, out],
                      [b, h, w, c], dt)
    return out


def patch_expand_bwd(x, dy, weight, ln_scale):
    """Backward wrapper: plain version on the CPU, the kernel (one count;
    four CUDA launches on the tensor-core route, six on the CUDA-core
    route) on the card.  Returns ``(dx, dweight, dscale, dbias)`` as
    :func:`patch_expand_bwd_reference`."""
    if x.device.type == "cpu":
        return patch_expand_bwd_reference(x, dy, weight, ln_scale)
    b, h, w, c = x.shape
    if not expand_supported(x.shape):
        raise ValueError(f"patch expand backward kernel: unsupported shape {tuple(x.shape)}")
    route = expand_route(x.dtype, c)
    dt, dev = x.dtype, x.device
    m = b * h * w
    wk = weight.to(dt).t().contiguous()  # (C, 2C), input-major, for z
    wt = weight.to(dt).contiguous()  # (2C, C), torch layout, for dx
    sc = ln_scale.float().contiguous()
    _build.check_cuda(x, "x")
    _build.check_cuda(dy, "dy", (b, 2 * h, 2 * w, c // 2), dt)
    _build.check_cuda(wk, "weight", (c, 2 * c), dt)
    _build.check_cuda(sc, "ln_scale", (c // 2,))
    f32 = dict(dtype=torch.float32, device=dev)
    dz = torch.empty((m, 2 * c), dtype=dt, device=dev)
    dx = torch.empty_like(x)
    dw = torch.empty((c, 2 * c), **f32)  # input-major
    dsc, dlb = torch.empty(c // 2, **f32), torch.empty(c // 2, **f32)
    if route == ROUTE_MMA:
        plan = expand_bwd_plan(m, c, _build.sm_count(dev.index))
        _build.launch("patch_expand_bwd", "ssa_patch_expand_bwd_mma",
                      [x, dy, wk, wt, sc, dz, torch.empty(plan.part_ln, **f32),
                       torch.empty(plan.part_dw, **f32), dx, dw, dsc, dlb],
                      [b, h, w, c, plan.rows], dt)
        return dx, dw.t(), dsc, dlb
    rows = dw_chunk_rows(m, c, 2 * c)
    chunks = -(-m // rows)
    part_ln = torch.empty((4 * -(-m // 32), 2, c // 2), **f32)
    part_dw = torch.empty((chunks, c, 2 * c), **f32)
    _build.launch("patch_expand_bwd", "ssa_patch_expand_bwd",
                  [x, dy, wk, wt, sc, dz, part_ln, part_dw, dx, dw, dsc, dlb],
                  [b, h, w, c, rows], dt)
    return dx, dw.t(), dsc, dlb


def _weight_grad(dw: torch.Tensor, compute: torch.dtype, param: torch.dtype) -> torch.Tensor:
    """The weight was cast to the compute dtype before the kernel, so its
    gradient is rounded to that dtype on its way back (JAX
    ``fused_patch.py:278-279, 423-424``)."""
    return dw.to(compute).to(param).contiguous()


class _PatchMerge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, weight):
        ctx.save_for_backward(x, ln_scale, ln_bias, weight)
        return _merge_fwd(x, ln_scale, ln_bias, weight)

    @staticmethod
    def backward(ctx, dy):
        x, sc, lb, w = ctx.saved_tensors
        dx, dsc, dlb, dw = patch_merge_bwd(x, dy.contiguous(), sc, lb, w)
        return dx, dsc.to(sc.dtype), dlb.to(lb.dtype), _weight_grad(dw, x.dtype, w.dtype)


class _PatchExpand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, ln_scale, ln_bias):
        ctx.save_for_backward(x, weight, ln_scale, ln_bias)
        return _expand_fwd(x, weight, ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, dy):
        x, w, sc, lb = ctx.saved_tensors
        dx, dw, dsc, dlb = patch_expand_bwd(x, dy.contiguous(), w, sc)
        return dx, _weight_grad(dw, x.dtype, w.dtype), dsc.to(sc.dtype), dlb.to(lb.dtype)


def fused_patch_merge(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``(B,H,W,C) -> (B,H/2,W/2,2C)``, differentiable in every input; plain
    versions on the CPU, the kernels on the card.  ``weight`` is torch
    layout ``(2C, 4C)``."""
    return _PatchMerge.apply(x, ln_scale, ln_bias, weight)


def fused_patch_expand(x: torch.Tensor, weight: torch.Tensor,
                       ln_scale: torch.Tensor, ln_bias: torch.Tensor) -> torch.Tensor:
    """``(B,H,W,C) -> (B,2H,2W,C/2)``, differentiable in every input; plain
    versions on the CPU, the kernels on the card.  ``weight`` is torch
    layout ``(2C, C)``."""
    return _PatchExpand.apply(x, weight, ln_scale, ln_bias)
