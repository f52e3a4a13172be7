"""Shifted-window attention with the window-shaped middle in one kernel.

Counterpart of the JAX package's ``ops/fused_window_attention.py``: the
qkv/proj projections, pad, roll and crop stay outside the kernel (plain
PyTorch, as the JAX package leaves them to XLA); the kernels
(``csrc/fused_window_attention.cu``, and ``csrc/fused_window_attention_tiled.cu``
for windows of more than 64 tokens) take the rolled, padded qkv
``(B,Hp,Wp,3C)``.  The forward writes the context ``(B,Hp,Wp,C)`` in the
same layout; the backward recomputes the probabilities from the saved
qkv and writes ``dqkv`` ``(B,Hp,Wp,3C)`` and the float32 bias gradient
``(heads,N,N)`` summed over every window and image.  On the card the
kernels cover every grid, so the TPU's width chunking
(``_layout``/``pad_chunk``) and stage caps are gone, and every window size
(the TPU kernel's up to 512 tokens, and more): windows of more than 64
tokens take the tiled kernels.  Which of the five kernel families a call
takes (:func:`kernel_route`), how many blocks walk each head's windows for
the ``mma.sync`` kernels (:func:`launch_plan`, from the card's SM count),
and the backward's windows per block, key chunks and scratch
(:func:`fwd_plan`, :func:`bwd_plan`) are decided here, from the static
shape, before the launch; the backward's scratch is held against what the
kernels' host code lays out for that plan before every launch.

:func:`window_attention_reference` and
:func:`window_attention_bwd_reference` are the kernels' plain PyTorch
versions, with the kernels' numerics: scores ``q.k^T`` in float32, then
scaled (the composed path scales q instead), + bias, + mask, float32
softmax, probs rounded to the input dtype before ``.v``; in the backward
``dS = P*(dP - rowsum(dP*P))`` from the float32 probs, the bias gradient
summed from the float32 ``dS``, ``dS`` rounded to the input dtype before
``dq = dS.k*scale`` and ``dk = dS^T.q*scale``, and the rounded probs in
``dv = P^T.dctx``.  :func:`window_attention` is a
``torch.autograd.Function`` over both; it takes the plain versions for
CPU tensors only, and a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import upload
from . import _build
from .window_attention import (
    effective_shift,
    gather_bias,
    pad_and_roll,
    shifted_window_mask,
    unroll_and_crop,
)

# Which kernel a call takes (``csrc/fused_window_attention.cu``).  Windows of
# up to 64 tokens (four 16-row bands): the CUDA-core kernels (float32, and
# bfloat16 head widths that are not a multiple of 16), the ``wmma`` kernels
# (bfloat16, other multiples of 16), or the ``mma.sync`` kernels of the main
# path (bfloat16, head width 16, 32 or 64).  Larger windows (window 12 and
# up): the tiled ``mma.sync`` kernels (bfloat16, head widths a multiple of 16
# up to 128: the deployment type), else the tiled kernels on the CUDA cores
# (float32, the parity type, and the other bfloat16 widths up to 128).
ROUTE_CORE, ROUTE_WMMA, ROUTE_MMA, ROUTE_TILED, ROUTE_TILED_MMA = 0, 1, 2, 3, 4
ROUTE_NAMES = ("CUDA-core", "wmma", "mma.sync", "tiled", "tiled mma.sync")
_MMA_HEAD_DIMS = (16, 32, 64)
_BAND_TOKENS = 64  # the largest window of the first three families
_TILED_MAX_HEAD_DIM = 128

# Resident blocks per SM of the ``mma.sync`` kernels (their
# ``__launch_bounds__`` and shared memory at head width 32): a launch gets at
# most one wave of blocks, each walking a balanced run of windows.
FWD_BLOCKS_PER_SM = 4
BWD_BLOCKS_PER_SM = 3

# Windows per backward block of the CUDA-core and ``wmma`` kernels: enough that
# the per-block bias-gradient partials stay small, few enough that the grid
# fills the card.
_BWD_TARGET_BLOCKS = 1024
_BWD_MAX_GROUP = 32
# Backward blocks per SM the tiled kernels aim at (two waves of their ~2
# resident blocks): each block's scratch is N x (N + hd + 3) floats a head,
# 103 KB at window 12 and head width 32, so fewer, longer blocks keep it at
# ~50 MB on a 132-SM card at stage 0 of Swin-B 512^2 b8.
TILED_BWD_BLOCKS_PER_SM = 4
# The tiled ``mma.sync`` kernels (``csrc/fused_window_attention_tiled.cu``).
# Windows of up to TILED_MMA_CHUNK tokens (window 12: 144), and in the
# backward head widths up to 32, take the one-block kernels: one block an SM
# walking a run of windows of one head (:func:`launch_plan` at one block an
# SM), a band's whole score row in registers.  Larger windows (or head
# widths) take the split kernels: 64-token chunks (TILED_MMA_SPLIT), the
# backward's keys split over blocks of a group of windows.  The C side
# (``tm_one_block``) makes the same choice and lays out the scratch by it;
# :func:`window_attention_bwd` refuses a launch whose scratch is smaller than
# that, so no disagreement can write past the scratch.
TILED_MMA_CHUNK = 144
TILED_MMA_BWD_MAX_HEAD_DIM = 32
TILED_MMA_SPLIT = 64
TILED_MMA_BLOCKS_PER_SM = 1
TILED_MMA_GROUP_BLOCKS_PER_SM = 4


def _partition(t: torch.Tensor, wh: int, ww: int, heads: int, parts: int) -> torch.Tensor:
    """``(B,Hp,Wp,parts*C) -> (parts, B, nW, heads, N, hd)``."""
    b, hp, wp, cc = t.shape
    hd = cc // parts // heads
    x = t.reshape(b, hp // wh, wh, wp // ww, ww, parts, heads, hd)
    return x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(
        parts, b, (hp // wh) * (wp // ww), heads, wh * ww, hd)


def _unpartition(x: torch.Tensor, hp: int, wp: int, wh: int, ww: int) -> torch.Tensor:
    """Inverse of :func:`_partition`."""
    parts, b, _, heads, _, hd = x.shape
    x = x.reshape(parts, b, hp // wh, wp // ww, heads, wh, ww, hd)
    return x.permute(1, 2, 5, 3, 6, 0, 4, 7).reshape(b, hp, wp, parts * heads * hd)


def _probs(q, k, rel_bias, hp, wp, wh, ww, sh, sw):
    """float32 softmax of ``q.k^T*scale + bias (+ mask)``."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    s = s + rel_bias.float()[None, None]
    if sh or sw:
        mask = upload(shifted_window_mask(hp, wp, wh, ww, sh, sw), q.device)
        s = s + mask[None, :, None]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


def window_attention_reference(qkv: torch.Tensor, rel_bias: torch.Tensor, *,
                               wh: int, ww: int, heads: int, sh: int,
                               sw: int) -> torch.Tensor:
    """Plain version of the forward kernel: ``(B,Hp,Wp,3C) -> (B,Hp,Wp,C)``."""
    _, hp, wp, _ = qkv.shape
    q, k, v = _partition(qkv, wh, ww, heads, 3).float()
    p = _probs(q, k, rel_bias, hp, wp, wh, ww, sh, sw).to(qkv.dtype).float()
    ctx = torch.matmul(p, v).to(qkv.dtype)  # (B, nW, heads, N, hd)
    return _unpartition(ctx[None], hp, wp, wh, ww)


def window_attention_bwd_reference(qkv: torch.Tensor, dctx: torch.Tensor,
                                   rel_bias: torch.Tensor, *, wh: int, ww: int,
                                   heads: int, sh: int, sw: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: ``(dqkv, dbias)``, ``dqkv``
    in qkv's dtype, ``dbias`` ``(heads, N, N)`` float32."""
    dt = qkv.dtype
    _, hp, wp, _ = qkv.shape
    q, k, v = _partition(qkv, wh, ww, heads, 3).float()
    d = _partition(dctx, wh, ww, heads, 1)[0].float()
    scale = q.shape[-1] ** -0.5
    p = _probs(q, k, rel_bias, hp, wp, wh, ww, sh, sw)
    dp = torch.matmul(d, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=(0, 1))
    dsr = ds.to(dt).float()
    dq = torch.matmul(dsr, k) * scale
    dk = torch.matmul(dsr.transpose(-1, -2), q) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), d)
    dqkv = _unpartition(torch.stack([dq, dk, dv]).to(dt), hp, wp, wh, ww)
    return dqkv, dbias


def _check_shape(qkv: torch.Tensor, wh: int, ww: int, heads: int) -> None:
    _, hp, wp, c3 = qkv.shape
    if (c3 // 3) % heads or hp % wh or wp % ww:
        raise ValueError(f"window attention kernel: unsupported shape "
                         f"{tuple(qkv.shape)} window {(wh, ww)} heads {heads}")


def kernel_route(dtype: torch.dtype, hd: int, n: int, shift_inside: bool = True) -> int:
    """The kernel a (dtype, head width, tokens per window) takes, decided
    from the static shape before any launch.  ``shift_inside``: the shift is
    smaller than the window on both axes (the ``mma.sync`` kernels build the
    shift mask from that).  Windows of more than 64 tokens take the tiled
    kernels, whatever the shift: on the tensor cores in bfloat16 at head
    widths that are a multiple of 16, else on the CUDA cores."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window attention kernel: float32 or bfloat16, got {dtype}")
    if hd < 1 or n < 1 or (n > _BAND_TOKENS and hd > _TILED_MAX_HEAD_DIM):
        raise ValueError(f"window attention kernel: no kernel takes head width {hd} "
                         f"with {n} tokens per window")
    if n > _BAND_TOKENS:
        return ROUTE_TILED_MMA if dtype == torch.bfloat16 and hd % 16 == 0 else ROUTE_TILED
    if dtype == torch.float32 or hd % 16:
        return ROUTE_CORE
    if hd in _MMA_HEAD_DIMS and shift_inside:
        return ROUTE_MMA
    return ROUTE_WMMA


def launch_plan(batch: int, n_windows: int, heads: int, sm_count: int,
                blocks_per_sm: int) -> int:
    """Blocks per head of an ``mma.sync`` launch.  The grid is
    ``chunks * heads`` blocks (block ``chunk * heads + head``); chunk ``c``
    walks the windows :func:`chunk_range` gives it, of all images in turn.
    At most one wave of resident blocks, at least one block per head, never
    more chunks than windows."""
    total = batch * n_windows
    if total < 1 or heads < 1 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError("launch_plan: every count must be at least 1")
    return max(1, min(total, sm_count * blocks_per_sm // heads))


def chunk_range(chunk: int, chunks: int, total: int) -> Tuple[int, int]:
    """The run ``[begin, end)`` of windows chunk ``chunk`` walks: a balanced
    split, as the kernels compute it."""
    return chunk * total // chunks, (chunk + 1) * total // chunks


def bwd_group(n_windows: int, heads: int) -> int:
    """Windows each backward block of the CUDA-core and ``wmma`` kernels
    walks through (its bias-gradient partial covers all of them)."""
    g = -(-n_windows * heads // _BWD_TARGET_BLOCKS)
    return max(1, min(_BWD_MAX_GROUP, g))


def tiled_bwd_group(n_windows: int, heads: int, sm_count: int) -> int:
    """Windows each backward block of the tiled kernels walks through: the
    (window, head) pairs spread over ``TILED_BWD_BLOCKS_PER_SM`` blocks an
    SM."""
    if n_windows < 1 or heads < 1 or sm_count < 1:
        raise ValueError("tiled_bwd_group: every count must be at least 1")
    return max(1, -(-n_windows * heads // (sm_count * TILED_BWD_BLOCKS_PER_SM)))


def tiled_mma_one_block(n: int, hd: int, backward: bool) -> bool:
    """Whether a tiled ``mma.sync`` launch takes the one-block kernels (a
    window's every row and key on one block) or the split ones."""
    return n <= TILED_MMA_CHUNK and (not backward or hd <= TILED_MMA_BWD_MAX_HEAD_DIM)


def tiled_mma_group(total: int, heads: int, n: int, sm_count: int) -> int:
    """Windows each block group of the split tiled ``mma.sync`` backward
    walks (its bias-gradient partial covers all of them): the (window, key
    chunk, head) triples spread over ``TILED_MMA_GROUP_BLOCKS_PER_SM`` blocks
    an SM."""
    if total < 1 or heads < 1 or n < 1 or sm_count < 1:
        raise ValueError("tiled_mma_group: every count must be at least 1")
    chunks = -(-n // TILED_MMA_SPLIT)
    return max(1, -(-total * heads * chunks // (sm_count * TILED_MMA_GROUP_BLOCKS_PER_SM)))


def fwd_plan(route: int, batch: int, n_windows: int, heads: int, n: int,
             sm_count: int, hd: int = 0) -> int:
    """The plan argument of a forward launch: blocks per head for the
    ``mma.sync`` kernels and the one-block tiled ``mma.sync`` kernel, else 1
    (those kernels take one block a window or chunk, and no plan)."""
    if route == ROUTE_MMA:
        return launch_plan(batch, n_windows, heads, sm_count, FWD_BLOCKS_PER_SM)
    if route == ROUTE_TILED_MMA and tiled_mma_one_block(n, hd, False):
        return launch_plan(batch, n_windows, heads, sm_count, TILED_MMA_BLOCKS_PER_SM)
    return 1


def bwd_plan(route: int, batch: int, n_windows: int, heads: int, n: int,
             sm_count: int, hd: int = 0) -> Tuple[int, Tuple[int, ...]]:
    """``(plan, scratch shape)`` of a backward launch: the plan argument of
    the C entry point (blocks per head for the ``mma.sync`` kernels and the
    one-block tiled ``mma.sync`` kernel, windows per block or block group for
    the others) and the float32 scratch of per-block bias-gradient partials,
    one ``(heads, N, columns)`` per block of a head.  The ``mma.sync``
    kernels pad a partial's rows to their key tiles (56 columns up to 56
    tokens, else 64) so that they write whole sectors, the one-block tiled
    ``mma.sync`` kernel to its 144 keys.  The tiled kernels on the CUDA cores
    (head width ``hd``) follow each row of a partial with the block's float32
    dq accumulator and the row's max, sum and rowsum(dP*P): ``N + hd + 3``
    columns.  The split tiled ``mma.sync`` kernels take one flat scratch: the
    groups' ``(heads, N, N)`` partials (padded to 4 floats), each row's max,
    1/sum and rowsum(dP*P) ``(B*nW, heads, N, 4)``, and dq's float32 partial
    of each 64-key chunk ``(chunks, B*nW*N, heads*hd)``."""
    if route == ROUTE_MMA:
        chunks = launch_plan(batch, n_windows, heads, sm_count, BWD_BLOCKS_PER_SM)
        return chunks, (chunks, heads, n, 56 if n <= 56 else 64)
    if route == ROUTE_TILED_MMA:
        if hd < 1:
            raise ValueError("bwd_plan: the tiled route needs the head width")
        total = batch * n_windows
        if tiled_mma_one_block(n, hd, True):
            chunks = launch_plan(batch, n_windows, heads, sm_count, TILED_MMA_BLOCKS_PER_SM)
            return chunks, (chunks, heads, n, TILED_MMA_CHUNK)
        group = tiled_mma_group(total, heads, n, sm_count)
        partials = -(-total // group) * heads * n * n
        floats = (-(-partials // 4) * 4 + total * heads * n * 4
                  + -(-n // TILED_MMA_SPLIT) * total * n * heads * hd)
        return group, (floats,)
    if route == ROUTE_TILED:
        if hd < 1:
            raise ValueError("bwd_plan: the tiled route needs the head width")
        group = tiled_bwd_group(batch * n_windows, heads, sm_count)
        return group, (-(-batch * n_windows // group), heads, n, n + hd + 3)
    group = bwd_group(batch * n_windows, heads)
    return group, (-(-batch * n_windows // group), heads, n, n)


_TILED = (ROUTE_TILED, ROUTE_TILED_MMA)


def _route(qkv: torch.Tensor, wh: int, ww: int, heads: int, sh: int, sw: int) -> int:
    _check_shape(qkv, wh, ww, heads)
    return kernel_route(qkv.dtype, qkv.shape[-1] // 3 // heads, wh * ww,
                        0 <= sh < wh and 0 <= sw < ww)


def _fwd(qkv, rel_bias, wh, ww, heads, sh, sw):
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, rel_bias, wh=wh, ww=ww,
                                          heads=heads, sh=sh, sw=sw)
    route = _route(qkv, wh, ww, heads, sh, sw)
    b, hp, wp, c3 = qkv.shape
    _build.check_cuda(qkv, "qkv")
    _build.check_cuda(rel_bias, "rel_bias", (heads, wh * ww, wh * ww), torch.float32)
    plan = fwd_plan(route, b, (hp // wh) * (wp // ww), heads, wh * ww,
                    _build.sm_count(qkv.device.index), c3 // 3 // heads)
    out = torch.empty((b, hp, wp, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    _build.launch("window_attention_tiled" if route in _TILED else "window_attention",
                  "ssa_window_attention_fwd",
                  [qkv, rel_bias, out],
                  [b, hp, wp, c3 // 3, heads, wh, ww, sh, sw, route, plan], qkv.dtype)
    return out


def window_attention_bwd(qkv, dctx, rel_bias, *, wh, ww, heads, sh, sw):
    """Backward wrapper: plain version on the CPU, the kernel (one count,
    two launches: the windows, then the deterministic sum of the bias
    partials; four for the split tiled ``mma.sync`` kernels: the rows'
    statistics, the windows, the sums of the dq and bias partials) on the
    card."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, dctx, rel_bias, wh=wh, ww=ww,
                                              heads=heads, sh=sh, sw=sw)
    route = _route(qkv, wh, ww, heads, sh, sw)
    b, hp, wp, c3 = qkv.shape
    n = wh * ww
    _build.check_cuda(qkv, "qkv")
    _build.check_cuda(dctx, "dctx", (b, hp, wp, c3 // 3), qkv.dtype)
    _build.check_cuda(rel_bias, "rel_bias", (heads, n, n), torch.float32)
    plan, scratch = bwd_plan(route, b, (hp // wh) * (wp // ww), heads, n,
                             _build.sm_count(qkv.device.index), c3 // 3 // heads)
    part = torch.empty(scratch, dtype=torch.float32, device=qkv.device)
    need = _build.query("ssa_window_attention_bwd_scratch",
                        [b, hp, wp, c3 // 3, heads, wh, ww, route, plan])
    if not 0 <= need <= part.numel():
        raise RuntimeError(f"window attention backward: the kernels lay out {need} floats of "
                           f"scratch for route {route} plan {plan}, {part.numel()} allocated")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((heads, n, n), dtype=torch.float32, device=qkv.device)
    _build.launch("window_attention_bwd_tiled" if route in _TILED
                  else "window_attention_bwd", "ssa_window_attention_bwd",
                  [qkv, dctx, rel_bias, dqkv, part, dbias],
                  [b, hp, wp, c3 // 3, heads, wh, ww, sh, sw, route, plan], qkv.dtype)
    return dqkv, dbias


class _WindowAttention(torch.autograd.Function):
    """Forward kernel, backward kernel; saves only qkv (and the bias it
    was given, an input: no copy)."""

    @staticmethod
    def forward(ctx, qkv, rel_bias, wh, ww, heads, sh, sw):
        ctx.save_for_backward(qkv, rel_bias)
        ctx.geom = (wh, ww, heads, sh, sw)
        return _fwd(qkv, rel_bias, wh, ww, heads, sh, sw)

    @staticmethod
    def backward(ctx, dctx):
        qkv, rel_bias = ctx.saved_tensors
        wh, ww, heads, sh, sw = ctx.geom
        dqkv, dbias = window_attention_bwd(qkv, dctx.contiguous(), rel_bias, wh=wh,
                                           ww=ww, heads=heads, sh=sh, sw=sw)
        return dqkv, dbias.to(rel_bias.dtype), None, None, None, None, None


def window_attention(qkv: torch.Tensor, rel_bias: torch.Tensor, *, wh: int,
                     ww: int, heads: int, sh: int, sw: int) -> torch.Tensor:
    """``(B,Hp,Wp,3C) -> (B,Hp,Wp,C)``, differentiable in qkv and the bias;
    plain versions on the CPU, the kernels on the card."""
    return _WindowAttention.apply(qkv, rel_bias, wh, ww, heads, sh, sw)


def fused_shifted_window_attention(
    x: torch.Tensor,
    qkv_weight: torch.Tensor,
    qkv_bias: Optional[torch.Tensor],
    proj_weight: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    bias_table: torch.Tensor,
    *,
    window_size: Tuple[int, int],
    shift_size: Tuple[int, int],
    num_heads: int,
) -> torch.Tensor:
    """Kernel-path counterpart of
    :func:`.window_attention.shifted_window_attention` (no dropout),
    computed in ``x.dtype``; weights in torch layout ``(out, in)``."""
    b, h, w, c = x.shape
    wh, ww = window_size
    hp, wp, sh, sw = effective_shift(h, w, window_size, shift_size)
    dt = x.dtype
    x = pad_and_roll(x, hp, wp, sh, sw)
    qkv = F.linear(x, qkv_weight.to(dt),
                   None if qkv_bias is None else qkv_bias.to(dt)).contiguous()
    rel_bias = gather_bias(bias_table, wh, ww, num_heads).float().contiguous()
    ctx = window_attention(qkv, rel_bias, wh=wh, ww=ww, heads=num_heads,
                           sh=sh, sw=sw)
    ctx = unroll_and_crop(ctx, h, w, sh, sw)
    return F.linear(ctx, proj_weight.to(dt),
                    None if proj_bias is None else proj_bias.to(dt))
