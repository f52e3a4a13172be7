"""Spatial sharding over the ``space`` group (counterpart of the JAX
package's ``space`` mesh axis and ``MSUNetSys._sc``).

JAX puts a sharding constraint on the token grid's H at each stage
boundary and lets GSPMD insert the halos.  Torch has no GSPMD, so here the
H-slab layout and its halos are explicit, built on one primitive:

* :func:`exchange_plan` (pure): which rows of a map held as H-slabs
  (rank ``s`` holds global rows ``bounds[s]``) each rank sends and where
  each rank puts what it receives, when every rank asks for a range of
  global rows.  Rows wrap modulo ``period``, and rows at or past
  ``height`` read as zeros.
* :func:`fetch_rows`: the autograd Function over that plan (an
  ``all_to_all`` over the group, skipped when every row is local); its
  backward sends the gradients back to the rows' owners and sums them
  there.
* :func:`gather_rows`: every rank gets the whole map; the backward takes
  this rank's rows only, so each rank may compute the same replicated loss
  from it.

A stage's slab is window-aligned on its padded grid
(:func:`window_slabs`): rank ``s`` holds a run of window rows, which may be
empty at any stage.  On it, :func:`window_attention` fetches the rolled
rows of its windows in place of ``torch.roll`` and fetches back for the
un-roll; :func:`merge_rows` and :func:`expand_rows` re-slab at the stage
boundaries; :func:`halo_conv` runs the head's 3x3 convs with one fetched
halo row on each side.  Token grids are square (the model checks its
input), so a slab's width is its grid's height.

:func:`attach_space` gives a model built with ``spatial_axis`` its group;
parameter gradients are then summed over the group
(``parallel/mesh.py::Mesh.reduce_gradients``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.window_attention import (
    Parts,
    attend_windows,
    effective_shift,
    shifted_window_mask,
    window_partition,
    window_reverse,
)
from ..utils.profiling import upload

Bounds = Tuple[Tuple[int, int], ...]


@dataclass(frozen=True)
class Plan:
    """One rank's part of an exchange: the local rows it sends, rank by
    rank (``send_index``, ``send_counts``), and the positions of its output
    that each rank fills (``recv_pos``, ``recv_counts``), ``size`` output
    rows; ``remote`` when any row crosses ranks (the same on every rank)."""

    send_index: Tuple[int, ...]
    send_counts: Tuple[int, ...]
    recv_pos: Tuple[int, ...]
    recv_counts: Tuple[int, ...]
    size: int
    remote: bool


@functools.lru_cache(maxsize=None)
def exchange_plan(bounds: Bounds, height: int, period: int, requests: Bounds,
                  me: int) -> Plan:
    """Rank ``me``'s plan when rank ``d`` asks for global rows
    ``requests[d]`` of a ``height``-row map held as ``bounds``.  Row ``g``
    is row ``g mod period``, a zero row at or past ``height``."""
    n = len(bounds)
    owner = {}
    for s, (lo, hi) in enumerate(bounds):
        for r in range(lo, hi):
            owner[r] = (s, r - lo)
    if any(r not in owner for r in range(height)):
        raise ValueError(f"slabs {bounds} do not cover {height} rows")
    send = [[] for _ in range(n)]
    recv = [[] for _ in range(n)]
    remote = False
    for d, (lo, hi) in enumerate(requests):
        for pos, g in enumerate(range(lo, hi)):
            r = g % period
            if r >= height:
                continue
            s, local = owner[r]
            remote |= s != d
            if s == me:
                send[d].append(local)
            if d == me:
                recv[s].append(pos)
    lo, hi = requests[me]
    return Plan(tuple(i for rows in send for i in rows), tuple(map(len, send)),
                tuple(i for rows in recv for i in rows), tuple(map(len, recv)), hi - lo,
                remote)


def _all_to_all(send: torch.Tensor, out_counts, in_counts, group) -> torch.Tensor:
    """Rows of ``send`` (dim 1) to the ranks by ``in_counts``; what each
    rank sends here, by ``out_counts``, concatenated in rank order.  gloo
    exchanges host memory."""
    rows = send.movedim(1, 0).contiguous()
    host = dist.get_backend(group) != "nccl" and rows.is_cuda
    src = rows.cpu() if host else rows
    out = src.new_empty((sum(out_counts),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, list(out_counts), list(in_counts), group=group)
    return (out.to(send.device) if host else out).movedim(0, 1)


def _index(rows, device) -> torch.Tensor:
    return upload(np.asarray(rows, dtype=np.int64), device)


def pack(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The rows this rank sends, in rank order."""
    return x.index_select(1, _index(plan.send_index, x.device))


def unpack(recv: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The output rows from what this rank received (zeros elsewhere)."""
    shape = (recv.shape[0], plan.size) + tuple(recv.shape[2:])
    return recv.new_zeros(shape).index_copy_(1, _index(plan.recv_pos, recv.device), recv)


def pack_back(grad: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The backward's send: the output rows' gradients, by source rank."""
    return grad.index_select(1, _index(plan.recv_pos, grad.device))


def unpack_back(recv: torch.Tensor, plan: Plan, rows: int) -> torch.Tensor:
    """The input slab's gradient: what came back, summed onto its rows."""
    shape = (recv.shape[0], rows) + tuple(recv.shape[2:])
    return recv.new_zeros(shape).index_add_(1, _index(plan.send_index, recv.device), recv)


def _exchange(x, group, plan: Plan) -> torch.Tensor:
    send = pack(x, plan)
    if plan.remote:
        send = _all_to_all(send, plan.recv_counts, plan.send_counts, group)
    return unpack(send, plan)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, plan):
        ctx.group, ctx.plan, ctx.rows = group, plan, x.shape[1]
        return _exchange(x, group, plan)

    @staticmethod
    def backward(ctx, grad):
        back = pack_back(grad.contiguous(), ctx.plan)
        if ctx.plan.remote:
            back = _all_to_all(back, ctx.plan.send_counts, ctx.plan.recv_counts, ctx.group)
        return unpack_back(back, ctx.plan, ctx.rows), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, plan, lo):
        ctx.lo, ctx.rows = lo, x.shape[1]
        return _exchange(x, group, plan)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.lo:ctx.lo + ctx.rows].contiguous(), None, None, None


@dataclass(frozen=True)
class Slabs:
    """A ``height``-row map held as H-slabs: rank ``s`` holds global rows
    ``bounds[s]``."""

    bounds: Bounds
    height: int

    def scaled(self, k: int) -> "Slabs":
        return Slabs(tuple((k * lo, k * hi) for lo, hi in self.bounds), k * self.height)


@functools.lru_cache(maxsize=None)
def window_rows(grid: int, window: int, size: int) -> Bounds:
    """Each rank's run of window rows of a ``grid`` padded to whole windows:
    the first ``n % size`` ranks one more (a rank may get none)."""
    n = -(-grid // window)
    k, extra = divmod(n, size)
    out, a = [], 0
    for s in range(size):
        b = a + k + (s < extra)
        out.append((a, b))
        a = b
    return tuple(out)


def window_slabs(grid: int, window: int, size: int) -> Slabs:
    """The window-aligned slabs of a stage: each rank's window rows, cut to
    the grid's unpadded rows."""
    return Slabs(tuple((min(a * window, grid), min(b * window, grid))
                       for a, b in window_rows(grid, window, size)), grid)


class SpaceShard:
    """This rank's place in the ``space`` group and the slab layout of
    every grid (square grids, ``window``-aligned)."""

    def __init__(self, group, window: int):
        self.group = group
        self.window = window
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def slabs(self, grid: int) -> Slabs:
        return window_slabs(grid, self.window, self.size)

    def rows(self, grid: int) -> Tuple[int, int]:
        return self.slabs(grid).bounds[self.rank]

    def row_part(self, x: torch.Tensor) -> Parts:
        """:func:`..ops.window_attention.dropout_keep`'s part of a slab."""
        lo, _ = self.rows(x.shape[2])
        return ((1, lo, x.shape[2]),)


def fetch_rows(x: torch.Tensor, space: SpaceShard, slabs: Slabs, period: int,
               requests: Bounds) -> torch.Tensor:
    """Global rows ``requests[space.rank]`` of the map held as ``slabs``, of
    which ``x`` is this rank's slab (a collective: rank ``d`` of the space
    group asks for ``requests[d]``)."""
    plan = exchange_plan(slabs.bounds, slabs.height, period, requests, space.rank)
    return _Fetch.apply(x, space.group, plan)


def gather_rows(x: torch.Tensor, space: SpaceShard, slabs: Slabs) -> torch.Tensor:
    """The whole map on every rank; the gradient keeps this rank's rows."""
    everything = ((0, slabs.height),) * space.size
    plan = exchange_plan(slabs.bounds, slabs.height, slabs.height, everything, space.rank)
    return _Gather.apply(x, space.group, plan, slabs.bounds[space.rank][0])


def window_attention(space: SpaceShard, x: torch.Tensor, qkv_weight, qkv_bias, proj_weight,
                     proj_bias, bias_table, *, window_size, shift_size, num_heads,
                     softmax_dtype=torch.float32, attention_dropout: float = 0.0,
                     dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                     heads: Parts = (), reduce=None) -> torch.Tensor:
    """``ops/window_attention.py::shifted_window_attention`` on this rank's
    slab: the rolled, padded rows of its windows are fetched (the roll's
    wrap and the padding's zeros included), attended with its windows' part
    of the shift mask, and fetched back to the slab's rows."""
    _, _, w, _ = x.shape
    wh, ww = window_size
    hp, wp, sh, sw = effective_shift(w, w, window_size, shift_size)
    slabs = space.slabs(w)
    wins = window_rows(w, wh, space.size)
    xr = fetch_rows(x, space, slabs, hp, tuple((a * wh + sh, b * wh + sh) for a, b in wins))
    if wp != w:
        xr = F.pad(xr, (0, 0, 0, wp - w))
    if sw:
        xr = torch.roll(xr, shifts=-sw, dims=2)
    a, b = wins[space.rank]
    nwx = wp // ww
    mask = None
    if sh or sw:
        mask = upload(shifted_window_mask(hp, wp, wh, ww, sh, sw)[a * nwx:b * nwx], x.device)
    out = attend_windows(
        window_partition(xr, wh, ww), qkv_weight, qkv_bias, proj_weight, proj_bias,
        bias_table, window_size=window_size, num_heads=num_heads, mask=mask,
        softmax_dtype=softmax_dtype, attention_dropout=attention_dropout, dropout=dropout,
        generator=generator, windows=((1, a * nwx, (hp // wh) * nwx),), heads=heads,
        reduce=reduce)
    out = window_reverse(out, (b - a) * wh, wp, wh, ww)
    if sw:
        out = torch.roll(out, shifts=sw, dims=2)
    rolled = Slabs(tuple((a * wh, b * wh) for a, b in wins), hp)
    return fetch_rows(out[:, :, :w], space, rolled, hp,
                       tuple((lo - sh, hi - sh) for lo, hi in slabs.bounds))


def merge_rows(space: SpaceShard, x: torch.Tensor) -> torch.Tensor:
    """The rows a 2x2 merge turns into this rank's slab of the next grid."""
    grid = x.shape[2]
    nxt = space.slabs(grid // 2)
    return fetch_rows(x, space, space.slabs(grid), grid,
                      tuple((2 * lo, 2 * hi) for lo, hi in nxt.bounds))


def expand_rows(space: SpaceShard, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """The rows a 2x expand turns into this rank's slab of the next grid,
    and the ``(start, count)`` of that slab's rows in the expanded map."""
    grid = x.shape[2]
    nxt = space.slabs(2 * grid)
    rows = fetch_rows(x, space, space.slabs(grid), grid,
                      tuple((lo // 2, (hi + 1) // 2) for lo, hi in nxt.bounds))
    lo, hi = nxt.bounds[space.rank]
    return rows, lo % 2, hi - lo


def halo_conv(space: SpaceShard, x: torch.Tensor, slabs: Slabs, conv: torch.nn.Conv2d,
              dtype: torch.dtype) -> torch.Tensor:
    """A 3x3 ``conv`` (padding 1, C -> C) on this rank's slab of ``slabs``:
    one halo row fetched on each side, zeros past the map's edges."""
    xh = fetch_rows(x, space, slabs, slabs.height + 1,
                    tuple((lo - 1, hi + 1) for lo, hi in slabs.bounds))
    if x.shape[1] == 0:  # an empty slab: three rows are the least a 3x3 conv takes
        return xh[:, 1:1]
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(xh.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype), bias,
                 padding=(0, 1))
    return y.permute(0, 2, 3, 1)


def attach_space(model: torch.nn.Module, group) -> SpaceShard:
    """Give a model built with ``spatial_axis`` (``TPU.SPATIAL_AXIS``) the
    ``space`` group: every module with a ``space`` attribute gets this
    rank's :class:`SpaceShard`."""
    sys = getattr(model, "ms_unet", model)
    if not sys.spatial_axis:
        raise ValueError("attach_space needs a model built with spatial_axis "
                         "(TPU.SPATIAL_AXIS): the kernels take whole maps")
    space = SpaceShard(group, sys.window_size)
    for mod in model.modules():
        if hasattr(mod, "space"):
            mod.space = space
    return space
