"""Shifted-window attention, composed from PyTorch ops.

The numerical contract of torchvision's ``shifted_window_attention`` as
the reference MS-UNet uses it (``network/model_parts.py:36,143-151``):
the *normed* input is zero-padded to window multiples (padded tokens
take part in unshifted attention), the shift is dropped where one window
spans the padded grid, the map is rolled by ``-shift`` and partitioned,
queries are scaled by ``head_dim**-0.5``, the relative-position bias is
gathered from a ``(2w-1)^2 x heads`` table, shifted blocks add the 0/-100
nine-region mask, softmax runs in ``softmax_dtype``, then ``.v``, proj,
reverse and unroll.  This is the path the port takes with
``TPU.USE_PALLAS_ATTENTION`` off, and the one attention dropout takes in
training; ``ops/fused_window_attention.py`` holds the kernel path.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span, upload

# ``(dim, start, total)`` for each dimension on which a tensor is one rank's part
Parts = Tuple[Tuple[int, int, int], ...]


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static ``(wh*ww, wh*ww)`` gather index into the (2wh-1)(2ww-1) table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(pad_h: int, pad_w: int, wh: int, ww: int,
                        sh: int, sw: int) -> np.ndarray:
    """Additive mask ``(num_windows, N, N)`` of 0 / -100: the padded grid
    labelled with 9 region ids from the (window, shift) slicing, windows
    partitioned, pairs with different ids masked."""
    img = np.zeros((pad_h, pad_w), dtype=np.float32)
    h_slices = ((0, pad_h - wh), (pad_h - wh, pad_h - sh), (pad_h - sh, pad_h))
    w_slices = ((0, pad_w - ww), (pad_w - ww, pad_w - sw), (pad_w - sw, pad_w))
    cnt = 0
    for h0, h1 in h_slices:
        for w0, w1 in w_slices:
            img[h0:h1, w0:w1] = cnt
            cnt += 1
    img = img.reshape(pad_h // wh, wh, pad_w // ww, ww)
    img = img.transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    mask = img[:, None, :] - img[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def effective_shift(h: int, w: int, window_size: Tuple[int, int],
                    shift_size: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """``(Hp, Wp, sh, sw)``: padded grid and the shift torchvision keeps
    (dropped on an axis where one window spans the padded grid)."""
    wh, ww = window_size
    sh, sw = shift_size
    hp, wp = h + (-h % wh), w + (-w % ww)
    return hp, wp, (0 if wh >= hp else sh), (0 if ww >= wp else sw)


def gather_bias(bias_table: torch.Tensor, wh: int, ww: int,
                heads: int) -> torch.Tensor:
    """Relative-position bias ``(heads, N, N)`` from the table."""
    n = wh * ww
    idx = upload(relative_position_index(wh, ww).reshape(-1), bias_table.device)
    return bias_table[idx].reshape(n, n, heads).permute(2, 0, 1)


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """``(B, H, W, C) -> (B, nW, wh*ww, C)``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // wh) * (w // ww), wh * ww, c)


def window_reverse(x: torch.Tensor, h: int, w: int, wh: int, ww: int) -> torch.Tensor:
    """``(B, nW, wh*ww, C) -> (B, H, W, C)``."""
    b, _, _, c = x.shape
    x = x.reshape(b, h // wh, w // ww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def pad_and_roll(x: torch.Tensor, hp: int, wp: int, sh: int, sw: int) -> torch.Tensor:
    """Zero-pad ``(B,H,W,C)`` bottom/right to ``(Hp,Wp)``, roll by -shift
    (inside an ``ssa.roll`` span when there is either)."""
    h, w = x.shape[1], x.shape[2]
    if hp == h and wp == w and not (sh or sw):
        return x
    with span("ssa.roll"):
        if hp != h or wp != w:
            x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        if sh or sw:
            x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
        return x


def unroll_and_crop(x: torch.Tensor, h: int, w: int, sh: int, sw: int) -> torch.Tensor:
    """Inverse of :func:`pad_and_roll`."""
    if x.shape[1] == h and x.shape[2] == w and not (sh or sw):
        return x
    with span("ssa.roll"):
        if sh or sw:
            x = torch.roll(x, shifts=(sh, sw), dims=(1, 2))
        return x[:, :h, :w, :]


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Boolean draws, True with probability ``keep``, from ``generator``."""
    if generator is None:
        raise ValueError("dropout and stochastic depth in training need a torch.Generator")
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout_keep(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
                 parts: Parts = ()) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1-rate``
    and scale it by ``1/(1-rate)``; zero the rest.

    ``parts``: ``(dim, start, total)`` for each dimension on which ``x`` is
    one rank's part of a larger tensor (its heads or hidden units under
    tensor parallelism, its rows or windows under spatial sharding).  The
    mask is drawn at the whole size and this part taken, so every rank
    draws what one process would and the generator advances alike on every
    rank."""
    keep = 1.0 - rate
    shape = list(x.shape)
    for dim, _, total in parts:
        shape[dim] = total
    mask = keep_mask(shape, keep, generator, x.device)
    for dim, start, _ in parts:
        mask = mask.narrow(dim, start, x.shape[dim])
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attend_windows(
    xw: torch.Tensor,
    qkv_weight: torch.Tensor,
    qkv_bias: Optional[torch.Tensor],
    proj_weight: torch.Tensor,
    proj_bias: Optional[torch.Tensor],
    bias_table: torch.Tensor,
    *,
    window_size: Tuple[int, int],
    num_heads: int,
    mask: Optional[torch.Tensor],
    softmax_dtype: torch.dtype = torch.float32,
    attention_dropout: float = 0.0,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    windows: Parts = (),
    heads: Parts = (),
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """MHSA within each window of ``xw`` ``(B, nW, wh*ww, C)``: qkv, scores
    + relative-position bias (+ ``mask`` ``(nW, N, N)``), softmax, ``.v``,
    proj; returns ``(B, nW, N, C_out)``.

    The head width is ``qkv_weight``'s rows over ``3 * num_heads``, so a
    rank may hold some of the heads (tensor parallelism): ``heads`` and
    ``windows`` place its heads and windows among all (see
    :func:`dropout_keep`), and ``reduce`` sums the proj products over the
    ranks before ``proj_bias`` is added."""
    b, nw, n, _ = xw.shape
    wh, ww = window_size
    dt = xw.dtype
    hd = qkv_weight.shape[0] // (3 * num_heads)
    qkv = F.linear(xw, qkv_weight.to(dt),
                   None if qkv_bias is None else qkv_bias.to(dt))
    qkv = qkv.reshape(b, nw, n, 3, num_heads, hd).permute(3, 0, 1, 4, 2, 5)
    q, k, v = qkv[0] * (hd ** -0.5), qkv[1], qkv[2]  # (B, nW, heads, N, hd)

    attn = torch.matmul(q, k.transpose(-1, -2)).to(softmax_dtype)
    attn = attn + gather_bias(bias_table, wh, ww, num_heads)[None, None].to(softmax_dtype)
    if mask is not None:
        attn = attn + mask[None, :, None].to(softmax_dtype)
    attn = torch.softmax(attn, dim=-1)
    if attention_dropout > 0.0:
        attn = dropout_keep(attn, attention_dropout, generator, windows + heads)
    out = torch.matmul(attn.to(dt), v)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, nw, n, num_heads * hd)
    if reduce is None:
        out = F.linear(out, proj_weight.to(dt),
                       None if proj_bias is None else proj_bias.to(dt))
    else:
        out = reduce(F.linear(out, proj_weight.to(dt)))
        if proj_bias is not None:
            out = out + proj_bias.to(dt)
    if dropout > 0.0:
        out = dropout_keep(out, dropout, generator, windows)
    return out


def shifted_window_attention(
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
    softmax_dtype: torch.dtype = torch.float32,
    attention_dropout: float = 0.0,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    heads: Parts = (),
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Shifted-window MHSA on ``(B, H, W, C)`` (already normed), computed
    in ``x.dtype``; weights in torch layout ``(out, in)``.

    ``attention_dropout`` drops softmax probabilities and ``dropout`` the
    projection output (JAX ``ops/window_attention.py:293-299, 467-472``),
    each keep scaled by ``1/(1-rate)``, with noise drawn from
    ``generator``; callers pass rates of 0 outside training.
    ``num_heads`` counts the heads the weights hold; ``heads`` and
    ``reduce`` are :func:`attend_windows`' (tensor parallelism)."""
    b, h, w, c = x.shape
    wh, ww = window_size
    hp, wp, sh, sw = effective_shift(h, w, window_size, shift_size)
    mask = None
    if sh or sw:
        mask = upload(shifted_window_mask(hp, wp, wh, ww, sh, sw), x.device)
    out = attend_windows(
        window_partition(pad_and_roll(x, hp, wp, sh, sw), wh, ww), qkv_weight, qkv_bias,
        proj_weight, proj_bias, bias_table, window_size=window_size, num_heads=num_heads,
        mask=mask, softmax_dtype=softmax_dtype, attention_dropout=attention_dropout,
        dropout=dropout, generator=generator, heads=heads, reduce=reduce)
    return unroll_and_crop(window_reverse(out, hp, wp, wh, ww), h, w, sh, sw)
