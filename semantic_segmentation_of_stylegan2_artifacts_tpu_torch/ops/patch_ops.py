"""Patch merge / expand layouts (NHWC), the channel orders of the
reference's ``PatchMerging`` (``network/model_parts.py:59-97``) and
``rearrange('b h w (p1 p2 c) -> b (h p1) (w p2) c')`` (``:403,464``)."""

from __future__ import annotations

import torch


def merge_2x2(x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C) -> (B, H/2, W/2, 4C)`` in [x0|x1|x2|x3] order =
    [(0::2,0::2), (1::2,0::2), (0::2,1::2), (1::2,1::2)]."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"merge_2x2 needs even H,W; got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)  # (b, h2, i, w2, j, c)
    x = x.permute(0, 1, 3, 4, 2, 5)  # (b, h2, w2, j, i, c)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def unmerge_2x2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`merge_2x2`: ``(B, H/2, W/2, 4C) -> (B, H, W, C)``."""
    b, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h2, w2, 2, 2, c)  # (b, h2, w2, j, i, c)
    x = x.permute(0, 1, 4, 2, 3, 5)  # (b, h2, i, w2, j, c)
    return x.reshape(b, 2 * h2, 2 * w2, c)


def depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """``(B, H, W, p*p*C) -> (B, p*H, p*W, C)``, channels p1-major."""
    b, h, w, cpp = x.shape
    if cpp % (p * p):
        raise ValueError(f"channels {cpp} not divisible by {p * p}")
    c = cpp // (p * p)
    x = x.reshape(b, h, w, p, p, c)  # (b, h, w, p1, p2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (b, h, p1, w, p2, c)
    return x.reshape(b, h * p, w * p, c)


def space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`depth_to_space`: ``(B, p*H, p*W, C) -> (B, H, W, p*p*C)``."""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // p, p, wp // p, p, c)  # (b, h, p1, w, p2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (b, h, w, p1, p2, c)
    return x.reshape(b, hp // p, wp // p, p * p * c)
