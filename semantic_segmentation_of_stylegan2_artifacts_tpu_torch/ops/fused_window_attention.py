"""Shifted-window attention with the window-shaped middle in one kernel.

Counterpart of the JAX package's ``ops/fused_window_attention.py``: the
qkv/proj projections, pad, roll and crop stay outside the kernel (plain
PyTorch, as the JAX package leaves them to XLA); the kernel
(``csrc/fused_window_attention.cu``) takes the rolled, padded qkv
``(B,Hp,Wp,3C)`` and writes the context ``(B,Hp,Wp,C)`` in the same
layout.  On the card the kernel covers every grid, so the TPU's width
chunking (``_layout``/``pad_chunk``) and stage caps are gone.

:func:`window_attention_reference` is the kernel's plain PyTorch
version, with the kernel's numerics: scores ``q.k^T`` in float32, then
scaled (the composed path scales q instead), + bias, + mask, float32
softmax, probs rounded to the input dtype before ``.v``.  The wrapper
takes it for CPU tensors only; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .window_attention import (
    effective_shift,
    gather_bias,
    pad_and_roll,
    shifted_window_mask,
    unroll_and_crop,
)


def window_attention_reference(qkv: torch.Tensor, rel_bias: torch.Tensor, *,
                               wh: int, ww: int, heads: int, sh: int,
                               sw: int) -> torch.Tensor:
    """Plain version of the kernel: ``(B,Hp,Wp,3C) -> (B,Hp,Wp,C)``."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    n = wh * ww
    nwh, nww = hp // wh, wp // ww
    x = qkv.reshape(b, nwh, wh, nww, ww, 3, heads, hd)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nwh * nww, heads, n, hd)
    q, k, v = x[0].float(), x[1].float(), x[2].float()
    s = torch.matmul(q, k.transpose(-1, -2))
    s = s * (hd ** -0.5)
    s = s + rel_bias.float()[None, None]
    if sh or sw:
        mask = torch.as_tensor(shifted_window_mask(hp, wp, wh, ww, sh, sw),
                               device=qkv.device)
        s = s + mask[None, :, None]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = (e / e.sum(dim=-1, keepdim=True)).to(qkv.dtype).float()
    ctx = torch.matmul(p, v).to(qkv.dtype)  # (B, nW, heads, N, hd)
    ctx = ctx.reshape(b, nwh, nww, heads, wh, ww, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return ctx.reshape(b, hp, wp, c)


def window_attention(qkv: torch.Tensor, rel_bias: torch.Tensor, *, wh: int,
                     ww: int, heads: int, sh: int, sw: int) -> torch.Tensor:
    """Kernel wrapper: plain version on the CPU, the kernel on the card."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, rel_bias, wh=wh, ww=ww,
                                          heads=heads, sh=sh, sw=sw)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    # the kernel keeps a window's N x N scores in shared memory
    if wh * ww > 64 or c % heads or hp % wh or wp % ww:
        raise ValueError(f"window attention kernel: unsupported shape "
                         f"{tuple(qkv.shape)} window {(wh, ww)} heads {heads}")
    _build.check_cuda(qkv, "qkv")
    _build.check_cuda(rel_bias, "rel_bias", (heads, wh * ww, wh * ww), torch.float32)
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    _build.launch("window_attention", "ssa_window_attention_fwd",
                  [qkv, rel_bias, out], [b, hp, wp, c, heads, wh, ww, sh, sw],
                  qkv.dtype)
    return out


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
    :func:`.window_attention.shifted_window_attention`, computed in
    ``x.dtype``; weights in torch layout ``(out, in)``."""
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
