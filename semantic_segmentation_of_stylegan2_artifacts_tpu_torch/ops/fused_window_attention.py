"""Shifted-window attention with the window-shaped middle in one kernel.

Counterpart of the JAX package's ``ops/fused_window_attention.py``: the
qkv/proj projections, pad, roll and crop stay outside the kernel (plain
PyTorch, as the JAX package leaves them to XLA); the kernels
(``csrc/fused_window_attention.cu``) take the rolled, padded qkv
``(B,Hp,Wp,3C)``.  The forward writes the context ``(B,Hp,Wp,C)`` in the
same layout; the backward recomputes the probabilities from the saved
qkv and writes ``dqkv`` ``(B,Hp,Wp,3C)`` and the float32 bias gradient
``(heads,N,N)`` summed over every window and image.  On the card the
kernels cover every grid, so the TPU's width chunking
(``_layout``/``pad_chunk``) and stage caps are gone.

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

from . import _build
from .window_attention import (
    effective_shift,
    gather_bias,
    pad_and_roll,
    shifted_window_mask,
    unroll_and_crop,
)

# Windows per backward block: enough that the per-block bias-gradient
# partials stay small, few enough that the grid fills the card.
_BWD_TARGET_BLOCKS = 1024
_BWD_MAX_GROUP = 32


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
        mask = torch.as_tensor(shifted_window_mask(hp, wp, wh, ww, sh, sw),
                               device=q.device)
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
    # the kernels keep a window's N x N scores in shared memory
    if wh * ww > 64 or (c3 // 3) % heads or hp % wh or wp % ww:
        raise ValueError(f"window attention kernel: unsupported shape "
                         f"{tuple(qkv.shape)} window {(wh, ww)} heads {heads}")


def _fwd(qkv, rel_bias, wh, ww, heads, sh, sw):
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, rel_bias, wh=wh, ww=ww,
                                          heads=heads, sh=sh, sw=sw)
    _check_shape(qkv, wh, ww, heads)
    b, hp, wp, c3 = qkv.shape
    _build.check_cuda(qkv, "qkv")
    _build.check_cuda(rel_bias, "rel_bias", (heads, wh * ww, wh * ww), torch.float32)
    out = torch.empty((b, hp, wp, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    _build.launch("window_attention", "ssa_window_attention_fwd",
                  [qkv, rel_bias, out], [b, hp, wp, c3 // 3, heads, wh, ww, sh, sw],
                  qkv.dtype)
    return out


def bwd_group(n_windows: int, heads: int) -> int:
    """Windows each backward block walks through (its bias-gradient
    partial covers all of them)."""
    g = -(-n_windows * heads // _BWD_TARGET_BLOCKS)
    return max(1, min(_BWD_MAX_GROUP, g))


def window_attention_bwd(qkv, dctx, rel_bias, *, wh, ww, heads, sh, sw):
    """Backward wrapper: plain version on the CPU, the kernel (one count,
    two launches: the windows, then the deterministic sum of the bias
    partials) on the card."""
    if qkv.device.type == "cpu":
        return window_attention_bwd_reference(qkv, dctx, rel_bias, wh=wh, ww=ww,
                                              heads=heads, sh=sh, sw=sw)
    _check_shape(qkv, wh, ww, heads)
    b, hp, wp, c3 = qkv.shape
    n = wh * ww
    _build.check_cuda(qkv, "qkv")
    _build.check_cuda(dctx, "dctx", (b, hp, wp, c3 // 3), qkv.dtype)
    _build.check_cuda(rel_bias, "rel_bias", (heads, n, n), torch.float32)
    n_win = b * (hp // wh) * (wp // ww)
    group = bwd_group(n_win, heads)
    n_blk = -(-n_win // group)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((n_blk, heads, n, n), dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((heads, n, n), dtype=torch.float32, device=qkv.device)
    _build.launch("window_attention_bwd", "ssa_window_attention_bwd",
                  [qkv, dctx, rel_bias, dqkv, part, dbias],
                  [b, hp, wp, c3 // 3, heads, wh, ww, sh, sw, group], qkv.dtype)
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
