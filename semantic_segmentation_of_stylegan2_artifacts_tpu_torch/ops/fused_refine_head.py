"""Decoder head tail on the card: GELU -> x4 depth-to-space -> 3x3 conv ->
GELU -> 3x3 conv -> LayerNorm, ``(B,Ht,Wt,16C) -> (B,4Ht,4Wt,C)``.

Counterpart of the JAX package's ``ops/fused_refine_head.py``: its
inference forward (``_fwd_kernel``), its training forward
(``_fwd_res_kernel``, which also saves ``pre`` = conv1 + b1 before the
GELU and ``a2`` = conv2 + b2 before the LayerNorm, both in the storage
dtype) and its backward (``_bwd_kernel``, no conv recomputed).  The
kernels live in ``csrc/fused_refine_head.cu`` and take C = 128 with tanh
GELU, the deployment head.

The plain versions carry the kernels' numerics: conv input GELU'd in
float32 and rounded to the storage dtype, each conv accumulated in
float32, rounded and its bias added in the storage dtype, h1 zero
outside the image, LayerNorm with float32 fast-variance stats (not
clamped).  Backward: LayerNorm statistics recomputed from ``a2``, ``da2``
and ``da1`` stored in the dtype, ``dy`` from the float32 transposed conv,
and the parameter gradients float32 sums over every pixel.  The wrappers
take the plain versions for CPU tensors only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused_head import gelu_tanh_grad
from .patch_ops import depth_to_space, space_to_depth

LN_EPS = 1e-5
CHANNELS = 128

# Mirrors of csrc/fused_refine_head.cu's tiling, to size the partial sums.
_CONV_TILE = {torch.bfloat16: 128, torch.float32: 64}  # pixels per conv block
_LN_PIX = 256        # pixels per LayerNorm-backward block
_DW_ROWS = 32        # pixel rows per weight-gradient chunk


def supported(dim: int, gelu_tanh: bool) -> bool:
    """The head the kernel takes (the JAX gate, ``fused_refine_head.py:616``,
    without its TPU tiling limits)."""
    return gelu_tanh and dim == CHANNELS


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _xp(y):
    """conv1's input: GELU(y) rounded to the dtype, x4 depth-to-space, NCHW f32."""
    return depth_to_space(_gelu(y.float()).to(y.dtype), 4).permute(0, 3, 1, 2).float()


def refine_head_res_reference(y, w1, b1, w2, b2, gamma, beta):
    """Plain version of the training forward: ``(out, pre, a2)``; conv
    weights in torch layout ``(C, C, 3, 3)``."""
    dt = y.dtype
    a1 = F.conv2d(_xp(y), w1.to(dt).float(), padding=1).to(dt)
    pre = (a1.float() + b1.to(dt).float()[None, :, None, None]).to(dt)
    h1 = _gelu(pre.float()).to(dt).float()
    a2 = F.conv2d(h1, w2.to(dt).float(), padding=1).to(dt)
    a2 = (a2.float() + b2.to(dt).float()[None, :, None, None]).to(dt)
    a2f = a2.float().permute(0, 2, 3, 1)
    mu = a2f.mean(dim=-1, keepdim=True)
    va = (a2f * a2f).mean(dim=-1, keepdim=True) - mu * mu
    xhat = (a2f - mu) * torch.rsqrt(va + LN_EPS)
    out = (xhat * gamma.float() + beta.float()).to(dt)
    return out, pre.permute(0, 2, 3, 1).contiguous(), a2.permute(0, 2, 3, 1).contiguous()


def refine_head_reference(y, w1, b1, w2, b2, gamma, beta):
    """Plain version of the inference forward."""
    return refine_head_res_reference(y, w1, b1, w2, b2, gamma, beta)[0]


def refine_head_bwd_reference(y, pre, a2, dout, w1, w2, gamma):
    """Plain version of the backward: ``(dy, dw1, db1, dw2, db2, dgamma,
    dbeta)``; dy in y's dtype, the rest float32, conv weight gradients in
    torch layout ``(C, C, 3, 3)``."""
    dt = y.dtype
    a2f, doutf = a2.float(), dout.float()
    mu = a2f.mean(dim=-1, keepdim=True)
    va = (a2f * a2f).mean(dim=-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(va + LN_EPS)
    xhat = (a2f - mu) * inv
    dxh = doutf * gamma.float()
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    da2 = (dxh - m1 - xhat * m2) * inv
    dgamma = (doutf * xhat).sum(dim=(0, 1, 2))
    dbeta = doutf.sum(dim=(0, 1, 2))
    db2 = da2.sum(dim=(0, 1, 2))
    da2s = da2.to(dt).float().permute(0, 3, 1, 2)
    h1 = _gelu(pre.float()).to(dt).float().permute(0, 3, 1, 2)
    dw2 = torch.nn.grad.conv2d_weight(h1, w2.shape, da2s, padding=1)
    dh1 = F.conv_transpose2d(da2s, w2.to(dt).float(), padding=1)
    da1 = dh1 * gelu_tanh_grad(pre.float()).permute(0, 3, 1, 2)
    db1 = da1.sum(dim=(0, 2, 3))
    da1s = da1.to(dt).float()
    dw1 = torch.nn.grad.conv2d_weight(_xp(y), w1.shape, da1s, padding=1)
    dxp = F.conv_transpose2d(da1s, w1.to(dt).float(), padding=1).permute(0, 2, 3, 1)
    dy = (space_to_depth(dxp, 4) * gelu_tanh_grad(y.float())).to(dt)
    return dy, dw1, db1, dw2, db2, dgamma, dbeta


def _prep(y, w1, b1, w2, b2, gamma, beta):
    """Kernel operands: HWIO weights and biases in the dtype, LN params f32."""
    c, dt = CHANNELS, y.dtype
    if y.shape[-1] != 16 * c:
        raise ValueError(f"refine head kernel: unsupported shape {tuple(y.shape)}")
    _build.check_cuda(y, "y")
    ops = (w1.to(dt).permute(2, 3, 1, 0).contiguous(), b1.to(dt).contiguous(),
           w2.to(dt).permute(2, 3, 1, 0).contiguous(), b2.to(dt).contiguous(),
           gamma.float().contiguous(), beta.float().contiguous())
    for t, name, shape in zip(ops, ("w1", "b1", "w2", "b2", "gamma", "beta"),
                              ((3, 3, c, c), (c,), (3, 3, c, c), (c,), (c,), (c,))):
        _build.check_cuda(t, name, shape)
    return ops


def _fwd_kernel(y, params, save_residuals: bool):
    b, ht, wt, _ = y.shape
    out = torch.empty((b, 4 * ht, 4 * wt, CHANNELS), dtype=y.dtype, device=y.device)
    h1 = torch.empty_like(out)
    pre = torch.empty_like(out) if save_residuals else None
    a2 = torch.empty_like(out) if save_residuals else None
    _build.launch("refine_head_res" if save_residuals else "refine_head",
                  "ssa_refine_head_fwd", [y, *params, h1, out, pre, a2],
                  [b, ht, wt], y.dtype)
    return out, pre, a2


def _bwd_kernel(y, pre, a2, dout, w1, w2, gamma):
    b, ht, wt, _ = y.shape
    c, dt, dev = CHANNELS, y.dtype, y.device
    h, w = 4 * ht, 4 * wt
    for t, name in ((pre, "pre"), (a2, "a2"), (dout, "dout")):
        _build.check_cuda(t, name, (b, h, w, c), dt)
    # the transposed convs run as forward convs with the taps flipped and
    # in/out swapped: W'[u, v, co, ci] = W[co, ci, 2-u, 2-v]
    w1f = w1.to(dt).flip(2, 3).permute(2, 3, 0, 1).contiguous()
    w2f = w2.to(dt).flip(2, 3).permute(2, 3, 0, 1).contiguous()
    g = gamma.float().contiguous()
    for t, name, shape in ((w1f, "w1", (3, 3, c, c)), (w2f, "w2", (3, 3, c, c)),
                           (g, "gamma", (c,))):
        _build.check_cuda(t, name, shape)
    f32 = dict(dtype=torch.float32, device=dev)
    n_conv = -(-w // _CONV_TILE[dt]) * h * b
    n_ln = -(-b * h * w // _LN_PIX)
    n_chunk = -(-b * h // _DW_ROWS)
    da2 = torch.empty_like(pre)
    da1 = torch.empty_like(pre)
    part_ln = torch.empty((n_ln, 3, c), **f32)
    part_db1 = torch.empty((n_conv, c), **f32)
    part_dw1 = torch.empty((n_chunk, 9, c, c), **f32)
    part_dw2 = torch.empty((n_chunk, 9, c, c), **f32)
    dy = torch.empty_like(y)
    dw1 = torch.empty((3, 3, c, c), **f32)  # HWIO
    dw2 = torch.empty((3, 3, c, c), **f32)
    db1, db2, dg, dbe = (torch.empty(c, **f32) for _ in range(4))
    _build.launch("refine_head_bwd", "ssa_refine_head_bwd",
                  [y, pre, a2, dout, w1f, w2f, g, da2, da1, part_ln, part_db1,
                   part_dw1, part_dw2, dy, dw1, db1, dw2, db2, dg, dbe],
                  [b, ht, wt, _DW_ROWS], dt)
    oihw = lambda t: t.permute(3, 2, 0, 1)  # noqa: E731  HWIO -> OIHW
    return dy, oihw(dw1), db1, oihw(dw2), db2, dg, dbe


class _RefineHead(torch.autograd.Function):
    """Training forward (saves ``pre`` and ``a2``) and backward kernel.
    Takes the float32 parameters and casts inside, so their gradients
    come back as unrounded float32 sums (JAX ``fused_refine_head.py:573-590``)."""

    @staticmethod
    def forward(ctx, y, w1, b1, w2, b2, gamma, beta):
        if y.device.type == "cpu":
            out, pre, a2 = refine_head_res_reference(y, w1, b1, w2, b2, gamma, beta)
        else:
            out, pre, a2 = _fwd_kernel(y, _prep(y, w1, b1, w2, b2, gamma, beta), True)
        ctx.save_for_backward(y, pre, a2, w1, w2, gamma)
        ctx.param_dtypes = tuple(t.dtype for t in (w1, b1, w2, b2, gamma, beta))
        return out

    @staticmethod
    def backward(ctx, dout):
        y, pre, a2, w1, w2, gamma = ctx.saved_tensors
        bwd = refine_head_bwd_reference if y.device.type == "cpu" else _bwd_kernel
        dy, *grads = bwd(y, pre, a2, dout.contiguous(), w1, w2, gamma)
        return (dy, *(g.to(dt) for g, dt in zip(grads, ctx.param_dtypes)))


def fused_refine_head(y, w1, b1, w2, b2, gamma, beta):
    """The head tail, differentiable in every input when autograd records.
    Without gradients it runs the inference forward (plain version on the
    CPU, two kernel launches with h1 in device memory on the card); with
    them the training forward and the backward kernel."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, w1, b1, w2, b2, gamma, beta)):
        return _RefineHead.apply(y, w1, b1, w2, b2, gamma, beta)
    if y.device.type == "cpu":
        return refine_head_reference(y, w1, b1, w2, b2, gamma, beta)
    return _fwd_kernel(y, _prep(y, w1, b1, w2, b2, gamma, beta), False)[0]
