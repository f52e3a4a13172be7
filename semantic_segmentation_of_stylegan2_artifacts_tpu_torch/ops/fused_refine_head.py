"""Decoder head tail on the card: GELU -> x4 depth-to-space -> 3x3 conv ->
GELU -> 3x3 conv -> LayerNorm, ``(B,Ht,Wt,16C) -> (B,4Ht,4Wt,C)``.

Counterpart of the JAX package's ``ops/fused_refine_head.py`` (its
inference variant, ``_fwd_kernel``); the kernel lives in
``csrc/fused_refine_head.cu`` and takes C = 128 with tanh GELU, the
deployment head.  :func:`refine_head_reference` is its plain version with
the kernel's numerics: conv input GELU'd in float32 and rounded to the
storage dtype, each conv accumulated in float32, rounded and its bias
added in the storage dtype, h1 zero outside the image, LayerNorm with
float32 fast-variance stats (not clamped).  The wrapper takes it for CPU
tensors only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .patch_ops import depth_to_space

LN_EPS = 1e-5
CHANNELS = 128


def supported(dim: int, gelu_tanh: bool) -> bool:
    """The head the kernel takes (the JAX gate, ``fused_refine_head.py:616``,
    without its TPU tiling limits)."""
    return gelu_tanh and dim == CHANNELS


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def refine_head_reference(y, w1, b1, w2, b2, gamma, beta):
    """Plain version; conv weights in torch layout ``(C, C, 3, 3)``."""
    dt = y.dtype
    xp = depth_to_space(_gelu(y.float()).to(dt), 4).permute(0, 3, 1, 2).float()
    a1 = F.conv2d(xp, w1.to(dt).float(), padding=1).to(dt)
    pre = (a1.float() + b1.to(dt).float()[None, :, None, None]).to(dt)
    h1 = _gelu(pre.float()).to(dt).float()
    a2 = F.conv2d(h1, w2.to(dt).float(), padding=1).to(dt)
    a2 = (a2.float() + b2.to(dt).float()[None, :, None, None]).to(dt).float()
    a2 = a2.permute(0, 2, 3, 1)
    mu = a2.mean(dim=-1, keepdim=True)
    va = (a2 * a2).mean(dim=-1, keepdim=True) - mu * mu
    xhat = (a2 - mu) * torch.rsqrt(va + LN_EPS)
    return (xhat * gamma.float() + beta.float()).to(dt)


def fused_refine_head(y, w1, b1, w2, b2, gamma, beta):
    """Plain version on the CPU, the kernel (two launches, h1 in device
    memory between them) on the card."""
    if y.device.type == "cpu":
        return refine_head_reference(y, w1, b1, w2, b2, gamma, beta)
    b, ht, wt, c16 = y.shape
    if c16 != 16 * CHANNELS:
        raise ValueError(f"refine head kernel: unsupported shape {tuple(y.shape)}")
    dt = y.dtype
    c = CHANNELS
    _build.check_cuda(y, "y")
    w1k = w1.to(dt).permute(2, 3, 1, 0).contiguous()  # HWIO
    w2k = w2.to(dt).permute(2, 3, 1, 0).contiguous()
    b1k, b2k = b1.to(dt).contiguous(), b2.to(dt).contiguous()
    gk, bek = gamma.float().contiguous(), beta.float().contiguous()
    for t, name, shape in ((w1k, "w1", (3, 3, c, c)), (w2k, "w2", (3, 3, c, c)),
                           (b1k, "b1", (c,)), (b2k, "b2", (c,)),
                           (gk, "gamma", (c,)), (bek, "beta", (c,))):
        _build.check_cuda(t, name, shape)
    h1 = torch.empty((b, 4 * ht, 4 * wt, c), dtype=dt, device=y.device)
    out = torch.empty_like(h1)
    _build.launch("refine_head", "ssa_refine_head_fwd",
                  [y, w1k, b1k, w2k, b2k, gk, bek, h1, out], [b, ht, wt], dt)
    return out
