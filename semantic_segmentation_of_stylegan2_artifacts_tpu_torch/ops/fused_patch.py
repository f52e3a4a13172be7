"""PatchMerging / PatchExpand forwards, each one kernel on the card.

Counterpart of the JAX package's ``ops/fused_patch.py``.  Merge is
``Linear(LN(merge_2x2(x)))``: ``(B,H,W,C) -> (B,H/2,W/2,2C)``; expand is
``LN(depth_to_space(Linear(x), 2))``: ``(B,H,W,C) -> (B,2H,2W,C/2)``;
both bias-free, LayerNorm with float32 fast-variance stats clamped at 0
(``models/layers.py:58-69`` of the JAX package).  The kernels live in
``csrc/fused_patch.cu``.  The plain versions below follow the kernels'
numerics (merge: the LN output is rounded to the input dtype before the
product; expand: the product is rounded to the input dtype before the
LN) and run for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import _build
from .patch_ops import depth_to_space, merge_2x2

LN_EPS = 1e-5


def _ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    xhat = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return xhat * scale.float() + bias.float()


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


def merge_supported(shape) -> bool:
    _, h, w, c = shape
    return h % 2 == 0 and w % 2 == 0 and c % 16 == 0


def expand_supported(shape) -> bool:
    c = shape[-1]
    return c % 64 == 0 and (c // 64) in (1, 2, 4, 8, 16)


def fused_patch_merge(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``(B,H,W,C) -> (B,H/2,W/2,2C)``; plain on the CPU, kernel on the card."""
    if x.device.type == "cpu":
        return patch_merge_reference(x, ln_scale, ln_bias, weight)
    b, h, w, c = x.shape
    if not merge_supported(x.shape):
        raise ValueError(f"patch merge kernel: unsupported shape {tuple(x.shape)}")
    dt = x.dtype
    _build.check_cuda(x, "x")
    wk = weight.to(dt).t().contiguous()  # (4C, 2C), input-major
    sc = ln_scale.float().contiguous()
    lb = ln_bias.float().contiguous()
    _build.check_cuda(wk, "weight", (4 * c, 2 * c), dt)
    _build.check_cuda(sc, "ln_scale", (4 * c,))
    _build.check_cuda(lb, "ln_bias", (4 * c,))
    out = torch.empty((b, h // 2, w // 2, 2 * c), dtype=dt, device=x.device)
    _build.launch("patch_merge", "ssa_patch_merge_fwd", [x, sc, lb, wk, out],
                  [b, h, w, c], dt)
    return out


def fused_patch_expand(x: torch.Tensor, weight: torch.Tensor,
                       ln_scale: torch.Tensor, ln_bias: torch.Tensor) -> torch.Tensor:
    """``(B,H,W,C) -> (B,2H,2W,C/2)``; plain on the CPU, kernel on the card."""
    if x.device.type == "cpu":
        return patch_expand_reference(x, weight, ln_scale, ln_bias)
    b, h, w, c = x.shape
    if not expand_supported(x.shape):
        raise ValueError(f"patch expand kernel: unsupported shape {tuple(x.shape)}")
    dt = x.dtype
    _build.check_cuda(x, "x")
    wk = weight.to(dt).t().contiguous()  # (C, 2C), input-major
    sc = ln_scale.float().contiguous()
    lb = ln_bias.float().contiguous()
    _build.check_cuda(wk, "weight", (c, 2 * c), dt)
    _build.check_cuda(sc, "ln_scale", (c // 2,))
    _build.check_cuda(lb, "ln_bias", (c // 2,))
    out = torch.empty((b, 2 * h, 2 * w, c // 2), dtype=dt, device=x.device)
    _build.launch("patch_expand", "ssa_patch_expand_fwd", [x, wk, sc, lb, out],
                  [b, h, w, c], dt)
    return out
