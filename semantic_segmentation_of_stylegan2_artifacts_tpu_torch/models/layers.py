"""MS-UNet building blocks (PyTorch, NHWC).

Counterparts of the JAX package's ``models/layers.py``.  Module and
parameter names follow the reference PyTorch model's keys
(``layers.0.blocks.1.attn.qkv.weight``, ``mlp.0``/``mlp.3``,
``downsample.reduction``, ``upsample.expand``, ``up.refine1``, ...), so a
reference ``best_model.pth`` loads with ``strict=True``.

Compute-dtype policy as in the JAX package: parameters stay float32, and
each module computes in ``dtype`` (bfloat16 on the deployment path) with
its weights cast on use; LayerNorm statistics run in float32.  The
modules implement the deterministic (inference) forward: dropout and
stochastic depth are training features and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_patch, fused_refine_head, fused_window_attention, patch_ops
from ..ops.window_attention import shifted_window_attention

LN_EPS = 1e-5


def gelu(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    """tanh-approximate GELU (``TPU.GELU_TANH``) or the exact erf form."""
    return F.gelu(x, approximate="tanh" if tanh else "none")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with the torch epsilon and float32 fast-variance stats
    (``mean(x^2) - mean^2`` clamped at 0), output in ``dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS) * weight + bias
    return y.to(dtype)


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype), bias,
                 stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.dtype)


class Mlp(nn.Sequential):
    """Linear -> GELU -> Dropout -> Linear -> Dropout (keys ``mlp.0``/``mlp.3``)."""

    def __init__(self, dim: int, hidden: int, gelu_tanh: bool, dtype: torch.dtype):
        super().__init__(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                         nn.Linear(hidden, dim), nn.Dropout(0.0))
        self.gelu_tanh = gelu_tanh
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(linear(x, self[0], self.dtype), self.gelu_tanh)
        return linear(x, self[3], self.dtype)


class WindowAttention(nn.Module):
    """Windowed MHSA over an NHWC map; owns qkv/proj/bias-table params.

    ``fused``: the window-shaped middle runs in the CUDA kernel
    (``TPU.USE_PALLAS_ATTENTION``); otherwise the composed op."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 qkv_bias: bool = True, fused: bool = False,
                 softmax_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = (window_size, window_size)
        self.shift_size = (shift_size, shift_size)
        self.fused = fused
        self.softmax_dtype = softmax_dtype
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = (x.to(self.dtype), self.qkv.weight, self.qkv.bias, self.proj.weight,
                self.proj.bias, self.relative_position_bias_table)
        kw = dict(window_size=self.window_size, shift_size=self.shift_size,
                  num_heads=self.num_heads)
        if self.fused:
            return fused_window_attention.fused_shifted_window_attention(*args, **kw)
        return shifted_window_attention(*args, softmax_dtype=self.softmax_dtype, **kw)


class SwinBlock(nn.Module):
    """``x = x + attn(norm1(x)); x = x + mlp(norm2(x))`` (torchvision contract)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 mlp_ratio: float, qkv_bias: bool, fused_attention: bool,
                 gelu_tanh: bool, softmax_dtype: torch.dtype, dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, num_heads, window_size,
                                    window_size // 2 if shift else 0, qkv_bias,
                                    fused_attention, softmax_dtype, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_tanh, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Conv k=4 s=4 patchify + LayerNorm; ``(B,H,W,3) -> (B,H/4,W/4,E)``."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 patch_norm: bool, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = LayerNorm(embed_dim, dtype) if patch_norm else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_nhwc(x, self.proj, self.dtype)
        return self.norm(x) if self.norm is not None else x


class PatchMerging(nn.Module):
    """2x2 concat -> LN(4C) -> Linear(4C, 2C, no bias); ``fused`` runs the
    CUDA kernel (``TPU.FUSED_PATCH``)."""

    def __init__(self, dim: int, fused: bool, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.fused = fused
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return fused_patch.fused_patch_merge(
                x.to(self.dtype).contiguous(), self.norm.weight, self.norm.bias,
                self.reduction.weight)
        return linear(self.norm(patch_ops.merge_2x2(x)), self.reduction, self.dtype)


class PatchExpand(nn.Module):
    """Linear(C, 2C, no bias) -> 2x2 depth-to-space -> LN(C/2); ``fused``
    runs the CUDA kernel (``TPU.FUSED_PATCH``)."""

    def __init__(self, dim: int, fused: bool, dtype: torch.dtype):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2, dtype)
        self.fused = fused
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return fused_patch.fused_patch_expand(
                x.to(self.dtype).contiguous(), self.expand.weight, self.norm.weight,
                self.norm.bias)
        x = patch_ops.depth_to_space(linear(x, self.expand, self.dtype), 2)
        return self.norm(x)


class FinalPatchExpandX4V2(nn.Module):
    """Linear(C, 16C) -> GELU -> x4 depth-to-space -> two 3x3 convs -> LN
    (reference ``model_parts.py:437-476``).  ``fused`` (``TPU.FUSED_HEAD``)
    runs everything after the expand projection in the CUDA kernel.  The
    JAX package falls back to its GELU+depth-to-space kernel where the
    refine-head gate fails (erf GELU, or C != 128); that kernel is not
    ported yet, so the port raises there instead."""

    def __init__(self, dim: int, gelu_tanh: bool, fused: bool, dtype: torch.dtype):
        super().__init__()
        if fused and not fused_refine_head.supported(dim, gelu_tanh):
            raise NotImplementedError(
                f"FUSED_HEAD with dim {dim}, GELU_TANH {gelu_tanh}: the JAX package "
                "runs its fused_head kernel here, which is not ported yet")
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.refine1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.refine2 = nn.Conv2d(dim, dim, 3, padding=1)
        self.norm = LayerNorm(dim, dtype)
        self.gelu_tanh = gelu_tanh
        self.fused = fused
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.expand, self.dtype)
        if self.fused:
            return fused_refine_head.fused_refine_head(
                x.contiguous(), self.refine1.weight, self.refine1.bias,
                self.refine2.weight, self.refine2.bias, self.norm.weight, self.norm.bias)
        x = patch_ops.depth_to_space(gelu(x, self.gelu_tanh), 4)
        x = gelu(conv_nhwc(x, self.refine1, self.dtype), self.gelu_tanh)
        return self.norm(conv_nhwc(x, self.refine2, self.dtype))


class _Stage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, fused_attention: bool,
                 gelu_tanh: bool, softmax_dtype: torch.dtype, dtype: torch.dtype):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, i % 2 == 1, mlp_ratio, qkv_bias,
                      fused_attention, gelu_tanh, softmax_dtype, dtype)
            for i in range(depth))

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class BasicLayer(_Stage):
    """Encoder stage: ``depth`` Swin blocks (shift 0 / w//2 alternating) +
    optional PatchMerging (reference ``model_parts.py:109-173``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, *, downsample: bool,
                 fused_patch: bool = False, **kw):
        super().__init__(dim, depth, num_heads, **kw)
        self.downsample: Optional[PatchMerging] = (
            PatchMerging(dim, fused_patch, kw["dtype"]) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.run_blocks(x)
        return self.downsample(x) if self.downsample is not None else x


class BasicLayerUp(_Stage):
    """Decoder stage: ``depth`` Swin blocks + optional PatchExpand
    (reference ``model_parts.py:478-541``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, *, upsample: bool,
                 fused_patch: bool = False, **kw):
        super().__init__(dim, depth, num_heads, **kw)
        self.upsample: Optional[PatchExpand] = (
            PatchExpand(dim, fused_patch, kw["dtype"]) if upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.run_blocks(x)
        return self.upsample(x) if self.upsample is not None else x
