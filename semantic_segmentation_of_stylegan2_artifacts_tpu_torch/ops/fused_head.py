"""tanh-GELU then x4 depth-to-space for the decoder head, one kernel per
direction on the card: ``(B,H,W,16C) -> (B,4H,4W,C)``.

Counterpart of the JAX package's ``ops/fused_head.py`` (``_fwd_kernel`` /
``_bwd_kernel``).  The head runs it where the refine-head kernel does not
take the head (``fused_refine_head.supported``: tanh GELU at C = 128), with
``TPU.FUSED_HEAD`` and tanh GELU on; the convs and the LayerNorm after it
stay composed.  The kernels live in ``csrc/fused_head.cu`` and take C a
multiple of 8 in bfloat16 or of 4 in float32 (one 16-byte vector never
straddles a C-channel block).

Numerics as the JAX kernels: the GELU in float32, rounded to the input
dtype, then the depth-to-space (channel ``(4*p1 + p2)*C + c``, p1-major);
the backward gathers the cotangent back (space-to-depth), multiplies by
GELU'(x) in float32 and rounds.  :func:`fused_gelu_d2s4` is a
``torch.autograd.Function`` that saves only ``x``; its plain versions
serve CPU tensors only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .patch_ops import depth_to_space, space_to_depth

_SQRT_2_OVER_PI = 0.7978845608028654
_KAPPA = 0.044715


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """Derivative of tanh-GELU, float32 (JAX ``_gelu_tanh_grad_f32``)."""
    x2 = x * x
    t = torch.tanh(_SQRT_2_OVER_PI * (x + _KAPPA * x * x2))
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _KAPPA * x2)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def gelu_d2s4_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward."""
    return depth_to_space(F.gelu(x.float(), approximate="tanh").to(x.dtype), 4)


def gelu_d2s4_bwd_reference(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: ``dx`` in x's dtype."""
    return (space_to_depth(dout.float(), 4) * gelu_tanh_grad(x.float())).to(x.dtype)


def kernel_supported(shape, dtype: torch.dtype) -> bool:
    """The shapes the kernels take: 16C channels, C a whole number of
    16-byte vectors."""
    if len(shape) != 4 or shape[-1] % 16:
        return False
    vec = 8 if dtype == torch.bfloat16 else 4
    return (shape[-1] // 16) % vec == 0


def _check(x: torch.Tensor) -> None:
    if not kernel_supported(x.shape, x.dtype):
        raise ValueError(f"GELU+depth-to-space kernel: unsupported shape {tuple(x.shape)} "
                         f"in {x.dtype} (C = channels/16 must be a multiple of 8 in "
                         "bfloat16, of 4 in float32)")
    _build.check_cuda(x, "x")


def gelu_d2s4_fwd(x: torch.Tensor) -> torch.Tensor:
    """Forward wrapper: plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return gelu_d2s4_reference(x)
    _check(x)
    b, h, w, c16 = x.shape
    out = torch.empty((b, 4 * h, 4 * w, c16 // 16), dtype=x.dtype, device=x.device)
    _build.launch("gelu_d2s4", "ssa_gelu_d2s4_fwd", [x, out], [b, h, w, c16 // 16], x.dtype)
    return out


def gelu_d2s4_bwd(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Backward wrapper: plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return gelu_d2s4_bwd_reference(x, dout)
    _check(x)
    b, h, w, c16 = x.shape
    _build.check_cuda(dout, "dout", (b, 4 * h, 4 * w, c16 // 16), x.dtype)
    dx = torch.empty_like(x)
    _build.launch("gelu_d2s4_bwd", "ssa_gelu_d2s4_bwd", [x, dout, dx],
                  [b, h, w, c16 // 16], x.dtype)
    return dx


class _GeluD2S4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_d2s4_fwd(x)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        return gelu_d2s4_bwd(x, dout.contiguous())


def fused_gelu_d2s4(x: torch.Tensor) -> torch.Tensor:
    """tanh-GELU then x4 depth-to-space, ``(B,H,W,16C) -> (B,4H,4W,C)``,
    differentiable in ``x``."""
    return _GeluD2S4.apply(x)
