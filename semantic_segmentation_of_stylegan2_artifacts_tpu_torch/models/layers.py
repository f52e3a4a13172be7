"""MS-UNet building blocks (PyTorch, NHWC).

Counterparts of the JAX package's ``models/layers.py``.  Module and
parameter names follow the reference PyTorch model's keys
(``layers.0.blocks.1.attn.qkv.weight``, ``mlp.0``/``mlp.3``,
``downsample.reduction``, ``upsample.expand``, ``up.refine1``, ...), so a
reference ``best_model.pth`` loads with ``strict=True``.

Compute-dtype policy as in the JAX package: parameters stay float32, and
each module computes in ``dtype`` (bfloat16 on the deployment path) with
its weights cast on use; LayerNorm statistics run in float32.

Training features as in the JAX package, on in ``train()`` mode (which
takes the place of JAX's ``deterministic=False``): per-sample ("row")
stochastic depth on both residuals of a Swin block, MLP dropout,
attention-probability and projection dropout (which put attention on the
composed path, as JAX ``models/layers.py:257-262`` does).  Their noise
comes from the ``torch.Generator`` set with :func:`noise_generator`.

Recomputation (JAX ``_maybe_remat``, ``models/layers.py:634-649``): a stage
built with ``remat`` runs each Swin block in training through
:func:`recomputed`, which keeps the block's input and recomputes its
activations in the backward pass; the noise of the recompute is replayed.

Tensor parallelism and spatial sharding (``parallel/tp.py``,
``parallel/spatial.py``): a module with a ``tp`` attribute computes its
heads or hidden units between the model group's f and g once one is
attached; a module with a ``space`` attribute works on its rank's H-slab
once a space group is attached.  The dropouts then draw whole-size masks
and take their part, so every rank's generator advances as one process's.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

from ..ops import (
    fused_head,
    fused_patch,
    fused_refine_head,
    fused_window_attention,
    patch_ops,
)
from ..ops.window_attention import (
    Parts,
    dropout_keep,
    keep_mask,
    shifted_window_attention,
)
from ..parallel import spatial
from ..utils.profiling import span

LN_EPS = 1e-5
_GENERATOR: list = [None]


@contextlib.contextmanager
def noise_generator(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Draw the dropout and stochastic-depth noise of the forwards run in
    this block from ``generator`` (on the activations' device)."""
    prev, _GENERATOR[0] = _GENERATOR[0], generator
    try:
        yield
    finally:
        _GENERATOR[0] = prev


# JAX ``dots_with_no_batch_dims_saveable``: the products without batch
# dimensions are the qkv, proj and MLP linears, which reach ATen as ``mm`` or
# ``addmm``; the batched ``bmm`` of the composed attention and the kernels'
# launches are recomputed, as in JAX
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def recomputed(fn, x: torch.Tensor, policy: str = "",
               collectives: bool = False) -> torch.Tensor:
    """``fn(x)`` under non-reentrant ``torch.utils.checkpoint``: the backward
    pass recomputes the activations of ``fn`` from ``x``.  ``policy`` ""
    recomputes everything, "dots" keeps the outputs of the non-batched
    products (JAX's ``dots_with_no_batch_dims_saveable``).

    Noise replay: the recompute runs in the backward pass, after the
    forward's :func:`noise_generator` block has closed.  It draws from a
    copy of the generator in force at the forward, set back to the state
    that generator had when ``fn`` started, so its dropout, attention
    dropout and stochastic-depth masks equal the forward's bit for bit,
    while the live generator advances in the forward only, as without
    recomputation.  Without a generator the recompute has none either, and
    a noisy forward raises (:func:`..ops.window_attention.keep_mask`).

    ``collectives``: ``fn`` talks to other ranks (tensor parallelism,
    spatial sharding), so the recompute runs it whole, replaying every
    collective in the same order on every rank, never stopping early."""
    generator = _GENERATOR[0]
    state = None if generator is None else generator.get_state()

    def contexts():
        forward, recompute = (create_selective_checkpoint_contexts(_save_dots)
                              if policy == "dots"
                              else (contextlib.nullcontext(), contextlib.nullcontext()))
        return forward, _replaying(recompute, generator, state)

    # the blocks draw no noise from the default generators: nothing to keep
    with set_checkpoint_early_stop(not collectives):
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                          context_fn=contexts)


@contextlib.contextmanager
def _replaying(recompute, generator: Optional[torch.Generator],
               state: Optional[torch.Tensor]) -> Iterator[None]:
    """The recompute's context: ``recompute`` (the selective-checkpoint
    one, or none) with a copy of ``generator`` at ``state`` drawing the
    noise."""
    replay = None
    if generator is not None:
        replay = torch.Generator(device=generator.device)
        replay.set_state(state)
    with contextlib.ExitStack() as stack:
        stack.enter_context(recompute)
        stack.enter_context(noise_generator(replay))
        yield


def dropout(x: torch.Tensor, rate: float, training: bool, parts: Parts = ()) -> torch.Tensor:
    """flax ``nn.Dropout`` with ``deterministic = not training``; ``parts``
    as :func:`..ops.window_attention.dropout_keep`'s."""
    if not training or rate == 0.0:
        return x
    return dropout_keep(x, rate, _GENERATOR[0], parts)


def gelu(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    """tanh-approximate GELU (``TPU.GELU_TANH``) or the exact erf form."""
    return F.gelu(x, approximate="tanh" if tanh else "none")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with the torch epsilon and float32 fast-variance stats
    (``mean(x^2) - mean^2`` clamped at 0), output in ``dtype``."""
    with span("ssa.norm"):
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


class StochasticDepth(nn.Module):
    """torchvision ``StochasticDepth(p, "row")``: in training, each sample's
    residual branch is kept with probability ``1-p`` and scaled by
    ``1/(1-p)`` in the branch's dtype (JAX ``models/layers.py:120-135``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return x * keep_mask(shape, keep, _GENERATOR[0], x.device).to(x.dtype) / keep


class Mlp(nn.Sequential):
    """Linear -> GELU -> Dropout -> Linear -> Dropout (keys ``mlp.0``/``mlp.3``).
    Under tensor parallelism ``mlp.0`` holds this rank's hidden units
    (column-parallel) and ``mlp.3`` their columns (row-parallel)."""

    def __init__(self, dim: int, hidden: int, gelu_tanh: bool, dtype: torch.dtype,
                 drop: float = 0.0):
        super().__init__(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(drop),
                         nn.Linear(hidden, dim), nn.Dropout(drop))
        self.gelu_tanh = gelu_tanh
        self.drop = float(drop)
        self.dtype = dtype
        self.tp = None
        self.space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = () if self.space is None else self.space.row_part(x)
        if self.tp is None:
            x = gelu(linear(x, self[0], self.dtype), self.gelu_tanh)
            x = dropout(x, self.drop, self.training, rows)
            return dropout(linear(x, self[3], self.dtype), self.drop, self.training, rows)
        hidden = self[0].out_features  # the full width: the shard cut the weight only
        start, _ = self.tp.part(hidden)
        x = gelu(linear(self.tp.copy(x), self[0], self.dtype), self.gelu_tanh)
        x = dropout(x, self.drop, self.training, rows + ((x.ndim - 1, start, hidden),))
        x = self.tp.reduce(F.linear(x, self[3].weight.to(self.dtype)))
        return dropout(x + self[3].bias.to(self.dtype), self.drop, self.training, rows)


class WindowAttention(nn.Module):
    """Windowed MHSA over an NHWC map; owns qkv/proj/bias-table params.

    ``fused``: the window-shaped middle runs in the CUDA kernels
    (``TPU.USE_PALLAS_ATTENTION``) unless a dropout is active in training,
    which the composed op takes (JAX ``models/layers.py:233-262``).  Under
    tensor parallelism qkv holds this rank's heads, proj their columns, and
    the replicated bias table gives their columns; under spatial sharding
    the composed op runs on the rank's slab."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 qkv_bias: bool = True, fused: bool = False,
                 softmax_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32,
                 attention_dropout: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.attention_dropout = float(attention_dropout)
        self.dropout = float(dropout)
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
        self.tp = None
        self.space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        table = self.relative_position_bias_table
        kw = dict(window_size=self.window_size, shift_size=self.shift_size,
                  num_heads=self.num_heads)
        noisy = self.training and (self.attention_dropout > 0.0 or self.dropout > 0.0)
        if self.fused and not noisy:
            return fused_window_attention.fused_shifted_window_attention(
                x, self.qkv.weight, self.qkv.bias, self.proj.weight, self.proj.bias, table,
                **kw)
        if noisy:
            kw.update(attention_dropout=self.attention_dropout, dropout=self.dropout,
                      generator=_GENERATOR[0])
        if self.tp is not None:
            start, count = self.tp.part(self.num_heads)
            x, table = self.tp.copy(x), table[:, start:start + count]
            kw.update(num_heads=count, heads=((2, start, self.num_heads),),
                      reduce=self.tp.reduce)
        args = (x, self.qkv.weight, self.qkv.bias, self.proj.weight, self.proj.bias, table)
        if self.space is not None:
            return spatial.window_attention(self.space, *args,
                                            softmax_dtype=self.softmax_dtype, **kw)
        return shifted_window_attention(*args, softmax_dtype=self.softmax_dtype, **kw)


class SwinBlock(nn.Module):
    """``x = x + sd(attn(norm1(x))); x = x + sd(mlp(norm2(x)))``
    (torchvision contract; ``sd`` is stochastic depth at ``drop_path``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 mlp_ratio: float, qkv_bias: bool, fused_attention: bool,
                 gelu_tanh: bool, softmax_dtype: torch.dtype, dtype: torch.dtype,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, num_heads, window_size,
                                    window_size // 2 if shift else 0, qkv_bias,
                                    fused_attention, softmax_dtype, dtype,
                                    attention_dropout=attn_drop, dropout=drop)
        self.stochastic_depth = StochasticDepth(drop_path)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_tanh, dtype, drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.stochastic_depth(self.attn(self.norm1(x)))
        return x + self.stochastic_depth(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    """Conv k=4 s=4 patchify + LayerNorm; ``(B,H,W,3) -> (B,H/4,W/4,E)``.
    An empty slab (``H == 0``, a space rank with no pixel rows) runs the
    conv on one zero patch row and keeps none of it: every parameter stays
    in the graph and gets a zero gradient, as on the ranks with rows."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 patch_norm: bool, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = LayerNorm(embed_dim, dtype) if patch_norm else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.shape[1]
        if rows == 0:  # a conv takes at least one kernel's rows
            x = x.new_zeros((x.shape[0], self.proj.kernel_size[0]) + tuple(x.shape[2:]))
        x = conv_nhwc(x, self.proj, self.dtype)
        if rows == 0:
            x = x[:, :0]
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
        self.space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is not None:
            x = spatial.merge_rows(self.space, x)
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
        self.space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is not None:
            x, start, count = spatial.expand_rows(self.space, x)
            return self._expand(x)[:, start:start + count]
        return self._expand(x)

    def _expand(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return fused_patch.fused_patch_expand(
                x.to(self.dtype).contiguous(), self.expand.weight, self.norm.weight,
                self.norm.bias)
        x = patch_ops.depth_to_space(linear(x, self.expand, self.dtype), 2)
        return self.norm(x)


class FinalPatchExpandX4V2(nn.Module):
    """Linear(C, 16C) -> GELU -> x4 depth-to-space -> two 3x3 convs -> LN
    (reference ``model_parts.py:437-476``).  With ``fused``
    (``TPU.FUSED_HEAD``) the head takes the first of three routes whose
    gate holds, as JAX ``models/layers.py:591-610`` does:

    1. the refine-head kernel for everything after the expand projection,
       where ``fused_refine_head.supported`` holds (tanh GELU, C = 128);
    2. with tanh GELU (any other C), the GELU+depth-to-space kernel
       (``ops/fused_head.py``), then the composed convs and LayerNorm;
    3. otherwise (erf GELU, the strict-parity mode) the composed head.

    Without ``fused`` the head is composed.  Parameter names are the same
    on every route."""

    def __init__(self, dim: int, gelu_tanh: bool, fused: bool, dtype: torch.dtype):
        super().__init__()
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.refine1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.refine2 = nn.Conv2d(dim, dim, 3, padding=1)
        self.norm = LayerNorm(dim, dtype)
        self.gelu_tanh = gelu_tanh
        self.fused_refine = fused and fused_refine_head.supported(dim, gelu_tanh)
        self.fused_gelu_d2s = fused and gelu_tanh and not self.fused_refine
        self.dtype = dtype
        self.space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is not None:
            pixels = self.space.slabs(x.shape[2]).scaled(4)
            x = patch_ops.depth_to_space(gelu(linear(x, self.expand, self.dtype),
                                              self.gelu_tanh), 4)
            x = gelu(spatial.halo_conv(self.space, x, pixels, self.refine1, self.dtype),
                     self.gelu_tanh)
            return self.norm(spatial.halo_conv(self.space, x, pixels, self.refine2,
                                               self.dtype))
        x = linear(x, self.expand, self.dtype)
        if self.fused_refine:
            return fused_refine_head.fused_refine_head(
                x.contiguous(), self.refine1.weight, self.refine1.bias,
                self.refine2.weight, self.refine2.bias, self.norm.weight, self.norm.bias)
        if self.fused_gelu_d2s:
            x = fused_head.fused_gelu_d2s4(x.contiguous())
        else:
            x = patch_ops.depth_to_space(gelu(x, self.gelu_tanh), 4)
        x = gelu(conv_nhwc(x, self.refine1, self.dtype), self.gelu_tanh)
        return self.norm(conv_nhwc(x, self.refine2, self.dtype))


class _Stage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, fused_attention: bool,
                 gelu_tanh: bool, softmax_dtype: torch.dtype, dtype: torch.dtype,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: Sequence[float] = (), remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        self.remat = remat
        self.remat_policy = remat_policy
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, i % 2 == 1, mlp_ratio, qkv_bias,
                      fused_attention, gelu_tanh, softmax_dtype, dtype, drop, attn_drop,
                      drop_path[i] if len(drop_path) else 0.0)
            for i in range(depth))

    def run_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks in turn; each through :func:`recomputed` where the
        stage recomputes and a backward pass may follow (training, grad
        on), else called directly (eval and ``no_grad`` launch the same)."""
        recompute = self.remat and self.training and torch.is_grad_enabled()
        for blk in self.blocks:
            if recompute:
                talks = blk.attn.tp is not None or blk.attn.space is not None
                x = recomputed(blk, x, self.remat_policy, collectives=talks)
            else:
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
