"""MS-UNet: Swin U-Net with two multi-scale auxiliary ("cent") decoders.

Counterpart of the JAX package's ``models/msunet.py`` (reference
``network/model_parts.py:543-893``, ``network/MSUNet.py``):

* 4-stage Swin encoder (depths [2,2,18,2] at Swin-B width),
* two auxiliary decoders that run during the encoder pass and rewrite
  skips 0 and 1 (``model_parts.py:775-815``),
* a main decoder whose stage depths reuse the *encoder* depth list (the
  reference's ``DECODER_DEPTHS`` is never wired; kept for checkpoint
  compatibility),
* shared ``concat_back_dim`` skip-reduction Linears,
* the ``FinalPatchExpand_X4_V2`` head and a bias-free 1x1 output conv.

NHWC end to end; returns logits ``(B, H, W, classes)``.  Stochastic depth
decays linearly 0 -> ``DROP_PATH_RATE`` over the encoder blocks; decoder
and cent stages reuse the rates of their mirrored encoder stage, as in
the reference.  ``train()`` mode turns on dropout and stochastic depth.

What differs from the JAX package on purpose:

* ``from_config`` carries no per-stage attention caps
  (``_pallas_stages``): those are TPU compile limits; the card's kernel
  runs on every stage.
* ``TPU.HOLD_WINDOW_LAYOUT`` and ``TPU.ATTN_WINDOW_GROUP`` are XLA layout
  choices that leave the numbers unchanged; they are read and ignored.
* ``TPU.MODEL_AXIS`` / ``TPU.SPATIAL_AXIS`` route every kernel off, as in
  JAX (:func:`attention_plan` names the reason); the groups come from the
  library (``parallel/mesh.py::make_mesh``, ``parallel/tp.py``,
  ``parallel/spatial.py``), as JAX's mesh does.  A ``TPU.MESH_SHAPE`` with
  a model or space axis raises, as the JAX trainer builds a data mesh only;
  ``HARDWARE.N_GPU`` data parallelism is the trainer's.

Recomputation (``TPU.REMAT``, ``TRAIN.USE_CHECKPOINT``) resolves as in the
JAX package (:func:`resolve_remat`): ``full`` and ``dots`` (and
``USE_CHECKPOINT``) recompute the Swin blocks of every stage, ``high_res``
those of the stages of width <= 256, and ``auto`` is ``high_res`` at
1024^2 and above unless the attention kernel trains, else ``none``.  The
patch merges and expands around the blocks are never recomputed.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.device import compute_dtype, resolve_device
from ..ops import fused_window_attention
from ..parallel import spatial
from ..parallel.mesh import world_size_for
from ..utils.profiling import span
from .layers import (
    BasicLayer,
    BasicLayerUp,
    FinalPatchExpandX4V2,
    LayerNorm,
    PatchEmbed,
    PatchExpand,
    dropout,
    linear,
)


def _dpr(drop_path_rate: float, depths: Sequence[int]) -> List[float]:
    """Linear stochastic-depth decay over all encoder blocks."""
    return [float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths))]


def resolve_remat(config, img_size: Optional[int] = None) -> Tuple[bool, bool, str]:
    """``(use_remat, remat_high_res, remat_policy)`` from ``TPU.REMAT`` and
    ``TRAIN.USE_CHECKPOINT`` (JAX ``models/msunet.py:501-524``).  The
    attention kernel trains only without dropout (training dropout takes the
    composed path), and ``auto`` keys on that: at 1024^2 and above it keeps
    every activation when the kernel trains, else recomputes the high-
    resolution stages.  A mode JAX does not know recomputes nothing, as there
    (unless ``USE_CHECKPOINT``)."""
    mode = str(config.TPU.REMAT)
    size = img_size or config.DATA.IMG_SIZE
    kernel_in_train = (bool(config.TPU.USE_PALLAS_ATTENTION)
                       and float(config.MODEL.ATTN_DROP_RATE) == 0.0
                       and float(config.MODEL.DROP_RATE) == 0.0)
    if mode == "auto":
        mode = "none" if size < 1024 or kernel_in_train else "high_res"
    return (bool(config.TRAIN.USE_CHECKPOINT) or mode in ("full", "dots"),
            mode == "high_res", "dots" if mode == "dots" else "")


def _stage_slice(dpr: List[float], depths: Sequence[int], stage: int) -> List[float]:
    lo = sum(depths[:stage])
    return dpr[lo:lo + depths[stage]]


class MSUNetSys(nn.Module):
    """The MS-UNet graph; parameter names are the reference's keys."""

    def __init__(self, img_size: int = 1024, patch_size: int = 4, in_chans: int = 3,
                 num_classes: int = 1, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, patch_norm: bool = True,
                 fused_attention: bool = False, fused_patch: bool = False,
                 fused_head: bool = False, gelu_tanh: bool = False,
                 softmax_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 use_remat: bool = False, remat_high_res: bool = False,
                 remat_policy: str = "", model_axis: str = "", spatial_axis: str = ""):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        # the knobs as asked, for attention_plan; a model or space axis routes
        # every kernel off (JAX MSUNetSys._stage_pallas, setup): the kernels
        # take whole weights and whole maps
        self.requested = dict(attention=fused_attention, patch=fused_patch, head=fused_head)
        self.model_axis = model_axis
        self.spatial_axis = spatial_axis
        if model_axis or spatial_axis:
            fused_attention = fused_patch = fused_head = False
        self.space = None
        self.use_remat = use_remat
        self.remat_high_res = remat_high_res
        self.depths = tuple(depths)
        nl = len(depths)
        dims = [embed_dim * 2 ** i for i in range(nl)]
        dpr = _dpr(drop_path_rate, depths)
        common = dict(window_size=window_size, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                      fused_attention=fused_attention, fused_patch=fused_patch,
                      gelu_tanh=gelu_tanh, softmax_dtype=softmax_dtype, dtype=dtype,
                      drop=drop_rate, attn_drop=attn_drop_rate,
                      remat_policy=remat_policy)
        self.dtype = dtype
        self.drop_rate = float(drop_rate)

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim, patch_norm, dtype)
        self.layers = nn.ModuleList(
            BasicLayer(dims[i], depths[i], num_heads[i], downsample=i < nl - 1,
                       drop_path=_stage_slice(dpr, depths, i),
                       remat=self.stage_remat(dims[i]), **common)
            for i in range(nl))
        # concat_back_dim[i]: Linear(2*dims[nl-1-i] -> dims[nl-1-i]); [0] unused
        self.concat_back_dim = nn.ModuleList(
            [nn.Identity()] + [nn.Linear(2 * dims[nl - 1 - i], dims[nl - 1 - i])
                               for i in range(1, nl)])

        def decoder(first: int, n_stages: int) -> nn.ModuleList:
            stages: List[nn.Module] = [PatchExpand(dims[first], fused_patch, dtype)]
            for i in range(1, n_stages):
                s = first - i  # mirrored encoder stage (encoder depths reused)
                stages.append(BasicLayerUp(dims[s], depths[s], num_heads[s],
                                           upsample=i < n_stages - 1,
                                           drop_path=_stage_slice(dpr, depths, s),
                                           remat=self.stage_remat(dims[s]), **common))
            return nn.ModuleList(stages)

        self.layers_up = decoder(nl - 1, nl)
        self.layers_cent1 = decoder(nl - 2, nl - 1)  # fires at encoder stage 2
        self.layers_cent2 = decoder(nl - 3, nl - 2)  # fires at encoder stage 1

        self.norm = LayerNorm(dims[-1], dtype)
        self.norm_up = LayerNorm(embed_dim, dtype)
        self.up = FinalPatchExpandX4V2(embed_dim, gelu_tanh, fused_head, dtype)
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    def stage_remat(self, dim: int) -> bool:
        """Whether the stage of width ``dim`` recomputes its blocks (JAX
        ``MSUNetSys._stage_remat``)."""
        return self.use_remat or (self.remat_high_res and dim <= 256)

    def _reduce(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.concat_back_dim[i], self.dtype)

    # each section runs inside a ``ssa.model.<section>`` span
    # (``utils/profiling.py::span``); a stage's skip reduction and the
    # closing norms belong to the stage's section
    def forward_features(self, x: torch.Tensor):
        with span("ssa.model.embed"):
            x = self.patch_embed(x)
            rows = () if self.space is None else self.space.row_part(x)
            x = dropout(x, self.drop_rate, self.training, rows)  # pos_drop
        skips: List[torch.Tensor] = []
        last = len(self.layers) - 1
        for i_layer, layer in enumerate(self.layers):
            if i_layer == 1:  # cent decoder 2 rewrites skip 0 (reference :785-795)
                x2 = x
                for i, stage in enumerate(self.layers_cent2):
                    with span(f"ssa.model.cent2.{i}"):
                        if i:
                            x2 = self._reduce(i + 2, torch.cat([x2, skips[i_layer - i]], -1))
                            skips[i_layer - i] = x2
                        x2 = stage(x2)
            if i_layer == 2:  # cent decoder 1 rewrites skips 1 and 0 (:797-807)
                x1 = x
                for i, stage in enumerate(self.layers_cent1):
                    with span(f"ssa.model.cent1.{i}"):
                        if i:
                            x1 = self._reduce(i + 1, torch.cat([x1, skips[i_layer - i]], -1))
                            skips[i_layer - i] = x1
                        x1 = stage(x1)
            skips.append(x)
            with span(f"ssa.model.encoder.{i_layer}"):
                x = layer(x)
                if i_layer == last:
                    x = self.norm(x)
        return x, skips

    def forward_up_features(self, x: torch.Tensor, skips) -> torch.Tensor:
        nl = len(self.depths)
        for inx, layer_up in enumerate(self.layers_up):
            with span(f"ssa.model.decoder.{inx}"):
                if inx:
                    x = self._reduce(inx, torch.cat([x, skips[nl - 1 - inx]], -1))
                x = layer_up(x)
                if inx == nl - 1:
                    x = self.norm_up(x)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        with span("ssa.model.head"):
            x = self.up(x)
            return torch.nn.functional.linear(
                x.to(self.dtype), self.output.weight[:, :, 0, 0].to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3) -> (B, H, W, num_classes)`` logits."""
        _, h, w, _ = x.shape
        if h != self.img_size or w != self.img_size:
            raise ValueError(f"Input image size ({h}*{w}) doesn't match model "
                             f"({self.img_size}*{self.img_size}).")
        if self.spatial_axis:
            return self._forward_slab(x)
        x, skips = self.forward_features(x)
        return self._head(self.forward_up_features(x, skips))

    def _forward_slab(self, x: torch.Tensor) -> torch.Tensor:
        """Spatial sharding: this rank's pixel rows through the network on
        its slabs, then the logits gathered in H on every rank."""
        if self.space is None:
            raise RuntimeError(f"spatial_axis {self.spatial_axis!r} is set but no space "
                               "group is attached (parallel/spatial.py::attach_space)")
        pixels = self.space.slabs(self.img_size // self.patch_size).scaled(self.patch_size)
        lo, hi = pixels.bounds[self.space.rank]
        x, skips = self.forward_features(x[:, lo:hi])
        x = self._head(self.forward_up_features(x, skips))
        return spatial.gather_rows(x, self.space, pixels)


def attention_plan(model: nn.Module) -> List[str]:
    """Which path each encoder stage's attention, the patch merges and
    expands, and the head take, with JAX ``attention_plan``'s reasons
    (``models/msunet.py:83-150``): under a model or space axis every kernel
    is routed off.  On the kernel path, the card's kernel family
    (``ops/fused_window_attention.py::kernel_route``) and the window's
    tokens.  A pure function of the model's configuration."""
    sys = getattr(model, "ms_unet", model)
    reason = ("spatial sharding" if sys.spatial_axis
              else "tensor parallel" if sys.model_axis else "")
    n = sys.window_size ** 2
    lines = []
    for i in range(len(sys.depths)):
        grid = sys.img_size // sys.patch_size // 2 ** i
        path = ("composed (disabled)" if not sys.requested["attention"]
                else f"composed ({reason})" if reason
                else _kernel_path(sys.dtype, sys.embed_dim * 2 ** i // sys.num_heads[i], n))
        lines.append(f"attention stage {i}: grid {grid}x{grid} c{sys.embed_dim * 2 ** i} "
                     f"-> {path}")
    for part, label in (("patch", "patch merge/expand"), ("head", "head")):
        if sys.requested[part]:
            lines.append(f"{label}: {'composed (sharded)' if reason else 'kernel'}")
    return lines


def _kernel_path(dtype: torch.dtype, hd: int, n: int) -> str:
    try:
        route = fused_window_attention.kernel_route(dtype, hd, n)
    except ValueError:
        return f"kernel (no kernel takes head width {hd} at {n} tokens: raises on the card)"
    return f"kernel ({fused_window_attention.ROUTE_NAMES[route]}, {n} tokens a window)"


_TRUNC_STD = 0.02 / 0.87962566103423978  # unit std after truncation at +-2


def _trunc_normal(shape, g: torch.Generator) -> torch.Tensor:
    """Normal truncated at +-2 std, by the inverse CDF of a uniform draw."""
    lo, hi = 0.5 * (1 + math.erf(-math.sqrt(2))), 0.5 * (1 + math.erf(math.sqrt(2)))
    u = torch.rand(shape, generator=g, dtype=torch.float64)
    return (torch.special.ndtri(lo + u * (hi - lo)) * _TRUNC_STD).float()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded init of the JAX package's initializers: truncated normal
    (std 0.02) for Linear weights and the bias tables, the torch conv
    init (uniform +-1/sqrt(fan_in)) for conv weights, zero biases,
    LayerNorm ones/zeros.  Draws on the CPU so every device gets the same
    weights from one seed."""
    g = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "relative_position_bias_table" or (p.ndim == 2 and leaf == "weight"):
            p.copy_(_trunc_normal(p.shape, g))
        elif p.ndim == 4:
            bound = 1.0 / math.sqrt(p.shape[1] * p.shape[2] * p.shape[3])
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)
        elif leaf == "bias":
            p.zero_()
        else:
            p.fill_(1.0)


class MSUNet(nn.Module):
    """Wrapper that repeats grey input to RGB and validates 3 channels
    (reference ``MSUNet.py:16-58``).  Its state-dict keys carry the
    reference trainer's ``ms_unet.`` prefix."""

    def __init__(self, **kw):
        super().__init__()
        self.ms_unet = MSUNetSys(**kw)
        self.dtype = self.ms_unet.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.repeat_interleave(3, dim=-1)
        if x.shape[-1] != 3:
            raise ValueError(f"Expected 3-channel NHWC input, got {tuple(x.shape)}")
        return self.ms_unet(x)

    @classmethod
    def from_config(cls, config, img_size: Optional[int] = None,
                    num_classes: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                    device=None) -> "MSUNet":
        """Build from a config (reference schema, the drop rates of
        ``MODEL`` included) with weights seeded from ``SEED``, in eval
        mode, on ``device`` (the card unless the caller
        passes another; raises with no GPU).  The positional order is the
        JAX package's ``MSUNet.from_config``; ``num_classes`` overrides
        ``MODEL.NUM_CLASSES``."""
        dev = resolve_device(device)
        tpu = config.TPU
        world_size_for(config)  # a MESH_SHAPE model or space axis raises
        swin = config.MODEL.SWIN
        use_remat, remat_high_res, remat_policy = resolve_remat(config, img_size)
        model = cls(
            img_size=img_size or config.DATA.IMG_SIZE,
            patch_size=swin.PATCH_SIZE,
            in_chans=swin.IN_CHANS,
            num_classes=num_classes or config.MODEL.NUM_CLASSES,
            embed_dim=swin.EMBED_DIM,
            depths=tuple(swin.DEPTHS),
            num_heads=tuple(swin.NUM_HEADS),
            window_size=swin.WINDOW_SIZE,
            mlp_ratio=float(swin.MLP_RATIO),
            qkv_bias=bool(swin.QKV_BIAS),
            patch_norm=bool(swin.PATCH_NORM),
            fused_attention=bool(tpu.USE_PALLAS_ATTENTION),
            fused_patch=bool(getattr(tpu, "FUSED_PATCH", False)),
            fused_head=bool(getattr(tpu, "FUSED_HEAD", False)),
            gelu_tanh=bool(getattr(tpu, "GELU_TANH", False)),
            softmax_dtype=compute_dtype(tpu.SOFTMAX_DTYPE),
            dtype=dtype or compute_dtype(tpu.COMPUTE_DTYPE),
            drop_rate=float(config.MODEL.DROP_RATE),
            attn_drop_rate=float(config.MODEL.ATTN_DROP_RATE),
            drop_path_rate=float(config.MODEL.DROP_PATH_RATE),
            use_remat=use_remat,
            remat_high_res=remat_high_res,
            remat_policy=remat_policy,
            model_axis=str(getattr(tpu, "MODEL_AXIS", "")),
            spatial_axis=str(getattr(tpu, "SPATIAL_AXIS", "")),
        )
        init_weights(model, int(config.SEED))
        return model.to(dev).eval()
