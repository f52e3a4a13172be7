"""Plain float32 MS-UNet: the forward pass the benchmark holds the port to.

Written from the architecture (reference ``network/model_parts.py:543-893``
and torchvision's ``shifted_window_attention``), not from the port: plain
``torch`` operations on a dict of parameters named as the reference
PyTorch model names them (``ms_unet.layers.0.blocks.1.attn.qkv.weight``).

* 4-stage Swin encoder; every block ``x + sd(attn(ln1(x)))`` then
  ``x + sd(mlp(ln2(x)))``; window attention zero-pads the normed map to
  window multiples (padded tokens take part), drops the shift where one
  window spans the padded grid, rolls by ``-shift``, scales q by
  ``hd**-0.5``, adds the relative-position bias and, when shifted, the
  0 / -100 nine-region mask.
* Two auxiliary ("cent") decoders run inside the encoder pass and rewrite
  skips 0 and 1; the last stage of each runs and its output is dropped.
* The main decoder reuses the encoder's depths and heads, mirrored; the
  head is Linear(C, 16C) -> GELU -> x4 depth-to-space -> conv3x3 -> GELU
  -> conv3x3 -> LayerNorm -> 1x1 conv without bias.

Noise (training): dropout and stochastic-depth masks are ``torch.rand(shape)
< keep`` drawn from one generator in forward order, each at the shape of the
whole batch, and this call's rows taken from it.  So a batch run in blocks of
rows draws, block after block, what one pass over the whole batch draws,
provided the generator is set back to the same state before each block.

``Numerics.fp8`` rounds the inputs of every product (linears, the two
attention products, the convs) to float8 e4m3 with a per-tensor scale, and
their gradients to e5m2: the benchmark's lower-precision control.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5


@dataclass(frozen=True)
class Arch:
    """The model's sizes and training noise (``config.yaml``'s ``MODEL``)."""

    img_size: int
    patch_size: int = 4
    in_chans: int = 3
    num_classes: int = 1
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    gelu_tanh: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        """From a configuration file's ``config`` (``config.yaml``'s schema)."""
        m, swin = cfg["MODEL"], cfg["MODEL"]["SWIN"]
        return cls(img_size=int(cfg["DATA"]["IMG_SIZE"]), patch_size=int(swin["PATCH_SIZE"]),
                   in_chans=int(swin["IN_CHANS"]), num_classes=int(m["NUM_CLASSES"]),
                   embed_dim=int(swin["EMBED_DIM"]), depths=tuple(swin["DEPTHS"]),
                   num_heads=tuple(swin["NUM_HEADS"]), window_size=int(swin["WINDOW_SIZE"]),
                   mlp_ratio=float(swin["MLP_RATIO"]), qkv_bias=bool(swin["QKV_BIAS"]),
                   gelu_tanh=bool(cfg["TPU"]["GELU_TANH"]),
                   drop_rate=float(m["DROP_RATE"]), attn_drop_rate=float(m["ATTN_DROP_RATE"]),
                   drop_path_rate=float(m["DROP_PATH_RATE"]))

    @property
    def dims(self) -> List[int]:
        return [self.embed_dim * 2 ** i for i in range(len(self.depths))]

    def drop_paths(self, stage: int) -> List[float]:
        """Stochastic-depth rates of an encoder stage's blocks: a linear ramp
        0 -> ``drop_path_rate`` over every encoder block; decoder stages
        take their mirrored encoder stage's."""
        ramp = np.linspace(0.0, self.drop_path_rate, sum(self.depths))
        lo = sum(self.depths[:stage])
        return [float(r) for r in ramp[lo:lo + self.depths[stage]]]


# -- parameters -------------------------------------------------------------

def _block_shapes(pfx: str, c: int, heads: int, window: int, hidden: int,
                  qkv_bias: bool) -> List[Tuple[str, tuple]]:
    out = [(pfx + "norm1.weight", (c,)), (pfx + "norm1.bias", (c,)),
           (pfx + "attn.relative_position_bias_table", ((2 * window - 1) ** 2, heads)),
           (pfx + "attn.qkv.weight", (3 * c, c))]
    if qkv_bias:
        out.append((pfx + "attn.qkv.bias", (3 * c,)))
    return out + [(pfx + "attn.proj.weight", (c, c)), (pfx + "attn.proj.bias", (c,)),
                  (pfx + "norm2.weight", (c,)), (pfx + "norm2.bias", (c,)),
                  (pfx + "mlp.0.weight", (hidden, c)), (pfx + "mlp.0.bias", (hidden,)),
                  (pfx + "mlp.3.weight", (c, hidden)), (pfx + "mlp.3.bias", (c,))]


def _expand_shapes(pfx: str, c: int) -> List[Tuple[str, tuple]]:
    return [(pfx + "expand.weight", (2 * c, c)), (pfx + "norm.weight", (c // 2,)),
            (pfx + "norm.bias", (c // 2,))]


def _decoder_stages(a: Arch, first: int, n_stages: int) -> List[Tuple[int, bool]]:
    """``(mirrored encoder stage, upsample)`` of stages 1.. of a decoder whose
    stage 0 is a PatchExpand of encoder stage ``first``'s width."""
    return [(first - i, i < n_stages - 1) for i in range(1, n_stages)]


def param_shapes(a: Arch) -> List[Tuple[str, tuple]]:
    """Every parameter's name and shape, in the reference model's naming."""
    p = "ms_unet."
    dims, nl, e = a.dims, len(a.depths), a.embed_dim
    out = [(p + "patch_embed.proj.weight", (e, a.in_chans, a.patch_size, a.patch_size)),
           (p + "patch_embed.proj.bias", (e,)),
           (p + "patch_embed.norm.weight", (e,)), (p + "patch_embed.norm.bias", (e,))]

    def stage(pfx, s):
        c = dims[s]
        return [x for j in range(a.depths[s])
                for x in _block_shapes(f"{pfx}blocks.{j}.", c, a.num_heads[s], a.window_size,
                                       int(c * a.mlp_ratio), a.qkv_bias)]

    for i in range(nl):
        out += stage(f"{p}layers.{i}.", i)
        if i < nl - 1:
            c = dims[i]
            out += [(f"{p}layers.{i}.downsample.norm.weight", (4 * c,)),
                    (f"{p}layers.{i}.downsample.norm.bias", (4 * c,)),
                    (f"{p}layers.{i}.downsample.reduction.weight", (2 * c, 4 * c))]
    for i in range(1, nl):
        c = dims[nl - 1 - i]
        out += [(f"{p}concat_back_dim.{i}.weight", (c, 2 * c)),
                (f"{p}concat_back_dim.{i}.bias", (c,))]
    for name, first, n in (("layers_up", nl - 1, nl), ("layers_cent1", nl - 2, nl - 1),
                           ("layers_cent2", nl - 3, nl - 2)):
        out += _expand_shapes(f"{p}{name}.0.", dims[first])
        for i, (s, up) in enumerate(_decoder_stages(a, first, n), start=1):
            out += stage(f"{p}{name}.{i}.", s)
            if up:
                out += _expand_shapes(f"{p}{name}.{i}.upsample.", dims[s])
    out += [(p + "norm.weight", (dims[-1],)), (p + "norm.bias", (dims[-1],)),
            (p + "norm_up.weight", (e,)), (p + "norm_up.bias", (e,)),
            (p + "up.expand.weight", (16 * e, e)),
            (p + "up.refine1.weight", (e, e, 3, 3)), (p + "up.refine1.bias", (e,)),
            (p + "up.refine2.weight", (e, e, 3, 3)), (p + "up.refine2.bias", (e,)),
            (p + "up.norm.weight", (e,)), (p + "up.norm.bias", (e,)),
            (p + "output.weight", (a.num_classes, e, 1, 1))]
    return out


# -- numerics ---------------------------------------------------------------

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


@dataclass
class Numerics:
    """float32 everywhere (``fp8=False``), or the control: products' inputs
    rounded to float8."""

    fp8: bool = False

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8Round.apply(x) if self.fp8 else x


# -- noise ------------------------------------------------------------------

@dataclass
class Noise:
    """Training noise drawn from ``generator`` at the whole batch's size
    (``batch`` rows), of which ``rows`` are this call's.  ``generator`` None:
    eval mode, no noise."""

    generator: Optional[torch.Generator]
    batch: int
    rows: slice = field(default_factory=lambda: slice(None))

    def keep(self, shape: Sequence[int], rate: float, device) -> torch.Tensor:
        full = (self.batch,) + tuple(shape[1:])
        mask = torch.rand(full, generator=self.generator, device=device) < 1.0 - rate
        return mask[self.rows]

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.generator is None or rate == 0.0:
            return x
        return torch.where(self.keep(x.shape, rate, x.device), x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def drop_path(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.generator is None or rate == 0.0:
            return x
        mask = self.keep((x.shape[0],) + (1,) * (x.ndim - 1), rate, x.device)
        return x * mask.to(x.dtype) / (1.0 - rate)


# -- layers -----------------------------------------------------------------

class Net:
    """The forward pass over parameters ``P`` (name -> float32 tensor)."""

    def __init__(self, arch: Arch, params: Dict[str, torch.Tensor],
                 numerics: Numerics = Numerics()):
        self.a, self.P, self.q = arch, params, numerics

    def ln(self, x, pfx):
        return F.layer_norm(x, (x.shape[-1],), self.P[pfx + "weight"], self.P[pfx + "bias"],
                            LN_EPS)

    def linear(self, x, pfx, bias=True):
        b = self.P.get(pfx + "bias") if bias else None
        return F.linear(self.q(x), self.q(self.P[pfx + "weight"]), b)

    def conv(self, x, pfx, stride=1, padding=0, bias=True):
        """NHWC conv."""
        b = self.P[pfx + "bias"] if bias else None
        y = F.conv2d(self.q(x.permute(0, 3, 1, 2)), self.q(self.P[pfx + "weight"]), b,
                     stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    def gelu(self, x):
        return F.gelu(x, approximate="tanh" if self.a.gelu_tanh else "none")

    def attention(self, x, pfx, heads, shift, noise: Noise):
        """Shifted-window MHSA on the normed map ``x`` (B, H, W, C)."""
        b, h, w, c = x.shape
        ws = self.a.window_size
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        sh = 0 if ws >= hp else shift
        sw = 0 if ws >= wp else shift
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        if sh or sw:
            x = torch.roll(x, (-sh, -sw), (1, 2))
        nh, nw, n, hd = hp // ws, wp // ws, ws * ws, c // heads
        xw = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nh * nw, n, c)
        qkv = self.linear(xw, pfx + "qkv.").reshape(b, nh * nw, n, 3, heads, hd)
        qkv = qkv.permute(3, 0, 1, 4, 2, 5)
        qh, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        s = self.q(qh) @ self.q(k).transpose(-1, -2)
        s = s + self.P[pfx + "relative_position_bias_table"][rel_index(ws).to(x.device)] \
            .permute(2, 0, 1)
        if sh or sw:
            s = s + shift_mask(hp, wp, ws, sh, sw).to(x.device)[None, :, None]
        p = noise.dropout(torch.softmax(s, dim=-1), self.a.attn_drop_rate)
        o = (self.q(p) @ self.q(v)).permute(0, 1, 3, 2, 4).reshape(b, nh * nw, n, c)
        o = noise.dropout(self.linear(o, pfx + "proj."), self.a.drop_rate)
        o = o.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if sh or sw:
            o = torch.roll(o, (sh, sw), (1, 2))
        return o[:, :h, :w]

    def block(self, x, pfx, heads, shift, rate, noise):
        h = self.attention(self.ln(x, pfx + "norm1."), pfx + "attn.", heads, shift, noise)
        x = x + noise.drop_path(h, rate)
        h = noise.dropout(self.gelu(self.linear(self.ln(x, pfx + "norm2."), pfx + "mlp.0.")),
                          self.a.drop_rate)
        h = noise.dropout(self.linear(h, pfx + "mlp.3."), self.a.drop_rate)
        return x + noise.drop_path(h, rate)

    def stage(self, x, pfx, s, noise):
        for j, rate in enumerate(self.a.drop_paths(s)):
            shift = self.a.window_size // 2 if j % 2 else 0
            x = self.block(x, f"{pfx}blocks.{j}.", self.a.num_heads[s], shift, rate, noise)
        return x

    def merge(self, x, pfx):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.linear(self.ln(x, pfx + "norm."), pfx + "reduction.", bias=False)

    def expand(self, x, pfx):
        return self.ln(depth_to_space(self.linear(x, pfx + "expand.", bias=False), 2),
                       pfx + "norm.")

    def decoder(self, name, first, n_stages, x, skips, skip_of, reduce_of, noise):
        """Run decoder ``name``: stage 0 expands ``x``; stage i > 0 first
        reduces ``[x | skips[skip_of(i)]]`` by ``concat_back_dim[reduce_of(i)]``,
        which a cent decoder writes back into ``skips``."""
        p = f"ms_unet.{name}."
        x = self.expand(x, p + "0.")
        for i, (s, up) in enumerate(_decoder_stages(self.a, first, n_stages), start=1):
            j = skip_of(i)
            x = self.linear(torch.cat([x, skips[j]], -1),
                            f"ms_unet.concat_back_dim.{reduce_of(i)}.")
            if name != "layers_up":
                skips[j] = x
            x = self.stage(x, f"{p}{i}.", s, noise)
            if up:
                x = self.expand(x, f"{p}{i}.upsample.")
        return x

    def forward(self, images: torch.Tensor, noise: Noise) -> torch.Tensor:
        """``(B, H, W, 3)`` float images in [0, 1] -> ``(B, H, W, classes)`` logits."""
        a, nl = self.a, len(self.a.depths)
        x = self.conv(images, "ms_unet.patch_embed.proj.", stride=a.patch_size)
        x = noise.dropout(self.ln(x, "ms_unet.patch_embed.norm."), a.drop_rate)
        skips: List[torch.Tensor] = []
        for i in range(nl):
            if i == 1:  # cent decoder 2 rewrites skip 0
                self.decoder("layers_cent2", nl - 3, nl - 2, x, skips,
                             lambda k: 1 - k, lambda k: k + 2, noise)
            if i == 2:  # cent decoder 1 rewrites skips 1 and 0
                self.decoder("layers_cent1", nl - 2, nl - 1, x, skips,
                             lambda k: 2 - k, lambda k: k + 1, noise)
            skips.append(x)
            x = self.stage(x, f"ms_unet.layers.{i}.", i, noise)
            if i < nl - 1:
                x = self.merge(x, f"ms_unet.layers.{i}.downsample.")
        x = self.ln(x, "ms_unet.norm.")
        x = self.decoder("layers_up", nl - 1, nl, x, skips, lambda k: nl - 1 - k,
                         lambda k: k, noise)
        x = self.ln(x, "ms_unet.norm_up.")
        x = depth_to_space(self.gelu(self.linear(x, "ms_unet.up.expand.", bias=False)), 4)
        x = self.gelu(self.conv(x, "ms_unet.up.refine1.", padding=1))
        x = self.ln(self.conv(x, "ms_unet.up.refine2.", padding=1), "ms_unet.up.norm.")
        return self.conv(x, "ms_unet.output.", bias=False)


def depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """``(B, H, W, p*p*C) -> (B, p*H, p*W, C)``, channel index ``(p1*p + p2)*C + c``."""
    b, h, w, cc = x.shape
    c = cc // (p * p)
    return x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h * p, w * p, c)


def rel_index(ws: int) -> torch.Tensor:
    """``(N, N)`` index into the ``(2w-1)^2`` bias table: query i, key j at
    ``(dy + w-1) * (2w-1) + (dx + w-1)``, ``d = pos_i - pos_j``."""
    pos = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    pos = pos.reshape(2, -1)
    d = pos[:, :, None] - pos[:, None, :] + (ws - 1)
    return d[0] * (2 * ws - 1) + d[1]


def shift_mask(hp: int, wp: int, ws: int, sh: int, sw: int) -> torch.Tensor:
    """``(nW, N, N)`` additive mask of a shifted map: -100 between tokens of
    different regions of the rolled grid, 0 within one."""

    def region(n, s):
        idx = torch.arange(n)
        return (idx >= n - ws).long() + (idx >= n - s).long()

    ids = region(hp, sh)[:, None] * 3 + region(wp, sw)[None, :]
    ids = ids.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0)
