"""Work counted from the cell's shapes: the model's useful operations, and
the operations and bytes of the window-attention and refine-head layers;
the card's peaks.

The model count is a frozen copy of the port's ``utils/flops.py`` (itself
the JAX package's): matmul and conv operations on unpadded tokens, the
backward twice the forward, recomputation not counted, AdamW at 10
operations a parameter; :func:`forward_flops` is its forward alone.

A layer's least time is the larger of its operations over the bf16 peak
and its bytes over the memory bandwidth, with its inputs read once and its
outputs written once: for a forward its input map (bf16), its float32
parameters and its output map; a training step adds the incoming gradient,
the input's gradient and the parameters' float32 gradients, and twice the
forward's operations.  The window-attention layer is one Swin block's
``attn`` module: the qkv projection, the window products ``q.k^T`` and
``p.v`` (the per-call counts of ``chip_smoke.py``'s attention rows, on
unpadded tokens) and the output projection.  The refine-head layer is the
``up`` module: the projection to 16 C, and the two 3x3 convs at full
resolution that ``chip_smoke.py``'s refine-head rows count.

These are the MS-UNet's counts: ``*_of`` read them off a configuration, and
the architecture lookup (``architecture.py``) takes them for a reference
module that brings none of its own.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12

BF16, F32 = 2, 4


def _block_flops(grid: int, c: int, window: int) -> float:
    t, n = grid * grid, window * window
    return (2.0 * t * c * 3 * c + 2.0 * t * n * c + 2.0 * t * n * c + 2.0 * t * c * c
            + 2.0 * 2.0 * t * c * 4 * c)


def forward_flops(img_size: int, batch: int, *, patch_size: int = 4, embed_dim: int = 128,
                  depths: Sequence[int] = (2, 2, 18, 2), window_size: int = 7,
                  num_classes: int = 1) -> float:
    """Matmul and conv operations of one forward on ``batch`` images."""
    nl = len(depths)
    g0 = img_size // patch_size
    grids = [g0 // (2 ** i) for i in range(nl)]
    dims = [embed_dim * (2 ** i) for i in range(nl)]
    fwd = 2.0 * g0 * g0 * embed_dim * 3 * patch_size * patch_size
    for i in range(nl):
        fwd += depths[i] * _block_flops(grids[i], dims[i], window_size)
        if i < nl - 1:
            fwd += 2.0 * grids[i + 1] ** 2 * (4 * dims[i]) * (2 * dims[i])

    def expand(g, c):
        return 2.0 * g * g * c * 2 * c

    def concat_back(g, c):
        return 2.0 * g * g * (2 * c) * c

    fwd += expand(grids[1], dims[1]) + concat_back(grids[0], dims[0])
    fwd += depths[0] * _block_flops(grids[0], dims[0], window_size)
    fwd += expand(grids[2], dims[2]) + concat_back(grids[1], dims[1])
    fwd += depths[1] * _block_flops(grids[1], dims[1], window_size)
    fwd += expand(grids[1], dims[1]) + concat_back(grids[0], dims[0])
    fwd += depths[0] * _block_flops(grids[0], dims[0], window_size)
    fwd += expand(grids[nl - 1], dims[nl - 1])
    for i in range(1, nl):
        g, c = grids[nl - 1 - i], dims[nl - 1 - i]
        fwd += concat_back(g, c) + depths[nl - 1 - i] * _block_flops(g, c, window_size)
        if i < nl - 1:
            fwd += expand(g, c)
    fwd += 2.0 * g0 * g0 * embed_dim * 16 * embed_dim
    fwd += 2 * (2.0 * img_size * img_size * embed_dim * embed_dim * 9)
    fwd += 2.0 * img_size * img_size * embed_dim * num_classes
    return fwd * batch


def step_flops(forward: float, params: int) -> float:
    """A train step's operations from its forward's: forward, backward
    (twice the forward) and AdamW (10 a parameter)."""
    return 3.0 * forward + 10.0 * params


def train_step_flops(img_size: int, batch: int, params: int, **arch) -> float:
    return step_flops(forward_flops(img_size, batch, **arch), params)


def least_ms(ops: float, n_bytes: float) -> float:
    return max(ops / PEAK_BF16_FLOP_S, n_bytes / PEAK_HBM_BYTES_S) * 1e3


def _layer_ms(ops_fwd: float, act_in: float, act_out: float, params: float,
              train: bool) -> float:
    """Least ms of one call of a layer: ``act_in``/``act_out`` elements of
    its bf16 input and output maps, ``params`` float32 parameters."""
    n_bytes = BF16 * (act_in + act_out) + F32 * params
    if train:
        return least_ms(3.0 * ops_fwd, 2 * n_bytes)
    return least_ms(ops_fwd, n_bytes)


def attention_blocks(img_size: int, patch_size: int, embed_dim: int, depths: Sequence[int],
                     num_heads: Sequence[int]) -> Iterator[Tuple[int, int, int]]:
    """``(grid, width, heads)`` of every Swin block a forward runs: the
    encoder's, both cent decoders' (their last stage included) and the main
    decoder's, which reuse the encoder's depths mirrored."""
    nl = len(depths)
    g0 = img_size // patch_size
    stage = [(g0 // 2 ** i, embed_dim * 2 ** i, num_heads[i]) for i in range(nl)]
    for first, n_stages in ((nl - 1, nl), (nl - 2, nl - 1), (nl - 3, nl - 2)):
        for i in range(1, n_stages):
            s = first - i
            yield from [stage[s]] * depths[s]
    for i in range(nl):
        yield from [stage[i]] * depths[i]


def attention_ms(batch: int, window: int, train: bool, **arch) -> float:
    """Least ms of every window-attention call of one forward (or train step)."""
    total = 0.0
    n = window * window
    for grid, c, heads in attention_blocks(**arch):
        t = batch * grid * grid
        ops = 2.0 * t * c * 3 * c + 2.0 * 2.0 * t * n * c + 2.0 * t * c * c
        params = 3 * c * c + 3 * c + c * c + c + (2 * window - 1) ** 2 * heads
        total += _layer_ms(ops, t * c, t * c, params, train)
    return total


def refine_head_ms(batch: int, img_size: int, patch_size: int, embed_dim: int,
                   train: bool) -> float:
    """Least ms of the head (projection to 16 C and two 3x3 convs) of one
    forward (or train step)."""
    c, g0 = embed_dim, img_size // patch_size
    pix = batch * img_size * img_size
    ops = 2.0 * batch * g0 * g0 * c * 16 * c + 2 * (2.0 * pix * c * 9 * c)
    params = 16 * c * c + 2 * (9 * c * c + c) + 2 * c
    return _layer_ms(ops, batch * g0 * g0 * c, pix * c, params, train)


def arch_kwargs(config: dict) -> dict:
    swin = config["MODEL"]["SWIN"]
    return dict(img_size=int(config["DATA"]["IMG_SIZE"]), patch_size=int(swin["PATCH_SIZE"]),
                embed_dim=int(swin["EMBED_DIM"]), depths=tuple(swin["DEPTHS"]),
                num_heads=tuple(swin["NUM_HEADS"]))


# -- the MS-UNet's counts by configuration (reference/msunet.py exports them) --

def _window(config: dict) -> int:
    return int(config["MODEL"]["SWIN"]["WINDOW_SIZE"])


def forward_flops_of(config: dict, batch: int) -> float:
    a = arch_kwargs(config)
    return forward_flops(a["img_size"], batch, patch_size=a["patch_size"],
                         embed_dim=a["embed_dim"], depths=a["depths"], window_size=_window(config))


def attention_ms_of(config: dict, batch: int, train: bool) -> float:
    return attention_ms(batch, _window(config), train, **arch_kwargs(config))


def head_ms_of(config: dict, batch: int, train: bool) -> float:
    a = arch_kwargs(config)
    return refine_head_ms(batch, a["img_size"], a["patch_size"], a["embed_dim"], train)
