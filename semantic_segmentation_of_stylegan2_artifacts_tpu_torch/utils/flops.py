"""Analytic FLOP model of the MS-UNet train step (a copy of the JAX
package's ``utils/flops.py``, which imports no JAX; the port keeps its own).

It counts the matmul and conv FLOPs from the architecture contract
(reference ``network/model_parts.py:543-893``), whichever ops run as
kernels: the patch-embed conv, per block qkv / scores / context / proj /
MLP on unpadded tokens, the PatchMerging / PatchExpand / concat_back_dim
linears of the encoder, both cent decoders and the main decoder, the
FinalPatchExpand_X4_V2 head (linear and two 3x3 convs) and the 1x1
classifier.  Backward = 2x forward; AdamW adds ~10 flops a parameter.
LayerNorm / GELU / softmax elementwise work is left out.  MFU is this
count over the step's time and the card's peak rate
(``chip_smoke.py::BF16_FLOP_PER_S`` on the H100).  The JAX package holds
the count within 15 % of XLA's cost analysis at 512^2
(``tests/test_flops.py``); ``tests/test_torch_tools_more.py`` holds this
copy equal to it.
"""

from __future__ import annotations

from typing import Sequence


def _pad_to(g: int, w: int) -> int:
    return g + (-g % w)


def _block_flops(grid: int, c: int, window: int) -> float:
    """Forward matmul FLOPs of one Swin block on a ``grid x grid`` map.

    MFU convention: count USEFUL work — unpadded tokens for the dense
    sublayers.  The 7-alignment padding (e.g. 32 -> 35 at stage 2) is
    implementation waste, not model FLOPs; counting it would inflate
    MFU by ~16% at 512^2 and hide real padding overhead.  The window
    score/context matmuls do run on padded windows structurally, but
    per-row masking makes the pad rows non-useful too, so they are
    counted unpadded as well (matches the r2 ledger anchor of 1.526
    TFLOP/img, BASELINE.md)."""
    t = grid * grid
    n = window * window
    qkv = 2.0 * t * c * 3 * c
    scores = 2.0 * t * n * c         # q@k^T over all heads, per token row
    ctx = 2.0 * t * n * c            # probs@v
    proj = 2.0 * t * c * c
    mlp = 2.0 * 2.0 * t * c * 4 * c  # fc1 + fc2
    return qkv + scores + ctx + proj + mlp


def train_step_flops(
    img_size: int,
    batch: int,
    *,
    patch_size: int = 4,
    embed_dim: int = 128,
    depths: Sequence[int] = (2, 2, 18, 2),
    window_size: int = 7,
    num_classes: int = 1,
    params: int | None = None,
) -> float:
    """Total FLOPs of one fwd+bwd+AdamW train step on a ``batch`` of
    ``img_size^2`` images (architecture contract of ``MSUNet``)."""
    nl = len(depths)
    g0 = img_size // patch_size
    grids = [g0 // (2 ** i) for i in range(nl)]
    dims = [embed_dim * (2 ** i) for i in range(nl)]
    fwd = 0.0

    # patch embed: conv k=4 s=4, 3 -> C
    fwd += 2.0 * g0 * g0 * embed_dim * 3 * patch_size * patch_size

    # encoder blocks + PatchMerging (4C -> 2C Linear on the merged grid)
    for i in range(nl):
        fwd += depths[i] * _block_flops(grids[i], dims[i], window_size)
        if i < nl - 1:
            tm = grids[i + 1] ** 2
            fwd += 2.0 * tm * (4 * dims[i]) * (2 * dims[i])

    # cent2 (fires at encoder stage 1): PatchExpand C1->C0 grid1->grid0,
    # concat_back Linear 2C0->C0, then depths[0] blocks at (grid0, C0)
    def expand(grid_in: int, c_in: int) -> float:
        # PatchExpand: Linear C -> 2C on the input grid
        return 2.0 * grid_in * grid_in * c_in * 2 * c_in

    def concat_back(grid: int, c: int) -> float:
        return 2.0 * grid * grid * (2 * c) * c

    fwd += expand(grids[1], dims[1]) + concat_back(grids[0], dims[0])
    fwd += depths[0] * _block_flops(grids[0], dims[0], window_size)

    # cent1 (fires at encoder stage 2): two expand+reduce+block stages
    fwd += expand(grids[2], dims[2]) + concat_back(grids[1], dims[1])
    fwd += depths[1] * _block_flops(grids[1], dims[1], window_size)
    fwd += expand(grids[1], dims[1]) + concat_back(grids[0], dims[0])
    fwd += depths[0] * _block_flops(grids[0], dims[0], window_size)

    # main decoder: stage 0 = pure PatchExpand at the bottleneck; stages
    # 1..3 = concat_back + blocks (+ expand, except the last stage).
    # Decoder stage depths reuse the ENCODER depth list reversed
    # (reference model_parts.py:660 quirk): [-, 18, 2, 2].
    fwd += expand(grids[nl - 1], dims[nl - 1])
    for i in range(1, nl):
        g, c = grids[nl - 1 - i], dims[nl - 1 - i]
        d = depths[nl - 1 - i] if i > 0 else 0
        fwd += concat_back(g, c)
        fwd += d * _block_flops(g, c, window_size)
        if i < nl - 1:
            fwd += expand(g, c)

    # head: FinalPatchExpand_X4_V2 = Linear C -> 16C at grid0, then two
    # 3x3 convs C->C at full res, then 1x1 conv C -> num_classes
    fwd += 2.0 * g0 * g0 * embed_dim * 16 * embed_dim
    fwd += 2 * (2.0 * img_size * img_size * embed_dim * embed_dim * 9)
    fwd += 2.0 * img_size * img_size * embed_dim * num_classes

    total = 3.0 * fwd * batch        # bwd = 2x fwd
    if params is None:
        params = 88_000_000          # Swin-B MS-UNet ballpark
    total += 10.0 * params           # AdamW elementwise
    return total
