#!/usr/bin/env python3
"""Times the port's bfloat16 window-attention forward at a few shapes, in
the port found at a given root, for an A/B of two trees in one call.

    python3 attention_ab.py ROOT LABEL

On one NVIDIA GPU: puts ``ROOT`` (a checkout of this repo, or an unpacked
``git archive`` of another commit) first on the import path, builds that
tree's kernels into its own ``_build/``, and prints for each shape in
``SHAPES`` the forward's ms by CUDA events (``chip_smoke.cuda_ms``, 20
launches), its device ms (``chip_smoke.device_ms``) and its error against
the plain version, each line prefixed with ``LABEL``.  Run the two trees
alternately in one call (a, b, a, b) and compare only within that call.
The shapes are the tiled ``mma.sync`` forward's head widths above 64 at
window 12 and 9 (one stage of the one-block kernel's ring).  Exits
non-zero without a GPU.
"""
from __future__ import annotations

import os
import sys
import time

import torch

# (B, Hp, Wp, C, heads, window, sh, sw)
SHAPES = [
    (1, 24, 36, 256, 2, (12, 12), 6, 0),
    (8, 72, 72, 512, 4, (12, 12), 6, 6),
    (8, 36, 36, 768, 8, (12, 12), 0, 0),
    (4, 72, 72, 512, 4, (9, 9), 4, 4),
]


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import _build
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import (
        fused_window_attention as fwa,
    )

    t0 = time.perf_counter()
    _build.library()
    print(f"{label} build {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, hp, wp, dim, heads, (wh, ww), sh, sw in SHAPES:
        n = wh * ww
        qkv = torch.randn((b, hp, wp, 3 * dim), generator=gen, device="cuda").bfloat16()
        bias = torch.randn((heads, n, n), generator=gen, device="cuda")
        kw = dict(wh=wh, ww=ww, heads=heads, sh=sh, sw=sw)
        run = lambda: fwa.window_attention(qkv, bias, **kw)  # noqa: E731
        err = cs.rel_err(run(), fwa.window_attention_reference(qkv, bias, **kw))
        print(f"{label} fwd qkv{tuple(qkv.shape)} window {(wh, ww)} hd {dim // heads}: "
              f"kernel_ms {cs.cuda_ms(run, 20):.4f} device_ms {cs.device_ms(run):.4f} "
              f"err {err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
