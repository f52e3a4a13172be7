"""Spatial artifact-frequency heatmaps over the face-aligned dataset.

Reference ``dataset/artifact_distibution/aritfact_distibution.py`` (+ the
size-normalized variant): average all fake masks — optionally each
normalized to sum 1 so large artifacts don't dominate — into a heatmap
rendered over a ground image (counterpart of the JAX package's
``viz/artifact_distribution.py``; PIL and matplotlib imported where a file
is read or drawn).
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional

import numpy as np


def average_mask_heatmap(mask_dir: str, normalize_per_mask: bool = False
                         ) -> np.ndarray:
    """Mean of all ``*_mask.png`` files (float map, max-normalized)."""
    from PIL import Image

    paths = sorted(glob(os.path.join(mask_dir, "*_mask.png")))
    if not paths:
        raise FileNotFoundError(f"No *_mask.png in {mask_dir}")
    acc: Optional[np.ndarray] = None
    for p in paths:
        m = np.asarray(Image.open(p).convert("L"), np.float64) / 255.0
        if normalize_per_mask:
            s = m.sum()
            if s > 0:
                m = m / s
        acc = m if acc is None else acc + m
    acc /= len(paths)
    if acc.max() > 0:
        acc = acc / acc.max()
    return acc


def create_heatmap(mask_dir: str, out_png: str,
                   ground_image: Optional[str] = None,
                   normalize_per_mask: bool = False,
                   alpha: float = 0.6) -> str:
    """Render the average-mask heatmap (optionally over a ground image)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    heat = average_mask_heatmap(mask_dir, normalize_per_mask)
    fig, ax = plt.subplots(figsize=(6, 6))
    if ground_image and os.path.exists(ground_image):
        ax.imshow(np.asarray(Image.open(ground_image).convert("RGB")))
    hm = ax.imshow(heat, cmap="jet", alpha=alpha, vmin=0.0, vmax=1.0)
    fig.colorbar(hm, ax=ax, fraction=0.046, pad=0.04)
    ax.set_title(
        "Artifact distribution"
        + (" (size-normalized)" if normalize_per_mask else "")
    )
    ax.axis("off")
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, bbox_inches="tight", dpi=200)
    plt.close(fig)
    return out_png
