"""Synthetic dataset generator for tests and smoke runs (a copy of the JAX
package's ``data/synthetic.py``; the same seed writes the same bytes).

Writes the reference layout (``real_images/ fake_images/ real_labels/
fake_labels/`` and ``lists/``): fake ids start with "09" (the load-bearing
naming convention), fake masks hold random elliptical "artifacts", real
masks are empty.  PIL is imported where the images are drawn.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def _face_like(rng: np.random.Generator, size: int):
    """A cheap synthetic 'face': smooth blobs and noise (content irrelevant)."""
    from PIL import Image

    base = rng.integers(60, 200, size=(3,), dtype=np.int64)
    img = np.zeros((size, size, 3), np.float32) + base[None, None, :]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for _ in range(3):
        cx, cy = rng.random(2)
        r = 0.15 + 0.2 * rng.random()
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r**2)))
        img += blob[..., None] * rng.integers(-40, 40, size=(3,))
    img += rng.normal(0, 6, img.shape)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


def _artifact_mask(rng: np.random.Generator, size: int, n_artifacts: int,
                   num_classes: int = 1):
    """Binary masks use {0,255}; multi-class masks hold class ids 1..C."""
    from PIL import Image, ImageDraw

    mask = Image.new("L", (size, size), 0)
    draw = ImageDraw.Draw(mask)
    for _ in range(n_artifacts):
        cx, cy = rng.integers(0, size, 2)
        rx, ry = rng.integers(size // 20, size // 6, 2)
        fill = 255 if num_classes <= 1 else int(rng.integers(1, num_classes + 1))
        draw.ellipse([cx - rx, cy - ry, cx + rx, cy + ry], fill=fill)
    return mask


def _write_list(path: str, names: List[str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for n in names:
            f.write(n + "\n")


def generate_synthetic_dataset(
    root: str,
    img_size: int = 64,
    n_fake_train: int = 6,
    n_real_train: int = 4,
    n_val_fake: int = 2,
    n_val_real: int = 1,
    n_test_fake: int = 2,
    n_test_real: int = 1,
    seed: int = 0,
    num_classes: int = 1,
) -> Dict[str, List[str]]:
    """Create the tree; returns the split lists.  ``lists/`` holds
    train/val/test/fake_train/real_train/real_train_all/two.txt."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("real_images", "fake_images", "real_labels", "fake_labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    list_dir = os.path.join(root, "lists")
    os.makedirs(list_dir, exist_ok=True)

    fake_ids: List[str] = []
    real_ids: List[str] = []
    n_fake = n_fake_train + n_val_fake + n_test_fake
    n_real = n_real_train + n_val_real + n_test_real
    for i in range(n_fake):
        cid = f"09{i:04d}"  # fake ids start with 09 (6 digits)
        fake_ids.append(cid)
        _face_like(rng, img_size).save(os.path.join(root, "fake_images", cid + ".png"))
        _artifact_mask(rng, img_size, int(rng.integers(1, 4)), num_classes).save(
            os.path.join(root, "fake_labels", cid + "_mask.png"))
    for i in range(n_real):
        cid = f"{10000 + i:05d}"  # real ids: 5 digits, never 09-prefixed
        real_ids.append(cid)
        _face_like(rng, img_size).save(os.path.join(root, "real_images", cid + ".png"))
        Image.new("L", (img_size, img_size), 0).save(
            os.path.join(root, "real_labels", cid + "_mask.png"))

    splits = {
        "fake_train": fake_ids[:n_fake_train],
        "real_train": real_ids[:n_real_train],
        "real_train_all": real_ids[:n_real_train],
        "val": fake_ids[n_fake_train:n_fake_train + n_val_fake]
        + real_ids[n_real_train:n_real_train + n_val_real],
        "test": fake_ids[n_fake_train + n_val_fake:]
        + real_ids[n_real_train + n_val_real:],
    }
    splits["train"] = splits["fake_train"] + splits["real_train"]
    splits["two"] = splits["train"][:2]
    for name, ids in splits.items():
        _write_list(os.path.join(list_dir, name + ".txt"), ids)
    return splits
