"""Image-only dataset for label-free inference (counterpart of the JAX
package's ``data/dataset.py``; reference ``dataset/dataset.py:166-209``).

A split file ``<list_dir>/<split>.txt`` lists basenames; each resolves to
``real_images/<id>.png`` or ``fake_images/<id>.png``.  Fake StyleGAN2 ids
start with "09".  Images decode with PIL, imported where a file is read.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def read_split_list(list_dir: str, split: str) -> List[str]:
    with open(os.path.join(list_dir, split + ".txt"), "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def is_fake_id(case_name: str) -> bool:
    """Fake StyleGAN2 ids start with '09' (6-digit); real ids are 5-digit."""
    return case_name.startswith("09")


class SegArtifactNoLabelDataset:
    """Images of one split, map-style, decoded on the host."""

    def __init__(self, base_dir: str, list_dir: str, split: str):
        self.data_dir = base_dir
        self.split = split
        self.sample_list = read_split_list(list_dir, split)

    def __len__(self) -> int:
        return len(self.sample_list)

    def __getitem__(self, idx: int) -> Dict:
        name = self.sample_list[idx]
        for sub in ("real_images", "fake_images"):
            p = os.path.join(self.data_dir, sub, name + ".png")
            if os.path.exists(p):
                return {"image": load_rgb(p), "case_name": name}
        raise FileNotFoundError(f"Sample {name} not found in real_images/ or fake_images/")
