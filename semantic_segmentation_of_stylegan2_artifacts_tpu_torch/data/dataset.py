"""Dataset sources: split lists and real/fake directory resolution
(counterpart of the JAX package's ``data/dataset.py``; reference
``dataset/dataset.py``).

A split file ``<list_dir>/<split>.txt`` lists basenames; each resolves to
``real_images/<id>.png`` or ``fake_images/<id>.png`` with a matching
``{real,fake}_labels/<id>_mask.png`` (missing files raise), loaded as RGB /
L.  Fake StyleGAN2 ids start with "09".  Images decode with PIL, imported
where a file is read.
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


def load_gray(path: str) -> np.ndarray:
    """(H, W) uint8 luma with PIL ``convert("L")`` rounding."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("L"), dtype=np.uint8)


def read_split_list(list_dir: str, split: str) -> List[str]:
    with open(os.path.join(list_dir, split + ".txt"), "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def is_fake_id(case_name: str) -> bool:
    """Fake StyleGAN2 ids start with '09' (6-digit); real ids are 5-digit."""
    return case_name.startswith("09")


class SegArtifactDataset:
    """Images and masks of one split, map-style, decoded on the host;
    samples are ``{'image': (H,W,3) u8, 'label': (H,W) u8, 'case_name'}``."""

    def __init__(self, base_dir: str, list_dir: str, split: str):
        self.data_dir = base_dir
        self.split = split
        self.sample_list = read_split_list(list_dir, split)

    def __len__(self) -> int:
        return len(self.sample_list)

    def _resolve(self, name: str):
        for kind in ("real", "fake"):
            img = os.path.join(self.data_dir, f"{kind}_images", name + ".png")
            if os.path.exists(img):
                lbl = os.path.join(self.data_dir, f"{kind}_labels", name + "_mask.png")
                if not os.path.exists(lbl):
                    raise FileNotFoundError(f"Label {name} not found in {kind}_labels")
                return img, lbl
        raise FileNotFoundError(f"Sample {name} not found in real_images/ or fake_images/")

    def __getitem__(self, idx: int) -> Dict:
        name = self.sample_list[idx]
        img_path, lbl_path = self._resolve(name)
        return {"image": load_rgb(img_path), "label": load_gray(lbl_path),
                "case_name": name}


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
