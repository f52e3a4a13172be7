"""Deterministic augmentation on the host, uint8 in and out (counterpart of
the JAX package's ``data/augment.py``; reference ``dataset/dataset.py:24-51``).

The reference's albumentations pipeline re-implemented with cv2 and numpy,
drawn from a counter-based generator keyed on ``(seed, epoch, index)``, so
every sample's augmentation is reproducible whatever the worker order, and
equal in bytes to the JAX package's for the same key.  cv2 is imported
inside the ops that call it.

Pipeline (probabilities per the reference):
  with p=0.9:
    ToGray(p=0.05)
    RandomBrightnessContrast(±0.1, ±0.1, p=0.8)
    HueSaturationValue(hue ±4, sat ±20, val ±2, p=0.8)
    OneOf([RandomGamma(90..110) w=1.0, GaussianBlur(3..5) w=0.5], p=0.7)
  horizontal flip of image+label with p=0.5
Then label binarization ``label > 127``; normalisation to [0, 1] happens on
the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Counter-based per-sample generator; stable across workers and platforms."""
    return np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[0, 0, epoch, index]))


def to_gray(img: np.ndarray) -> np.ndarray:
    import cv2

    g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    return cv2.cvtColor(g, cv2.COLOR_GRAY2RGB)


def brightness_contrast(img: np.ndarray, brightness: float, contrast: float) -> np.ndarray:
    """albumentations RandomBrightnessContrast (brightness_by_max=True):
    ``img*(1+contrast) + brightness*255``."""
    out = img.astype(np.float32) * (1.0 + contrast) + brightness * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def hue_saturation_value(img: np.ndarray, hue_shift: int, sat_shift: int,
                         val_shift: int) -> np.ndarray:
    import cv2

    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + hue_shift) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + sat_shift, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + val_shift, 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def random_gamma(img: np.ndarray, gamma: float) -> np.ndarray:
    table = ((np.arange(256) / 255.0) ** gamma * 255.0).astype(np.uint8)
    return table[img]


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    import cv2

    return cv2.GaussianBlur(img, (ksize, ksize), 0)


def horizontal_flip(image: np.ndarray, label: Optional[np.ndarray]):
    image = np.ascontiguousarray(image[:, ::-1])
    if label is not None:
        label = np.ascontiguousarray(label[:, ::-1])
    return image, label


class RandomGenerator:
    """Per-sample transform (the reference ``RandomGenerator``'s API).

    Called with a sample dict and an ``rng``; without one, the generator is
    derived from ``(seed, epoch, sample['index'])``, the epoch set with
    :meth:`set_epoch`."""

    def __init__(self, output_size, random_flip_flag: bool = False,
                 transform: bool = True, seed: int = 0, num_classes: int = 1):
        self.output_size = tuple(output_size)
        self.random_flip_flag = random_flip_flag
        self.enable_transform = transform
        self.seed = seed
        self.epoch = 0
        self.num_classes = num_classes

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _augment_image(self, img: np.ndarray, rng: np.random.Generator):
        if rng.random() <= 0.1 or not self.enable_transform:
            return img  # the reference applies the pipeline when random() > 0.1
        if rng.random() < 0.05:
            img = to_gray(img)
        if rng.random() < 0.8:
            img = brightness_contrast(img, brightness=float(rng.uniform(-0.1, 0.1)),
                                      contrast=float(rng.uniform(-0.1, 0.1)))
        if rng.random() < 0.8:
            img = hue_saturation_value(img, hue_shift=int(rng.integers(-4, 5)),
                                       sat_shift=int(rng.integers(-20, 21)),
                                       val_shift=int(rng.integers(-2, 3)))
        if rng.random() < 0.7:
            # OneOf: gamma weight 1.0 vs blur weight 0.5 -> 2/3 vs 1/3
            if rng.random() < (1.0 / 1.5):
                img = random_gamma(img, float(rng.uniform(90, 110)) / 100.0)
            else:
                img = gaussian_blur(img, int(rng.choice([3, 5])))
        return img

    def __call__(self, sample: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
        image = np.asarray(sample["image"], dtype=np.uint8)
        label = sample.get("label")
        if label is not None:
            label = np.asarray(label, dtype=np.uint8)
        if rng is None:
            rng = sample_rng(self.seed, self.epoch, sample.get("index", 0))
        if self.enable_transform:
            image = self._augment_image(image, rng)
        if self.random_flip_flag and rng.random() > 0.5:
            image, label = horizontal_flip(image, label)

        h, w = image.shape[:2]
        if (h, w) != self.output_size:
            raise ValueError(f"RandomGenerator: Wrong image size: {(h, w)}")
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("RandomGenerator: Image does not have 3 channels")
        out = {"image": image, "case_name": sample.get("case_name", "")}
        if label is not None:
            # multi-class masks hold integer class ids and pass through
            out["label"] = label if self.num_classes > 1 else (label > 127).astype(np.uint8)
        return out
