"""Prediction exports: grey heatmap, binary mask, colour heatmap, contour
overlay (counterpart of the JAX package's ``viz/maps.py``; reference
``scripts/map_generator.py``).  PIL, matplotlib and cv2 are imported only
inside the writers."""

from __future__ import annotations

import os
from typing import Iterable, List, Tuple

import numpy as np

from ..data.dataset import is_fake_id, load_rgb


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(x, dtype=np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)


def save_grey_heatmap(heat_hw: np.ndarray, out_png: str) -> None:
    from PIL import Image

    Image.fromarray(_to_u8(heat_hw), "L").save(out_png)


def save_binary_mask(heat_hw: np.ndarray, out_png: str, threshold: float = 0.5) -> None:
    from PIL import Image

    mask = (np.asarray(heat_hw) > threshold).astype(np.uint8) * 255
    Image.fromarray(mask, "L").save(out_png)


def _gyr_colormap(heat: np.ndarray) -> np.ndarray:
    """Green -> yellow -> red, (H,W) in [0,1] -> (H,W,3) uint8."""
    h = np.clip(np.asarray(heat, np.float32), 0.0, 1.0)
    rgb = np.stack([np.clip(2.0 * h, 0, 1), np.clip(2.0 * (1.0 - h), 0, 1),
                    np.zeros_like(h)], -1)
    return (rgb * 255).astype(np.uint8)


def save_color_heatmap(img_hw3: np.ndarray, heat_hw: np.ndarray, out_png: str,
                       alpha: float = 0.45) -> None:
    """Green/yellow/red heatmap over the image, with a colourbar when
    matplotlib is installed, else a plain PIL blend."""
    img = np.asarray(img_hw3, dtype=np.uint8)
    heat = np.clip(np.asarray(heat_hw, np.float32), 0, 1)
    try:
        import matplotlib
    except ImportError:
        from PIL import Image

        blend = img.astype(np.float32) * (1 - alpha) + _gyr_colormap(heat) * alpha
        Image.fromarray(blend.astype(np.uint8), "RGB").save(out_png)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list(
        "gyr", [(0, "green"), (0.5, "yellow"), (1, "red")])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(img)
    hm = ax.imshow(heat, cmap=cmap, alpha=alpha, vmin=0.0, vmax=1.0)
    fig.colorbar(hm, ax=ax, fraction=0.046, pad=0.04)
    ax.axis("off")
    fig.savefig(out_png, bbox_inches="tight", dpi=150)
    plt.close(fig)


def overlay_mask_on_image(img_hw3: np.ndarray, mask_hw: np.ndarray, out_png: str,
                          color: Tuple[int, int, int] = (255, 0, 255),
                          fill_alpha: float = 0.3) -> None:
    """Magenta contours and a translucent fill over the binary mask."""
    import cv2
    from PIL import Image

    img = np.asarray(img_hw3, dtype=np.uint8).copy()
    mask = (np.asarray(mask_hw) > 0).astype(np.uint8)
    contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    fill = img.copy()
    fill[mask > 0] = color
    img = cv2.addWeighted(fill, fill_alpha, img, 1 - fill_alpha, 0)
    cv2.drawContours(img, contours, -1, color, 2)
    Image.fromarray(img, "RGB").save(out_png)


def create_bin_heat_mask_from_list(output_saver: Iterable[Tuple[str, np.ndarray]],
                                   pred_dir: str, dataset_root: str,
                                   threshold: float = 0.5) -> List[str]:
    """Per case: ``{case}_grey_heats.png``, ``{case}_bin_mask.png``,
    ``{case}_overlay_color.png`` (colour heatmap) and
    ``{case}_overlay_contour.png`` (the trainer-side naming the predict CLI
    uses, reference ``trainer.py:458-491``); the source image is found in
    ``fake_images/`` or ``real_images/`` by the "09" id prefix."""
    os.makedirs(pred_dir, exist_ok=True)
    written: List[str] = []
    for case_name, pred in output_saver:
        case_name = str(case_name)
        heat = np.clip(np.asarray(pred, np.float32), 0.0, 1.0)
        if heat.ndim == 3:
            heat = heat[0]
        sub = "fake_images" if is_fake_id(case_name) else "real_images"
        img_path = os.path.join(dataset_root, sub, case_name + ".png")
        if not os.path.exists(img_path):
            raise FileNotFoundError(f"Image not found: {img_path}")
        image = load_rgb(img_path)
        paths = [os.path.join(pred_dir, f"{case_name}_{s}.png")
                 for s in ("grey_heats", "bin_mask", "overlay_color", "overlay_contour")]
        save_grey_heatmap(heat, paths[0])
        save_binary_mask(heat, paths[1], threshold)
        save_color_heatmap(image, heat, paths[2], alpha=0.45)
        overlay_mask_on_image(image, heat > threshold, paths[3])
        written += paths
    return written
