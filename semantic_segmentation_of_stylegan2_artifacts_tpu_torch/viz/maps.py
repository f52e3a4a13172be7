"""Prediction exports: grey heatmap, binary mask, colour heatmap,
probability contours, contour overlay and multi-class class maps
(counterpart of the JAX package's ``viz/maps.py``; reference
``scripts/map_generator.py``).  PIL, matplotlib
and cv2 are imported only inside the writers."""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

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


def save_contour_heatmap(img_hw3: np.ndarray, heat_hw: np.ndarray, out_png: str,
                         levels: Sequence[float] = (0.3, 0.6, 0.9)) -> None:
    """Probability contours at fixed levels over the image (reference
    ``map_generator.py:67-106``); needs matplotlib, which no CLI calls for."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(img_hw3, dtype=np.uint8))
    cs = ax.contour(np.clip(np.asarray(heat_hw, np.float32), 0, 1),
                    levels=list(levels), colors=["green", "yellow", "red"])
    ax.clabel(cs, inline=True, fontsize=6)
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


# colours for class ids 1..12 (0 = background stays black); multi-class
# artifact segmentation is an extension beyond the binary reference task
_CLASS_PALETTE = np.array(
    [(0, 0, 0), (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
     (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
     (210, 245, 60), (250, 190, 212), (0, 128, 128), (220, 190, 255)],
    dtype=np.uint8)


def save_class_map(probs_hwc: np.ndarray, out_png: str, bg_threshold: float = 0.5) -> np.ndarray:
    """Colour PNG of the argmax class per pixel from per-class sigmoids
    (channel ``c`` is class id ``c + 1``); a pixel whose best probability is
    under ``bg_threshold`` is background."""
    from PIL import Image

    p = np.asarray(probs_hwc, np.float32)
    cls = np.where(p.max(axis=-1) >= bg_threshold, p.argmax(axis=-1), 0)
    rgb = _CLASS_PALETTE[np.minimum(cls, len(_CLASS_PALETTE) - 1)]
    Image.fromarray(rgb, "RGB").save(out_png)
    return rgb


def export_class_maps(output_saver: Iterable[Tuple[str, np.ndarray]], pred_dir: str,
                      bg_threshold: float = 0.5) -> List[str]:
    """``{case}_class_map.png`` for each ``(case, (H, W, C) probs)``."""
    os.makedirs(pred_dir, exist_ok=True)
    written: List[str] = []
    for case_name, probs in output_saver:
        out = os.path.join(pred_dir, f"{case_name}_class_map.png")
        save_class_map(np.asarray(probs), out, bg_threshold)
        written.append(out)
    return written


def create_bin_heat_mask_from_list(output_saver: Iterable[Tuple[str, np.ndarray]],
                                   pred_dir: str, dataset_root: str,
                                   threshold: float = 0.5,
                                   include_original: bool = False) -> List[str]:
    """Per case: ``{case}_grey_heats.png`` and ``{case}_bin_mask.png``, then,
    as the trainer names them (reference ``trainer.py:458-491``), the colour
    heatmap ``{case}_overlay_color.png`` and the contour overlay
    ``{case}_overlay_contour.png``; with ``include_original``, as the test
    script names them (reference ``test.py:183-224``), a copy of the image
    ``{case}.png``, the colour heatmap ``{case}_heatmap.png`` and the contour
    overlay ``{case}_overlay_color.png``.  The source image is found in
    ``fake_images/`` or ``real_images/`` by the "09" id prefix."""
    from PIL import Image

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
        grey, binp = (os.path.join(pred_dir, f"{case_name}_{s}.png")
                      for s in ("grey_heats", "bin_mask"))
        save_grey_heatmap(heat, grey)
        save_binary_mask(heat, binp, threshold)
        written += [grey, binp]
        if include_original:
            orig = os.path.join(pred_dir, f"{case_name}.png")
            Image.fromarray(image, "RGB").save(orig)
            written.append(orig)
            colp, ovp = (os.path.join(pred_dir, f"{case_name}_{s}.png")
                         for s in ("heatmap", "overlay_color"))
        else:
            colp, ovp = (os.path.join(pred_dir, f"{case_name}_{s}.png")
                         for s in ("overlay_color", "overlay_contour"))
        save_color_heatmap(image, heat, colp, alpha=0.45)
        overlay_mask_on_image(image, heat > threshold, ovp)
        written += [colp, ovp]
    return written
