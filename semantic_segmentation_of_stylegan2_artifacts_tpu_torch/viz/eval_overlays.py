"""TP/FP/FN composite overlays for exported predictions (counterpart of
the JAX package's ``viz/eval_overlays.py``; PIL imported where a file is
read or written).

Reference ``scripts/evaluation_scripts/overlap_prediction_and_mask.py``:
match ``<id>_grey_heats.png`` predictions to ``fake_labels/<id>_mask.png``,
threshold, compute TP/FP/FN maps + dice, write an RGB composite
(TP green, FP red, FN blue).
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np


def tp_fp_fn_composite(pred_bin: np.ndarray, gt_bin: np.ndarray) -> np.ndarray:
    """RGB uint8 composite: TP green, FP red, FN blue."""
    h, w = pred_bin.shape
    out = np.zeros((h, w, 3), np.uint8)
    tp = pred_bin & gt_bin
    fp = pred_bin & ~gt_bin
    fn = ~pred_bin & gt_bin
    out[tp] = (0, 255, 0)
    out[fp] = (255, 0, 0)
    out[fn] = (0, 0, 255)
    return out


def process_one(pred_path: str, mask_path: str, out_path: str,
                threshold: int = 127) -> float:
    """Write the composite; returns the binary dice for the case."""
    from PIL import Image

    pred = np.asarray(Image.open(pred_path).convert("L")) > threshold
    gt = np.asarray(Image.open(mask_path).convert("L")) > threshold
    comp = tp_fp_fn_composite(pred, gt)
    Image.fromarray(comp, "RGB").save(out_path)
    tp = float(np.sum(pred & gt))
    denom = pred.sum() + gt.sum()
    return 2.0 * tp / denom if denom else 0.0


def overlay_predictions_with_masks(
    pred_dir: str, dataset_root: str, out_dir: str,
    threshold: int = 127,
) -> Dict[str, float]:
    """All ``*_grey_heats.png`` fake predictions vs their GT masks."""
    os.makedirs(out_dir, exist_ok=True)
    dices: Dict[str, float] = {}
    for name in sorted(os.listdir(pred_dir)):
        m = re.match(r"^(09\d+)_grey_heats\.png$", name)
        if not m:
            continue
        case = m.group(1)
        mask_path = os.path.join(dataset_root, "fake_labels",
                                 f"{case}_mask.png")
        if not os.path.exists(mask_path):
            continue
        out_path = os.path.join(out_dir, f"{case}_tp_fp_fn.png")
        dices[case] = process_one(os.path.join(pred_dir, name), mask_path,
                                  out_path, threshold)
    return dices
