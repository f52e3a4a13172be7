"""Validation metrics: per-case device reductions and host aggregation
(counterpart of the JAX package's ``metrics/segmentation.py``; reference
``scripts/validation_functions.py:37-309``).

* per case: sigmoid probs; ``pred_bin = p > sig_threshold``; ``gt = label > 0``,
* real images (empty GT): binary and soft confusion matrices, accuracy,
  ``FPR = fp / (fp + tn)``,
* fake images: binary dice/recall/precision/jaccard (medpy definitions,
  from the confusion counts), F1 with the reference's 1e-8 smoothing,
  accuracy, soft dice ``(2Σpg+ε)/(Σp²+Σg²+ε)`` and soft IoU,
* means over real / fake / all and ``Score = mean_soft_dice − 10·mean_FPR``.

The per-case reductions are torch ops on the tensors' device; only the
scalars cross to the host.  A val split with no real image makes ``Score``
undefined in the reference (NameError at ``validation_functions.py:180``);
here that raises a ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

_SMOOTH = 1e-8


@dataclasses.dataclass
class CaseMetrics:
    """Host-side scalars for one validation case."""

    case_name: str
    is_real: bool
    val_loss: float
    tp: float
    fp: float
    fn: float
    tn: float
    soft_tp: float
    soft_fp: float
    soft_fn: float
    soft_tn: float
    accuracy: float
    fpr: float
    bin_dice: float
    bin_recall: float
    bin_precision: float
    bin_iou: float
    bin_f1: float
    soft_dice: float
    soft_iou: float


def _guarded(cond: torch.Tensor, num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``cond``, else 0 (medpy's 0 guard)."""
    return torch.where(cond, num / torch.where(cond, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def case_metrics(probs: torch.Tensor, label: torch.Tensor,
                 sig_threshold: float) -> Dict[str, torch.Tensor]:
    """Per-case reductions over the trailing two axes (``(H, W)`` for one
    case, ``(B, H, W)`` for a batch of cases, each reduced on its own).

    Returns every scalar of both the real and the fake branch; the host
    selects by ``is_real``."""
    p = probs.float()
    gt = (label > 0).float()
    pb = (p > sig_threshold).float()
    dims = (-2, -1)

    def s(x):
        return x.sum(dim=dims)

    tp, fp = s(pb * gt), s(pb * (1.0 - gt))
    fn, tn = s((1.0 - pb) * gt), s((1.0 - pb) * (1.0 - gt))
    soft_tp, soft_fp = s(p * gt), s(p * (1.0 - gt))
    soft_fn, soft_tn = s((1.0 - p) * gt), s((1.0 - p) * (1.0 - gt))

    accuracy = (tp + tn) / (tp + fp + fn + tn)
    # a case with no negative pixel reads NaN, as in JAX: its 1e-38 guard is
    # a float32 subnormal that XLA flushes to 0 (only real cases' FPR is used)
    fpr = fp / (fp + tn)
    bin_dice = _guarded(2 * tp + fp + fn > 0, 2 * tp, 2 * tp + fp + fn)
    bin_recall = _guarded(tp + fn > 0, tp, tp + fn)
    bin_precision = _guarded(tp + fp > 0, tp, tp + fp)
    bin_iou = _guarded(tp + fp + fn > 0, tp, tp + fp + fn)
    bin_f1 = 2 * bin_precision * bin_recall / (bin_precision + bin_recall + _SMOOTH)

    sum_g = s(gt)
    soft_dice = (2.0 * soft_tp + _SMOOTH) / (s(p * p) + s(gt * gt) + _SMOOTH)
    soft_iou = (soft_tp + _SMOOTH) / (s(p) + sum_g - soft_tp + _SMOOTH)
    return dict(
        tp=tp, fp=fp, fn=fn, tn=tn,
        soft_tp=soft_tp, soft_fp=soft_fp, soft_fn=soft_fn, soft_tn=soft_tn,
        accuracy=accuracy, fpr=fpr,
        bin_dice=bin_dice, bin_recall=bin_recall, bin_precision=bin_precision,
        bin_iou=bin_iou, bin_f1=bin_f1,
        soft_dice=soft_dice, soft_iou=soft_iou,
        is_real=sum_g == 0,
    )


def case_metrics_multiclass(probs: torch.Tensor, label: torch.Tensor,
                            sig_threshold: float) -> Dict[str, torch.Tensor]:
    """Macro-averaged per-case metrics for multi-class (multi-label) eval.

    ``probs``: ``(H, W, C)`` per-class sigmoids; ``label``: ``(H, W)``
    integer class ids (0 = background).  The dice family averages over the
    classes present in the ground truth; FPR and accuracy over all
    classes; ``is_real`` = no foreground of any class."""
    lab = label.long()
    c = probs.shape[-1]
    per = case_metrics(probs.movedim(-1, 0),
                       torch.stack([(lab == k + 1).float() for k in range(c)]),
                       sig_threshold)
    present = ~per["is_real"]
    n_present = torch.clamp(present.float().sum(), min=1.0)
    out = {k: per[k].mean() for k in ("tp", "fp", "fn", "tn", "soft_tp", "soft_fp",
                                      "soft_fn", "soft_tn", "accuracy", "fpr")}
    for k in ("bin_dice", "bin_recall", "bin_precision", "bin_iou", "bin_f1",
              "soft_dice", "soft_iou"):
        out[k] = torch.where(present, per[k], torch.zeros_like(per[k])).sum() / n_present
    out["is_real"] = ~present.any()
    return out


def metrics_to_host(device_metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy for all the scalars of a case or a batch."""
    keys = list(device_metrics)
    stacked = torch.stack([device_metrics[k].double() for k in keys]).cpu().numpy()
    return dict(zip(keys, stacked))


def to_case_metrics(case_name: str, metrics: Dict, val_loss: float) -> CaseMetrics:
    m = {k: float(v) for k, v in metrics.items()}
    return CaseMetrics(
        case_name=case_name, is_real=bool(m.pop("is_real")), val_loss=float(val_loss),
        **m)


@dataclasses.dataclass
class EpochSummary:
    """Aggregated means for one validation epoch (the CSV row contents)."""

    epoch: int
    mean_soft_dice: float
    mean_fpr: float
    score: float
    mean_accuracy: float
    mean_val_loss: float
    mean_train_loss: float
    mean_conf_bin: List[float]
    mean_conf_soft: List[float]
    # real split
    n_real: int
    mean_accuracy_real: float = float("nan")
    mean_val_loss_real: float = float("nan")
    mean_conf_bin_real: Optional[List[float]] = None
    mean_conf_soft_real: Optional[List[float]] = None
    # fake split
    n_fake: int = 0
    mean_accuracy_fake: float = float("nan")
    mean_val_loss_fake: float = float("nan")
    mean_conf_bin_fake: Optional[List[float]] = None
    mean_conf_soft_fake: Optional[List[float]] = None
    mean_bin_accuracy: float = float("nan")
    mean_bin_recall: float = float("nan")
    mean_bin_precision: float = float("nan")
    mean_bin_iou: float = float("nan")
    mean_bin_dice: float = float("nan")
    mean_bin_f1: float = float("nan")
    mean_soft_iou: float = float("nan")


class MetricsAggregator:
    """Collects :class:`CaseMetrics` and produces the epoch summary
    (``validation_functions.py:150-211``): fake-only means for the dice
    family, real-only FPR, combined accuracy/val-loss/confusions,
    ``Score = soft_dice − 10·FPR``."""

    def __init__(self):
        self.cases: List[CaseMetrics] = []

    def add(self, case: CaseMetrics) -> None:
        self.cases.append(case)

    def summarize(self, epoch: int, mean_train_loss: float = float("nan")) -> EpochSummary:
        if not self.cases:
            raise ValueError("Expected at least one validation case")
        real = [c for c in self.cases if c.is_real]
        fake = [c for c in self.cases if not c.is_real]
        if not fake:
            raise ValueError("No valid fake metrics to aggregate.")
        if not real:
            raise ValueError(
                "Validation split contains no real images: mean_FPR and "
                "Score are undefined (reference contract requires real "
                "images in val/test splits).")

        def mean(xs):
            return float(np.mean(xs)) if len(xs) else float("nan")

        def conf(cs, soft=False):
            if soft:
                rows = [[c.soft_tp, c.soft_fp, c.soft_fn, c.soft_tn] for c in cs]
            else:
                rows = [[c.tp, c.fp, c.fn, c.tn] for c in cs]
            return [float(x) for x in np.mean(np.array(rows, dtype=float), axis=0)]

        mean_fpr = mean([c.fpr for c in real])
        mean_soft_dice = mean([c.soft_dice for c in fake])
        return EpochSummary(
            epoch=epoch,
            mean_soft_dice=mean_soft_dice,
            mean_fpr=mean_fpr,
            score=mean_soft_dice - 10.0 * mean_fpr,
            mean_accuracy=mean([c.accuracy for c in self.cases]),
            mean_val_loss=mean([c.val_loss for c in self.cases]),
            mean_train_loss=mean_train_loss,
            mean_conf_bin=conf(self.cases),
            mean_conf_soft=conf(self.cases, soft=True),
            n_real=len(real),
            mean_accuracy_real=mean([c.accuracy for c in real]),
            mean_val_loss_real=mean([c.val_loss for c in real]),
            mean_conf_bin_real=conf(real),
            mean_conf_soft_real=conf(real, soft=True),
            n_fake=len(fake),
            mean_accuracy_fake=mean([c.accuracy for c in fake]),
            mean_val_loss_fake=mean([c.val_loss for c in fake]),
            mean_conf_bin_fake=conf(fake),
            mean_conf_soft_fake=conf(fake, soft=True),
            mean_bin_accuracy=mean([c.accuracy for c in fake]),
            mean_bin_recall=mean([c.bin_recall for c in fake]),
            mean_bin_precision=mean([c.bin_precision for c in fake]),
            mean_bin_iou=mean([c.bin_iou for c in fake]),
            mean_bin_dice=mean([c.bin_dice for c in fake]),
            mean_bin_f1=mean([c.bin_f1 for c in fake]),
            mean_soft_iou=mean([c.soft_iou for c in fake]),
        )
