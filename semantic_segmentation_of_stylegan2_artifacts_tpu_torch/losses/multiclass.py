"""Multi-label Dynamic loss for ``NUM_CLASSES > 1`` (counterpart of the
JAX package's ``losses/multiclass.py``): each class channel is its own
binary problem, Tversky applies to the (sample, class) pairs whose mask
is non-empty.  Logits and targets ``(B, H, W, C)``.  ``per_class_dice``
and ``macro_dice`` come with the metrics.
"""

from __future__ import annotations

import torch

from .losses import _normalize_target, bce_with_logits, tversky_index


def _per_class(logits, targets, alpha, beta, tversky_bce_mix, smooth):
    """``(B, C)`` Dynamic losses."""
    if logits.ndim != 4 or targets.ndim != 4:
        raise ValueError(f"expected (B,H,W,C) logits/targets, got "
                         f"{tuple(logits.shape)} / {tuple(targets.shape)}")
    b, h, w, c = logits.shape
    targets = _normalize_target(targets)
    lf = logits.permute(0, 3, 1, 2).reshape(b, c, h * w)
    tf = targets.permute(0, 3, 1, 2).reshape(b, c, h * w)
    bce = bce_with_logits(lf, tf, axis=2)
    tv = 1.0 - tversky_index(torch.sigmoid(lf.float()), tf, alpha, beta, smooth, axis=2)
    has_fg = tf.sum(dim=2) != 0.0
    mixed = (1.0 - tversky_bce_mix) * bce + tversky_bce_mix * tv
    return torch.where(has_fg, mixed, bce)


def dynamic_loss_multiclass(logits, targets, alpha=0.4, beta=0.6, tversky_bce_mix=0.5,
                            smooth=1e-6):
    """Per-(sample, class) Dynamic loss, averaged over classes and batch."""
    return _per_class(logits, targets, alpha, beta, tversky_bce_mix, smooth).mean()


def dynamic_loss_multiclass_per_sample(logits, targets, alpha=0.4, beta=0.6,
                                       tversky_bce_mix=0.5, smooth=1e-6):
    """Class-averaged Dynamic loss per sample, ``(B,)``."""
    return _per_class(logits, targets, alpha, beta, tversky_bce_mix, smooth).mean(dim=1)
