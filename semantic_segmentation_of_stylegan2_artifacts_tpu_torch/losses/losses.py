"""Segmentation losses as batch-vectorised reductions (PyTorch).

Counterpart of the JAX package's ``losses/losses.py`` (reference
``loss/DynamicLoss.py``, ``loss/TverskyLoss.py`` and the Symmetric
Unified Focal loss): the Dynamic loss's "Tversky only when the mask is
non-empty" rule is a ``torch.where`` over per-sample reductions.  Every
reduction runs in float32.

Shapes: logits ``(B, H, W)`` or ``(B, H, W, 1)``; targets likewise (float
{0,1} or uint8 {0,255}, normalised as the reference does: ``target >
127.5`` when the max exceeds 1).
"""

from __future__ import annotations

import torch


def _flatten_per_sample(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _squeeze_channel(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.ndim == 4 and x.shape[-1] == 1 else x


def _normalize_target(target: torch.Tensor) -> torch.Tensor:
    target = target.float()
    return torch.where(target.max() > 1.0, (target > 127.5).float(), target)


def bce_with_logits(logits, targets, axis=None):
    """Mean BCE with logits, ``max(x,0) - x*y + log1p(exp(-|x|))``."""
    x, y = logits.float(), targets.float()
    loss = torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return loss.mean() if axis is None else loss.mean(dim=axis)


def _sum(x, axis):
    return x.sum() if axis is None else x.sum(dim=axis)


def tversky_index(probs, targets, alpha, beta, smooth=1e-6, axis=None):
    """``TI = (TP+s) / (TP + a*FP + b*FN + s)`` over the given axes."""
    p, t = probs.float(), targets.float()
    tp = _sum(p * t, axis)
    fp = _sum(p * (1.0 - t), axis)
    fn = _sum((1.0 - p) * t, axis)
    return (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


def tversky_loss(logits, targets, alpha=0.7, beta=0.3, smooth=1e-6, axis=None):
    """``1 - TI`` on sigmoid probabilities."""
    return 1.0 - tversky_index(torch.sigmoid(logits.float()), targets, alpha, beta,
                               smooth, axis)


def focal_tversky_loss(logits, targets, alpha=0.7, beta=0.3, gamma=1.1, smooth=1e-6,
                       axis=None):
    """``(1 - TI)**gamma``."""
    return tversky_loss(logits, targets, alpha, beta, smooth, axis) ** gamma


def dynamic_loss_per_sample(logits, targets, alpha=0.4, beta=0.6,
                            tversky_bce_mix=0.5, smooth=1e-6):
    """Per-sample Dynamic losses, ``(B,)``."""
    targets = _normalize_target(_squeeze_channel(targets))
    lf = _flatten_per_sample(_squeeze_channel(logits))
    tf = _flatten_per_sample(targets)
    bce = bce_with_logits(lf, tf, axis=1)
    tv = 1.0 - tversky_index(torch.sigmoid(lf.float()), tf, alpha, beta, smooth, axis=1)
    has_fg = tf.sum(dim=1) != 0.0
    mixed = (1.0 - tversky_bce_mix) * bce + tversky_bce_mix * tv
    return torch.where(has_fg, mixed, bce)


def dynamic_loss(logits, targets, alpha=0.4, beta=0.6, tversky_bce_mix=0.5,
                 smooth=1e-6):
    """The reference's DynamicLoss: per sample, mean BCE, mixed with
    ``1 - TI`` when the mask is non-empty; batch mean."""
    return dynamic_loss_per_sample(logits, targets, alpha, beta, tversky_bce_mix,
                                   smooth).mean()


def symmetric_unified_focal_loss(logits, targets, delta=0.6, gamma=0.5, weight=0.5,
                                 smooth=1e-6):
    """Symmetric Unified Focal loss (Yeung et al. 2021):
    ``weight * L_msFL + (1-weight) * L_msFTL``."""
    t = _normalize_target(_squeeze_channel(targets))
    p = torch.sigmoid(_squeeze_channel(logits).float()).clamp(1e-7, 1.0 - 1e-7)
    ce_fg = -t * torch.log(p)
    ce_bg = -(1.0 - t) * torch.log(1.0 - p)
    fl = (delta * (1.0 - p) ** gamma * ce_fg + (1.0 - delta) * p ** gamma * ce_bg).mean()
    pf, tf = _flatten_per_sample(p), _flatten_per_sample(t)
    ti_fg = tversky_index(pf, tf, 1.0 - delta, delta, smooth, axis=1)
    ti_bg = tversky_index(1.0 - pf, 1.0 - tf, 1.0 - delta, delta, smooth, axis=1)
    ftl = ((1.0 - ti_fg) ** (1.0 - gamma) + (1.0 - ti_bg) ** (1.0 - gamma)).mean()
    return weight * fl + (1.0 - weight) * ftl

