"""Learning-rate schedule replicating timm's ``CosineLRScheduler`` as the
reference uses it (counterpart of the JAX package's
``train/schedule.py``; reference ``trainer.py:154-169``): stepped once
per epoch, ``t_initial = max(60, MAX_EPOCHS) - WARMUP_EPOCHS``.

* ``t < warmup_t``:   ``lr = warmup_lr + t * (base_lr - warmup_lr)/warmup_t``
* else, with prefix:  ``tt = t - warmup_t``; without: ``tt = t``;
  ``tt < t_initial``: ``lr = min_lr + 0.5*(base_lr-min_lr)*(1+cos(pi*tt/t_initial))``
  ``tt >= t_initial``: ``lr = min_lr``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CosineWarmupSchedule:
    base_lr: float
    min_lr: float
    warmup_lr: float
    warmup_t: int
    t_initial: int
    warmup_prefix: bool = True

    @classmethod
    def from_config(cls, config, base_lr=None) -> "CosineWarmupSchedule":
        warmup = config.TRAIN.WARMUP_EPOCHS
        return cls(
            base_lr=base_lr if base_lr is not None else config.TRAIN.BASE_LR,
            min_lr=config.TRAIN.MIN_LR,
            warmup_lr=config.TRAIN.WARMUP_LR,
            warmup_t=warmup,
            t_initial=max(60, config.TRAIN.MAX_EPOCHS) - warmup,
            warmup_prefix=bool(config.TRAIN.LR_SCHEDULER.WARMUP_PREFIX),
        )

    def lr_at_epoch(self, epoch: int) -> float:
        t = epoch
        if self.warmup_t > 0 and t < self.warmup_t:
            step = (self.base_lr - self.warmup_lr) / self.warmup_t
            return self.warmup_lr + t * step
        tt = t - self.warmup_t if self.warmup_prefix else t
        if self.t_initial <= 0 or tt >= self.t_initial:
            return self.min_lr
        return self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
            1.0 + math.cos(math.pi * tt / self.t_initial))
