"""AdamW with the reference's decay/no-decay split (counterpart of the JAX
package's ``train/optim.py``).

The decay rule is JAX ``decay_mask_fn`` exactly (reference
``trainer.py:129-152``): a parameter is decayed when it has more than one
dimension, has no "norm" in its name and is not a bias, so the
relative-position bias tables are decayed.  The learning rate is set per
call (the reference steps its scheduler once per epoch).  Encoder
freezing (``freeze_labels``) and carrying optimizer state across a
freeze-set rebuild (``carry_opt_state``) come with the trainer.
"""

from __future__ import annotations

from typing import Dict

import torch


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> True when weight decay applies."""
    return {name: p.ndim > 1 and "norm" not in name.lower()
            and name.rsplit(".", 1)[-1] != "bias"
            for name, p in model.named_parameters()}


def build_optimizer(config, model: torch.nn.Module) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over two groups, decay and no decay, with
    ``TRAIN.OPTIMIZER.BETAS/EPS``, ``TRAIN.WEIGHT_DECAY`` and
    ``TRAIN.BASE_LR`` as the first learning rate."""
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    decay = [p for n, p in params.items() if mask[n]]
    no_decay = [p for n, p in params.items() if not mask[n]]
    betas = tuple(float(b) for b in config.TRAIN.OPTIMIZER.BETAS)
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": float(config.TRAIN.WEIGHT_DECAY)},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=float(config.TRAIN.BASE_LR), betas=betas,
        eps=float(config.TRAIN.OPTIMIZER.EPS))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
