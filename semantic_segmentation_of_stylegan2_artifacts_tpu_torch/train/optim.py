"""AdamW with the reference's decay/no-decay split and encoder freezing
(counterpart of the JAX package's ``train/optim.py``).

The decay rule is JAX ``decay_mask_fn`` exactly (reference
``trainer.py:129-152``): a parameter is decayed when it has more than one
dimension, has no "norm" in its name and is not a bias, so the
relative-position bias tables are decayed.  The learning rate is set per
call (the reference steps its scheduler once per epoch).

Encoder freezing (reference ``MSUNet.freeze_encoder`` /
``unfreeze_encoder``, ``model_parts.py:867-893``): a frozen encoder stage,
and with stage 0 the patch embedding, gets ``requires_grad=False`` and is
left out of the optimizer, so it gets no update and no decay (what
``optax.set_to_zero`` gives in JAX).  :func:`unfreeze` adds a stage back as
new parameter groups: the parameters already trained keep their moments
and per-parameter ``step``, and only the new stage starts fresh (the
reference's ``add_param_group``, ``trainer.py:252-288``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

import torch


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Parameter name -> True when weight decay applies."""
    return {name: p.ndim > 1 and "norm" not in name.lower()
            and name.rsplit(".", 1)[-1] != "bias"
            for name, p in model.named_parameters()}


def frozen_mask(model: torch.nn.Module, frozen_stages: Iterable[int],
                freeze_patch_embed: bool) -> Dict[str, bool]:
    """Parameter name -> True when it belongs to a frozen encoder stage
    (``layers.<i>``; decoders and cent decoders are never frozen) or is the
    patch embedding and ``freeze_patch_embed`` is set."""
    frozen_stages = set(frozen_stages)

    def frozen(name: str) -> bool:
        parts = name.split(".")
        if freeze_patch_embed and "patch_embed" in parts:
            return True
        return any(p == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit()
                   and int(parts[i + 1]) in frozen_stages for i, p in enumerate(parts))

    return {name: frozen(name) for name, _ in model.named_parameters()}


def _groups(config, model: torch.nn.Module, names: Set[str]) -> List[dict]:
    """The decay and no-decay groups of the parameters ``names``."""
    mask = decay_mask(model)
    params = [(n, p) for n, p in model.named_parameters() if n in names]
    return [{"params": [p for n, p in params if mask[n]],
             "weight_decay": float(config.TRAIN.WEIGHT_DECAY)},
            {"params": [p for n, p in params if not mask[n]], "weight_decay": 0.0}]


def build_optimizer(config, model: torch.nn.Module,
                    frozen_stages: Optional[Set[int]] = None,
                    freeze_patch_embed: Optional[bool] = None) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over two groups, decay and no decay, with
    ``TRAIN.OPTIMIZER.BETAS/EPS``, ``TRAIN.WEIGHT_DECAY`` and
    ``TRAIN.BASE_LR`` as the first learning rate.  The parameters of
    ``frozen_stages`` (and the patch embedding, by default with stage 0)
    are frozen and left out."""
    frozen_stages = set(frozen_stages or ())
    if freeze_patch_embed is None:
        freeze_patch_embed = 0 in frozen_stages
    frozen = frozen_mask(model, frozen_stages, freeze_patch_embed)
    for name, p in model.named_parameters():
        p.requires_grad_(not frozen[name])
    betas = tuple(float(b) for b in config.TRAIN.OPTIMIZER.BETAS)
    return torch.optim.AdamW(
        _groups(config, model, {n for n, f in frozen.items() if not f}),
        lr=float(config.TRAIN.BASE_LR), betas=betas,
        eps=float(config.TRAIN.OPTIMIZER.EPS))


def unfreeze(optimizer: torch.optim.Optimizer, config, model: torch.nn.Module,
             frozen_stages: Set[int], freeze_patch_embed: Optional[bool] = None) -> None:
    """Unfreeze every parameter that ``frozen_stages`` no longer covers and
    add it to ``optimizer`` as new groups with fresh state; the groups and
    state already there are kept."""
    if freeze_patch_embed is None:
        freeze_patch_embed = 0 in frozen_stages
    frozen = frozen_mask(model, frozen_stages, freeze_patch_embed)
    new = {n for n, p in model.named_parameters() if not frozen[n] and not p.requires_grad}
    lr = current_learning_rate(optimizer)
    for name, p in model.named_parameters():
        if name in new:
            p.requires_grad_(True)
    for group in _groups(config, model, new):
        if group["params"]:
            optimizer.add_param_group({**group, "lr": lr})


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
