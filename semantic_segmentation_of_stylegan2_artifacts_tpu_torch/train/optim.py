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

:func:`to_optax` and :func:`load_optax` carry the state across packages:
the optax state of JAX ``build_optimizer`` (``inject_hyperparams(adamw)``,
wrapped in ``multi_transform`` while an encoder stage is frozen) as
``flax.serialization.to_state_dict`` lays it out, the form of the orbax
``epoch_N.orbax`` checkpoints.  ``mu`` / ``nu`` are ``exp_avg`` /
``exp_avg_sq`` through the weights' transposes (``models/weights.py``),
``count`` is AdamW's ``step``.  optax keeps one count; after a staged
unfreeze the port's newer groups count fewer steps (ROADMAP.md: "Adam's step
after an unfreeze"), so :func:`to_optax` writes the largest step, that of
the parameters trained from the start, and :func:`load_optax` gives every
parameter the one count.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

import numpy as np
import torch

from ..models.weights import flax_to_state_dict, state_dict_to_flax, torch_key_to_flax_path


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


def _trained(optimizer: torch.optim.Optimizer, model: torch.nn.Module):
    """(name, parameter) of ``model``'s network in ``optimizer``, and the
    names it leaves out (the frozen ones)."""
    sys = getattr(model, "ms_unet", model)
    in_opt = {id(p) for g in optimizer.param_groups for p in g["params"]}
    named = list(sys.named_parameters())
    return ([(n, p) for n, p in named if id(p) in in_opt],
            [n for n, p in named if id(p) not in in_opt])


def to_optax(optimizer: torch.optim.AdamW, model: torch.nn.Module) -> Dict:
    """``optimizer``'s state as the optax state dict of JAX
    ``build_optimizer`` for the same frozen set (numpy leaves, copied; an
    empty dict where optax masks a frozen parameter)."""
    trained, frozen = _trained(optimizer, model)
    steps = [float(st["step"]) for st in optimizer.state.values() if "step" in st]
    count = np.asarray(int(max(steps, default=0)), np.int32)
    moments = {}
    for slot in ("exp_avg", "exp_avg_sq"):
        tree = state_dict_to_flax({  # copies: the next step changes the moments
            n: optimizer.state.get(p, {}).get(slot, torch.zeros_like(p)) for n, p in trained})
        for name in frozen:
            node = tree["msunet"]
            path = torch_key_to_flax_path(name)[0]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = {}
        moments[slot] = tree
    g0 = optimizer.param_groups[0]
    hyper = {"learning_rate": g0["lr"], "b1": g0["betas"][0], "b2": g0["betas"][1],
             "eps": g0["eps"], "eps_root": 0.0,
             "weight_decay": max(g["weight_decay"] for g in optimizer.param_groups)}
    inner = {"count": count,
             "hyperparams": {k: np.asarray(v, np.float32) for k, v in hyper.items()},
             "hyperparams_states": {},
             "inner_state": {"0": {"count": count, "mu": moments["exp_avg"],
                                   "nu": moments["exp_avg_sq"]},
                             "1": {"inner_state": {}}, "2": {}}}
    if not frozen:
        return inner
    return {"inner_states": {"frozen": {"inner_state": {}},
                             "trainable": {"inner_state": inner}}}


def load_optax(optimizer: torch.optim.AdamW, model: torch.nn.Module, tree: Dict,
               source: str = "optimizer state") -> None:
    """Set ``optimizer``'s moments, steps and learning rate from the optax
    state dict ``tree`` (:func:`to_optax`'s layout, of either package).
    ``ValueError`` when its parameters are not those ``optimizer`` trains."""
    try:
        inner = tree["inner_states"]["trainable"]["inner_state"] \
            if "inner_states" in tree else tree
        adam = inner["inner_state"]["0"]
        count = int(adam["count"])
        lr = float(inner["hyperparams"]["learning_rate"])
        mu, nu = flax_to_state_dict(adam["mu"]), flax_to_state_dict(adam["nu"])
    except (KeyError, TypeError) as e:
        raise ValueError(f"{source}: not the optax state of build_optimizer "
                         f"(no {e})") from e
    trained, _ = _trained(optimizer, model)
    want = {n for n, _ in trained}
    for got in (mu, nu):
        if set(got) != want:
            missing, extra = sorted(want - set(got)), sorted(set(got) - want)
            raise ValueError(
                f"{source}: Adam moments for {len(got)} parameters, the optimizer trains "
                f"{len(want)} (missing {missing[:3]}, extra {extra[:3]}): the frozen "
                "stages differ")
    for name, p in trained:
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"{source}: {name} moments of shape {tuple(mu[name].shape)}, "
                             f"the parameter is {tuple(p.shape)}")
        optimizer.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": mu[name].to(p.device, p.dtype),
                              "exp_avg_sq": nu[name].to(p.device, p.dtype)}
    set_learning_rate(optimizer, lr)
