"""Seeded weights, made on the device in one draw, handed by name to the
program and to the reference alike.

One uniform draw covers every parameter, in the order of the
architecture's ``param_shapes``; each leaf maps its slice, as a truncated
normal (std 0.02, cut at 2 std, by the inverse CDF) or as uniform in
``[-1, 1)``, by its architecture's ``draw_leaf`` rule.  The MS-UNet's rule
(:func:`draw_leaf`): the truncated normal for the linear weights, the
relative-position bias tables and every bias; ``1 + `` that for the
LayerNorm gains; uniform in ``+-1/sqrt(fan_in)`` for the conv weights.
Biases and gains are drawn, not zero and one, so the comparison sees the
paths they take.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

_LO = 0.5 * (1 + math.erf(-math.sqrt(2)))
_HI = 0.5 * (1 + math.erf(math.sqrt(2)))
_STD = 0.02 / 0.87962566103423978  # truncation at +-2 leaves 0.8796 of the std


def draw_leaf(name: str, shape: tuple, normal: torch.Tensor,
              uniform: torch.Tensor) -> torch.Tensor:
    """The MS-UNet's leaf from its slices of the draw (flat, one number an
    element): ``normal`` the truncated normal, ``uniform`` in ``[-1, 1)``."""
    if len(shape) == 4:
        return uniform / math.sqrt(shape[1] * shape[2] * shape[3])
    if name.rsplit(".", 1)[-1] == "weight" and len(shape) == 1:
        return 1.0 + normal
    return normal


@torch.no_grad()
def make(shapes: List[Tuple[str, tuple]], seed: int, device,
         leaf: Callable) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from ``seed``; ``leaf``, the
    architecture's ``draw_leaf``, maps each parameter's slices
    (:func:`draw_leaf`'s arguments)."""
    sizes = [math.prod(s) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float64)
    normal = (torch.special.ndtri(_LO + u * (_HI - _LO)) * _STD).float()
    uniform = (u * 2 - 1).float()
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        w = leaf(name, tuple(shape), normal[at:at + n], uniform[at:at + n])
        out[name] = w.reshape(shape).clone()
        at += n
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters by name; the two sets of
    names and shapes have to agree exactly."""
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        missing, extra = sorted(set(named) - set(weights)), sorted(set(weights) - set(named))
        raise ValueError(f"parameters differ: program has {missing[:4]}, "
                         f"reference has {extra[:4]}")
    for name, p in named.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, "
                             f"reference {tuple(weights[name].shape)}")
        p.copy_(weights[name])
