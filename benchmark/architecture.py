"""The lookup from a configuration to its architecture's plain reference,
and to everything the harness reads of that architecture.

A configuration file (``configs/<name>.json``) may name, under its
top-level key ``"reference"`` (beside ``name`` and ``source``, outside
``config``), the module that defines its architecture's plain reference: a
bare name is a module of ``benchmark/reference/``, a dotted name is
imported as it stands from the checkout's root.  Without the key it is
:data:`DEFAULT`, the Swin-V1 MS-UNet.

The module provides every part the harness reads of the architecture:

* ``Arch`` (with ``Arch.from_config(config)``, from the configuration's
  ``config``) and ``param_shapes(arch)``: every parameter's name and shape,
  in the order of the seeded draw;
* ``Net``, ``Noise`` and ``Numerics``: the forward pass over a dict of
  parameters, its training noise, and float32 or the float8 control's
  products;
* ``draw_leaf(name, shape, normal, uniform)``: one parameter from its slices
  of the seeded draw (``weights.make``);
* ``decayed(name, shape)``: whether AdamW decays the parameter
  (``reference/train.py``'s AdamW);
* ``forward_flops(config, batch)``, ``attention_ms(config, batch, train)``
  and ``head_ms(config, batch, train)``: the model's forward operations
  that ``mfu.*`` read, and the least times of the window-attention layer and
  of the head that the rooflines read;
* ``SPANS``: the port's module class names whose forward calls the
  benchmark wraps in a profiler range, and each range's name.

A module that lacks a part fails in :func:`load`.  A new architecture is
then new files under ``benchmark/``: its reference module, its
configuration, traffic and limits, and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict

from . import weights

DEFAULT = "msunet"

REQUIRED = ("Arch", "param_shapes", "Net", "Noise", "Numerics", "draw_leaf", "decayed",
            "forward_flops", "attention_ms", "head_ms", "SPANS")


@dataclass(frozen=True)
class Architecture:
    """An architecture's reference module and its parts."""

    name: str
    module: ModuleType
    Arch: type
    param_shapes: Callable
    Net: type
    Noise: type
    Numerics: type
    draw_leaf: Callable
    decayed: Callable
    forward_flops: Callable
    attention_ms: Callable
    head_ms: Callable
    spans: Dict[str, str]

    def arch(self, config: dict):
        return self.Arch.from_config(config)

    def draw(self, arch, seed: int, device) -> dict:
        """The seeded weights, name -> float32 tensor on ``device``."""
        return weights.make(self.param_shapes(arch), seed, device, self.draw_leaf)


@functools.lru_cache(maxsize=None)
def load(name: str = DEFAULT) -> Architecture:
    """The architecture whose reference module ``name`` names; raises
    ``LookupError`` where it names no module or the module lacks a
    required part."""
    mod_name = name if "." in name else f"{__package__}.reference.{name}"
    try:
        found = importlib.util.find_spec(mod_name)
    except ModuleNotFoundError:  # a package on the way is missing
        found = None
    if found is None:
        raise LookupError(f"reference {name!r} names no module ({mod_name})")
    mod = importlib.import_module(mod_name)
    missing = [k for k in REQUIRED if not hasattr(mod, k)]
    if missing:
        raise LookupError(f"reference module {mod_name} lacks {missing}")
    parts = {k: getattr(mod, k) for k in REQUIRED}
    spans = dict(parts.pop("SPANS"))
    return Architecture(name=name, module=mod, spans=spans, **parts)


def default() -> Architecture:
    return load(DEFAULT)
