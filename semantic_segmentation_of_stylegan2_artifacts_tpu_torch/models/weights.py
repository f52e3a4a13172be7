"""Weight bridge: the JAX package's params tree <-> the port's state dict.

The JAX tree is ``{'msunet': {...}}`` of numpy arrays (flax naming:
``layers_0/blocks_1/attn/qkv/kernel``); the port's state dict uses the
reference PyTorch keys of ``MSUNetSys`` (``layers.0.blocks.1.attn.qkv.weight``).
The key map and the layout transforms are the port's own copy of the
JAX package's ``models/weight_convert.py:33-99`` (``torch_key_to_flax_path``
and ``_apply_transform``) and their inverse: Linear ``(in, out) <->
(out, in)``, conv HWIO <-> OIHW (patch embed, refine convs, the 1x1
``output``), LayerNorm ``scale`` <-> ``weight``.  ``relative_position_index``
and ``attn_mask`` are buffers of the reference, not parameters, and are
skipped.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LISTS = ("layers", "layers_up", "layers_cent1", "layers_cent2", "concat_back_dim",
          "blocks")
_LIST_ITEM = re.compile(r"^(%s)_(\d+)$" % "|".join(_LISTS))
_CONV_MODULES = ("refine1", "refine2", "output")


def torch_key_to_flax_path(key: str) -> Optional[Tuple[Tuple[str, ...], str]]:
    """One reference key -> (flax path, transform in {linear_t, conv_t, copy});
    None for buffers with no flax counterpart."""
    if key.endswith("relative_position_index") or key.endswith("attn_mask"):
        return None
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in _LISTS and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
            continue
        if p == "mlp" and i + 1 < len(parts) and parts[i + 1] in ("0", "3"):
            out += ["mlp", "fc1" if parts[i + 1] == "0" else "fc2"]
            i += 2
            continue
        out.append(p)
        i += 1
    leaf, module_path = out[-1], out[:-1]
    mod = module_path[-1] if module_path else ""
    if leaf == "weight":
        if mod.startswith("norm"):
            return tuple(module_path + ["scale"]), "copy"
        if mod in _CONV_MODULES or (mod == "proj" and "patch_embed" in module_path):
            return tuple(module_path + ["kernel"]), "conv_t"
        return tuple(module_path + ["kernel"]), "linear_t"
    return tuple(out), "copy"


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """Inverse of :func:`torch_key_to_flax_path` (the path without 'msunet')."""
    parts = []
    for i, p in enumerate(path):
        m = _LIST_ITEM.match(p)
        if m:
            parts += [m.group(1), m.group(2)]
        elif p in ("fc1", "fc2") and i and path[i - 1] == "mlp":
            parts.append("0" if p == "fc1" else "3")
        elif p in ("scale", "kernel") and i == len(path) - 1:
            parts.append("weight")
        else:
            parts.append(p)
    return ".".join(parts)


def _to_flax(value: np.ndarray, transform: str) -> np.ndarray:
    if transform == "linear_t":
        return np.ascontiguousarray(value.T)
    if transform == "conv_t":  # (out, in, kh, kw) -> (kh, kw, in, out)
        return np.ascontiguousarray(value.transpose(2, 3, 1, 0))
    return value


def _from_flax(value: np.ndarray, transform: str) -> np.ndarray:
    if transform == "linear_t":
        return np.ascontiguousarray(value.T)
    if transform == "conv_t":  # (kh, kw, in, out) -> (out, in, kh, kw)
        return np.ascontiguousarray(value.transpose(3, 2, 0, 1))
    return value


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params ``{'msunet': ...}`` -> a state dict for ``MSUNetSys``."""
    sd = {}
    for path, value in _flatten(params["msunet"]).items():
        key = flax_path_to_torch_key(path)
        mapped = torch_key_to_flax_path(key)
        if mapped is None or mapped[0] != path:
            raise KeyError(f"no reference key for flax path {'/'.join(path)}")
        sd[key] = torch.from_numpy(_from_flax(np.asarray(value), mapped[1]).copy())
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A ``MSUNetSys`` (or reference, prefix stripped) state dict -> the JAX
    params tree ``{'msunet': ...}`` of numpy arrays."""
    tree: Dict = {}
    for key, value in state_dict.items():
        mapped = torch_key_to_flax_path(key)
        if mapped is None:
            continue
        path, transform = mapped
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax(value.detach().cpu().numpy(), transform)
    return {"msunet": tree}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth``/``.pt`` -> a ``MSUNetSys`` state dict: unwraps a
    ``model``/``state_dict`` payload, strips the trainer's ``ms_unet.``
    prefix (``cli/predict_cli.py:80-81`` of the JAX package), drops buffers."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict):
        for key in ("model", "state_dict"):
            if isinstance(payload.get(key), dict):
                payload = payload[key]
                break
    sd = {}
    for k, v in payload.items():
        if not torch.is_tensor(v) or torch_key_to_flax_path(k) is None:
            continue
        sd[k[len("ms_unet."):] if k.startswith("ms_unet.") else k] = v
    return sd
