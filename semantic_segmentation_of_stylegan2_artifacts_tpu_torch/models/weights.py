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

Also the encoder pretrain (``MODEL.PRETRAIN_WEIGHTS``): the SegFace and
torchvision ImageNet-1k key tables of the JAX package's
``models/weight_convert.py:180-243``, copied into an ``MSUNetSys`` in place.
"""

from __future__ import annotations

import os
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


def _to_flax(value: torch.Tensor, transform: str) -> torch.Tensor:
    if transform == "linear_t":
        return value.t()
    if transform == "conv_t":  # (out, in, kh, kw) -> (kh, kw, in, out)
        return value.permute(2, 3, 1, 0)
    return value


def _from_flax(value: np.ndarray, transform: str) -> np.ndarray:
    if transform == "linear_t":
        return np.ascontiguousarray(value.T)
    if transform == "conv_t":  # (kh, kw, in, out) -> (out, in, kh, kw)
        return np.ascontiguousarray(value.transpose(3, 2, 0, 1))
    return value


def _from_flax_tensor(value: torch.Tensor, transform: str) -> torch.Tensor:
    if transform == "linear_t":
        return value.t().contiguous()
    if transform == "conv_t":
        return value.permute(3, 2, 0, 1).contiguous()
    return value.clone()


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params ``{'msunet': ...}`` (numpy or tensor leaves) -> a state
    dict for ``MSUNetSys``."""
    sd = {}
    for path, value in _flatten(params["msunet"]).items():
        key = flax_path_to_torch_key(path)
        mapped = torch_key_to_flax_path(key)
        if mapped is None or mapped[0] != path:
            raise KeyError(f"no reference key for flax path {'/'.join(path)}")
        if torch.is_tensor(value):  # the orbax reader's leaves
            sd[key] = _from_flax_tensor(value, mapped[1])
        else:
            sd[key] = torch.from_numpy(_from_flax(np.asarray(value), mapped[1]).copy())
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """A ``MSUNetSys`` (or reference, prefix stripped) state dict -> the JAX
    params tree ``{'msunet': ...}`` of numpy arrays, copies in host memory
    (laid out on the tensors' device first: the card transposes fast)."""
    tree: Dict = {}
    for key, value in state_dict.items():
        mapped = torch_key_to_flax_path(key)
        if mapped is None:
            continue
        path, transform = mapped
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax(value.detach(), transform).contiguous().to(
            "cpu", copy=True).numpy()
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


# Encoder-pretrain key tables (reference MSUNet.py:86-122, 169-199)
_SEGFACE_PREFIX_MAP = [
    ("backbone.0.0.0.", "patch_embed.proj."),
    ("backbone.0.0.2.", "patch_embed.norm."),
    ("backbone.0.1.0.", "layers.0.blocks.0."),
    ("backbone.0.1.1.", "layers.0.blocks.1."),
    ("backbone.0.2.", "layers.0.downsample."),
    ("backbone.0.3.0.", "layers.1.blocks.0."),
    ("backbone.0.3.1.", "layers.1.blocks.1."),
    ("backbone.0.4.", "layers.1.downsample."),
    *[(f"backbone.0.5.{i}.", f"layers.2.blocks.{i}.") for i in range(18)],
    ("backbone.0.6.", "layers.2.downsample."),
    ("backbone.0.7.0.", "layers.3.blocks.0."),
    ("backbone.0.7.1.", "layers.3.blocks.1."),
]
_IMAGENET1K_PREFIX_MAP = [
    ("features.0.0.", "patch_embed.proj."),
    ("features.0.2.", "patch_embed.norm."),
    ("features.1.0.", "layers.0.blocks.0."),
    ("features.1.1.", "layers.0.blocks.1."),
    ("features.2.", "layers.0.downsample."),
    ("features.3.0.", "layers.1.blocks.0."),
    ("features.3.1.", "layers.1.blocks.1."),
    ("features.4.", "layers.1.downsample."),
    *[(f"features.5.{i}.", f"layers.2.blocks.{i}.") for i in range(18)],
    ("features.6.", "layers.2.downsample."),
    ("features.7.0.", "layers.3.blocks.0."),
    ("features.7.1.", "layers.3.blocks.1."),
]


def remap_encoder_keys(state_dict: Mapping, kind: str) -> Dict:
    """SegFace (``backbone.0.*``) or torchvision ImageNet-1k (``features.*``)
    encoder keys -> the reference model's key space (the JAX package's
    ``models/weight_convert.py::remap_encoder_keys``)."""
    if kind == "segface":
        table, root = _SEGFACE_PREFIX_MAP, "backbone"
    elif kind == "imagenet1k":
        table, root = _IMAGENET1K_PREFIX_MAP, "features"
    else:
        raise ValueError(f"unknown pretrain kind: {kind}")
    # longest prefix first, so features.5.1x matches before features.5.1
    table = sorted(table, key=lambda kv: -len(kv[0]))
    out = {}
    matched_root = False
    for k, v in state_dict.items():
        if not k.startswith(root):
            continue
        matched_root = True
        if kind == "segface" and k.startswith("backbone.1."):
            continue  # the face parser's decode head (reference :117-118)
        for src, dst in table:
            if k.startswith(src):
                out[dst + k[len(src):]] = v
                break
        else:
            raise ValueError(f"Key {k} not found in dictionary!!")
    if not matched_root:
        raise ValueError("No new keys from backbone!!")
    return out


def load_pretrained_encoder(model: torch.nn.Module, ckpt_path: str, kind: str,
                            logger=None) -> int:
    """Copy a SegFace / ImageNet-1k encoder checkpoint into ``model``
    (an ``MSUNetSys``) in place; returns the number of tensors copied.

    As the reference (``MSUNet.py:65-67``), a missing file leaves the model
    unchanged, with an error logged; a shape mismatch raises."""
    if not ckpt_path or not os.path.exists(ckpt_path):
        if logger is not None:
            logger.error(f"No {kind} pretrain found at: {ckpt_path}")
        return 0
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict):
        for key in ("state_dict_backbone", "model", "state_dict"):
            if isinstance(payload.get(key), dict):
                payload = payload[key]
                break
    remapped = remap_encoder_keys(
        {k: v for k, v in payload.items() if torch.is_tensor(v)}, kind)
    own = model.state_dict()
    copied, skipped = 0, 0
    with torch.no_grad():
        for k, v in remapped.items():
            if torch_key_to_flax_path(k) is None:
                continue  # reference buffers
            if k not in own:
                skipped += 1
                continue
            if own[k].shape != v.shape:
                raise ValueError(f"Key {k} does not match: checkpoint {tuple(v.shape)} "
                                 f"vs model {tuple(own[k].shape)}")
            own[k].copy_(v)
            copied += 1
    if logger is not None:
        logger.info(f"pretrained {kind}: {copied} tensors loaded, {skipped} checkpoint "
                    "keys without model counterpart")
    return copied
