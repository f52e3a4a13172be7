"""orbax checkpoint directories (the JAX package's ``TPU.CKPT_BACKEND:
orbax``, its ``StandardCheckpointer``), read and written without orbax or
TensorStore.

A directory holds ``_CHECKPOINT_METADATA`` (the handler and timestamps; a
directory without it is not a checkpoint), ``_METADATA`` (the tree: each
leaf's key path and value type) and an OCDBT store (``train/ocdbt.py``) of
zarr v2 arrays (``train/zarr.py``), one a leaf, named by the key path
joined with ``.``.  Value types: ``scalar`` (a 0-d array, read back as a
Python number), ``np.ndarray`` / ``jax.Array`` (an array) and ``Dict`` with
``skip_deserialize`` (an empty dict: optax's masked and empty states).

:func:`save` writes what the JAX package's asynchronous writer writes for
the same tree (``np.ndarray`` leaves, no ``_sharding``), uncompressed, into
a temporary directory that it renames onto the target at the end, as orbax
commits; :func:`restore` reads a directory of either package.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import ocdbt, zarr

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


def is_checkpoint(path) -> bool:
    """True when ``path`` is a committed orbax checkpoint directory."""
    return os.path.isfile(os.path.join(path, CHECKPOINT_METADATA))


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in orbax's order; an empty dict is a leaf."""
    if isinstance(tree, dict) and tree:
        out = []
        for k in sorted(tree, key=str):
            out += _leaves(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _as_tensor(value: Any) -> torch.Tensor:
    if torch.is_tensor(value):
        return value
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.asarray(value, order="C"))  # keeps 0-d arrays 0-d
    raise TypeError(f"not an array: {type(value).__name__}")


def save(path, tree: Dict) -> str:
    """Write ``tree`` (nested dicts of tensors or numpy arrays, Python ints
    and floats, empty dicts) as the orbax checkpoint ``path``, replacing
    one that is there."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.orbax-checkpoint-tmp-{os.getpid()}-{time.time_ns()}")
    init = time.time_ns()
    tmp.mkdir()
    try:
        items, meta = [], {}
        for keys, leaf in _leaves(tree):
            entry = {"key_metadata": [{"key": k, "key_type": 2} for k in keys]}
            if isinstance(leaf, dict):
                entry["value_metadata"] = {"value_type": "Dict", "skip_deserialize": True}
            elif isinstance(leaf, (bool, int, float, np.integer, np.floating)):
                is_int = isinstance(leaf, (bool, int, np.integer))
                entry["value_metadata"] = {"value_type": "scalar", "skip_deserialize": False}
                items += zarr.encode(".".join(keys), torch.tensor(
                    int(leaf) if is_int else float(leaf),
                    dtype=torch.int64 if is_int else torch.float64))
            else:
                entry["value_metadata"] = {"value_type": "np.ndarray",
                                           "skip_deserialize": False}
                items += zarr.encode(".".join(keys), _as_tensor(leaf))
            meta[str(keys)] = entry
        ocdbt.write_store(tmp, items)
        (tmp / "_METADATA").write_text(json.dumps({
            "tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
        (tmp / CHECKPOINT_METADATA).write_text(json.dumps({
            "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}))
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(path)


def restore(path) -> Dict:
    """The tree of the orbax checkpoint ``path``: nested dicts of CPU
    tensors, Python numbers for scalars, empty dicts for empty nodes."""
    path = Path(path)
    if not is_checkpoint(path):
        raise FileNotFoundError(f"{path}: not an orbax checkpoint (no {CHECKPOINT_METADATA})")
    meta = json.loads((path / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}/_METADATA: zarr3 arrays are not supported")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}/_METADATA: only OCDBT checkpoints are supported")
    store = ocdbt.Store(path)
    tree: Dict = {}
    for name, entry in meta["tree_metadata"].items():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        vm = entry["value_metadata"]
        kind = vm.get("value_type")
        if vm.get("skip_deserialize"):
            if kind != "Dict":
                raise ValueError(f"{path}/_METADATA: {name} skipped, of type {kind!r}")
            value = {}
        elif kind == "scalar":
            value = zarr.read_array(store, ".".join(keys)).item()
        elif kind in ("np.ndarray", "jax.Array"):
            value = zarr.read_array(store, ".".join(keys))
        else:
            raise ValueError(f"{path}/_METADATA: {name} of type {kind!r} is not supported")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree
