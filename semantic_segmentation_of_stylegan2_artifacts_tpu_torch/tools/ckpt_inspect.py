"""Checkpoint key and shape inspection (counterpart of the JAX package's
``tools/ckpt_inspect.py``; reference ``network/pretrained_weights`` tooling:
``short_look.py``, ``short_look_IMAGNET1K.py``, ``txt_to_excel.py``).

Dumps the parameter naming contract of a checkpoint, the files that
``train/checkpoint.py::load_best_state_dict`` reads, as they are on disk:
a JAX ``.msgpack`` tree (``train/checkpoint.py::read_msgpack``) or a torch
``.pt``/``.pth`` payload (its ``state_dict_backbone`` / ``model`` /
``state_dict`` entry when it has one), and diffs two dumps by shape into
the key table the converters rely on.  The dump and the diff equal the
JAX tool's.

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.ckpt_inspect \\
        CKPT [--out FILE] [--diff CKPT2]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..train.checkpoint import read_msgpack


def _flatten(tree, prefix="") -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}.{k}" if prefix else str(k))
    elif hasattr(tree, "shape"):
        out.append((prefix, tuple(tree.shape)))
    return out


def load_any(path: str) -> Dict:
    """The tree of a checkpoint: a flat dict of tensors for ``.pt``/``.pth``,
    the nested msgpack tree otherwise."""
    if path.endswith((".pt", ".pth")):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(payload, dict):
            for key in ("state_dict_backbone", "model", "state_dict"):
                if isinstance(payload.get(key), dict):
                    payload = payload[key]
                    break
        return {k: v for k, v in payload.items() if hasattr(v, "shape")}
    return read_msgpack(path)


def dump_keys(path: str) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(key, shape)`` rows, sorted; nested keys joined with dots."""
    tree = load_any(path)
    if all(not isinstance(v, dict) for v in tree.values()):
        return [(k, tuple(np.shape(v))) for k, v in sorted(tree.items())
                if hasattr(v, "shape")]
    return _flatten(tree)


def diff_dumps(a: List[Tuple[str, Tuple[int, ...]]],
               b: List[Tuple[str, Tuple[int, ...]]]) -> Dict[str, List[str]]:
    """Each key of ``a`` -> the keys of ``b`` with its shape."""
    by_shape: Dict[Tuple[int, ...], List[str]] = {}
    for k, s in b:
        by_shape.setdefault(s, []).append(k)
    return {k: by_shape.get(s, []) for k, s in a}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--out", default=None, help="write key table to file")
    ap.add_argument("--diff", default=None,
                    help="second checkpoint: print shape-matched candidates")
    args = ap.parse_args(argv)
    rows = dump_keys(args.ckpt)
    text = "\n".join(f"{k} {list(s)}" for k, s in rows)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"{len(rows)} keys -> {args.out}")
    else:
        print(text)
    if args.diff:
        for k, cands in diff_dumps(rows, dump_keys(args.diff)).items():
            print(f"{k} -> {cands[:3]}")


if __name__ == "__main__":
    main()
