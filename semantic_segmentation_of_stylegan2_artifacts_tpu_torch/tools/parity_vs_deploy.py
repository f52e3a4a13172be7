"""Deployment-vs-parity numerics A/B on the card (counterpart of the JAX
package's ``tools/parity_vs_deploy.py``).

Trains the synthetic-data config twice with identical seeds and data
through the port's trainer:

  parity  -- erf GELU, float32 compute and softmax, every kernel knob off
  deploy  -- the shipped deployment defaults: bfloat16 compute, tanh GELU,
             bfloat16 softmax, the attention, refine-head and patch kernels

and prints the final-epoch validation metric rows and their deltas (the
JAX package's table is ``PARITY.md``).  ``--deploy_f32`` keeps the deploy
arm in float32 (the kernels, GELU and softmax without the bfloat16 cast);
``--no-fused_patch`` leaves the patch kernels out of it.

Usage::

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.parity_vs_deploy \\
        --img 512 --epochs 15 [--no-fused_patch] [--deploy_f32] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import shutil
import sys
import tempfile
from typing import Dict, Optional

import torch

# the JAX tool's model: Swin-B widths at depths 2/2/2/2
MODEL = dict(embed_dim=128, depths=(2, 2, 2, 2), num_heads=(4, 8, 16, 32), window_size=7)
SPLIT = dict(n_fake_train=12, n_real_train=8, n_val_fake=4, n_val_real=2)


def run_one(tag: str, root: str, out_base: str, deploy: bool, args,
            model_kw: Optional[Dict] = None) -> Dict[str, str]:
    """Train one arm on the split at ``root`` into ``out_base/tag`` from the
    weights ``SEED`` gives (JAX's trainer initialises from it too); returns
    the final row of its ``val_metric_all_epoch.csv`` (column -> cell).
    ``args`` has ``img``, ``epochs``, ``fused_patch``, ``deploy_f32`` and
    ``device``; ``model_kw`` replaces :data:`MODEL`."""
    from ..core.config import default_config
    from ..models.msunet import MSUNet, init_weights
    from ..train.trainer import trainer

    c = default_config()
    c.DATA.DATA_PATH = root
    c.DATA.IMG_SIZE = args.img
    c.DATA.BATCH_SIZE = 4
    c.LIST_DIR = os.path.join(root, "lists")
    c.TRAIN.MAX_EPOCHS = args.epochs
    c.TRAIN.WARMUP_EPOCHS = 2
    c.TRAIN.BASE_LR = 3e-4
    c.MODEL.FREEZE_ENCODER = False
    c.SAVE_BEST_RUN = False
    c.SHOW_PREDICTIONS = 0
    c.DATA.NUM_WORKERS = 2
    c.SEED = 1234
    c.TPU.GELU_TANH = deploy
    c.TPU.SOFTMAX_DTYPE = "bfloat16" if deploy else "float32"
    c.TPU.USE_PALLAS_ATTENTION = deploy
    c.TPU.FUSED_HEAD = deploy
    c.TPU.FUSED_PATCH = deploy and args.fused_patch
    c.freeze()

    dtype = torch.float32 if (not deploy or args.deploy_f32) else torch.bfloat16
    model = MSUNet(img_size=args.img, **(model_kw or MODEL), gelu_tanh=deploy,
                   fused_attention=deploy, fused_head=deploy,
                   fused_patch=deploy and args.fused_patch, dtype=dtype,
                   softmax_dtype=torch.bfloat16 if deploy else torch.float32)
    init_weights(model, int(c.SEED))  # both arms start from the same weights
    out_dir = os.path.join(out_base, tag)
    res = trainer(model, logging.getLogger(tag), None, out_dir, c, device=args.device)
    print(tag, "->", res, flush=True)
    with open(os.path.join(out_dir, "val_metric_all_epoch.csv")) as f:
        r = list(csv.reader(f))
    rows = dict(zip(r[0], r[-1]))
    print(tag, "final:", rows, flush=True)
    return rows


def print_deltas(a: Dict[str, str], b: Dict[str, str]) -> Dict[str, float]:
    """Print ``deploy - parity`` for every numeric column; returns them."""
    print("\n== deltas (deploy - parity) ==")
    deltas = {}
    for k in a:
        try:
            d = float(b[k]) - float(a[k])
        except ValueError:
            continue
        deltas[k] = d
        print(f"  {k:>12s}: parity {float(a[k]):.5f}  deploy "
              f"{float(b[k]):.5f}  delta {d:+.5f}")
    return deltas


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", type=int, default=224)
    ap.add_argument("--epochs", type=int, default=8)
    # default = the shipped kernel set: attention + refine-head + patch kernels
    ap.add_argument("--fused_patch", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--deploy_f32", action="store_true",
                    help="keep the deploy arm in f32 compute (isolates "
                         "kernel/GELU/softmax effects from the bf16 cast)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> Dict[str, float]:
    from ..data.synthetic import generate_synthetic_dataset

    args = build_arg_parser().parse_args(argv)
    # float32 means float32 in both arms: cuDNN would take TF32 for float32
    # convolutions by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_base = tempfile.mkdtemp(prefix="parity_deploy_")
    root = os.path.join(out_base, "data")
    generate_synthetic_dataset(root, img_size=args.img, **SPLIT)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    a = run_one("parity", root, out_base, deploy=False, args=args)
    b = run_one("deploy", root, out_base, deploy=True, args=args)
    deltas = print_deltas(a, b)
    shutil.rmtree(root, ignore_errors=True)
    print("outputs kept in", out_base)
    return deltas


if __name__ == "__main__":
    main()
