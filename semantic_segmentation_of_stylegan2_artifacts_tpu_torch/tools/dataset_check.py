"""Dataset smoke check (counterpart of the JAX package's
``tools/dataset_check.py``; reference ``dataset/dataset_check.py``).

Loads a few augmented samples of a split and one train batch through the
port's ``data/dataset.py`` and ``data/pipeline.py``, asserting shapes,
dtypes and label values, and prints what it found::

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dataset_check \\
        --data_path DIR --list_dir DIR --img_size 1024
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from ..data.augment import RandomGenerator
from ..data.dataset import SegArtifactDataset
from ..data.pipeline import TrainLoader


def check_dataset(data_path: str, list_dir: str, img_size: int, split: str = "train",
                  n_samples: int = 3, verbose: bool = True) -> Dict:
    """``{"n_samples", "label_values", "batch_shape"}`` of the split and one
    train batch; raises where a shape, dtype or label value is off."""
    t = RandomGenerator([img_size, img_size], random_flip_flag=True, transform=True,
                        seed=0)
    ds = SegArtifactDataset(data_path, list_dir, split)
    assert len(ds) > 0, "empty split"
    label_values = set()
    for i in range(min(n_samples, len(ds))):
        s = t(ds[i])
        img, lbl = s["image"], s["label"]
        assert img.shape == (img_size, img_size, 3), img.shape
        assert img.dtype == np.uint8
        assert lbl.shape == (img_size, img_size), lbl.shape
        label_values |= set(np.unique(lbl).tolist())
        if verbose:
            print(f"sample {i} ({s['case_name']}): image {img.shape} "
                  f"{img.dtype}, label values {sorted(set(np.unique(lbl)))}")
    assert label_values <= {0, 1}, f"unexpected label values {label_values}"

    loader = TrainLoader(SegArtifactDataset(data_path, list_dir, "fake_train"),
                         SegArtifactDataset(data_path, list_dir, "real_train_all"),
                         img_size=img_size, num_workers=2)
    batch = next(iter(loader.epoch_batches(0)))
    assert batch["image"].shape[1:] == (img_size, img_size, 3)
    assert batch["label"].shape[1:] == (img_size, img_size)
    if verbose:
        print(f"batch: image {batch['image'].shape}, label "
              f"{batch['label'].shape}, cases {batch['case_name']}")
    return {"n_samples": len(ds), "label_values": sorted(label_values),
            "batch_shape": tuple(batch["image"].shape)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--list_dir", required=True)
    ap.add_argument("--img_size", type=int, default=1024)
    ap.add_argument("--split", default="train")
    args = ap.parse_args(argv)
    info = check_dataset(args.data_path, args.list_dir, args.img_size, args.split)
    print(f"OK: {info}")


if __name__ == "__main__":
    main()
