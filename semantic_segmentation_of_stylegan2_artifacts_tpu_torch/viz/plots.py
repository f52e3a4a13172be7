"""Training-curve plots (a copy of the JAX package's ``viz/plots.py``;
reference ``scripts/plot_scripts/``), drawn with matplotlib from the CSVs,
which pandas reads; both are imported where a plot is written.

* :func:`plot_lr_range` — EWM-smoothed LR-range-test curves from
  ``lr_range_test.csv`` (reference ``trainer.py:429-446`` /
  ``plot_lr.py:10-24``),
* :func:`plot_per_epoch` — train/val loss curves from the epoch CSVs
  (reference ``plot_per_epoch.py:5-24``).
"""

from __future__ import annotations

import os


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_lr_range(lr_range_test_file: str, log_save_path: str,
                  out_name: str = "weight_decay_test.png") -> str:
    """LR-range-test plot with EWM smoothing (span 20)."""
    import pandas as pd

    plt = _plt()
    df = pd.read_csv(lr_range_test_file)
    df["smoothed_train_loss"] = df["train_loss"].ewm(span=20, adjust=False).mean()
    df["smoothed_val_loss"] = df["val_loss"].ewm(span=20, adjust=False).mean()
    plt.figure(figsize=(8, 6))
    plt.plot(df["lr"], df["smoothed_train_loss"], label="Smoothed Train Loss",
             linewidth=2)
    plt.plot(df["lr"], df["train_loss"], color="lightblue", alpha=0.3,
             label="Raw Train Loss")
    plt.plot(df["lr"], df["smoothed_val_loss"], color="red",
             label="Smoothed Validation Loss", linewidth=2)
    plt.plot(df["lr"], df["val_loss"], color="salmon", alpha=0.3,
             label="Raw Validation Loss")
    plt.xscale("log")
    plt.xlabel("Learning Rate")
    plt.ylabel("Loss")
    plt.ylim(0, 2)
    plt.legend(loc="best")
    plt.title("Learning Rate Range Test")
    plt.grid(True)
    out = os.path.join(log_save_path, out_name)
    plt.savefig(out, dpi=300)
    plt.close()
    return out


def plot_per_epoch(run_dir: str, out_name: str = "loss_per_epoch.png") -> str:
    """Train/val loss per epoch from ``val_metric_all_epoch.csv``."""
    import pandas as pd

    plt = _plt()
    df = pd.read_csv(os.path.join(run_dir, "val_metric_all_epoch.csv"))
    plt.figure(figsize=(8, 6))
    plt.plot(df["epoch"], df["mean_train_loss"], label="train loss")
    plt.plot(df["epoch"], df["mean_val_loss"], label="val loss")
    if "Score" in df.columns:
        ax2 = plt.gca().twinx()
        ax2.plot(df["epoch"], df["Score"], color="green", alpha=0.5,
                 label="Score")
        ax2.set_ylabel("Score")
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.legend(loc="best")
    plt.grid(True)
    out = os.path.join(run_dir, out_name)
    plt.savefig(out, dpi=200)
    plt.close()
    return out
