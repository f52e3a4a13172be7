"""Hyperparameter grid search over the port's train CLI::

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli.run_cli \
        --cfg <copy of config.yaml> [--root_out DIR] [--device cpu]

A copy of the JAX package's ``cli/run_cli.py`` (reference ``run.py``):
three sweeps in order (attention-dropout -> Tversky alpha (beta = 1 -
alpha) -> learning-rate), each trial mutating ``--cfg`` in place through the
round-trip editor (so point it at a copy), running one training, then
ranking trials by the max of the ``Score`` column in
``val_metric_all_epoch.csv``.  A trial runs the port's train CLI
(``python -m <port>.cli.train_cli --cfg <yaml> --device <device>``) from the
working directory; ``--train_py PATH`` runs the script at PATH instead
(``PATH --cfg <yaml>``).

Beyond the reference: ``--jobs N`` runs the trials *within* each sweep
concurrently (the sweeps themselves stay sequential — each consumes the
previous winner).  Parallel trials each get their own copy of the config
(no shared-file mutation race) and a per-slot environment from
``--slot_env "VAR={slot}"`` templates, so trials can be pinned to
distinct devices/hosts (e.g. ``--slot_env CUDA_VISIBLE_DEVICES={slot}``
off-TPU, or distinct ``SSA_TPU_PLATFORM``/coordinator settings).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import csv
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

from ..core.yaml_editor import ConfigParser

TRAIN_MODULE = __package__ + ".train_cli"
CSV_NAME = "val_metric_all_epoch.csv"
METRIC_COL = "Score"


def best_score_from_csv(path: Path, column: str = METRIC_COL) -> Optional[float]:
    """Max numeric value of ``column`` in a per-epoch CSV, or None.

    Trial ranking must survive a trial that crashed mid-epoch, so every
    failure mode degrades to None rather than raising: unreadable file,
    absent header, short/garbled rows (a partially flushed writer), and
    non-numeric cells are all skipped.
    """
    best: Optional[float] = None
    try:
        with open(path, newline="") as fh:
            for row in csv.DictReader(fh):
                cell = (row or {}).get(column)
                try:
                    value = float(cell)
                except (TypeError, ValueError):
                    continue
                if value == value and (best is None or value > best):
                    best = value
    except OSError as e:
        print(f"[WARN] could not read {path}: {e}")
        return None
    return best


def train_command(python: str, train_py: str, cfg_path: str, device: str = "cuda"):
    """The trial's command: the script ``train_py``, or with ``train_py``
    empty the port's train CLI on ``device``."""
    if train_py:
        return [python, train_py, "--cfg", cfg_path]
    return [python, "-m", TRAIN_MODULE, "--cfg", cfg_path, "--device", device]


def run_trial(cfg_path: str, out_dir: Path, overrides, python: str,
              train_py: str, env=None, copy_cfg: bool = False,
              device: str = "cuda") -> float:
    out_dir.mkdir(parents=True, exist_ok=True)
    if copy_cfg:
        # isolated config per trial: parallel trials must not race on one
        # shared YAML (the reference's in-place mutation is sequential-only)
        trial_cfg = out_dir / "trial_config.yaml"
        shutil.copyfile(cfg_path, trial_cfg)
        cfg_path = str(trial_cfg)
    parser = ConfigParser(cfg_path)
    parser.set_value("OUTPUT_DIR", str(out_dir))
    for path, value in overrides:
        parser.set_value(path, value)
    parser.save()
    cmd = train_command(python, train_py, cfg_path, device)
    print("CMD:", " ".join(cmd))
    subprocess.run(cmd, env=env or os.environ.copy(), check=True)
    best = best_score_from_csv(out_dir / CSV_NAME)
    if best is None:
        raise ValueError(
            f"trial produced no usable '{METRIC_COL}' column in "
            f"{out_dir / CSV_NAME}"
        )
    return best


def run_sweep(trials, python: str, train_py: str, cfg_path: str,
              jobs: int = 1, slot_env=(), device: str = "cuda") -> dict:
    """Run ``trials`` (list of (key, out_dir, overrides)) -> {key: score}.

    ``jobs > 1`` dispatches trials to a thread pool (each trial is a
    subprocess; threads only wait).  Slot ``i % jobs`` formats every
    ``slot_env`` template (``VAR={slot}``) into the trial's environment.
    """
    if jobs <= 1:
        return {
            key: run_trial(cfg_path, out, ov, python, train_py, device=device)
            for key, out, ov in trials
        }

    # slots are leased from a free pool, not derived from the trial
    # index — index-derived slots can collide when trials finish out of
    # order (two live trials pinned to the same device)
    import queue

    free_slots: "queue.Queue[int]" = queue.Queue()
    for slot in range(jobs):
        free_slots.put(slot)

    def one(key, out, ov):
        slot = free_slots.get()
        try:
            env = os.environ.copy()
            for template in slot_env:
                var, _, val = template.partition("=")
                env[var] = val.format(slot=slot)
            return key, run_trial(cfg_path, out, ov, python, train_py,
                                  env=env, copy_cfg=True, device=device)
        finally:
            free_slots.put(slot)

    scores = {}
    with cf.ThreadPoolExecutor(jobs) as pool:
        futs = [pool.submit(one, *t) for t in trials]
        for fut in futs:
            key, score = fut.result()
            scores[key] = score
    return scores


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", default="./config.yaml")
    ap.add_argument("--root_out", default="./model_out/RUN1")
    ap.add_argument("--train_py", default="",
                    help="a training script run as PATH --cfg <yaml> (default: "
                         "the port's train CLI)")
    ap.add_argument("--device", default="cuda",
                    help="device of the port's train CLI (cuda | cpu)")
    ap.add_argument("--python", default=sys.executable)
    ap.add_argument("--attn_drop", type=float, nargs="+", default=[0.1])
    ap.add_argument("--alpha", type=float, nargs="+", default=[0.3, 0.4])
    ap.add_argument("--lr", type=float, nargs="+", default=[8.5e-6, 3e-5])
    ap.add_argument("--weight_decay", type=float, default=0.001)
    ap.add_argument("--drop_path", type=float, default=0.1)
    ap.add_argument("--drop_rate", type=float, default=0.0)
    ap.add_argument("--jobs", type=int, default=1,
                    help="concurrent trials per sweep (1 = reference-"
                         "sequential); >1 copies the config per trial")
    ap.add_argument("--slot_env", action="append", default=[],
                    help="env template per job slot, e.g. "
                         "'CUDA_VISIBLE_DEVICES={slot}' (repeatable)")
    args = ap.parse_args(argv)

    root_out = Path(args.root_out)
    root_out.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(filename=str(root_out / "run.log"), level=logging.DEBUG)

    wd, dp, dr = args.weight_decay, args.drop_path, args.drop_rate
    base = [
        ("TRAIN.WEIGHT_DECAY", wd),
        ("MODEL.DROP_RATE", dr),
        ("MODEL.DROP_PATH_RATE", dp),
    ]

    def sweep(name, trials):
        logging.info(name)
        scores = run_sweep(trials, args.python, args.train_py, args.cfg,
                           jobs=args.jobs, slot_env=args.slot_env, device=args.device)
        for key, score in scores.items():
            logging.info(f"{name} {key}: result {score}")
        return max(scores, key=scores.get)

    # -------- sweep 1: attention dropout --------
    best_att = sweep("Attention drop search:", [
        (attn_drop,
         root_out / (f"drop_path{dp:.2f}_drop_rate{dr:.2f}"
                     f"_attn_drop{attn_drop:.2f}"),
         base + [("MODEL.ATTN_DROP_RATE", attn_drop),
                 ("TRAIN.TVERSKY_LOSS_ALPHA", 0.2),
                 ("TRAIN.TVERSKY_LOSS_BETA", 0.8)])
        for attn_drop in args.attn_drop
    ])
    logging.info(f"Best attention drop {best_att}")

    # -------- sweep 2: Tversky alpha (beta = 1 - alpha) --------
    best_alpha = sweep("Alpha refine:", [
        (alpha,
         root_out / (f"alpha_{alpha:.2f}_drop_path{dp:.2f}"
                     f"_drop_rate{dr:.2f}_attn_drop{best_att:.2f}"),
         base + [("MODEL.ATTN_DROP_RATE", best_att),
                 ("TRAIN.TVERSKY_LOSS_ALPHA", alpha),
                 ("TRAIN.TVERSKY_LOSS_BETA", 1 - alpha)])
        for alpha in args.alpha
    ])
    logging.info(f"Best alpha {best_alpha}")

    # -------- sweep 3: learning rate --------
    best_lr = sweep("LR search:", [
        (lr,
         root_out / (f"lr_{lr:.2e}_alpha_{best_alpha:.2f}"
                     f"_attn_drop{best_att:.2f}"),
         base + [("MODEL.ATTN_DROP_RATE", best_att),
                 ("TRAIN.TVERSKY_LOSS_ALPHA", best_alpha),
                 ("TRAIN.TVERSKY_LOSS_BETA", 1 - best_alpha),
                 ("TRAIN.BASE_LR", lr)])
        for lr in args.lr
    ])
    logging.info(f"Best lr {best_lr}")
    print(f"BEST: attn_drop={best_att} alpha={best_alpha} lr={best_lr}")
    return best_att, best_alpha, best_lr


if __name__ == "__main__":
    main()
