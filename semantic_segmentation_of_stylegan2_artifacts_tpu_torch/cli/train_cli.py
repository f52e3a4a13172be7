"""One training run on the card:

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli.train_cli \\
        --cfg config.yaml [--resume <epoch_N.pth>] [--device cuda]

Counterpart of the JAX package's ``cli/train_cli.py`` (reference
``train.py:24-122``): the frozen config, the hyperparameter echo,
``OUTPUT_DIR`` with ``config_used.yaml`` (the resolved config) and
``log.txt``, an optional TensorBoard writer in ``OUTPUT_DIR/log``, the seeds,
the model with ``MODEL.PRETRAIN_WEIGHTS`` (segface | imagenet1k | none)
copied into its encoder, ``MODEL.FREEZE_ENCODER``, then the trainer.  It
prints "Training Finished!" at the end.
"""

from __future__ import annotations

import argparse
import os
import random
from datetime import datetime

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE",
                        help="path to config file")
    parser.add_argument("--resume", type=str, default=None, metavar="CKPT",
                        help="resume from an epoch_N.pth checkpoint "
                             "(params, optimizer, epoch)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def echo_hyperparameters(config) -> None:
    for line in (
        f"Weight_decay = {config.TRAIN.WEIGHT_DECAY}",
        f"Drop_path = {config.MODEL.DROP_PATH_RATE}",
        f"Drop_rate = {config.MODEL.DROP_RATE}",
        f"Attention Drop = {config.MODEL.ATTN_DROP_RATE}",
        f"tversky alpha = {config.TRAIN.TVERSKY_LOSS_ALPHA}",
        f"tversky beta = {config.TRAIN.TVERSKY_LOSS_BETA}",
        f"tversky_bce_mix_factor = {config.TRAIN.LOSS_TVERSKY_BCE_MIX}",
        f"base_lr = {config.TRAIN.BASE_LR}",
        f"DYNAMIC_LOADER = {config.DYNAMIC_LOADER}",
        f"warm_up = {config.TRAIN.WARMUP_EPOCHS}",
        f"epochs = {config.TRAIN.MAX_EPOCHS}",
        f"seed = {config.SEED}",
        f"pretrained weights = {config.MODEL.PRETRAIN_WEIGHTS}",
        f"SAVE_BEST_RUN = {config.SAVE_BEST_RUN}",
        f"SHOW_PREDICTIONS = {config.SHOW_PREDICTIONS}",
    ):
        print(line)


def main(argv=None) -> str:
    from ..core.config import get_config, save_config
    from ..models.msunet import MSUNet
    from ..models.weights import load_pretrained_encoder
    from ..train.optim import build_optimizer
    from ..train.state import create_train_state
    from ..train.trainer import trainer
    from .run_dir import close_logger, file_logger, tensorboard_writer

    args = build_arg_parser().parse_args(argv)
    config = get_config(args, True, False)
    kind = str(config.MODEL.PRETRAIN_WEIGHTS)
    if kind not in ("segface", "imagenet1k", "none", ""):
        raise ValueError(f"Could not load pretrained weights: unknown kind {kind!r}")

    timestamp = datetime.now().strftime("%d%m%y_%H%M")
    print(f"time: {timestamp}")
    echo_hyperparameters(config)
    output_dir = config.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)
    save_config(config, os.path.join(output_dir, "config_used.yaml"))
    log = file_logger("train", output_dir)
    try:
        log.info(f"date: {timestamp}")
        seed = int(config.SEED)
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)

        model = MSUNet.from_config(config, device=args.device)
        if kind in ("segface", "imagenet1k"):
            load_pretrained_encoder(
                model.ms_unet, config.MODEL.PRETRAIN_SEGFACE if kind == "segface"
                else config.MODEL.PRETRAIN_IMAGENET1K, kind, log)
        state = create_train_state(model, config, device=args.device)
        if bool(config.MODEL.FREEZE_ENCODER):
            state.optimizer = build_optimizer(config, model, set(range(4)))
        result = trainer(model, log, tensorboard_writer(os.path.join(output_dir, "log")),
                         output_dir, config, config.TRAIN.BASE_LR, state=state,
                         resume_from=args.resume)
    finally:
        close_logger(log)
    print(result)
    return timestamp


if __name__ == "__main__":
    main()
