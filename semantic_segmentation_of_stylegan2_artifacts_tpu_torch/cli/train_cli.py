"""One training run on the card:

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli.train_cli \\
        --cfg config.yaml [--resume <epoch_N.pth | epoch_N.orbax>] [--device cuda]
        [--dist_backend gloo]

Counterpart of the JAX package's ``cli/train_cli.py`` (reference
``train.py:24-122``): the frozen config, the hyperparameter echo,
``OUTPUT_DIR`` with ``config_used.yaml`` (a copy of ``--cfg``) and
``log.txt``, an optional TensorBoard writer in ``OUTPUT_DIR/log``, the seeds,
the model with ``MODEL.PRETRAIN_WEIGHTS`` (segface | imagenet1k | none)
copied into its encoder, ``MODEL.FREEZE_ENCODER``, then the trainer.  It
prints "Training Finished!" at the end.

``HARDWARE.N_GPU: k`` above 1 trains data-parallel over k ranks, one
process each.  Started as above, the CLI spawns the k ranks itself (rank
``r`` on ``cuda:r`` over NCCL; ``--device cpu`` over gloo; ``--device
cuda:0 --dist_backend gloo`` puts every rank on one card, which NCCL
refuses).  Under ``torchrun --nproc_per_node k`` it reads its rank from the
environment instead.  Rank 0 alone writes the run directory; the other
ranks print their log lines (``rank_sync``, ``epoch_timing``) on standard
output, each behind ``rank <r>:``.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import shutil
import sys
import tempfile
from datetime import datetime

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE",
                        help="path to config file")
    parser.add_argument("--resume", type=str, default=None, metavar="CKPT",
                        help="resume from an epoch_N.pth checkpoint or an "
                             "epoch_N.orbax directory of either package "
                             "(params, optimizer, epoch)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dist_backend", type=str, default=None,
                        choices=("nccl", "gloo"),
                        help="process-group backend when HARDWARE.N_GPU > 1 "
                             "(default: nccl on the cards, gloo on the CPU)")
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
    """Train one run; with ``HARDWARE.N_GPU > 1`` spawn the ranks (or, under
    ``torchrun``, be one).  Returns the run's timestamp."""
    from ..core.config import get_config
    from ..parallel.mesh import check_world, world_size_for

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_arg_parser().parse_args(argv)
    config = get_config(args, True, False)
    world = world_size_for(config)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world > 1:  # torchrun
        if env_world != world:
            raise ValueError(f"torchrun started {env_world} ranks for HARDWARE.N_GPU "
                             f"{world}")
        rank = int(os.environ["RANK"])
        return _run(args, config, rank, world, "env://",
                    int(os.environ.get("LOCAL_RANK", rank)))
    if world == 1:
        return _run(args, config, 0, 1)
    check_world(world, args.device, args.dist_backend)
    timestamp = datetime.now().strftime("%d%m%y_%H%M")
    rendezvous = tempfile.mkdtemp(prefix="train_cli_")
    try:
        torch.multiprocessing.spawn(
            _spawned, args=(argv, world, "file://" + os.path.join(rendezvous, "init")),
            nprocs=world, join=True)
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)
    return timestamp


def _spawned(rank: int, argv, world: int, init_method: str) -> None:
    from ..core.config import get_config

    args = build_arg_parser().parse_args(argv)
    _run(args, get_config(args, True, False), rank, world, init_method, rank)


def _run(args, config, rank: int, world: int, init_method=None, local_rank: int = 0) -> str:
    """The run as rank ``rank`` of ``world`` (a process group joined first
    when ``world > 1``)."""
    from ..models.msunet import MSUNet
    from ..models.weights import load_pretrained_encoder
    from ..parallel.mesh import destroy_process_group, init_process_group
    from ..train.optim import build_optimizer
    from ..train.state import create_train_state
    from ..train.trainer import trainer
    from .run_dir import close_logger, file_logger, tensorboard_writer

    kind = str(config.MODEL.PRETRAIN_WEIGHTS)
    if kind not in ("segface", "imagenet1k", "none", ""):
        raise ValueError(f"Could not load pretrained weights: unknown kind {kind!r}")
    device = args.device
    if world > 1:
        device = init_process_group(rank, world, init_method, args.device,
                                    args.dist_backend, local_rank)
    main_rank = rank == 0
    timestamp = datetime.now().strftime("%d%m%y_%H%M")
    output_dir = config.OUTPUT_DIR
    if main_rank:
        print(f"time: {timestamp}")
        echo_hyperparameters(config)
        os.makedirs(output_dir, exist_ok=True)
        shutil.copy(args.cfg, os.path.join(output_dir, "config_used.yaml"))
        log = file_logger("train", output_dir)
    else:  # only rank 0 writes the run directory; the others log to stdout
        log = logging.getLogger(f"train.rank{rank}")
        log.propagate = False
        log.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(f"rank {rank}: %(message)s"))
        log.addHandler(handler)
    try:
        log.info(f"date: {timestamp}")
        seed = int(config.SEED)
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)

        model = MSUNet.from_config(config, device=device)
        if kind in ("segface", "imagenet1k"):
            load_pretrained_encoder(
                model.ms_unet, config.MODEL.PRETRAIN_SEGFACE if kind == "segface"
                else config.MODEL.PRETRAIN_IMAGENET1K, kind, log)
        state = create_train_state(model, config, device=device)
        if bool(config.MODEL.FREEZE_ENCODER):
            state.optimizer = build_optimizer(config, model, set(range(4)))
        writer = tensorboard_writer(os.path.join(output_dir, "log")) if main_rank else None
        result = trainer(model, log, writer, output_dir, config, config.TRAIN.BASE_LR,
                         state=state, resume_from=args.resume)
    finally:
        close_logger(log)
        if world > 1:
            destroy_process_group()
    if main_rank:
        print(result, flush=True)
    return timestamp


if __name__ == "__main__":
    main()
