"""The training loop: epochs, validation, model selection, checkpoints
(counterpart of the JAX package's ``train/trainer.py``; reference
``trainer.py:33-426``).

Per epoch: the mixed fake/real set with the dynamic real ratio, the
cosine-warmup learning rate, the train steps with the loss read one step
late (so the host never waits on step n before step n+1 is queued) and a
non-finite loss raising ``FloatingPointError``, then validation through
the metric reductions, ``Score``-based best checkpoint, early stopping with
the staged encoder unfreeze (deepest stage first, brought forward by an
early stop), CSV, log-file and optional TensorBoard output, and at the end
the prediction exports of the best epoch.

Input batches are copied to the device from pinned host memory with
``TPU.DEVICE_PREFETCH`` batches in flight (the reference's
``DataLoader(pin_memory=True)``).  A kernel failure on the card raises out
of the trainer: there is no fallback to the composed path.

Each epoch logs one ``epoch_timing {json}`` line on every rank: the rank,
the epoch's host seconds, the host seconds the steps waited for the train
loader, the steps, the validation's seconds and cases (rank 0's; 0 on the
others), and this process's image decodes of the epoch, native and PIL
(``native.DECODES``).

Data parallelism (JAX ``train/trainer.py``'s mesh): ``HARDWARE.N_GPU``
sampler pairs make one global batch a step.  When a process group is up
(``parallel/mesh.py``, started by the train CLI) each rank decodes its
share of every global batch, trains through a ``DistributedDataParallel``
wrapper (rebuilt at every staged unfreeze, since DDP fixes its parameter
set when built), and checks after each epoch that every rank holds the same
parameters; rank 0 alone validates, broadcasts the Score that every rank's
best-checkpoint, early-stop and unfreeze decisions read, and writes the
logs, CSVs, checkpoints and predictions.  With no group, one process
trains the whole global batch.
"""

from __future__ import annotations

import json
import logging as _logging
import os
import time
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..data.dataset import SegArtifactDataset
from ..data.pipeline import EvalLoader, TrainLoader
from ..metrics.csv_logger import CSVHandler
from ..parallel.mesh import (
    broadcast_float,
    check_replicas,
    replicate_state,
    stage_sums,
)
from ..parallel.multihost import host_shard, local_merge
from ..metrics.segmentation import (
    MetricsAggregator,
    case_metrics,
    case_metrics_multiclass,
    metrics_to_host,
    to_case_metrics,
)
from ..viz.maps import create_bin_heat_mask_from_list
from .checkpoint import CheckpointWriter, load_checkpoint, load_orbax
from .optim import build_optimizer, load_optax, unfreeze
from .schedule import CosineWarmupSchedule
from .state import TrainState, create_train_state, make_eval_step, make_train_step


class _PinnedRing:
    """Host-to-device copies through a ring of pinned buffers.  A buffer is
    refilled only after the event recorded behind its last copy has
    passed, so a copy still in flight never reads a buffer being refilled."""

    def __init__(self, dev: torch.device, size: int):
        self.dev = dev
        self.slots: List[Optional[Tuple[torch.Tensor, torch.cuda.Event]]] = [None] * size
        self.i = 0

    def put(self, arr: np.ndarray) -> torch.Tensor:
        k = self.i % len(self.slots)
        self.i += 1
        slot = self.slots[k]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or tuple(slot[0].shape) != arr.shape:
            buf = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                              pin_memory=True)
        else:
            buf = slot[0]
        buf.numpy()[...] = arr
        out = buf.to(self.dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.slots[k] = (buf, event)
        return out


def prefetch_to_device(batches: Iterable[Dict], dev: torch.device, depth: int,
                       wait: List[float]) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """``(image, label)`` device tensors, ``depth`` batches placed ahead of
    the consumer.  On the card the copies come from pinned buffers and do
    not block the host; ``wait[0]`` gathers the host seconds spent waiting
    for ``batches``."""
    depth = max(1, depth)
    ring = {k: _PinnedRing(dev, depth + 1) for k in ("image", "label")} \
        if dev.type == "cuda" else None

    def place(batch):
        if ring is None:
            return tuple(torch.from_numpy(batch[k]).to(dev) for k in ("image", "label"))
        return tuple(ring[k].put(batch[k]) for k in ("image", "label"))

    it = iter(batches)
    buf: deque = deque()
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        wait[0] += time.perf_counter() - t0
        if batch is None:
            break
        buf.append(place(batch))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def validate(eval_step: Callable, valloader: EvalLoader, epoch: int, sig_threshold: float,
             output_num: int = 10, mean_train_loss: float = float("nan"), logger=None,
             csv_handler: Optional[CSVHandler] = None, num_classes: int = 1,
             collapse_probs: bool = True):
    """The metric pass over a validation loader (reference
    ``validation_functions.py:37-211``).

    ``eval_step(image, label) -> (probs, per-sample losses)``.  A padded
    tail of a batch (``pad_to_batch``) is dropped: only the leading
    ``len(case_name)`` entries are cases.  Returns ``(mean_soft_dice,
    output_saver, Score, mean_FPR, summary)``; ``output_saver`` holds the
    first ``output_num`` probability maps, multi-class maps collapsed to
    their max over classes unless ``collapse_probs`` is False."""
    agg = MetricsAggregator()
    output_saver: List[Tuple[str, np.ndarray]] = []
    for batch in valloader:
        probs, loss = eval_step(batch["image"], batch["label"])
        labels = torch.from_numpy(batch["label"]).to(probs.device)
        bsz = len(batch["case_name"])
        losses = loss.double().reshape(-1).cpu().numpy()
        if losses.shape[0] >= bsz:
            losses = losses[:bsz]
        else:  # a batch-mean loss: every case gets it
            losses = np.full((bsz,), float(losses.mean()))
        if num_classes <= 1:
            m = metrics_to_host(case_metrics(probs[:bsz], labels[:bsz], sig_threshold))
            case_ms = [{k: v[i] for k, v in m.items()} for i in range(bsz)]
        else:
            case_ms = [metrics_to_host(case_metrics_multiclass(probs[i], labels[i],
                                                               sig_threshold))
                       for i in range(bsz)]
        for i in range(bsz):
            name = batch["case_name"][i]
            agg.add(to_case_metrics(name, case_ms[i], float(losses[i])))
            if len(output_saver) < output_num:
                pm = probs[i].cpu().numpy()
                if pm.ndim == 3 and collapse_probs:
                    pm = pm.max(axis=-1)
                output_saver.append((name, pm))
    summary = agg.summarize(epoch, mean_train_loss)
    if csv_handler is not None:
        csv_handler.write_epoch(summary)
    if logger is not None:
        logger.info(f"epoch {epoch}: mean_soft_dice {summary.mean_soft_dice:.5f} "
                    f"mean_FPR {summary.mean_fpr:.5f} Score {summary.score:.5f} "
                    f"mean_val_loss {summary.mean_val_loss:.5f}")
    return summary.mean_soft_dice, output_saver, summary.score, summary.mean_fpr, summary


def _unfreeze_epochs(config) -> Dict[int, int]:
    """Epoch at which each encoder stage unfreezes (reference ``trainer.py:171-175``)."""
    m, e = config.MODEL, config.TRAIN.MAX_EPOCHS
    return {3: int(e * m.STAGE3_UNFREEZE_PERIODE), 2: int(e * m.STAGE2_UNFREEZE_PERIODE),
            1: int(e * m.STAGE1_UNFREEZE_PERIODE), 0: int(e * m.STAGE0_UNFREEZE_PERIODE)}


def trainer(model, logger, writer, log_save_path: str = "", config=None,
            base_lr: Optional[float] = None, state: Optional[TrainState] = None,
            resume_from: Optional[str] = None, device=None) -> str:
    """Train ``model`` (an ``MSUNet``) per ``config``; returns "Training Finished!".

    ``state`` is a :class:`TrainState` from ``create_train_state`` (built
    here on ``device``, the card unless the caller passes another, when
    None); with ``MODEL.FREEZE_ENCODER`` a state built here starts with the
    encoder frozen, and a state passed in must be so already.
    ``resume_from`` is an ``epoch_N.pth`` of :class:`CheckpointWriter`, or
    an ``epoch_N.orbax`` directory of either package.
    Under a process group ``model`` is this rank's replica, already on its
    device."""
    if config is None:
        raise ValueError("Config file is not found!")
    if logger is None:
        logger = _logging.getLogger("trainer")
    max_epoch = int(config.TRAIN.MAX_EPOCHS)
    freeze_encoder = bool(config.MODEL.FREEZE_ENCODER)
    img_size = int(config.DATA.IMG_SIZE)
    num_classes = int(config.MODEL.NUM_CLASSES)
    # N_GPU sampler pairs a global batch (JAX trainer.py's merge = n_dp); each
    # rank of a process group decodes its share
    merge = max(1, int(config.HARDWARE.N_GPU))
    rank, world = host_shard()
    local_merge(merge)
    distributed = torch.distributed.is_available() and torch.distributed.is_initialized()
    is_main = rank == 0

    pred_dir = os.path.join(log_save_path, "final_preds")
    if is_main:
        os.makedirs(pred_dir, exist_ok=True)

    # ---- data ------------------------------------------------------------
    data, lists = config.DATA.DATA_PATH, config.LIST_DIR
    train_loader = TrainLoader(
        SegArtifactDataset(data, lists, "fake_train"),
        SegArtifactDataset(data, lists, "real_train_all"), img_size=img_size,
        seed=int(config.SEED), dynamic_loader=bool(config.DYNAMIC_LOADER),
        num_workers=int(config.DATA.NUM_WORKERS),
        prefetch_depth=int(config.TPU.PREFETCH_DEPTH), num_classes=num_classes)
    eval_batch = int(config.TPU.EVAL_BATCH)
    valloader = EvalLoader(SegArtifactDataset(data, lists, "val"), img_size=img_size,
                           num_classes=num_classes, batch_size=eval_batch,
                           pad_to_batch=eval_batch > 1)

    # ---- model and optimizer state ----------------------------------------
    frozen_stages = set(range(4)) if freeze_encoder else set()
    if state is None:
        state = create_train_state(model, config, device=device)
        if freeze_encoder:
            state.optimizer = build_optimizer(config, model, frozen_stages)
    dev = next(model.parameters()).device
    stage_unfreeze_epoch = _unfreeze_epochs(config)

    def unfreeze_stage(stage: int) -> None:
        nonlocal frozen_stages
        frozen_stages = frozen_stages - {stage}
        unfreeze(state.optimizer, config, model, frozen_stages)
        if state.replica is not None:
            replicate_state(state)  # DDP reduces only what was trainable when built

    start_epoch = int(config.TRAIN.START_EPOCH)
    if resume_from:
        from_orbax = os.path.isdir(resume_from)
        raw = load_orbax(resume_from) if from_orbax else load_checkpoint(resume_from)
        start_epoch = int(raw["epoch"]) + 1
        if freeze_encoder:
            # replay the scheduled unfreezes up to the resume epoch (one stage
            # an epoch, deepest first, as below), so the optimizer's groups
            # match the checkpoint's; an unfreeze that an early stop brought
            # forward cannot be replayed: params only then from a .pth, an
            # error from an orbax directory
            frozen_stages = set(range(4))
            state.optimizer = build_optimizer(config, model, frozen_stages)
            for e in range(start_epoch):
                for stage in (3, 2, 1, 0):
                    if stage in frozen_stages and e >= stage_unfreeze_epoch[stage]:
                        unfreeze_stage(stage)
                        break
        if from_orbax:
            # either package's epoch_N.orbax: optax's state; a layout that
            # differs from the rebuilt optimizer's raises
            getattr(model, "ms_unet", model).load_state_dict(raw["model"], strict=True)
            load_optax(state.optimizer, model, raw["optimizer"], resume_from)
        else:
            model.load_state_dict(raw["model"], strict=True)
            try:
                state.optimizer.load_state_dict(raw["optimizer"])
            except ValueError:
                logger.warning(
                    f"Optimizer state in {resume_from} does not match the rebuilt "
                    "structure (e.g. an early-stop-forced unfreeze before the save); "
                    "restoring params only, fresh moments.")
        # the noise seed folds the step in: resumed noise continues the sequence
        state.step = int(raw.get("iter_num", 0))
        logger.info(f"Resumed from {resume_from} at epoch {start_epoch}")
    if distributed:
        replicate_state(state)
        logger.info(f"data parallel: {world} ranks, {merge} sampler pairs a global "
                    f"batch, {2 * merge // world} rows a rank")

    alpha = float(config.TRAIN.TVERSKY_LOSS_ALPHA)
    beta = float(config.TRAIN.TVERSKY_LOSS_BETA)
    mix = float(config.TRAIN.LOSS_TVERSKY_BCE_MIX)
    train_step = make_train_step(model, alpha, beta, mix,
                                 accumulation_steps=max(1, int(config.TRAIN.ACCUMULATION_STEPS)),
                                 num_classes=num_classes)
    eval_step = make_eval_step(model, alpha, beta, mix, num_classes=num_classes,
                               per_sample=True, device=dev)
    schedule = CosineWarmupSchedule.from_config(config, base_lr)

    def maybe_unfreeze(epoch_num: int, force_next: bool) -> None:
        if not freeze_encoder:
            return
        for stage in (3, 2, 1, 0):
            if stage in frozen_stages and (epoch_num >= stage_unfreeze_epoch[stage]
                                           or force_next):
                unfreeze_stage(stage)
                logger.info(f"Unfroze encoder stage {stage} at epoch {epoch_num}")
                return

    # ---- loop ------------------------------------------------------------
    # the reference starts at -1.0 (trainer.py:178), which skips saving while
    # Score < -1 (high-FPR early epochs); -inf always keeps the best
    best_score = float("-inf")
    since_best = 0
    iter_num = state.step
    last_run = False
    unfreeze_in_next_epoch = False
    mean_dice = float("nan")
    save_best_output: List[Tuple[str, np.ndarray]] = []
    train_loss_list: List[float] = []
    ckpt_writer = CheckpointWriter(backend=str(config.TPU.CKPT_BACKEND),
                                   async_=bool(config.TPU.CKPT_ASYNC) and is_main)
    csv_handler = CSVHandler(log_save_path) if is_main else None
    device_prefetch = int(config.TPU.DEVICE_PREFETCH)

    def drain_loss(pending: deque) -> None:
        nonlocal iter_num
        loss_f = float(pending.popleft())
        if not np.isfinite(loss_f):
            # the reference raises on non-finite BCE inputs
            # (loss/DynamicLoss.py:15-19)
            raise FloatingPointError(
                f"non-finite train loss ({loss_f}) at iteration {iter_num + 1}: "
                "inputs or activations produced NaN/inf")
        train_loss_list.append(loss_f)
        iter_num += 1
        if writer is not None:
            writer.add_scalar("info/total_loss", loss_f, iter_num)

    try:
        for epoch_num in range(start_epoch, max_epoch):
            maybe_unfreeze(epoch_num, unfreeze_in_next_epoch)
            unfreeze_in_next_epoch = False
            lr = schedule.lr_at_epoch(epoch_num)
            t0 = time.perf_counter()
            decodes = dict(native.DECODES)
            loader_wait = [0.0]
            n_batches = 0
            pending: deque = deque()
            for image, label in prefetch_to_device(
                    train_loader.epoch_batches_merged(epoch_num, merge,
                                                      shard=(rank, world)),
                    dev, device_prefetch, loader_wait):
                pending.append(train_step(state, image, label, lr))
                n_batches += 1
                if len(pending) > 1:
                    drain_loss(pending)
            while pending:
                drain_loss(pending)
            epoch_time = time.perf_counter() - t0
            if n_batches != train_loader.num_batches(epoch_num, merge):
                raise RuntimeError(f"epoch {epoch_num}: {n_batches} steps, the plan has "
                                   f"{train_loader.num_batches(epoch_num, merge)}")
            if distributed:
                check_replicas(model)
                logger.info("rank_sync " + json.dumps({
                    "epoch": epoch_num + 1, "world": world,
                    "frozen_stages": sorted(frozen_stages),
                    "stage_sums": stage_sums(model)}))
            mean_train_loss = (sum(train_loss_list) / len(train_loss_list)
                               if train_loss_list else float("nan"))
            logger.info(f"Epoch {epoch_num + 1}: {n_batches} batches, lr={lr:.3e}, "
                        f"mean_train_loss={mean_train_loss:.5f}, {epoch_time:.1f}s")

            # -------- validation: rank 0's Score decides on every rank --------
            t0 = time.perf_counter()
            if is_main:
                mean_dice, output_dict, score, _, _ = validate(
                    eval_step, valloader, epoch_num + 1,
                    sig_threshold=float(config.TRAIN.SIG_THRESHOLD),
                    output_num=int(config.SHOW_PREDICTIONS),
                    mean_train_loss=mean_train_loss, logger=logger,
                    csv_handler=csv_handler, num_classes=num_classes)
            else:
                output_dict, score = [], float("nan")
            # every rank's: its steps, loader wait and decodes (rank 0 alone
            # validates)
            logger.info("epoch_timing " + json.dumps({
                "epoch": epoch_num + 1, "rank": rank, "train_s": epoch_time,
                "steps": n_batches, "loader_wait_s": loader_wait[0],
                "val_s": time.perf_counter() - t0 if is_main else 0.0,
                "val_cases": len(valloader) if is_main else 0,
                "decodes": {k: v - decodes[k] for k, v in native.DECODES.items()}}))
            if distributed:
                score = broadcast_float(score)

            # -------- model selection (Score) --------
            if score > best_score:
                save_best_output = output_dict
                best_score = score
                since_best = 0
                if config.SAVE_BEST_RUN and is_main:
                    path = ckpt_writer.save_best(log_save_path, model, epoch_num + 1,
                                                 best_score)
                    logger.info(f"Saved new BEST weights to {path} "
                                f"(Score={best_score:.5f})")
            else:
                since_best += 1
                if (since_best >= config.TRAIN.EARLY_STOPPING_PATIENCE
                        and config.TRAIN.EARLY_STOPPING_FLAG):
                    if not frozen_stages or not freeze_encoder:
                        logger.info(f"Early stopping at epoch {epoch_num} (no val "
                                    f"improvement for "
                                    f"{config.TRAIN.EARLY_STOPPING_PATIENCE} epochs).")
                        last_run = True
                    else:
                        unfreeze_in_next_epoch = True
                        since_best = 0

            if epoch_num >= max_epoch - 1:
                last_run = True
                if config.SAVE_LAST_RUN and is_main:
                    ckpt_writer.save_last(log_save_path, epoch_num, model, state.optimizer,
                                          iter_num, mean_dice)
            if last_run:
                if save_best_output and is_main:
                    create_bin_heat_mask_from_list(
                        save_best_output, pred_dir, config.DATA.DATA_PATH,
                        threshold=float(config.TRAIN.SIG_THRESHOLD))
                break
    finally:
        if csv_handler is not None:
            csv_handler.close_files()
        if writer is not None:
            writer.close()
    ckpt_writer.close()  # waits for background saves; re-raises a failure
    logger.info("Training finished")
    return "Training Finished!"
