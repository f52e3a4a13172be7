"""Train state, train/eval steps and the label-free predict step
(counterpart of the JAX package's ``train/state.py``).

uint8 NHWC batches go to the device as they are and are normalised there
in the model's compute dtype, as in the JAX steps.  A train step runs the
forward in the compute dtype with float32 parameters, the Dynamic loss
in float32, the backward and one AdamW update with the learning rate
passed per call.  Dropout and stochastic-depth noise come from the state's
``torch.Generator``, re-seeded from (seed, step, micro-batch) before each
forward, so a step is reproducible.

Under data parallelism (``parallel/mesh.py::replicate_state``) the
forward and backward run through the state's ``DistributedDataParallel``
wrapper, which all-reduces the gradients over the data group: every
micro-batch but the last under ``no_sync()``.  The data rank folds into the
noise seeds (data rank 0 keeps the one-process seeds), so the model and
space ranks of one data shard draw the same masks, and the returned loss is
the mean over the data ranks.  Under a mesh with a model or space axis the
gradients those axes leave partial are summed before the update
(``Mesh.reduce_gradients``); every rank computes its data shard's whole
loss.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..losses import dynamic_loss
from ..losses.losses import dynamic_loss_per_sample
from ..losses.multiclass import (
    dynamic_loss_multiclass,
    dynamic_loss_multiclass_per_sample,
)
from ..models.layers import noise_generator
from .optim import build_optimizer, set_learning_rate


@dataclass
class TrainState:
    """What a train step updates: the model's parameters (in place),
    the optimizer's moments, the step count; and the noise generator.
    ``replica`` is the model's DDP wrapper under data parallelism,
    ``rank`` / ``world`` this rank's data rank and the data size, and
    ``mesh`` the ``parallel/mesh.py::Mesh`` when one was given."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    seed: int
    step: int = 0
    replica: Optional[torch.nn.Module] = None
    rank: int = 0
    world: int = 1
    mesh: Optional[object] = None


def create_train_state(model: torch.nn.Module, config, device=None) -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller passes
    another; raises with no GPU) and pair it with ``build_optimizer``'s
    AdamW and a generator there; noise seeds derive from ``config.SEED``."""
    dev = resolve_device(device)
    model.to(dev)
    return TrainState(model=model, optimizer=build_optimizer(config, model),
                      generator=torch.Generator(device=dev), seed=int(config.SEED))


def _noise_seed(seed: int, step: int, micro: int, rank: int = 0) -> int:
    """The noise seed of a micro-batch; data ranks other than 0 add their
    data rank, so the data ranks draw independent masks for their
    different rows."""
    entropy = [seed, step, micro] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> [0, 1] in ``dtype``."""
    return images_u8.to(dtype) / 255.0


def encode_labels(label_u8: torch.Tensor, num_classes: int) -> torch.Tensor:
    """uint8 label maps -> loss targets: a float map ``(B, H, W)`` for one
    class; for ``num_classes > 1`` class ids 0..C (0 = background)
    one-hot encoded to ``(B, H, W, C)`` multi-label targets."""
    if num_classes <= 1:
        return label_u8.float()
    onehot = torch.nn.functional.one_hot(label_u8.long(), num_classes + 1)
    return onehot[..., 1:].float()


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return a.to(dev, non_blocking=True)


def _loss_for(num_classes: int, per_sample: bool = False) -> Callable:
    if num_classes <= 1:
        return dynamic_loss_per_sample if per_sample else dynamic_loss
    return dynamic_loss_multiclass_per_sample if per_sample else dynamic_loss_multiclass


def make_train_step(model: torch.nn.Module, loss_alpha: float, loss_beta: float,
                    loss_mix: float, accumulation_steps: int = 1,
                    num_classes: int = 1) -> Callable:
    """``step(state, image_u8, label_u8, lr) -> loss`` (a float32 scalar
    tensor on the device; the state is updated in place).

    ``accumulation_steps > 1`` splits the batch into micro-batches whose
    losses and gradients are averaged before one optimizer update.
    ``num_classes > 1`` takes the multi-label Dynamic loss with integer
    class-id label maps (see :func:`encode_labels`)."""
    loss_impl = _loss_for(num_classes)
    acc = int(accumulation_steps)

    def step(state: TrainState, image_u8, label_u8, lr) -> torch.Tensor:
        dev = next(model.parameters()).device
        model.train()
        images = normalize_images(_as_tensor(image_u8, dev), model.dtype)
        labels = encode_labels(_as_tensor(label_u8, dev), num_classes)
        b = images.shape[0]
        if b % acc:
            raise ValueError(f"batch {b} not divisible by accumulation_steps {acc}")
        mb = b // acc
        set_learning_rate(state.optimizer, lr)
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        net = model if state.replica is None else state.replica
        for i in range(acc):
            # DDP all-reduces in the backward of the last micro-batch only
            sync = (state.replica.no_sync() if state.replica is not None and i < acc - 1
                    else contextlib.nullcontext())
            with sync:
                state.generator.manual_seed(
                    _noise_seed(state.seed, state.step, i, state.rank))
                with noise_generator(state.generator):
                    logits = net(images[i * mb:(i + 1) * mb])
                loss_i = loss_impl(logits, labels[i * mb:(i + 1) * mb], loss_alpha,
                                   loss_beta, loss_mix)
                (loss_i / acc).backward()
            loss = loss + loss_i.detach()
        # trainable parameters the loss does not reach (the last stage of
        # each cent decoder, whose output the reference drops) get zero
        # gradients, so AdamW still decays them, as optax does; a frozen
        # parameter (requires_grad False) keeps none: no update, no decay
        for p in model.parameters():
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        if state.mesh is not None:
            state.mesh.reduce_gradients(model)
        state.optimizer.step()
        state.step += 1
        if state.world > 1:
            dist.all_reduce(loss, group=None if state.mesh is None else state.mesh.data_group)
            loss = loss / state.world
        return loss / acc

    return step


def make_eval_step(model: torch.nn.Module, loss_alpha: float, loss_beta: float,
                   loss_mix: float, num_classes: int = 1, per_sample: bool = False,
                   device=None) -> Callable:
    """``step(image_u8, label_u8) -> (probs float32, loss)`` in eval mode:
    ``(B, H, W)`` sigmoids of the single logit channel, or ``(B, H, W, C)``
    per class; ``per_sample=True`` returns a ``(B,)`` loss vector."""
    dev = resolve_device(device)
    model.to(dev)
    loss_impl = _loss_for(num_classes, per_sample)

    @torch.inference_mode()
    def step(image_u8, label_u8):
        model.eval()
        logits = model(normalize_images(_as_tensor(image_u8, dev), model.dtype))
        loss = loss_impl(logits, encode_labels(_as_tensor(label_u8, dev), num_classes),
                         loss_alpha, loss_beta, loss_mix)
        probs = logits[..., 0] if num_classes <= 1 else logits
        return torch.sigmoid(probs.float()), loss

    return step


def make_predict_step(model: torch.nn.Module, num_classes: int = 1,
                      device=None) -> Callable:
    """``step(image_u8) -> probs`` float32: ``(B, H, W)`` sigmoid of the
    single logit channel, or ``(B, H, W, C)`` per-class sigmoids.

    Runs on ``device`` (the card unless the caller passes another; raises
    with no GPU); the model is moved there and put in eval mode."""
    dev = resolve_device(device)
    model.to(dev).eval()
    dtype = model.dtype

    @torch.inference_mode()
    def step(image_u8) -> torch.Tensor:
        logits = model(normalize_images(_as_tensor(image_u8, dev), dtype))
        if num_classes <= 1:
            return torch.sigmoid(logits[..., 0].float())
        return torch.sigmoid(logits.float())

    return step
