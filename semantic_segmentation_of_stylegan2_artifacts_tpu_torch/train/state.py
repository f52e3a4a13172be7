"""Label-free predict step (counterpart of the JAX package's
``train/state.py``: ``normalize_images`` and ``make_predict_step``).

uint8 NHWC batches go to the device as they are and are normalised there
in the model's compute dtype, as in the JAX step."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.device import resolve_device


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> [0, 1] in ``dtype``."""
    return images_u8.to(dtype) / 255.0


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
        if not torch.is_tensor(image_u8):
            image_u8 = torch.from_numpy(np.require(image_u8, requirements=["C", "W"]))
        logits = model(normalize_images(image_u8.to(dev, non_blocking=True), dtype))
        if num_classes <= 1:
            return torch.sigmoid(logits[..., 0].float())
        return torch.sigmoid(logits.float())

    return step
