"""Device and dtype selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  With no GPU and no explicit ``"cpu"`` this raises; it
    never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``TPU.COMPUTE_DTYPE`` / ``TPU.SOFTMAX_DTYPE`` value -> torch dtype."""
    return torch.bfloat16 if str(name) == "bfloat16" else torch.float32
