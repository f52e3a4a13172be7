"""The one traffic generator: a pool of synthetic faces and artifact masks
made from the seed, and the rows each step or batch takes from it.

The images follow the port's ``data/synthetic.py`` (frozen here, drawn on
the device in bulk): a base colour in [60, 200) a channel, three Gaussian
blobs of radius 0.15-0.35 of the side shifting each channel by [-40, 40),
noise of std 6, clipped to uint8.  Even rows are fakes whose masks hold 1-3
ellipses of radii [side/20, side/6) at 255; odd rows are real faces with
empty masks, so every pair of rows takes both branches of the Dynamic loss.

A traffic file (``traffic/<name>.json``) sets ``entry`` (``train`` or
``predict``), ``batch_per_rank``, ``pool`` (rows made), ``check_steps``
(train: steps the reference follows), ``check_every`` (predict: one batch
in this many is kept for the comparison), ``trace_steps`` (steps or
batches a traced run profiles) and ``reference_rows`` (rows the reference
runs at a time).  The image size is the configuration's.
"""

from __future__ import annotations

from typing import Tuple

import torch

_CHUNK = 8


@torch.no_grad()
def _faces(n: int, size: int, g: torch.Generator, dev) -> torch.Tensor:
    base = torch.randint(60, 200, (n, 1, 1, 3), generator=g, device=dev).float()
    axis = torch.arange(size, device=dev, dtype=torch.float32) / size
    yy, xx = axis[:, None], axis[None, :]
    img = base.expand(n, size, size, 3).clone()
    for _ in range(3):
        cx, cy = torch.rand(2, n, 1, 1, generator=g, device=dev)
        r = 0.15 + 0.2 * torch.rand(n, 1, 1, generator=g, device=dev)
        shift = torch.randint(-40, 40, (n, 1, 1, 3), generator=g, device=dev).float()
        blob = torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r ** 2))
        img += blob[..., None] * shift
    img += 6.0 * torch.randn(img.shape, generator=g, device=dev)
    return img.clamp_(0, 255).to(torch.uint8)


@torch.no_grad()
def _masks(n: int, size: int, fake: torch.Tensor, g: torch.Generator, dev) -> torch.Tensor:
    axis = torch.arange(size, device=dev, dtype=torch.float32)
    yy, xx = axis[:, None], axis[None, :]
    count = torch.randint(1, 4, (n, 1, 1), generator=g, device=dev)
    out = torch.zeros((n, size, size), dtype=torch.bool, device=dev)
    for j in range(3):
        cx, cy = torch.randint(0, size, (2, n, 1, 1), generator=g, device=dev).float()
        rx, ry = torch.randint(size // 20, size // 6, (2, n, 1, 1), generator=g,
                               device=dev).float()
        inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
        out |= inside & (j < count) & fake[:, None, None]
    return out.to(torch.uint8) * 255


def make_pool(rows: int, size: int, seed: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(images (rows, size, size, 3), masks (rows, size, size))`` uint8 on the
    host, pinned when ``dev`` is a card."""
    g = torch.Generator(device=dev).manual_seed(int(seed))
    pin = torch.device(dev).type == "cuda"
    images = torch.empty((rows, size, size, 3), dtype=torch.uint8, pin_memory=pin)
    masks = torch.empty((rows, size, size), dtype=torch.uint8, pin_memory=pin)
    for lo in range(0, rows, _CHUNK):
        n = min(_CHUNK, rows - lo)
        fake = (torch.arange(lo, lo + n, device=dev) % 2) == 0
        images[lo:lo + n].copy_(_faces(n, size, g, dev))
        masks[lo:lo + n].copy_(_masks(n, size, fake, g, dev))
    return images, masks


def rows_of(step: int, batch: int, world: int, rank: int, pool: int) -> slice:
    """Rank ``rank``'s rows of step ``step``: global batches of
    ``batch * world`` rows follow each other through the pool, and each rank
    takes its contiguous part (as ``parallel/mesh.py::shard_batch`` does)."""
    width = batch * world
    if pool % width:
        raise ValueError(f"pool {pool} is not a multiple of the global batch {width}")
    start = (step * width) % pool + rank * batch
    return slice(start, start + batch)


def global_rows(step: int, batch: int, world: int, pool: int) -> slice:
    width = batch * world
    start = (step * width) % pool
    return slice(start, start + width)
