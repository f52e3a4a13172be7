"""Validation loss, label-free prediction and tiled inference (counterpart
of the JAX package's ``train/inference.py``: ``validation_loss``,
``artifact_prediction``, ``tiled_predict``).  ``eval_step`` and
``predict_step`` are the callables that :func:`..train.state.make_eval_step`
and :func:`..train.state.make_predict_step` return; the model they close
over holds the parameters."""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def validation_loss(eval_step: Callable, val_loader, bool_break: bool = False,
                    n_batches: int = 0) -> float:
    """Mean of the eval step's (batch-mean) loss over the loader, or over its
    first ``n_batches`` with ``bool_break`` (reference
    ``validation_functions.py:8-34``)."""
    losses: List[float] = []
    for i_batch, batch in enumerate(val_loader):
        if bool_break and i_batch >= n_batches:
            break
        _, loss = eval_step(batch["image"], batch["label"])
        losses.append(float(loss.mean()))
    return sum(losses) / len(losses) if losses else float("nan")


def artifact_prediction(predict_step: Callable, loader) -> List[Tuple[str, np.ndarray]]:
    """``(case_name, probability map)`` for the first image of each batch
    of an image-only loader (reference ``validation_functions.py:312-357``)."""
    out: List[Tuple[str, np.ndarray]] = []
    for batch in loader:
        probs = predict_step(batch["image"])
        out.append((batch["case_name"][0], probs[0].cpu().numpy()))
    return out


def _hann2d(tile: int) -> np.ndarray:
    w = np.hanning(tile + 2)[1:-1]
    return np.maximum(np.outer(w, w), 1e-3).astype(np.float32)


def tile_grid(size: int, tile: int, stride: int) -> List[int]:
    """Tile start offsets covering [0, size) with the last tile flush."""
    if tile >= size:
        return [0]
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] != size - tile:
        starts.append(size - tile)
    return starts


def tiled_predict(predict_step: Callable, image_u8: np.ndarray, tile: int,
                  overlap: float = 0.5, batch_tiles: int = 8) -> np.ndarray:
    """Sliding-window probability map for one ``(H, W, 3)`` uint8 image.

    Tiles go through ``predict_step`` in batches of ``batch_tiles`` (a
    short last batch is padded with zero tiles, so every call has one
    shape) and are blended with a 2-D Hann window.  Per-class outputs
    ``(B, tile, tile, C)`` blend channel-wise into ``(H, W, C)``."""
    h, w, _ = image_u8.shape
    stride = max(1, int(tile * (1.0 - overlap)))
    coords = [(y, x) for y in tile_grid(h, tile, stride) for x in tile_grid(w, tile, stride)]
    win = _hann2d(tile)
    acc = None
    den = np.zeros((h, w), np.float64)
    for i in range(0, len(coords), batch_tiles):
        chunk = coords[i:i + batch_tiles]
        tiles = np.stack([image_u8[y:y + tile, x:x + tile] for y, x in chunk])
        if len(chunk) < batch_tiles:
            pad = np.zeros((batch_tiles - len(chunk), tile, tile, 3), np.uint8)
            tiles = np.concatenate([tiles, pad])
        probs = predict_step(tiles).cpu().numpy()
        if acc is None:
            acc = np.zeros((h, w) + probs.shape[3:], np.float64)
        for (y, x), p in zip(chunk, probs):
            acc[y:y + tile, x:x + tile] += p.astype(np.float64) * (
                win if p.ndim == 2 else win[:, :, None])
            den[y:y + tile, x:x + tile] += win
    dv = den if acc.ndim == 2 else den[:, :, None]
    return (acc / np.maximum(dv, 1e-9)).astype(np.float32)
