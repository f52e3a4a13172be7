"""Sequential image-only loader (counterpart of the JAX package's
``data/pipeline.py::EvalLoader`` with the no-augmentation path of
``data/augment.py::RandomGenerator``): worker threads decode one image per
batch, batches are uint8 NHWC numpy, normalisation happens on the device."""

from __future__ import annotations

import concurrent.futures as cf
from typing import Dict, Iterator

import numpy as np

_WORKERS = 2
_PREFETCH = 2  # batches decoded ahead


class EvalLoader:
    """Batches ``{'image': (1,H,W,3) u8, 'case_name': [name]}`` in split
    order, a few decoded ahead by worker threads.  Each image must already
    be ``img_size`` square with 3 channels (no augmentation, no resize, as
    the reference's test-time ``RandomGenerator``)."""

    def __init__(self, ds, img_size: int):
        self.ds = ds
        self.size = (img_size, img_size)

    def __len__(self) -> int:
        return len(self.ds)

    def _fetch(self, idx: int) -> Dict:
        sample = self.ds[idx]
        image = np.asarray(sample["image"], dtype=np.uint8)
        if image.shape[:2] != self.size:
            raise ValueError(f"RandomGenerator: Wrong image size: {image.shape[:2]}")
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("RandomGenerator: Image does not have 3 channels")
        return {"image": image[None], "case_name": [sample["case_name"]]}

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.ds)
        with cf.ThreadPoolExecutor(_WORKERS) as pool:
            pending = [pool.submit(self._fetch, i) for i in range(min(_PREFETCH, n))]
            nxt = len(pending)
            while pending:
                fut = pending.pop(0)
                if nxt < n:
                    pending.append(pool.submit(self._fetch, nxt))
                    nxt += 1
                yield fut.result()
