"""Host data pipeline: threaded decode and augment with prefetch, uint8
batches for the device (counterpart of the JAX package's
``data/pipeline.py``; reference ``trainer.py:193-245``).

Worker threads (PIL and cv2 release the GIL) assemble uint8 NHWC numpy
batches; normalisation to [0, 1] happens on the device inside the step.
Epoch construction reproduces the reference's mixed set
(``trainer.py:196-237``): a dynamic real-ratio schedule picks ``num_real``
real images per epoch, a seeded draw selects the subset, and
:class:`BatchPatternSampler` puts at least one fake image in every pair.
The batches are equal in bytes to the JAX package's for the same seed.
"""

from __future__ import annotations

import concurrent.futures as cf
import random
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .augment import RandomGenerator, sample_rng
from .sampler import BatchPatternSampler


def real_ratio_schedule(epoch: int, dynamic: bool) -> float:
    """Per-epoch real-image ratio (reference ``trainer.py:196-208``)."""
    if not dynamic:
        return 0.4
    if epoch < 9:
        return 0.1
    if epoch < 20:
        return 0.10 + 0.03 * (epoch - 8)
    if epoch < 30:
        return 0.4
    if epoch < 35:
        return 0.2
    return 0.4


def num_real_for_ratio(total_fake: int, total_real: int, real_ratio: float) -> int:
    """``num_real`` so the mixed set has the requested ratio and an even
    size (reference ``trainer.py:210-215``)."""
    num_real = int((total_fake / (1.0 - real_ratio)) * real_ratio)
    if (num_real + total_fake) % 2 != 0:
        num_real = max(0, num_real - 1)
    if num_real > total_real:
        raise ValueError(f"More real images required than available: num_real "
                         f"{num_real} total_real {total_real}")
    return num_real


def _stack_batch(samples: List[Dict]) -> Dict:
    batch = {"image": np.stack([s["image"] for s in samples]),
             "case_name": [s["case_name"] for s in samples]}
    if "label" in samples[0]:
        batch["label"] = np.stack([s["label"] for s in samples])
    return batch


def _prefetched(jobs: List, make: Callable[..., Dict], workers: int,
                depth: int) -> Iterator[Dict]:
    """``make(job)`` for each job on worker threads, ``depth`` ahead of the
    consumer, yielded in order."""
    with cf.ThreadPoolExecutor(workers) as pool:
        pending = [pool.submit(make, j) for j in jobs[:depth]]
        nxt = len(pending)
        while pending:
            fut = pending.pop(0)
            if nxt < len(jobs):
                pending.append(pool.submit(make, jobs[nxt]))
                nxt += 1
            yield fut.result()


class TrainLoader:
    """Per-epoch mixed fake/real loader with deterministic augmentation."""

    def __init__(self, fake_ds, real_ds, img_size: int, seed: int = 0,
                 dynamic_loader: bool = False, num_workers: int = 4,
                 prefetch_depth: int = 2, batch_size: int = 2, num_classes: int = 1):
        self.fake_ds = fake_ds
        self.real_ds = real_ds
        self.seed = seed
        self.dynamic_loader = dynamic_loader
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self.batch_size = batch_size
        self.transform = RandomGenerator(
            output_size=[img_size, img_size], random_flip_flag=True, transform=True,
            seed=seed, num_classes=num_classes)

    def num_batches(self, epoch: int, merge: int = 1) -> int:
        ratio = real_ratio_schedule(epoch, self.dynamic_loader)
        n_real = num_real_for_ratio(len(self.fake_ds), len(self.real_ds), ratio)
        return (len(self.fake_ds) + n_real) // self.batch_size // merge

    def _epoch_plan(self, epoch: int):
        """Index-level epoch plan ``(sampler pairs, fetch)``, seeded by
        ``(seed, epoch)`` only; nothing is decoded here."""
        n_fake = len(self.fake_ds)
        n_real = num_real_for_ratio(n_fake, len(self.real_ds),
                                    real_ratio_schedule(epoch, self.dynamic_loader))
        # seeded real-subset selection (reference trainer.py:218-221)
        real_subset = random.Random(self.seed + epoch).sample(range(len(self.real_ds)),
                                                              n_real)
        # index space: 0..n_fake-1 fake, n_fake..n_fake+n_real-1 the real subset
        sampler = BatchPatternSampler(
            fake_indices=range(n_fake), real_indices=range(n_fake, n_fake + n_real),
            num_batch=(n_fake + n_real) // self.batch_size,
            batch_size=self.batch_size, epoch=epoch + 1)

        def fetch(idx: int) -> Dict:
            sample = (self.fake_ds[idx] if idx < n_fake
                      else self.real_ds[real_subset[idx - n_fake]])
            return self.transform(sample, rng=sample_rng(self.seed, epoch, idx))

        return list(sampler), fetch

    def epoch_batches(self, epoch: int) -> Iterator[Dict]:
        """Batches ``{'image': (B,H,W,3) u8, 'label': (B,H,W) u8, 'case_name'}``."""
        yield from self.epoch_batches_merged(epoch, 1)

    def epoch_batches_merged(self, epoch: int, merge: int,
                             shard: Optional[Tuple[int, int]] = None) -> Iterator[Dict]:
        """``merge`` sampler pairs concatenated into one global batch (each
        pair keeps its at-least-one-fake guarantee); trailing pairs that do
        not fill a batch are dropped.

        ``shard=(rank, world)`` decodes only this rank's rows: ``merge`` is
        the global pair count a step, and the rank takes the contiguous
        ``merge // world`` pairs at offset ``rank * (merge // world)`` of
        each group.  The plan depends on ``(seed, epoch)`` alone, so every
        rank derives the same global batches."""
        pi, pc = (0, 1) if shard is None else (int(shard[0]), int(shard[1]))
        if pc < 1 or not 0 <= pi < pc:
            raise ValueError(f"bad shard {shard}")
        merge = max(1, merge)
        if merge % pc != 0:
            raise ValueError(f"global merge {merge} not divisible by process_count {pc}")
        local = merge // pc
        pairs, fetch = self._epoch_plan(epoch)
        groups = [[i for pair in pairs[g * merge + pi * local:g * merge + (pi + 1) * local]
                   for i in pair]
                  for g in range(len(pairs) // merge)]
        yield from _prefetched(groups, lambda g: _stack_batch([fetch(i) for i in g]),
                               self.num_workers, self.prefetch_depth)


class EvalLoader:
    """Sequential loader without augmentation (val, test and predict).

    ``batch_size=1`` is the reference's per-case loop.  ``pad_to_batch``
    pads a short last batch to ``batch_size`` by repeating its last sample,
    so every batch has one shape; padded entries carry no ``case_name``, so
    ``len(batch['case_name'])`` is the count of valid leading samples and
    consumers ignore the tail.  Images must already be ``img_size`` square
    with 3 channels (no resize, as the reference's test-time transform)."""

    def __init__(self, ds, img_size: int, num_workers: int = 2, prefetch_depth: int = 2,
                 num_classes: int = 1, batch_size: int = 1, pad_to_batch: bool = False):
        self.ds = ds
        self.transform = RandomGenerator(
            output_size=[img_size, img_size], random_flip_flag=False, transform=False,
            num_classes=num_classes)
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self.batch_size = max(1, batch_size)
        self.pad_to_batch = pad_to_batch

    def __len__(self) -> int:
        return len(self.ds)

    def _fetch(self, chunk: List[int]) -> Dict:
        batch = _stack_batch([self.transform(self.ds[i]) for i in chunk])
        pad = self.batch_size - len(chunk)
        if self.pad_to_batch and pad > 0:
            for key in ("image", "label"):
                if key in batch:
                    tail = np.repeat(batch[key][-1:], pad, axis=0)
                    batch[key] = np.concatenate([batch[key], tail])
        return batch

    def __iter__(self) -> Iterator[Dict]:
        bs, n = self.batch_size, len(self.ds)
        chunks = [list(range(i, min(i + bs, n))) for i in range(0, n, bs)]
        yield from _prefetched(chunks, self._fetch, self.num_workers, self.prefetch_depth)
