"""Fake/real-aware batch sampling (a copy of the JAX package's
``data/sampler.py``).

Deterministic batch-index generator with the reference's guarantees
(reference ``scripts/batch_data_loader_V2.py``):

* batch size 2, exactly ``(n_fake + n_real) // 2`` batches per epoch,
* every batch contains at least one fake image; the per-epoch pattern
  (how many all-fake vs fake+real batches) matches the pool sizes,
* deterministic per epoch: a ``random.Random(epoch)`` shuffles the pools
  and the pattern, and a ``random.Random(epoch + b)`` decides the
  in-batch order — identical stream semantics to the reference, so epoch
  schedules reproduce.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Sequence


class BatchPatternSampler:
    """Yields lists of dataset indices (batches of 2: >=1 fake each)."""

    def __init__(self, fake_indices: Sequence[int], real_indices: Sequence[int],
                 num_batch: int, batch_size: int, epoch: int):
        self.fake_indices = list(fake_indices)
        self.real_indices = list(real_indices)
        if batch_size != 2:
            raise ValueError("batch_size must be 2 ")
        if len(self.fake_indices) == 0:
            raise ValueError(
                "Need at least 1 fake index to guarantee 'at least one fake "
                "per batch'."
            )
        if len(self.real_indices) == 0:
            raise ValueError(
                "Need at least 1 real index to guarantee 'at least one fake "
                "per batch'."
            )
        if len(self.fake_indices) + len(self.real_indices) != 2 * num_batch:
            raise ValueError("num fake + num real != batch_size * 2")
        if len(self.fake_indices) < num_batch:
            raise ValueError(
                "num fake needs to be higher than the number of batches"
            )
        self.epoch = epoch
        self.num_batch = num_batch
        rest_fake = len(self.fake_indices) - num_batch
        # pattern entry 2 => fake+fake batch; 1 => fake+real batch
        self.pattern = [2] * rest_fake + [1] * len(self.real_indices)

    def __len__(self) -> int:
        return self.num_batch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __iter__(self) -> Iterator[List[int]]:
        rng = random.Random(self.epoch)
        fake = self.fake_indices.copy()
        real = self.real_indices.copy()
        rng.shuffle(fake)
        rng.shuffle(real)
        pattern = self.pattern.copy()
        rng.shuffle(pattern)

        i_fake = 0
        i_real = 0
        for b in range(self.num_batch):
            rng_batch = random.Random(self.epoch + b)
            fake_first = rng_batch.random() < 0.5
            if pattern[b] == 1:
                pair_other = real[i_real]
                i_real += 1
            else:
                pair_other = None
            first_fake = fake[i_fake]
            i_fake += 1
            if pair_other is None:
                second = fake[i_fake]
                i_fake += 1
            else:
                second = pair_other
            # in-batch order: fake first or second, per the epoch+b draw
            if fake_first:
                yield [first_fake, second]
            else:
                yield [second, first_fake]
