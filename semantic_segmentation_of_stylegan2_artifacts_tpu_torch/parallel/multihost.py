"""Rank-sharded input (counterpart of the JAX package's
``parallel/multihost.py``).

Every rank of a data-parallel run derives the same global epoch plan from
``(seed, epoch)`` alone and decodes only its own rows of each global batch
(``TrainLoader.epoch_batches_merged(..., shard=host_shard())``), so the
ranks agree on the global batch without exchanging data.

JAX ``make_global_batch`` assembles the hosts' local rows into one global
array; it has no counterpart here: under ``DistributedDataParallel`` each
rank keeps its local rows, and the gradients, not the batches, are
all-reduced.
"""

from __future__ import annotations

from typing import Tuple

import torch.distributed as dist


def host_shard() -> Tuple[int, int]:
    """``(rank, world_size)`` of the process group, ``(0, 1)`` when none is
    up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_merge(global_merge: int) -> int:
    """Sampler pairs this rank decodes per global batch of
    ``global_merge`` pairs."""
    pc = host_shard()[1]
    if global_merge % pc != 0:
        raise ValueError(f"global merge {global_merge} not divisible by "
                         f"process_count {pc}")
    return global_merge // pc
