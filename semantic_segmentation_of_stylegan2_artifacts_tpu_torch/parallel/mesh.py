"""Data parallelism over ranks (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package puts every device of one process into a
``jax.sharding.Mesh`` whose ``data`` axis carries the batch; XLA inserts
the gradient ``psum``.  Here each device is a rank of a
``torch.distributed`` process group, the model is wrapped in
``DistributedDataParallel`` (parameters replicated, gradients all-reduced
in the backward), and each rank trains on its rows of the global batch.

* :func:`world_size_for` sizes the data axis from ``HARDWARE.N_GPU``, as
  the JAX trainer does; ``TPU.MESH_SHAPE`` with a model or space axis
  above 1 raises (tensor and spatial parallelism are not ported yet).
* :func:`init_process_group` / :func:`destroy_process_group`: ``nccl``
  when each rank has a card of its own (rank ``r`` on ``cuda:r``), ``gloo``
  on the CPU; ``backend=`` overrides.  Several ranks on one named card
  (``device="cuda:0"``) need an explicit backend, since NCCL refuses two
  ranks on one device.
* :func:`replicate_model` / :func:`replicate_state`: the DDP wrapper,
  rebuilt by the trainer whenever the set of trainable parameters changes
  (DDP fixes that set when it is built).
* :func:`shard_batch`: this rank's rows of a host batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def world_size_for(config) -> int:
    """The data axis of ``config``: ``HARDWARE.N_GPU`` ranks (at least 1).
    ``TPU.MESH_SHAPE`` entries after the first (the model and space axes)
    must be 0 or 1, and ``TPU.MODEL_AXIS`` / ``TPU.SPATIAL_AXIS`` empty."""
    tpu = config.TPU
    for key in ("SPATIAL_AXIS", "MODEL_AXIS"):
        if str(getattr(tpu, key, "")):
            raise NotImplementedError(f"TPU.{key} (sharding) is not ported yet")
    if any(int(n) > 1 for n in list(tpu.MESH_SHAPE)[1:]):
        raise NotImplementedError(
            f"TPU.MESH_SHAPE {list(tpu.MESH_SHAPE)}: a model or space axis (tensor or "
            "spatial parallelism) is not ported yet")
    return max(1, int(config.HARDWARE.N_GPU))


def check_world(world: int, device="cuda", backend: Optional[str] = None) -> None:
    """JAX ``make_mesh``'s check: ``world`` ranks, one card each, need
    ``world`` visible cards.  Ranks that share a named card
    (``device="cuda:0"``) or run on the CPU are the caller's choice and
    need ``backend``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    if dev.index is None:
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"mesh {world}x1x1 needs {world} devices, have {have}")
    elif world > 1 and backend is None:
        raise ValueError(f"{world} ranks on {dev} need an explicit backend: NCCL "
                         "refuses two ranks on one device (pass backend='gloo')")


def rank_device(local_rank: int, device="cuda") -> torch.device:
    """``cuda:{local_rank}`` for ``device="cuda"``; a named card or the CPU
    as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def init_process_group(rank: int, world: int, init_method: str, device="cuda",
                       backend: Optional[str] = None,
                       local_rank: Optional[int] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world`` (``local_rank`` on
    this host, by default ``rank``); returns this rank's device (made
    current on the card)."""
    dev = rank_device(rank if local_rank is None else local_rank, device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if torch.device(device).index is not None:
            check_world(world, device, backend)
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} needs {dev}, have "
                             f"{torch.cuda.device_count()} devices")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


def destroy_process_group() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def replicate_model(module: torch.nn.Module) -> DistributedDataParallel:
    """``module`` (already on this rank's device) in DDP.  Parameters no
    loss reaches (the last stage of each cent decoder) get no gradient on
    any rank: ``find_unused_parameters`` lets the reducer finish without
    them, and the train step's zero fill after it treats them alike on
    every rank."""
    dev = next(module.parameters()).device
    ids = [dev.index] if dev.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=ids, find_unused_parameters=True)


def replicate_state(state):
    """Give a :class:`TrainState` its DDP wrapper and this rank's place
    (the rank folds into the noise seeds); a new wrapper replaces an
    earlier one, whose reducer is dropped first."""
    state.replica = None
    state.replica = replicate_model(state.model)
    state.rank, state.world = dist.get_rank(), dist.get_world_size()
    return state


def shard_batch(batch: Dict, rank: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """This rank's contiguous rows of a host batch (arrays and the
    ``case_name`` list); the rows must split evenly."""
    if rank is None or world is None:
        from .multihost import host_shard

        rank, world = host_shard()
    out = {}
    for key, val in batch.items():
        n = len(val)
        if n % world:
            raise ValueError(f"{key}: {n} rows do not split over {world} ranks")
        k = n // world
        out[key] = val[rank * k:(rank + 1) * k]
    return out


def _collective(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can reduce it (gloo: host memory)."""
    return t if dist.get_backend() == "nccl" else t.cpu()


def broadcast_float(value: float, src: int = 0) -> float:
    """Rank ``src``'s ``value`` on every rank."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.broadcast(t, src)
    return float(t.item())


def parameter_digest(module: torch.nn.Module) -> torch.Tensor:
    """Per parameter, its float64 sum and sum of squares: equal on every
    rank while the replicas agree."""
    with torch.no_grad():
        return torch.stack([torch.stack([p.double().sum(), p.double().square().sum()])
                            for p in module.parameters()]).reshape(-1)


def check_replicas(module: torch.nn.Module) -> None:
    """Raise unless every rank holds the same parameters (the digest's
    element-wise maximum and minimum over the ranks agree)."""
    d = _collective(parameter_digest(module))
    hi, lo = d.clone(), d.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    bad = torch.nonzero(hi != lo).reshape(-1)
    if bad.numel():
        names = [n for n, _ in module.named_parameters()]
        raise RuntimeError(f"rank {dist.get_rank()}: replicas differ in "
                           f"{sorted({names[i // 2] for i in bad.tolist()})[:5]}")


def stage_sums(module: torch.nn.Module) -> Dict[str, float]:
    """Float64 sum of each encoder stage's parameters (``layers.<i>``), for
    logs that show which stages trained."""
    sums: Dict[str, float] = {}
    for name, p in module.state_dict().items():
        parts = name.split(".")
        for i, part in enumerate(parts[:-1]):
            if part == "layers" and parts[i + 1].isdigit():
                key = f"layers.{parts[i + 1]}"
                sums[key] = sums.get(key, 0.0) + float(p.double().sum())
                break
    return dict(sorted(sums.items()))
