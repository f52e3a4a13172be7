"""The mesh of ranks: data parallelism, and the groups of tensor and
spatial parallelism (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package puts every device of one process into a
``jax.sharding.Mesh`` whose ``data`` axis carries the batch; XLA inserts
the gradient ``psum``.  Here each device is a rank of a
``torch.distributed`` process group, the model is wrapped in
``DistributedDataParallel`` (parameters replicated, gradients all-reduced
in the backward), and each rank trains on its rows of the global batch.

* :func:`make_mesh` (JAX ``make_mesh(n_data, n_model, n_space)``): the
  ranks laid out as JAX's ``reshape(n_data, n_model, n_space)``, this
  rank's coordinates and its data, model and space groups
  (:class:`Mesh`).  The model axis carries tensor parallelism
  (``parallel/tp.py``), the space axis the token grid's H
  (``parallel/spatial.py``); :meth:`Mesh.reduce_gradients` sums what they
  leave partial.
* :func:`world_size_for` sizes the trainer's data axis from
  ``HARDWARE.N_GPU``, as the JAX trainer does; ``TPU.MESH_SHAPE`` with a
  model or space axis above 1 raises there, since the JAX trainer builds a
  data mesh only (the library builds the others).
* :func:`init_process_group` / :func:`destroy_process_group`: ``nccl``
  when each rank has a card of its own (rank ``r`` on ``cuda:r``), ``gloo``
  on the CPU; ``backend=`` overrides.  Several ranks on one named card
  (``device="cuda:0"``) need an explicit backend, since NCCL refuses two
  ranks on one device.
* :func:`replicate_model` / :func:`replicate_state`: the DDP wrapper over
  the data group, rebuilt by the trainer whenever the set of trainable
  parameters changes (DDP fixes that set when it is built).
* :func:`shard_batch`: this rank's rows of a host batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def world_size_for(config) -> int:
    """The trainer's data axis: ``HARDWARE.N_GPU`` ranks (at least 1).
    ``TPU.MESH_SHAPE`` entries after the first (the model and space axes)
    must be 0 or 1; ``TPU.MODEL_AXIS`` / ``TPU.SPATIAL_AXIS`` only route the
    kernels off (the model's ``from_config``)."""
    shape = list(config.TPU.MESH_SHAPE)
    if any(int(n) > 1 for n in shape[1:]):
        raise NotImplementedError(
            f"TPU.MESH_SHAPE {shape}: the trainer builds a data mesh only, as the JAX "
            "trainer does; a model or space axis is the library's (parallel/mesh.py::"
            "make_mesh with parallel/tp.py and parallel/spatial.py)")
    return max(1, int(config.HARDWARE.N_GPU))


def mesh_coords(rank: int, n_model: int, n_space: int) -> Tuple[int, int, int]:
    """``(data, model, space)`` of ``rank`` in JAX's layout
    ``rank = (d * n_model + m) * n_space + s``."""
    return rank // (n_model * n_space), rank // n_space % n_model, rank % n_space


@dataclass
class Mesh:
    """This rank's place in an ``n_data x n_model x n_space`` mesh and its
    three groups (each of the ranks that differ only on that axis)."""

    n_data: int
    n_model: int
    n_space: int
    data: int
    model: int
    space: int
    data_group: object
    model_group: object
    space_group: object

    def reduce_gradients(self, module: torch.nn.Module) -> None:
        """What the data group's DDP leaves partial: every gradient is
        summed over the space group (each rank computed its rows' part),
        and the relative-position tables' over the model group (each rank
        its heads' columns).  The other replicated parameters' gradients
        are the model group's first rank's on every rank: the same sums on
        every rank, but a kernel that adds with atomics (the card's
        index and conv backwards) may round them apart, and the replicas
        would drift.  Call after the backward, before the update."""
        from .tp import tp_spec

        if self.n_space > 1:
            _reduce_grads([p for p in module.parameters() if p.grad is not None],
                          self.space_group)
        if self.n_model > 1:
            named = [(n, p) for n, p in module.named_parameters()
                     if p.grad is not None and tp_spec(n) is None]
            table = [n.endswith("relative_position_bias_table") for n, _ in named]
            _reduce_grads([p for (_, p), t in zip(named, table) if t], self.model_group)
            _reduce_grads([p for (_, p), t in zip(named, table) if not t], self.model_group,
                          src=dist.get_global_rank(self.model_group, 0))


def _reduce_grads(params, group, src: Optional[int] = None) -> None:
    """All-reduce the gradients of ``params`` over ``group`` in one buffer
    (or, with ``src``, broadcast rank ``src``'s)."""
    if not params:
        return
    grads = [p.grad for p in params]
    flat = _collective(torch.cat([g.reshape(-1) for g in grads]), group)
    if src is None:
        dist.all_reduce(flat, group=group)
    else:
        dist.broadcast(flat, src, group=group)
    flat = flat.to(grads[0].device)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_space: int = 1) -> Mesh:
    """The mesh over the initialised process group's ranks (JAX
    ``make_mesh``): ``n_data`` defaults to what the model and space axes
    leave.  Every rank creates every group, in one order."""
    world = dist.get_world_size()
    per = n_model * n_space
    if n_data is None or n_data <= 0:
        n_data = max(1, world // per)
    use = n_data * per
    if use > world:
        raise ValueError(f"mesh {n_data}x{n_model}x{n_space} needs {use} devices, "
                         f"have {world}")
    if use < world:
        raise ValueError(f"mesh {n_data}x{n_model}x{n_space} leaves {world - use} of "
                         f"{world} ranks out: every rank needs a place")
    ranks = torch.arange(world).reshape(n_data, n_model, n_space)
    d, m, s = mesh_coords(dist.get_rank(), n_model, n_space)

    def groups(lines, mine):
        out = None
        for i, line in enumerate(lines):
            group = dist.new_group(line.reshape(-1).tolist())
            if i == mine:
                out = group
        return out

    data = groups([ranks[:, j, k] for j in range(n_model) for k in range(n_space)],
                  m * n_space + s)
    model = groups([ranks[i, :, k] for i in range(n_data) for k in range(n_space)],
                   d * n_space + s)
    space = groups([ranks[i, j, :] for i in range(n_data) for j in range(n_model)],
                   d * n_model + m)
    return Mesh(n_data, n_model, n_space, d, m, s, data, model, space)


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


def replicate_model(module: torch.nn.Module, group=None) -> DistributedDataParallel:
    """``module`` (already on this rank's device) in DDP over ``group``
    (default: every rank).  Parameters no
    loss reaches (the last stage of each cent decoder) get no gradient on
    any rank: ``find_unused_parameters`` lets the reducer finish without
    them, and the train step's zero fill after it treats them alike on
    every rank."""
    dev = next(module.parameters()).device
    ids = [dev.index] if dev.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=ids, find_unused_parameters=True,
                                   process_group=group)


def replicate_state(state, mesh: Optional[Mesh] = None):
    """Give a :class:`TrainState` its DDP wrapper over the data group of
    ``mesh`` (by default the state's mesh, else every rank is a data rank)
    and its data rank and size, which fold into the noise seeds: the ranks
    of one data shard (its model and space ranks) draw the same noise.  A
    new wrapper replaces an earlier one, whose reducer is dropped first.
    Shard the state (``parallel/tp.py``) and attach the space group
    (``parallel/spatial.py``) before: DDP fixes the parameters' shapes."""
    mesh = mesh or state.mesh
    state.replica = None
    state.replica = replicate_model(state.model, mesh.data_group if mesh else None)
    state.mesh = mesh
    state.rank, state.world = ((mesh.data, mesh.n_data) if mesh
                               else (dist.get_rank(), dist.get_world_size()))
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


def _collective(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` where the backend can reduce it (gloo: host memory)."""
    return t if dist.get_backend(group) == "nccl" else t.cpu()


def broadcast_float(value: float, src: int = 0) -> float:
    """Rank ``src``'s ``value`` on every rank."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.broadcast(t, src)
    return float(t.item())


def parameter_digest(module: torch.nn.Module, names=None) -> torch.Tensor:
    """Per parameter (of ``names``, default all), its float64 sum and sum
    of squares: equal on every rank while the replicas agree."""
    with torch.no_grad():
        return torch.stack([torch.stack([p.double().sum(), p.double().square().sum()])
                            for n, p in module.named_parameters()
                            if names is None or n in names]).reshape(-1)


def check_replicas(module: torch.nn.Module, group=None, replicated_only: bool = False) -> None:
    """Raise unless every rank of ``group`` (default: all) holds the same
    parameters (the digest's element-wise maximum and minimum over the
    ranks agree); ``replicated_only`` leaves out the tensor-parallel
    shards."""
    from .tp import tp_spec

    names = [n for n, _ in module.named_parameters()
             if not (replicated_only and tp_spec(n))]
    d = _collective(parameter_digest(module, set(names)), group)
    hi, lo = d.clone(), d.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    bad = torch.nonzero(hi != lo).reshape(-1)
    if bad.numel():
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
