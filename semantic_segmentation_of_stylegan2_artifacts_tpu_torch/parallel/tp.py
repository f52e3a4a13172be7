"""Tensor parallelism over the ``model`` group (counterpart of the JAX
package's ``parallel/tp.py``).

JAX places the transformer products Megatron-style on the ``model`` mesh
axis and lets GSPMD insert the collectives.  Here the placement and the
collectives are explicit:

* :func:`tp_spec` gives each parameter name JAX's rule: ``attn.qkv`` and
  ``mlp.0`` (``fc1``) weights and biases are column-parallel (their output
  rows are split), ``attn.proj`` and ``mlp.3`` (``fc2``) weights are
  row-parallel (their input columns are split; torch's ``(out, in)``
  layout flips JAX's dims), everything else is replicated, the
  relative-position tables included.  The cent decoders' blocks follow the
  same names.
* The qkv split goes by heads: rank ``m`` of ``T`` holds the q, k and v
  rows of heads ``[m H/T, (m+1) H/T)`` (:func:`shard_index`), so it can
  attend over its own heads.  JAX's ``P(None, 'model')`` splits the 3C
  rows contiguously instead; the numbers are the same either way.
* :func:`shard_params_tp` / :func:`shard_state_tp` cut the parameters (and
  their AdamW moments) in place, so the optimizer keeps its parameters,
  and attach a :class:`TensorShard` to every ``WindowAttention`` and
  ``Mlp``, which then compute their heads or hidden units between
  Megatron's f (identity forward, all-reduce backward) at the input and g
  (all-reduce forward, identity backward) after the row-parallel product,
  the row-parallel bias added once after g.
* Each rank gathers its heads' columns of the replicated table; the
  table's gradient is summed over the group before AdamW
  (``parallel/mesh.py::Mesh.reduce_gradients``).  Every other replicated
  parameter gets the same gradient on every rank (equal in bits on the
  CPU); ``reduce_gradients`` hands the group's first rank's to all, since
  the card's atomic adds may round them apart.
* :func:`unshard_state_dict_tp` gathers a full ``state_dict`` with the
  unsharded keys and shapes (checkpoints, the weight bridge);
  :func:`shard_state_dict_tp` cuts a full one for this rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

_COLUMN = ("attn.qkv.weight", "attn.qkv.bias", "mlp.0.weight", "mlp.0.bias")
_ROW = ("attn.proj.weight", "mlp.3.weight")


def tp_spec(name: str) -> Optional[str]:
    """``"column"``, ``"row"`` or None (replicated) for a parameter name."""
    if name.endswith(_COLUMN):
        return "column"
    if name.endswith(_ROW):
        return "row"
    return None


def shard_index(name: str, shape, size: int, rank: int) -> Tuple[int, torch.Tensor]:
    """``(dim, index)``: the rows (column-parallel) or columns (row-parallel)
    of the full parameter ``name`` of ``shape`` that ``rank`` of ``size``
    holds.  qkv goes by heads: the same slice of each of q, k and v."""
    dim = 0 if tp_spec(name) == "column" else 1
    parts = 3 if ".attn.qkv." in "." + name else 1
    n = shape[dim] // parts
    if n % size:
        raise ValueError(f"{name}: {n} does not split over {size} ranks")
    k = n // size
    idx = torch.cat([p * n + torch.arange(rank * k, (rank + 1) * k) for p in range(parts)])
    return dim, idx


def _cut(name: str, t: torch.Tensor, size: int, rank: int) -> torch.Tensor:
    dim, idx = shard_index(name, t.shape, size, rank)
    return t.index_select(dim, idx.to(t.device)).contiguous()


def shard_state_dict_tp(state_dict: Dict[str, torch.Tensor], size: int,
                        rank: int) -> Dict[str, torch.Tensor]:
    """``rank``'s shard of a full state dict (replicated tensors as they are)."""
    return {name: t if tp_spec(name) is None else _cut(name, t, size, rank)
            for name, t in state_dict.items()}


def unshard_tensor(name: str, shards) -> torch.Tensor:
    """The full parameter ``name`` from every rank's shard, rank order."""
    size = len(shards)
    dim = 0 if tp_spec(name) == "column" else 1
    shape = list(shards[0].shape)
    shape[dim] *= size
    full = shards[0].new_empty(shape)
    for rank, shard in enumerate(shards):
        _, idx = shard_index(name, shape, size, rank)
        full.index_copy_(dim, idx.to(shard.device), shard)
    return full


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorShard:
    """This rank's place in the ``model`` group, held by the modules it
    shards; ``copy`` is f and ``reduce`` g."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.group)

    def part(self, total: int) -> Tuple[int, int]:
        """``(start, count)`` of this rank's share of ``total`` heads or units."""
        return self.rank * total // self.size, total // self.size


def check_divisible(model: torch.nn.Module, size: int) -> None:
    """Raise unless ``size`` divides every attention's heads and every
    MLP's hidden width."""
    from ..models.layers import Mlp, WindowAttention

    for name, mod in model.named_modules():
        n = (mod.num_heads if isinstance(mod, WindowAttention)
             else mod[0].out_features if isinstance(mod, Mlp) else None)
        if n is not None and n % size:
            what = "heads" if isinstance(mod, WindowAttention) else "hidden units"
            raise ValueError(f"{name}: {n} {what} do not split over {size} model ranks")


def shard_params_tp(model: torch.nn.Module, group) -> TensorShard:
    """Cut ``model``'s column- and row-parallel parameters to this rank's
    shard in place and attach the group to its attention and MLP modules.
    The model must be built with ``model_axis`` set (every kernel routed
    off: their weights would no longer be whole)."""
    from ..models.layers import Mlp, WindowAttention

    if not getattr(model, "ms_unet", model).model_axis:
        raise ValueError("shard_params_tp needs a model built with model_axis "
                         "(TPU.MODEL_AXIS): the kernels take whole weights")
    shard = TensorShard(group)
    check_divisible(model, shard.size)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if tp_spec(name) is not None:
                p.data = _cut(name, p.data, shard.size, shard.rank)
    for mod in model.modules():
        if isinstance(mod, (WindowAttention, Mlp)):
            mod.tp = shard
    return shard


def shard_state_tp(state, group) -> TensorShard:
    """:func:`shard_params_tp` on ``state.model``, and the same cut of the
    AdamW moments already in ``state.optimizer`` (before any DDP wrapper is
    built: ``parallel/mesh.py::replicate_state`` comes after)."""
    shard = shard_params_tp(state.model, group)
    shard_moments_tp(state.optimizer, state.model, shard.size, shard.rank)
    return shard


def shard_moments_tp(optimizer: torch.optim.Optimizer, model: torch.nn.Module, size: int,
                     rank: int) -> None:
    """Cut the AdamW moments of ``model``'s sharded parameters to ``rank``'s
    shard in place (the replicated ones' as they are)."""
    names = {p: n for n, p in model.named_parameters()}
    for p, st in optimizer.state.items():
        if tp_spec(names[p]) is not None:
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key] = _cut(names[p], st[key], size, rank)


def unshard_state_dict_tp(model: torch.nn.Module, group) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded tensor gathered over
    ``group`` to its full shape (a collective: every rank calls it)."""
    from .mesh import _collective

    size = dist.get_world_size(group)
    out = {}
    for name, t in model.state_dict().items():
        if tp_spec(name) is None:
            out[name] = t
            continue
        t = _collective(t.contiguous(), group)
        shards = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(shards, t, group=group)
        out[name] = unshard_tensor(name, shards)
    return out
