"""Train steps over a mesh of k ranks, to hold against one process's
steps over the same global batches (the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip`` check: its dp, dp x tp and
dp x sp sections).

A *spec* (a dict, see :func:`make_spec`) names a config YAML, optional
starting weights, the global batches, the learning rate, the accumulation,
a frozen-encoder schedule and the mesh's model and space axes.
:func:`run_steps` trains it in one process on the whole global batches,
or, inside a process group, on this rank's data shard through
``DistributedDataParallel`` over the data group, with the parameters
cut over the model group (``parallel/tp.py``; the config sets
``TPU.MODEL_AXIS``) and the maps over the space group
(``parallel/spatial.py``; ``TPU.SPATIAL_AXIS``); :func:`spawn_steps` starts
the k ranks (``torch.multiprocessing.spawn``, a ``file://`` rendezvous in
a work directory) and returns each rank's result::

    spec = make_spec("tiny.yaml", batches, lr=1e-3, device="cpu")
    one = run_steps(spec)
    ranks = spawn_steps(spec, world=2, workdir="/tmp/dp")
    # ranks[0]["losses"] ~ one["losses"]; ranks[0]["state_dict"] ~ one["state_dict"]
    tp = make_spec("tiny_tp.yaml", batches, lr=1e-3, device="cpu", n_model=2)
    ranks = spawn_steps(tp, world=4, workdir="/tmp/tp")  # 2 data x 2 model

The spec's device defaults to the card (``core/device.py::resolve_device``);
the CPU is asked for with ``device="cpu"``.

With ``timed`` set, each rank then times that many steps of another config
on batches of its own (ms by CUDA events, peak memory).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


def make_spec(cfg_path: str, batches: Sequence[Tuple[np.ndarray, np.ndarray]], lr: float,
              accumulation: int = 1, frozen: Sequence[int] = (),
              unfreeze: Optional[Dict[int, Sequence[int]]] = None,
              state_dict: Optional[Dict[str, torch.Tensor]] = None, device=None,
              backend: Optional[str] = None, threads: int = 1,
              timed: Optional[Dict] = None, n_model: int = 1, n_space: int = 1) -> Dict:
    """``batches``: global ``(uint8 images, uint8 labels)`` a step;
    ``frozen``: the encoder stages frozen at the start; ``unfreeze``: step
    index -> the stages still frozen from that step on; ``state_dict``:
    ``MSUNetSys`` weights to start from (else the config's seeded init);
    ``device``: the card unless the caller asks for another (raises with no
    GPU); ``timed``: ``{"cfg_path", "batch", "steps"}`` to time on each
    rank; ``n_model`` / ``n_space``: the mesh's model and space axes (the
    data axis takes the other ranks)."""
    return {"cfg_path": cfg_path, "batches": list(batches), "lr": float(lr),
            "accumulation": int(accumulation), "frozen": sorted(frozen),
            "unfreeze": {int(k): sorted(v) for k, v in (unfreeze or {}).items()},
            "state_dict": state_dict, "device": str(resolve_device(device)),
            "backend": backend, "threads": int(threads), "timed": timed,
            "n_model": int(n_model), "n_space": int(n_space)}


def _train_step_for(cfg, model, accumulation: int):
    from ..train.state import make_train_step

    return make_train_step(model, float(cfg.TRAIN.TVERSKY_LOSS_ALPHA),
                           float(cfg.TRAIN.TVERSKY_LOSS_BETA),
                           float(cfg.TRAIN.LOSS_TVERSKY_BCE_MIX),
                           accumulation_steps=accumulation)


def place_state(state, n_model: int = 1, n_space: int = 1):
    """Inside a process group: the mesh, the state's parameters and moments
    cut over its model group, the space group attached, and DDP over its
    data group.  Returns the mesh."""
    from ..parallel.mesh import make_mesh, replicate_state
    from ..parallel.spatial import attach_space
    from ..parallel.tp import shard_state_tp

    mesh = make_mesh(n_model=n_model, n_space=n_space)
    if n_model > 1:
        shard_state_tp(state, mesh.model_group)
    if n_space > 1:
        attach_space(state.model, mesh.space_group)
    replicate_state(state, mesh)
    return mesh


def run_steps(spec: Dict, device=None) -> Dict:
    """The spec's steps: in one process over the whole global batches, or
    (inside a process group) over this rank's data shard on the spec's
    mesh.  Returns the per-step losses (the mean over the data ranks), the
    final ``MSUNetSys`` state dict on the CPU (gathered to full shapes
    under a model axis), the final frozen stages, this rank's data rank and
    size, its mesh coordinates, the digest of its replicated parameters
    (``parallel/mesh.py::parameter_digest``) and the kernel launches of
    its steps (``ops/_build.py::LAUNCHES``)."""
    from ..core.config import load_config
    from ..models.msunet import MSUNet
    from ..ops import _build
    from ..parallel.mesh import check_replicas, parameter_digest, replicate_state, shard_batch
    from ..parallel.tp import tp_spec, unshard_state_dict_tp
    from ..train.optim import build_optimizer, unfreeze
    from ..train.state import create_train_state

    distributed = torch.distributed.is_initialized()
    dev = device or spec["device"]
    cfg = load_config(spec["cfg_path"])
    model = MSUNet.from_config(cfg, device=dev)
    if spec["state_dict"] is not None:
        model.ms_unet.load_state_dict(spec["state_dict"], strict=True)
    state = create_train_state(model, cfg, device=dev)
    frozen = set(spec["frozen"])
    if frozen:
        state.optimizer = build_optimizer(cfg, model, frozen)
    mesh = place_state(state, spec["n_model"], spec["n_space"]) if distributed else None
    rank, world = (mesh.data, mesh.n_data) if mesh else (0, 1)
    step = _train_step_for(cfg, model, spec["accumulation"])
    _build.reset_launches()
    losses: List[float] = []
    for i, (img, lbl) in enumerate(spec["batches"]):
        if i in spec["unfreeze"]:
            frozen = set(spec["unfreeze"][i])
            unfreeze(state.optimizer, cfg, model, frozen)
            if distributed:
                replicate_state(state)  # the new stage joins the reducer
        mine = shard_batch({"image": img, "label": lbl}, rank, world)
        losses.append(float(step(state, mine["image"], mine["label"], spec["lr"])))
    launches = dict(_build.LAUNCHES)
    if mesh is None:
        full, coords = model.ms_unet.state_dict(), (0, 0, 0)
    else:
        check_replicas(model, mesh.data_group)
        check_replicas(model, mesh.model_group, replicated_only=True)
        check_replicas(model, mesh.space_group)
        full = (unshard_state_dict_tp(model.ms_unet, mesh.model_group) if mesh.n_model > 1
                else model.ms_unet.state_dict())
        coords = (mesh.data, mesh.model, mesh.space)
    replicated = {n for n, _ in model.named_parameters() if not tp_spec(n)}
    return {"losses": losses, "frozen": sorted(frozen), "rank": rank, "world": world,
            "coords": coords, "digest": parameter_digest(model, replicated).cpu(),
            "launches": launches,
            "state_dict": {k: v.detach().cpu() for k, v in full.items()}}


def time_steps(cfg_path: str, batch: int, steps: int, device=None, n_model: int = 1,
               n_space: int = 1) -> Dict:
    """``steps`` train steps of ``cfg_path``'s model on one random uint8
    batch of ``batch`` rows (after one warm-up step), on the mesh inside a
    process group: ms a step (CUDA events), the device time of one step
    (the profiler's, every kernel and copy of the step) and peak GiB on
    the card."""
    from ..core.config import load_config
    from ..models.msunet import MSUNet
    from ..utils.profiling import section_times
    from ..train.state import create_train_state

    cfg = load_config(cfg_path)
    model = MSUNet.from_config(cfg, device=device)
    state = create_train_state(model, cfg, device=device)
    rank = (place_state(state, n_model, n_space).data if torch.distributed.is_initialized()
            else 0)
    step = _train_step_for(cfg, model, 1)
    rng = np.random.default_rng(1000 + rank)
    size = int(cfg.DATA.IMG_SIZE)
    img = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    lbl = (rng.random((batch, size, size)) > 0.8).astype(np.uint8)
    lr = float(cfg.TRAIN.BASE_LR)
    step(state, img, lbl, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = [step(state, img, lbl, lr) for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    out = {"ms": start.elapsed_time(end) / steps,
           "host_ms": 1e3 * (time.perf_counter() - t0) / steps,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "timed_losses": [float(x) for x in losses]}
    out["device_ms"] = section_times(lambda: step(state, img, lbl, lr), model, [])["total"]
    return out


def _rank_main(rank: int, world: int, init_method: str, workdir: str) -> None:
    from ..parallel.mesh import destroy_process_group, init_process_group

    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    torch.set_num_threads(spec["threads"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_process_group(rank, world, init_method, spec["device"], spec["backend"])
    try:
        out = run_steps(spec, dev)
        if rank != 0:
            out["state_dict"] = None
        if spec["timed"]:
            out.update(time_steps(spec["timed"]["cfg_path"], spec["timed"]["batch"],
                                  spec["timed"]["steps"], dev, spec["n_model"],
                                  spec["n_space"]))
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        destroy_process_group()


def spawn_steps(spec: Dict, world: int, workdir: str) -> List[Dict]:
    """Run ``spec`` over ``world`` spawned ranks (``n_data x n_model x
    n_space``); each rank's result, rank 0 first (only rank 0 returns the
    state dict).  A rank that fails raises here, naming the rank."""
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(os.path.abspath(workdir), "rendezvous")
    for name in ["rendezvous"] + [f"rank{r}.pt" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    torch.multiprocessing.spawn(_rank_main, args=(world, "file://" + init, workdir),
                                nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
