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
on batches of its own (ms by CUDA events, device time and the collectives'
kernels by the profiler, peak memory, launches).

The deployment configs both the one-card smoke (``chip_smoke.py``) and the
four-card check (``tools/multichip.py``) train come from here:
:func:`deployment_config` (``config.yaml``'s Swin-B at 512^2, bf16, every
kernel knob on), :data:`TRAIN_CHANGES` (bench.py's step), :data:`F32` (its
float32 twin without noise), :data:`COMPOSED` (every knob off), with
:func:`write_config` and :func:`train_batch`.  Both hold their ranks
against one process with :func:`hold_against_one` (two gloo ranks sharing
one card there, four NCCL ranks on four cards here) and print each rank's
timed step with :func:`rank_rows`.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

DEPLOY_IMG = 512
# bench.py's train step (bench.py:153-163, 216; FUSED_PATCH on unless
# --no_fused_patch, bench.py:161): no dropout, drop-path 0.1
TRAIN_CHANGES = {"MODEL.DROP_RATE": 0.0, "MODEL.ATTN_DROP_RATE": 0.0,
                 "MODEL.DROP_PATH_RATE": 0.1}
# the steps held against one process: float32, no dropout, no drop-path
F32 = {**TRAIN_CHANGES, "MODEL.DROP_PATH_RATE": 0.0, "TPU.COMPUTE_DTYPE": "float32",
       "TPU.SOFTMAX_DTYPE": "float32"}
# kernel launches of one Swin-B train step with every knob on: 48 attention
# backwards for 52 forwards, since the last stage of each cent decoder feeds
# nothing the loss reads
PER_STEP = dict(window_attention=52, window_attention_bwd=48, patch_merge=3,
                patch_merge_bwd=3, patch_expand=6, patch_expand_bwd=6,
                refine_head_res=1, refine_head_bwd=1)
LOSS_TOL = 1e-5         # tests/test_parallel.py::test_dp_matches_single_device
FAR, FAR_SHARE = 1e-5, 1e-3
# the composed path: every kernel knob off, float32 softmax
COMPOSED = {"TPU.USE_PALLAS_ATTENTION": False, "TPU.FUSED_HEAD": False,
            "TPU.FUSED_PATCH": False, "TPU.SOFTMAX_DTYPE": "float32"}


def deployment_config(**changes):
    """config.yaml's deployment model at 512^2 (bf16, every kernel knob on,
    seed 120); ``changes`` maps dotted keys to values
    (``{"TPU.FUSED_PATCH": False}``)."""
    from ..core.config import default_config

    cfg = default_config()
    cfg.DATA.IMG_SIZE = DEPLOY_IMG
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.SOFTMAX_DTYPE = "bfloat16"
    for knob in ("USE_PALLAS_ATTENTION", "GELU_TANH", "FUSED_HEAD", "FUSED_PATCH"):
        cfg.TPU[knob] = True
    cfg.SEED = 120
    for key, value in changes.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[leaf] = value
    cfg.freeze()
    return cfg


def write_config(cfg, path: str) -> str:
    with open(path, "w") as f:
        f.write(cfg.dump_yaml())
    return path


def train_batch(rng: np.random.Generator, batch: int,
                img: int = DEPLOY_IMG) -> Tuple[np.ndarray, np.ndarray]:
    """Random uint8 images and labels (a fifth of the pixels set)."""
    images = rng.integers(0, 256, (batch, img, img, 3), dtype=np.uint8)
    labels = (rng.random((batch, img, img)) > 0.8).astype(np.uint8)
    return images, labels


def param_agreement(got: Dict, want: Dict) -> Tuple[float, str, int, int]:
    """``(worst |diff|, its name, elements beyond FAR, elements)`` of two
    state dicts."""
    worst, worst_name, n_far, n_all = 0.0, "", 0, 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        if d.max().item() > worst:
            worst, worst_name = d.max().item(), k
        n_far += int((d > FAR).sum())
        n_all += d.numel()
    return worst, worst_name, n_far, n_all


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
    process group, on the card ``device`` (default: the current one):
    ms a step (CUDA events) and on the host's clock, the kernel launches of
    the timed steps (``ops/_build.py::LAUNCHES``), the device time of one
    step (the profiler: every kernel and copy) with the collectives'
    ``nccl*`` kernels by name, and peak GiB on the card."""
    from ..core.config import load_config
    from ..models.msunet import MSUNet
    from ..ops import _build
    from ..train.state import create_train_state
    from ..utils.profiling import kernel_times

    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    cfg = load_config(cfg_path)
    model = MSUNet.from_config(cfg, device=dev)
    state = create_train_state(model, cfg, device=dev)
    rank = (place_state(state, n_model, n_space).data if torch.distributed.is_initialized()
            else 0)
    step = _train_step_for(cfg, model, 1)
    img, lbl = train_batch(np.random.default_rng(1000 + rank), batch,
                           int(cfg.DATA.IMG_SIZE))
    lr = float(cfg.TRAIN.BASE_LR)
    with torch.cuda.device(dev):
        step(state, img, lbl, lr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses = [step(state, img, lbl, lr) for _ in range(steps)]
        end.record()
        torch.cuda.synchronize()
        out = {"ms": start.elapsed_time(end) / steps,
               "host_ms": 1e3 * (time.perf_counter() - t0) / steps,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "timed_launches": dict(_build.LAUNCHES),
               "timed_losses": [float(x) for x in losses]}
    rows = kernel_times(lambda: step(state, img, lbl, lr), dev)
    out["device_ms"] = sum(ms for ms, _, _ in rows)
    out["nccl"] = {name: (ms, n) for ms, n, name in rows if name.startswith("nccl")}
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


def spawn_steps(spec: Dict, world: int, workdir: str,
                timeout: Optional[float] = None) -> List[Dict]:
    """Run ``spec`` over ``world`` spawned ranks (``n_data x n_model x
    n_space``); each rank's result, rank 0 first (only rank 0 returns the
    state dict).  A rank that fails raises here, naming the rank; ranks
    still running after ``timeout`` seconds (a hung collective) are killed
    and ``TimeoutError`` raised."""
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(os.path.abspath(workdir), "rendezvous")
    for name in ["rendezvous"] + [f"rank{r}.pt" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    ranks = torch.multiprocessing.spawn(_rank_main, args=(world, "file://" + init, workdir),
                                        nprocs=world, join=False)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ranks.join(None if deadline is None
                             else max(0.0, min(5.0, deadline - time.monotonic()))):
            if deadline is not None and time.monotonic() >= deadline:
                late = [r for r, p in enumerate(ranks.processes) if p.is_alive()]
                raise TimeoutError(f"ranks {late} of {world} still running after "
                                   f"{timeout:g} s")
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def launches(per_step: Dict[str, int], steps: int) -> Dict[str, int]:
    """Every launch counter after ``steps`` steps of ``per_step`` each."""
    from ..ops import _build

    return {k: steps * per_step.get(k, 0) for k in _build.LAUNCHES}


def hold_against_one(label: str, spec: Dict, world: int, workdir: str, one: Dict,
                     per_step: Dict[str, int],
                     timeout: Optional[float] = None) -> Tuple[List[Dict], Dict]:
    """Run ``spec`` over ``world`` spawned ranks and hold them against
    ``one`` (:func:`run_steps` in one process over the same global
    batches): every rank at its mesh coordinates; ``one`` and every rank
    launching ``per_step`` kernels a step (the timed steps too); the same
    losses and replicated parameters on every rank; the losses within
    ``LOSS_TOL`` of one process's; rank 0's gathered parameters within
    Adam's 2 x lr x steps (Adam moves a parameter by about lr a step
    whatever its gradient's size, so round-off can flip one near-zero
    gradient's step), at most ``FAR_SHARE`` of the elements beyond
    ``FAR``.  Prints the agreement; raises naming ``label``.  Returns the
    ranks' results and ``{"loss_diff", "param_diff", "beyond", "elements",
    "ranks_s"}`` (the ranks' wall time, their start included)."""
    from ..parallel.mesh import mesh_coords

    t0 = time.perf_counter()
    try:
        ranks = spawn_steps(spec, world, workdir, timeout)
    except Exception as e:
        raise RuntimeError(f"{label}: {e}") from e
    wall = time.perf_counter() - t0
    coords = [mesh_coords(r, spec["n_model"], spec["n_space"]) for r in range(world)]
    if [tuple(r["coords"]) for r in ranks] != coords:
        raise AssertionError(f"{label}: coordinates {[r['coords'] for r in ranks]} != {coords}")
    steps = len(spec["batches"])
    want = launches(per_step, steps)
    timed_want = launches(per_step, spec["timed"]["steps"]) if spec["timed"] else None
    for who, res in [("one process", one)] + [(f"rank {r}", res) for r, res in enumerate(ranks)]:
        if res["launches"] != want or res.get("timed_launches", timed_want) != timed_want:
            raise AssertionError(f"{label}: {who} launched {res['launches']} over {steps} "
                                 f"steps, {res.get('timed_launches')} over the timed ones; want "
                                 f"{per_step or 'none'} a step")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"{label}: ranks report other losses {[r['losses'] for r in ranks]}")
    if any(not torch.equal(r["digest"], ranks[0]["digest"]) for r in ranks):
        raise AssertionError(f"{label}: the ranks' replicated parameters differ")
    dl = max(abs(a - b) for a, b in zip(ranks[0]["losses"], one["losses"]))
    worst, worst_name, n_far, n_all = param_agreement(ranks[0]["state_dict"], one["state_dict"])
    bound = 2 * spec["lr"] * steps
    print(f"{label}: launches {per_step or 'none'} a step on every rank; losses "
          f"{ranks[0]['losses']} vs one process {one['losses']}, max |diff| {dl:.3e} (tol "
          f"{LOSS_TOL:g}); parameters max |diff| {worst:.3e} ({worst_name}; bound 2 x lr x "
          f"steps = {bound:g}), {n_far} of {n_all} elements beyond {FAR:g} (tol {FAR_SHARE:g} "
          f"of them); replicas equal on every rank; {wall:.1f} s with the ranks' start")
    if not dl <= LOSS_TOL or not worst <= bound or not n_far <= FAR_SHARE * n_all:
        raise AssertionError(f"{label}: the ranks differ from one process")
    return ranks, {"loss_diff": dl, "param_diff": worst, "beyond": n_far, "elements": n_all,
                   "ranks_s": wall}


def rank_rows(label: str, ranks: List[Dict], batch: int, card: str) -> List[Dict]:
    """Print and return each rank's timed step (:func:`time_steps`): ms by
    CUDA events and the host's clock, device ms of one step, of which the
    collectives' kernels, the busy share (device time outside them over
    the step) and peak GiB."""
    rows = []
    for r, res in enumerate(ranks):
        comm = sum(ms for ms, _ in res["nccl"].values())
        row = {"rank": r, "coords": list(res["coords"]), "ms": res["ms"],
               "host_ms": res["host_ms"], "device_ms": res["device_ms"], "nccl_ms": comm,
               "busy": (res["device_ms"] - comm) / res["ms"], "peak_gib": res["peak_gib"],
               "img_s": 1e3 * batch / res["ms"]}
        print(f"  {label} rank {r} {tuple(res['coords'])}: {res['ms']:.2f} ms/step (CUDA "
              f"events), {res['host_ms']:.2f} ms (host), device {res['device_ms']:.2f} ms "
              f"(profiler, one step) of which NCCL kernels {comm:.2f}, busy {row['busy']:.3f}, "
              f"peak {res['peak_gib']:.2f} GiB; {card}")
        rows.append(row)
    return rows
