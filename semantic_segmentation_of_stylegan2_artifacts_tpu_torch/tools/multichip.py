"""Four cards over NCCL: the port's data, model and space axes and the
train CLI at ``HARDWARE.N_GPU: 4`` (the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``, whose dp, dp x tp and dp x
sp sections each ran a training step on a mesh)::

    python3 -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.multichip \\
        [--workdir model_out/multichip]

It refuses to run on fewer than four cards or without NCCL: no arm runs
gloo or the CPU.  It prints each card's name and power limit,
``nvidia-smi topo -m`` (NVLink or PCIe between the cards) and NCCL's
version, builds the kernels and the native decoder once before any rank
starts, then runs its four arms in this order, rank ``r`` on ``cuda:r``:

* ``data`` (4 x 1 x 1; the arm that runs the kernels): Swin-B 512^2 f32,
  drop rates 0, every kernel knob on, 3 steps over a global batch of 8 (2 a
  rank) against one process on ``cuda:0`` over the same batches (loss
  within 1e-5, parameters within Adam's 2 x lr x steps with at most 1e-3 of
  the elements beyond 1e-5, every rank's replicas equal); each rank's
  launches a step equal to the one-card smoke's (attention 52/48, merge
  3/3, expand 6/6, refine 1/1); then bench.py's deployment step (bf16, f32
  parameters, drop-path 0.1, 512^2 b8 a rank) timed on each rank, with its
  device time, busy share, peak memory and NCCL kernels, and on one card
  alone before and after the ranks: aggregate img/s and the scaling
  efficiency (four ranks' img/s over four times one card's).
* ``model`` (2 x 2 x 1, then 1 x 4 x 1; ``TPU.MODEL_AXIS``) and ``space``
  (2 x 1 x 2, then 1 x 1 x 4; ``TPU.SPATIAL_AXIS``; at 512^2 stage 3's 16
  rows pad to 3 windows, so one of four slabs is empty): Swin-B 512^2 b2
  f32, 3 steps, against one process's composed step to the same
  tolerances; no kernel launched (the axis routes them off, as in JAX);
  each rank's ms a step, device time and peak memory.  The space arm
  then runs 1 x 1 x 4 at 64^2 against one process's step at 64^2: stage
  0's 16 rows make 3 windows of 7, so rank 3 holds no rows at any stage
  and runs the patch embedding, every block, the merges, the expands and
  the head's halo convs on empty slabs.
* ``cli``: ``config.yaml`` with ``HARDWARE.N_GPU: 4``, one epoch on a
  synthetic 1024^2 split, through ``python -m ...cli.train_cli`` (four NCCL
  ranks, 2 images a card), then ``python -m ...cli.test_cli`` on its best
  checkpoint: the test CLI's Score equal to the trainer's best to 1e-6,
  each rank's ``epoch_timing`` line, every decode native on every rank.

Every number is printed beside the cards' name and power limit; each arm
ends with one ``multichip {json}`` line.  A failed rank or check raises,
naming the arm (``multichip: arm <name> failed: ...``), and the exit is
non-zero; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import dp_check

PKG = __package__.rsplit(".", 1)[0]
ROOT = Path(__file__).resolve().parents[2]
WORLD = 4
DEPLOY_IMG = dp_check.DEPLOY_IMG
EMPTY_IMG = 64  # 1 x 1 x 4 at 64^2: space rank 3 holds no rows at any stage
# (n_data, n_model, n_space, image side) of each arm's meshes (JAX's rank
# layout)
MESHES = {"data": ((4, 1, 1, DEPLOY_IMG),),
          "model": ((2, 2, 1, DEPLOY_IMG), (1, 4, 1, DEPLOY_IMG)),
          "space": ((2, 1, 2, DEPLOY_IMG), (1, 1, 4, DEPLOY_IMG), (1, 1, 4, EMPTY_IMG))}
AXIS_KEYS = {"model": "TPU.MODEL_AXIS", "space": "TPU.SPATIAL_AXIS"}
# seconds a spawn of the ranks (or a CLI process) may take before it counts
# as hung: its ranks are killed and the arm fails
ARM_TIMEOUT_S = {"data": 600, "model": 300, "space": 300, "cli": 600}
STEPS = 3
LR = 1e-4
DATA_BATCH = 8          # the data arm's global batch: 2 rows a rank
TIMED_BATCH = 8         # rows a rank of the timed deployment step
TIMED_STEPS = 10
SHARD_BATCH = 2         # the model and space arms' global batch
SHARD_TIMED = 3
# the train CLI's split at config.yaml's 1024^2: the loader's real ratio of
# 0.4 draws 10 real images beside 16 fake (fewer than 10 real raise), 26
# images, 3 global batches of 8 a epoch; 4 val cases on rank 0
CLI_SPLIT = dict(n_fake_train=16, n_real_train=12, n_val_fake=2, n_val_real=2,
                 n_test_fake=0, n_test_real=0)
CLI_IMG = 1024
SCORE_TOL = 1e-6


def mesh_name(mesh: Sequence[int]) -> str:
    return "x".join(map(str, mesh))


def arm_meshes(arm: str) -> List[Dict]:
    """Each mesh of ``arm``: its axes, image side and every rank's ``(data,
    model, space)`` coordinates, ``rank = (d * n_model + m) * n_space + s``."""
    from ..parallel.mesh import mesh_coords

    out = []
    for n_data, n_model, n_space, img in MESHES[arm]:
        world = n_data * n_model * n_space
        if world != WORLD:
            raise ValueError(f"{arm} mesh {n_data}x{n_model}x{n_space} has {world} ranks")
        out.append({"n_data": n_data, "n_model": n_model, "n_space": n_space, "img": img,
                    "coords": [mesh_coords(r, n_model, n_space) for r in range(world)]})
    return out


def stage_slabs(n_space: int, img: int = DEPLOY_IMG, patch: int = 4,
                window: int = 7) -> List[Tuple[Tuple[int, int], ...]]:
    """Each encoder stage's H-slabs (global rows a space rank holds) at
    ``img``^2 (``parallel/spatial.py::window_slabs``)."""
    from ..parallel.spatial import window_slabs

    return [window_slabs((img // patch) >> i, window, n_space).bounds for i in range(4)]


def require_cards(world: int = WORLD) -> None:
    """Raise unless ``world`` cards and NCCL are there: this check runs
    nowhere else."""
    import torch.distributed as dist

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < world:
        raise RuntimeError(f"multichip needs {world} CUDA cards, have {have}")
    if not dist.is_available() or not dist.is_nccl_available():
        raise RuntimeError("multichip needs NCCL (torch.distributed built with it)")


def arm_spec(cfg_path: str, batches, mesh: Dict, timed: Dict) -> Dict:
    """The ranks' spec: on the cards (rank ``r`` on ``cuda:r``) over NCCL."""
    return dp_check.make_spec(cfg_path, batches, LR, device="cuda", backend="nccl",
                              threads=4, timed=timed, n_model=mesh["n_model"],
                              n_space=mesh["n_space"])


def link_kinds(topo: str, world: int = WORLD) -> List[str]:
    """The link kinds (``NV18``, ``SYS``, ``PIX``, ...) between GPU0..world-1
    in ``nvidia-smi topo -m``'s matrix."""
    rows = {}
    for line in topo.splitlines():
        cells = line.split()
        if cells and re.fullmatch(r"GPU\d+", cells[0]):
            rows[int(cells[0][3:])] = cells[1:]
    kinds = set()
    for i in range(world):
        for j in range(world):
            if i != j and i in rows and j < len(rows[i]):
                kinds.add(rows[i][j])
    return sorted(kinds)


def _run(cmd: Sequence[str]) -> str:
    return subprocess.run(list(cmd), capture_output=True, text=True, timeout=60,
                          check=True).stdout


def card_lines() -> List[str]:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).strip().splitlines()


def print_nccl(kernels: Dict) -> None:
    print("  rank 0's NCCL kernels in one step (profiler): " + ", ".join(
        f"{k.split('(')[0]} {ms:.3f} ms x{n}" for k, (ms, n) in sorted(kernels.items())))


def data_arm(workdir: str, card: str) -> Dict:
    """4 x 1 x 1 with the kernels: agreement, launches, then the timed step."""
    rng = np.random.default_rng(0)
    mesh = arm_meshes("data")[0]
    f32 = dp_check.write_config(dp_check.deployment_config(**dp_check.F32),
                                os.path.join(workdir, "data_f32.yaml"))
    bf16 = dp_check.write_config(dp_check.deployment_config(**dp_check.TRAIN_CHANGES),
                                 os.path.join(workdir, "data_bf16.yaml"))
    batches = [dp_check.train_batch(rng, DATA_BATCH) for _ in range(STEPS)]
    spec = arm_spec(f32, batches, mesh, {"cfg_path": bf16, "batch": TIMED_BATCH,
                                         "steps": TIMED_STEPS})
    t0 = time.perf_counter()
    one = dp_check.run_steps(spec, device="cuda:0")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    single = [dp_check.time_steps(bf16, TIMED_BATCH, TIMED_STEPS, "cuda:0")]
    torch.cuda.empty_cache()
    print(f"data 4x1x1 over NCCL, Swin-B {DEPLOY_IMG}^2 f32, every kernel knob "
          f"on, global batch {DATA_BATCH} ({DATA_BATCH // WORLD} a rank), {STEPS} steps at "
          f"lr {LR:g} (f32 steps), then bench.py's bf16 step timed; one process on cuda:0 "
          f"{t1 - t0:.1f} s; {card}")
    ranks, agreement = dp_check.hold_against_one(
        "data 4x1x1 over NCCL", spec, WORLD, os.path.join(workdir, "data_4x1x1"), one,
        dp_check.PER_STEP, ARM_TIMEOUT_S["data"])
    single.append(dp_check.time_steps(bf16, TIMED_BATCH, TIMED_STEPS, "cuda:0"))
    torch.cuda.empty_cache()
    out = {"arm": "data", "mesh": "4x1x1", "card": card, **agreement}
    print(f"bench.py's deployment step, bf16, f32 parameters, drop-path 0.1, "
          f"{DEPLOY_IMG}^2 b{TIMED_BATCH} a rank, {TIMED_STEPS} steps:")
    out["ranks"] = dp_check.rank_rows("data 4x1x1", ranks, TIMED_BATCH, card)
    kernels = ranks[0]["nccl"]
    print_nccl(kernels)
    if not kernels or not out["ranks"][0]["nccl_ms"] > 0:
        raise AssertionError("rank 0's profile shows no NCCL kernel with device time")
    for i, res in enumerate(single):
        print(f"  one card (cuda:0, no process group), {'before' if i == 0 else 'after'} "
              f"the ranks: {res['ms']:.2f} ms/step (CUDA events), {res['host_ms']:.2f} ms "
              f"(host), device {res['device_ms']:.2f} ms, peak {res['peak_gib']:.2f} GiB; "
              f"{card}")
    one_img_s = 1e3 * TIMED_BATCH / (sum(res["ms"] for res in single) / len(single))
    agg = 1e3 * WORLD * TIMED_BATCH / max(res["ms"] for res in ranks)
    out.update({"one_card_ms": [res["ms"] for res in single], "one_card_img_s": one_img_s,
                "img_s": agg, "scaling_efficiency": agg / (WORLD * one_img_s),
                "rank0_nccl": {k: list(v) for k, v in kernels.items()}})
    print(f"  aggregate {agg:.2f} img/s over four ranks (by the slowest rank's events), "
          f"one card {one_img_s:.2f} img/s (mean of its two runs): scaling efficiency "
          f"{out['scaling_efficiency']:.4f}; {card}")
    return out


def one_process(arm: str, img: int, workdir: str, rng: np.random.Generator) -> Tuple:
    """The global batches at ``img``^2, the axis config's path and one
    process's composed steps on ``cuda:0`` over those batches."""
    batches = [dp_check.train_batch(rng, SHARD_BATCH, img) for _ in range(STEPS)]
    changes = {**dp_check.F32, "DATA.IMG_SIZE": img}
    plain = dp_check.write_config(
        dp_check.deployment_config(**{**changes, **dp_check.COMPOSED}),
        os.path.join(workdir, f"{arm}_{img}_composed.yaml"))
    path = dp_check.write_config(
        dp_check.deployment_config(**{**changes, AXIS_KEYS[arm]: arm}),
        os.path.join(workdir, f"{arm}_{img}.yaml"))
    t0 = time.perf_counter()
    one = dp_check.run_steps(dp_check.make_spec(plain, batches, LR, device="cuda:0"))
    torch.cuda.empty_cache()
    print(f"{arm} axis: one process on cuda:0, composed, Swin-B {img}^2 b{SHARD_BATCH} f32, "
          f"{STEPS} steps in {time.perf_counter() - t0:.1f} s")
    return batches, path, one


def shard_arm(arm: str, workdir: str, card: str) -> Dict:
    """The model or space axis: each mesh against one process's composed
    step at its image size; no kernel launched; each rank's timed step."""
    rng = np.random.default_rng(1)
    out = {"arm": arm, "card": card, "meshes": []}
    ones: Dict[int, Tuple] = {}
    for mesh in arm_meshes(arm):
        img = mesh["img"]
        if img not in ones:
            ones[img] = one_process(arm, img, workdir, rng)
        batches, path, one = ones[img]
        name = mesh_name((mesh["n_data"], mesh["n_model"], mesh["n_space"]))
        label = f"{arm} {name} {img}^2 over NCCL"
        if mesh["n_space"] > 1:
            print(f"  {name}: each stage's H-slabs at {img}^2 (rows a space rank holds): "
                  f"{stage_slabs(mesh['n_space'], img)}")
        spec = arm_spec(path, batches, mesh, {"cfg_path": path, "batch": SHARD_BATCH,
                                              "steps": SHARD_TIMED})
        print(f"{label}, Swin-B global batch {SHARD_BATCH} f32, every kernel knob on, which "
              f"the axis routes off; {card}")
        ranks, agreement = dp_check.hold_against_one(
            label, spec, WORLD, os.path.join(workdir, f"{arm}_{name}_{img}"), one, {},
            ARM_TIMEOUT_S[arm])
        row = {"mesh": name, "img": img, **agreement}
        print(f"  each rank's step, {SHARD_BATCH} rows a data shard, {SHARD_TIMED} steps:")
        row["ranks"] = dp_check.rank_rows(f"{arm} {name} {img}^2", ranks, SHARD_BATCH, card)
        print_nccl(ranks[0]["nccl"])
        out["meshes"].append(row)
    return out


def cli_config(workdir: str, data: str) -> str:
    """``config.yaml`` as shipped but for ``HARDWARE.N_GPU: 4``, the data
    and output paths, one epoch, and no pretrained weights (the SegFace
    file is not in the repository)."""
    path = os.path.join(workdir, "cli.yaml")
    with open(path, "w") as f:
        f.write(f"BASE: ['{ROOT / 'config.yaml'}']\n"
                f"DATA:\n  DATA_PATH: '{data}'\n"
                f"HARDWARE:\n  N_GPU: {WORLD}\n"
                f"MODEL:\n  PRETRAIN_WEIGHTS: none\n"
                f"TRAIN:\n  MAX_EPOCHS: 1\n"
                f"OUTPUT_DIR: '{os.path.join(workdir, 'cli_train')}'\n"
                f"LIST_DIR: '{os.path.join(data, 'lists')}'\n")
    return path


def run_process(cmd: List[str], timeout: float) -> str:
    """``cmd`` in a session of its own, its output echoed; it and every
    process it starts are killed after ``timeout`` s.  Raises unless it
    exits 0."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise TimeoutError(f"{' '.join(cmd)} still running after {timeout:g} s")
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # what it started and left behind
    print("\n".join("  | " + line for line in text.splitlines()[-60:]))
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}")
    return text


def rank_timings(log_text: str, stdout: str) -> Dict[int, List[Dict]]:
    """Each rank's ``epoch_timing`` records: rank 0's from ``log.txt``, the
    others' from the CLI's standard output (``rank <r>: epoch_timing ...``)."""
    out: Dict[int, List[Dict]] = {}
    for line in log_text.splitlines() + stdout.splitlines():
        if "epoch_timing " in line:
            rec = json.loads(line.split("epoch_timing ", 1)[1])
            out.setdefault(int(rec["rank"]), []).append(rec)
    return out


def csv_score(path: str) -> List[float]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    col = rows[0].index("Score")
    return [float(r[col]) for r in rows[1:]]


def cli_arm(workdir: str, card: str) -> Dict:
    """The train CLI on four NCCL ranks, then the test CLI on its best
    checkpoint."""
    from ..data.synthetic import generate_synthetic_dataset

    data = os.path.join(workdir, "cli_data")
    t0 = time.perf_counter()
    generate_synthetic_dataset(data, img_size=CLI_IMG, seed=0, **CLI_SPLIT)
    print(f"cli: synthetic split {CLI_IMG}^2 {CLI_SPLIT} in {time.perf_counter() - t0:.1f} s")
    path = cli_config(workdir, data)
    out_dir = os.path.join(workdir, "cli_train")
    t0 = time.perf_counter()
    text = run_process([sys.executable, "-m", f"{PKG}.cli.train_cli", "--cfg", path],
                       ARM_TIMEOUT_S["cli"])
    train_wall = time.perf_counter() - t0
    if "Training Finished!" not in text:
        raise AssertionError("the train CLI did not print 'Training Finished!'")
    with open(os.path.join(out_dir, "log.txt")) as f:
        log_text = f.read()
    if f"data parallel: {WORLD} ranks" not in log_text:
        raise AssertionError(f"the train CLI did not train on {WORLD} ranks")
    syncs = [json.loads(ln.split("rank_sync ", 1)[1]) for ln in log_text.splitlines()
             if "rank_sync " in ln]
    timings = rank_timings(log_text, text)
    print(f"train CLI, config.yaml at N_GPU {WORLD} ({CLI_IMG}^2, 2 images a card, attention "
          f"dropout 0.05, REMAT auto), 1 epoch: {train_wall:.1f} s with the ranks' start; "
          f"rank_sync {[(s['epoch'], s['world']) for s in syncs]}; {card}")
    if sorted(timings) != list(range(WORLD)) or any(len(v) != 1 for v in timings.values()):
        raise AssertionError(f"epoch_timing lines by rank: {timings}")
    if [(s["epoch"], s["world"]) for s in syncs] != [(1, WORLD)]:
        raise AssertionError(f"rank_sync lines {syncs}")
    steps = {t[0]["steps"] for t in timings.values()}
    for r in range(WORLD):
        t = timings[r][0]
        print(f"  rank {r} epoch_timing: {t['steps']} steps in {t['train_s']:.2f} s "
              f"({1e3 * t['train_s'] / t['steps']:.1f} ms/step, host clock), loader wait "
              f"{1e3 * t['loader_wait_s'] / t['steps']:.2f} ms/step, validation "
              f"{t['val_s']:.2f} s over {t['val_cases']} cases, decodes {t['decodes']}; "
              f"{card}")
        if t["decodes"]["pil"] != 0 or t["decodes"]["native"] <= 0:
            raise AssertionError(f"rank {r}: decodes {t['decodes']}, want native ones only")
    if len(steps) != 1:
        raise AssertionError(f"the ranks took other numbers of steps: {steps}")
    scores = csv_score(os.path.join(out_dir, "val_metric_all_epoch.csv"))
    if len(scores) != 1 or not math.isfinite(scores[0]):
        raise AssertionError(f"the trainer's val Scores {scores}")
    test_dir = os.path.join(workdir, "cli_test")
    t0 = time.perf_counter()
    run_process([sys.executable, "-m", f"{PKG}.cli.test_cli", "--cfg", path,
                 "--check_point_dir", out_dir, "--out_dir", test_dir, "--split", "val"],
                ARM_TIMEOUT_S["cli"])
    test_wall = time.perf_counter() - t0
    score = csv_score(os.path.join(test_dir, "val_metric_all_epoch.csv"))[-1]
    diff = abs(score - max(scores))
    print(f"test CLI on best_model.pth over {CLI_SPLIT['n_val_fake'] + CLI_SPLIT['n_val_real']} "
          f"val cases: Score {score!r} vs the trainer's best {max(scores)!r} (|diff| "
          f"{diff:.3e}, tol {SCORE_TOL:g}); {test_wall:.1f} s; {card}")
    if not diff <= SCORE_TOL:
        raise AssertionError(f"test CLI Score {score} != the trainer's best {max(scores)}")
    return {"arm": "cli", "card": card, "train_s": train_wall, "test_s": test_wall,
            "score": score, "score_diff": diff,
            "epoch_timing": {r: timings[r][0] for r in range(WORLD)}}


def run_arm(name: str, fn: Callable[..., Dict], *args) -> None:
    """One arm: its seconds and its ``multichip {json}`` line; a failure
    says on stdout which arm failed, then re-raises."""
    t0 = time.perf_counter()
    try:
        result = fn(*args)
    except BaseException as e:
        print(f"multichip: arm {name} failed: {type(e).__name__}: {e}", flush=True)
        raise
    result["seconds"] = time.perf_counter() - t0
    print(f"arm {name}: {result['seconds']:.1f} s")
    print("multichip " + json.dumps(result))


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", default=str(ROOT / "model_out" / "multichip"),
                        help="scratch directory, emptied first and removed at the end")
    return parser


def main(argv=None) -> int:
    from .. import native
    from ..ops import _build

    args = build_arg_parser().parse_args(argv)
    require_cards()
    cards = card_lines()
    for i, line in enumerate(cards):
        print(f"card {i}: {line}")
    links = []
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
        try:  # the record only, not a check: either may be refused on a restricted host
            text = _run(cmd)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"{' '.join(cmd)}: {e}")
            continue
        print(text.rstrip())
        links = link_kinds(text) or (["NVLink"] if "GB/s" in text else [])
        if links:
            break
    links = links or ["not read"]
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(WORLD)]
             for i in range(WORLD)]
    print(f"links between cuda:0-{WORLD - 1}: {links}; peer access (torch): {peers}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    card = (f"{WORLD} x {cards[0]}" if len(set(cards[:WORLD])) == 1
            else "; ".join(cards[:WORLD])) + f", links {'/'.join(links)}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    native.library()
    print(f"build (kernels and native decoder, once, before any rank): "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    try:
        run_arm("data", data_arm, args.workdir, card)
        run_arm("model", shard_arm, "model", args.workdir, card)
        run_arm("space", shard_arm, "space", args.workdir, card)
        run_arm("cli", cli_arm, args.workdir, card)
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    for i, line in enumerate(cards):
        print(f"card {i}: {line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
