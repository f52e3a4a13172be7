"""Run one cell of the port's benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s workload) names its configuration and
traffic files; ``drive.py`` runs it.  A cell on more than one card runs one
process a card, joined over NCCL; this process starts them, waits for every
one, and prints the combined line.  The last lines on standard error are the
numbers that decided ``correct``, each beside its limit; the last line on
standard output is the result (JSON).  No card, too few cards, or JAX
loaded by the time the window has closed: exit 3 and no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# build and kernel caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_segmentation_of_stylegan2_artifacts_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def _rank_main(rank: int, world: int, init_method: str, args, t_start: float, queue) -> None:
    """One card's process of a multi-card cell."""
    from benchmark import drive, spec
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh

    try:
        dev = mesh.init_process_group(rank, world, init_method, device="cuda")
        cell = spec.load(args.workload)
        res = drive.run(cell, args.seed, args.seconds, bool(args.trace), dev, rank=rank,
                        world=world, t_start=t_start)
        info = _device_info(world) if rank == 0 else None
        queue.put((rank, res, forbidden_modules(), info, None))
    except BaseException as e:  # noqa: BLE001 - reported by the parent
        import traceback

        queue.put((rank, None, forbidden_modules(), None, traceback.format_exc()))
        raise SystemExit(1) from e
    finally:
        mesh.destroy_process_group()


def _run_ranks(world: int, args) -> tuple:
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    rdzv = tempfile.mkdtemp(prefix="bench-rdzv-")
    init = "file://" + os.path.join(rdzv, "rendezvous")
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, args, T_START, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) + len(errors) < world:
            try:
                rank, res, bad, info, err = queue.get(timeout=5)
            except queue_mod.Empty:
                # a rank that died without a word (killed, or a crash in native code)
                silent = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                          and r not in got]
                if silent and len(got) + len(errors) < world:
                    errors.append(f"ranks {silent} exited with codes "
                                  f"{[procs[r].exitcode for r in silent]}")
                    break
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                got[rank] = (res, bad, info)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
        for name in os.listdir(rdzv):
            os.remove(os.path.join(rdzv, name))
        os.rmdir(rdzv)
    if errors:
        raise RuntimeError("\n".join(errors))
    parts = [got[r][0] for r in range(world)]
    bad = sorted({m for r in range(world) for m in got[r][1]})
    return parts, bad, got[0][2]


def main(argv=None) -> int:
    args = _args(argv)
    from benchmark import drive, spec

    cell = spec.load(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, {have} found",
              file=sys.stderr)
        return 3
    if cell.chips == 1:
        parts = [drive.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                           t_start=T_START)]
        bad, info = [], _device_info(1)
    else:
        parts, bad, info = _run_ranks(cell.chips, args)
    bad = sorted(set(bad) | set(forbidden_modules()))
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    result = drive.combine(cell, parts, info)
    r0 = parts[0]
    print(f"timing setup_s {r0.setup_s:.3f} window_s {r0.window_s:.3f} steps {r0.steps} "
          f"reference_s {r0.reference_s:.3f}", file=sys.stderr)
    for p in parts:
        stages = " ".join(f"{k} {v:.3f}" for k, v in p.stages.items())
        print(f"rank {p.rank} set-up stages (s from the start): {stages} "
              f"checked_steps {p.setup_s:.3f}", file=sys.stderr)
    if r0.done:
        tenth = r0.done[-1] / 10
        counts = [sum(1 for t in r0.done if i * tenth <= t < (i + 1) * tenth) for i in range(10)]
        print(f"steps by tenth of the window: {counts}", file=sys.stderr)
        if r0.traced_step_s:
            print(f"seconds a step: window {r0.done[-1] / len(r0.done):.4f}, traced on the "
                  f"device alone {r0.traced_step_s:.4f}", file=sys.stderr)
    detail = (r0.checks or {}).get("_detail", {}).get("detail")
    if detail:
        print(f"check detail: {json.dumps(detail)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
