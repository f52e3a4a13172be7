"""Readings for setting a cell's correctness limits, many seeds in one
process (``set-up`` is most of a run, so one process a seed would waste it).

    python -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... \\
        [--control 3] [--faults 3] [--seconds 8]

For each seed: the program's numbers against the reference (as a run
compares them; train cells from their first steps alone, predict cells
after a window of ``--seconds``), then on the first ``--control`` seeds the
control (the reference in float8, put in the program's place) against the
same reference, and on the first ``--faults`` seeds of a train cell the
program with half of each batch left out (and, across cards, with no
gradient exchange).  One JSON line a reading on standard output.  A
multi-card cell runs one process a card, as ``benchmark.run`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def calibrate(workload: str, seeds, n_control: int, n_faults: int, seconds: float,
              dev="cuda:0", rank: int = 0, world: int = 1) -> None:
    import torch

    from benchmark import compare, drive, spec, traffic

    cell = spec.load(workload)
    cell.limits = None
    arch = cell.architecture.arch(cell.config)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = drive.run(cell, seed, seconds if cell.entry == "predict" else 0.0, False, dev,
                        rank=rank, world=world, t_start=t0)
        faults = ("half_batch",) + (("no_exchange",) if world > 1 else ())
        if rank != 0:
            if i < n_faults and cell.entry == "train":
                for f in faults:
                    drive.run(cell, seed, 0.0, False, dev, rank=rank, world=world,
                              t_start=time.perf_counter(), faults=(f,), reference=False)
            continue
        if cell.entry == "train":
            _emit(seed=seed, kind="program", **(compare.train_gaps(res.program,
                                                                           res.reference)))
        else:
            _emit(seed=seed, kind="program", batches=res.steps,
                  **(compare.predict_gaps(res.program["maps"],
                                                  res.reference["maps"])))
        if i < n_control:
            seeds_ = drive.Seeds.of(seed)
            with drive._reference_numerics():
                if cell.entry == "train":
                    cfg = spec.port_config(cell.config, seeds_.noise)
                    images, masks = traffic.make_pool(int(cell.traffic["pool"]),
                                                      cell.img_size, seeds_.data, dev)
                    ctl = drive.train_reference(cell, cfg, arch, seeds_, images, masks,
                                                world, dev, fp8=True)
                    gaps = compare.train_gaps(ctl, res.reference)
                else:
                    ctl = drive.predict_reference(cell, arch, seeds_, res.program, dev,
                                                  fp8=True)
                    gaps = compare.predict_gaps(ctl, res.reference["maps"])
            _emit(seed=seed, kind="control_fp8", **(gaps))
        if i < n_faults and cell.entry == "train":
            for f in faults:
                bad = drive.run(cell, seed, 0.0, False, dev, rank=rank, world=world,
                                t_start=time.perf_counter(), faults=(f,), reference=False)
                _emit(seed=seed, kind=f"fault_{f}",
                      **(compare.train_gaps(bad.program, res.reference)))
        del res
        torch.cuda.empty_cache()
        print(f"seed {seed} done in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)


def _rank_main(rank, world, init, a):
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh

    try:
        dev = mesh.init_process_group(rank, world, init, device="cuda")
        calibrate(a.workload, a.seeds, a.control, a.faults, a.seconds, dev, rank, world)
    finally:
        mesh.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=8.0)
    a = p.parse_args(argv)
    from benchmark import spec

    world = spec.load(a.workload).chips
    if world == 1:
        calibrate(a.workload, a.seeds, a.control, a.faults, a.seconds)
        return 0
    import multiprocessing as mp
    import os
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bench-rdzv-") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, world, init, a)) for r in range(world)]
        for p_ in procs:
            p_.start()
        for p_ in procs:
            p_.join()
    return max(p_.exitcode for p_ in procs)


if __name__ == "__main__":
    sys.exit(main())
