"""The rest of a run, its look for a card skipped, on the CPU at 64^2, with
the timed path broken underneath: ``correct`` has to come out false for
each fault a cell can have, and true for a sound run."""

import os
import tempfile
import time

import pytest
import torch.multiprocessing as mp

from benchmark import drive
from conftest import tiny_cell

DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1}


def _line(entry, faults=(), seed=2 ** 33 + 7, traced=False):
    cell = tiny_cell(entry)
    res = drive.run(cell, seed, 1.0, traced, "cpu", t_start=time.perf_counter(), faults=faults)
    return drive.combine(cell, [res], DEVICE)


@pytest.mark.parametrize("entry", ["train", "predict"])
def test_sound_run_is_correct(entry):
    line = _line(entry)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("entry,fault", [("train", "frozen_state"), ("train", "half_batch"),
                                         ("predict", "altered_answer")])
def test_fault_is_not_correct(entry, fault):
    line = _line(entry, (fault,))
    assert not line["correct"], line["checks"]


def test_traced_run_reports_layer_metrics_and_breakdown():
    line = _line("train", traced=True)
    assert line["correct"]
    assert "idle_share.train" in line["metrics"] and "mfu.train" in line["metrics"]
    assert {"device_ops", "idle_gaps"} <= set(line["breakdown"])
    assert line["device"]["window_s"] > 0


def _rank(rank, world, init, faults, queue):
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh

    try:
        dev = mesh.init_process_group(rank, world, init, device="cpu")
        cell = tiny_cell("train", world=world)
        res = drive.run(cell, 11, 1.0, False, dev, rank=rank, world=world,
                        t_start=time.perf_counter(), faults=faults)
        queue.put((rank, res))
    finally:
        mesh.destroy_process_group()


@pytest.mark.parametrize("faults,want", [((), True), (("no_exchange",), False)])
def test_two_ranks(faults, want):
    """Two gloo ranks: a sound run is correct; one whose gradients are not
    exchanged between the ranks is not."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, 2, init, faults, queue)) for r in range(2)]
        for p in procs:
            p.start()
        got = dict(queue.get() for _ in procs)
        for p in procs:
            p.join(timeout=120)
    assert got[0].steps == got[1].steps > 0
    line = drive.combine(tiny_cell("train", world=2), [got[0], got[1]], DEVICE)
    assert line["correct"] is want, line["checks"]
