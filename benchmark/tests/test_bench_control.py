"""The control: the reference in float8 put in the program's place has to
come out not correct, by at least one of a cell's numbers.  On the card at
each cell's own size and limits (``cuda``); on the CPU at 64^2 against the
tiny cells' limits."""

import time

import pytest

from benchmark import compare, drive, spec, traffic
from benchmark.reference.msunet import Arch
from conftest import tiny_cell


def _control_fails(cell, seed, dev) -> dict:
    seeds = drive.Seeds.of(seed)
    arch = Arch.from_config(cell.config)
    res = drive.run(cell, seed, 2.0 if cell.entry == "predict" else 0.0, False, dev,
                    t_start=time.perf_counter())
    assert all(c["ok"] for c in res.checks.values()), res.checks
    with drive._reference_numerics():
        if cell.entry == "train":
            cfg = spec.port_config(cell.config, seeds.noise)
            images, masks = traffic.make_pool(int(cell.traffic["pool"]), cell.img_size,
                                              seeds.data, dev)
            ctl = drive.train_reference(cell, cfg, arch, seeds, images, masks, 1, dev,
                                        fp8=True)
            gaps = compare.train_gaps(ctl, res.reference)
        else:
            ctl = drive.predict_reference(cell, arch, seeds, res.program, dev, fp8=True)
            gaps = compare.predict_gaps(ctl, res.reference["maps"])
    judged = compare.judge(gaps, cell.limits)
    assert not all(c["ok"] for c in judged.values()), judged
    return judged


@pytest.mark.parametrize("entry", ["train", "predict"])
def test_control_fails_on_the_cpu(entry):
    _control_fails(tiny_cell(entry), 5, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train.swinb_w7.1024b2", "predict.swinb_w7.1024b4"])
def test_control_fails_on_the_card(card, workload):
    _control_fails(spec.load(workload), 2 ** 31 + 99, card)
