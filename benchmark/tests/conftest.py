"""The benchmark's own tests.  Those marked ``cuda`` need a card and skip
without one; whether there is one is decided inside the ``card`` fixture,
never while a module is imported."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


TINY_SWIN = {"EMBED_DIM": 16, "DEPTHS": [2, 2, 2, 2], "NUM_HEADS": [2, 2, 4, 4],
             "WINDOW_SIZE": 4}

TINY_TRAFFIC = {
    "train": {"entry": "train", "batch_per_rank": 2, "pool": 8, "check_steps": 3,
              "trace_steps": 2, "reference_rows": 1},
    "predict": {"entry": "predict", "batch_per_rank": 2, "pool": 8, "check_every": 3,
                "trace_steps": 3, "reference_rows": 1},
}

# limits for the tiny cells on the CPU (bf16 compute): sound runs read
# loss 4e-4-9e-4, gradient and change 8e-3-1.2e-2, probabilities 2e-3-4e-3
TINY_LIMITS = {"loss_gap": 5e-3, "grad_gap": 0.05, "change_gap": 0.05, "prob_gap": 0.05,
               "prob_mean_gap": 5e-3}


def tiny_cell(entry: str, world: int = 1, **swin):
    """A cell of ``BENCHMARK.json``'s kind at 64^2 with a small Swin, for
    runs on the CPU."""
    from benchmark import spec

    workload = {"train": "train.swinb_w7.1024b2", "predict": "predict.swinb_w7.1024b4"}[entry]
    real = spec.load(workload)
    conf = copy.deepcopy(real.config)
    conf["DATA"]["IMG_SIZE"] = 64
    conf["MODEL"]["SWIN"].update(TINY_SWIN, **swin)
    return spec.Cell(name=workload, chips=world, config_name="tiny", config=conf,
                     traffic_name="tiny", traffic=dict(TINY_TRAFFIC[entry]),
                     limits=dict(TINY_LIMITS), metrics_e2e=real.metrics_e2e,
                     metrics_layer=real.metrics_layer)


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
