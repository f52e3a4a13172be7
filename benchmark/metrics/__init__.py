"""Per-layer metrics: one reader a metric, in ``metrics/<metric name>.py``,
found by the name ``BENCHMARK.json`` gives it.

A reader has ``read(ctx) -> float | None``, run on each rank over that
rank's traced window (``None``: nothing to read, and the metric is left out
of the line, never reported as 0), and ``combine(values) -> float``, which
makes the ranks' readings one number.
"""

from __future__ import annotations

import functools
import importlib.util
from dataclasses import dataclass
from pathlib import Path

from .. import counts
from ..spec import Cell
from ..trace import Trace

HERE = Path(__file__).resolve().parent


@dataclass
class Context:
    cell: Cell
    trace: Trace  # the device's and the host's operations, with the layer spans
    device_trace: Trace  # the device's alone, over as many steps (less host cost)
    params: int
    steps_per_s: float = 0.0  # steps or batches a second of the run's untraced window

    @property
    def steps(self) -> int:
        return self.trace.steps

    @property
    def window_s(self) -> float:
        return self.trace.window_us / 1e6

    @property
    def arch(self) -> dict:
        return counts.arch_kwargs(self.cell.config)

    @property
    def window(self) -> int:
        return int(self.cell.config["MODEL"]["SWIN"]["WINDOW_SIZE"])

    def layer_share(self, span: str, least_ms_a_step: float):
        """% of the layer's least time over its device time in the window."""
        us = self.trace.layer_us(span)
        if not us:
            return None
        return 100.0 * least_ms_a_step * self.steps / (us / 1e3)


@functools.lru_cache(maxsize=None)
def reader(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mean(values):
    return sum(values) / len(values)
