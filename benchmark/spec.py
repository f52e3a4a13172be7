"""A cell as the files name it: ``BENCHMARK.json``'s workload, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its correctness limits
(``limits/<workload>.json``).  Everything belonging to one configuration,
mix or cell sits in its own file, found by its name."""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _read(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # config.yaml's schema: MODEL, DATA, TRAIN, TPU, ...
    traffic_name: str
    traffic: dict
    limits: Optional[dict]
    metrics_e2e: list  # end-to-end metric entries that this cell reports
    metrics_layer: list  # per-layer metric entries that this cell reports

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    @property
    def img_size(self) -> int:
        return int(self.config["DATA"]["IMG_SIZE"])

    @property
    def batch(self) -> int:
        """Rows a rank runs in one step or batch."""
        return int(self.traffic["batch_per_rank"])


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = _read(HERE / "configs" / f"{w['config']}.json")
    traffic = _read(HERE / "traffic" / f"{w['traffic']}.json")
    limits_path = HERE / "limits" / f"{workload}.json"
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"],
                config=conf["config"], traffic_name=w["traffic"], traffic=traffic,
                limits=_read(limits_path) if limits_path.exists() else None,
                metrics_e2e=[m for m in bench["end_to_end"] if _reports(m, workload)],
                metrics_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def port_config(config: dict, seed: int):
    """The port's config node: its defaults, the configuration's keys over
    them, ``SEED`` from the run's seed."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
        default_config,
    )

    node = default_config()

    def merge(dst, src, path):
        for k, v in src.items():
            if k not in dst:
                raise KeyError(f"configuration key {path}{k} is not in the port's schema")
            if isinstance(v, dict):
                merge(dst[k], v, f"{path}{k}.")
            else:
                dst[k] = copy.deepcopy(v)

    merge(node, config, "")
    node.SEED = int(seed)
    return node
