"""Nothing the benchmark loads is JAX or the JAX package: a fresh process
imports ``benchmark.run`` and every module under ``benchmark/`` (its tests
aside) and lists the top-level names of what it loaded, compared whole (the
port's name begins with the JAX package's)."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "semantic_segmentation_of_stylegan2_artifacts_tpu"}

PROBE = r"""
import importlib, json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
import benchmark.run
from benchmark import metrics
names = []
for path in sorted((root / "benchmark").rglob("*.py")):
    rel = path.relative_to(root)
    if "tests" in rel.parts:
        continue
    if path.parent.name == "metrics" and path.name != "__init__.py":
        metrics.reader(path.stem)
        continue
    mod = ".".join(rel.with_suffix("").parts)
    importlib.import_module(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    names.append(mod)
import semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state
import semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel.mesh
print(json.dumps({"imported": names,
                  "top": sorted({m.split(".")[0] for m in list(sys.modules)})}))
"""


def test_no_jax_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "benchmark.run" in got["imported"] and "benchmark.drive" in got["imported"]
    assert "semantic_segmentation_of_stylegan2_artifacts_tpu_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"]), FORBIDDEN & set(got["top"])


def test_run_refuses_without_enough_cards():
    """Without a card (or with fewer than the cell asks for) a run exits
    non-zero and prints no result."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = max(bench["workloads"], key=lambda w: w["chips"])
    if have >= cell["chips"]:
        return
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
