"""The port's grid-search run CLI and its YAML editor against the JAX
package's, on the CPU:

* ``ConfigParser`` edits of a copy of ``config.yaml`` write the same bytes;
* ``best_score_from_csv`` on the crafted CSVs of ``tests/test_cli.py``;
* ``run_sweep`` over a stub training script, sequential and with
  ``--jobs 2`` and slot environments;
* ``main`` over the same stub: the same trial directories, the same config
  bytes after the sweeps and the same ``BEST:`` line;
* a trial's default command is the port's train CLI, and a real sweep of
  three trials through it at 32^2 on the CPU ends in ``BEST:``.
"""

import csv
import os
import shutil
import sys

import pytest

from semantic_segmentation_of_stylegan2_artifacts_tpu.cli import run_cli as jax_run_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu.core.yaml_editor import (
    ConfigParser as JaxConfigParser,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import run_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.yaml_editor import (
    ConfigParser,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config.yaml")

EDITS = [("OUTPUT_DIR", "/tmp/some dir/run 1"), ("TRAIN.BASE_LR", 3e-05),
         ("MODEL.ATTN_DROP_RATE", 0.1), ("TRAIN.TVERSKY_LOSS_BETA", 1 - 0.3),
         ("MODEL.SWIN.DEPTHS[2]", 6), ("MODEL.SWIN.NUM_HEADS[0]", 3),
         ("TPU.FUSED_PATCH", False), ("MODEL.PRETRAIN_WEIGHTS", "none"),
         ("DATA.DATA_PATH", ""), ("TRAIN.USE_CHECKPOINT", True),
         ("TPU.REMAT", "high_res"), ("SEED", 7)]

# scores a trial from its config: Score = ATTN + ALPHA + 1000 * LR
STUB = """import argparse, os, re
ap = argparse.ArgumentParser(); ap.add_argument('--cfg')
text = open(ap.parse_args().cfg).read()
def num(key):
    return float(re.search(key + r': *([-0-9.e]+)', text).group(1))
out = re.search(r"OUTPUT_DIR: *'?([^'\\n]+)'?", text).group(1).strip('"')
slot = int(os.environ.get('TRIAL_SLOT', '0'))
score = (num('ATTN_DROP_RATE') + num('TVERSKY_LOSS_ALPHA') + 1000 * num('BASE_LR')
         + slot / 100.0)
os.makedirs(out, exist_ok=True)
with open(os.path.join(out, 'val_metric_all_epoch.csv'), 'w') as f:
    f.write('epoch,Score\\n1,%r\\n' % score)
"""


def _copy_config(d):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "config.yaml")
    shutil.copyfile(CONFIG, path)
    return path


def test_config_parser_writes_the_bytes_jax_writes(tmp_path):
    mine, theirs = _copy_config(tmp_path / "port"), _copy_config(tmp_path / "jax")
    port, ref = ConfigParser(mine), JaxConfigParser(theirs)
    for key, value in EDITS:
        port.set_value(key, value)
        ref.set_value(key, value)
        assert port.get_value(key) == ref.get_value(key) == value
    port.save()
    ref.save()
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        got, want = f.read(), g.read()
    assert got == want
    with open(CONFIG, "rb") as f:
        assert got != f.read()
    for bad in ("NO.SUCH.KEY", "MODEL.SWIN.DEPTHS[9]"):
        with pytest.raises((KeyError, IndexError)):
            ConfigParser(mine).set_value(bad, 1)


def test_best_score_from_csv_matches_jax(tmp_path):
    p = tmp_path / "val_metric_all_epoch.csv"
    p.write_text("epoch,mean_val_loss,Score\n1,0.9,-3.2\n2,0.8,-1.5\n3,0.7\n"
                 "4,0.6,not_a_number\n5,0.5,-2.0\n")
    q = tmp_path / "empty.csv"
    q.write_text("epoch,Score\n")
    for args in ((p,), (p, "Dice"), (tmp_path / "nope.csv",), (q,)):
        assert run_cli.best_score_from_csv(*args) == jax_run_cli.best_score_from_csv(*args)
    assert run_cli.best_score_from_csv(p) == -1.5


def _stub(tmp_path):
    stub = tmp_path / "stub_train.py"
    stub.write_text(STUB)
    return str(stub)


@pytest.mark.parametrize("jobs", [1, 2])
def test_run_sweep_matches_jax(tmp_path, jobs):
    stub = _stub(tmp_path)
    scores = {}
    for name, mod in (("port", run_cli), ("jax", jax_run_cli)):
        cfg = _copy_config(tmp_path / name)
        trials = [(alpha, tmp_path / name / f"trial_{alpha}",
                   [("TRAIN.TVERSKY_LOSS_ALPHA", alpha)]) for alpha in (0.1, 0.5, 0.3)]
        scores[name] = mod.run_sweep(trials, sys.executable, stub, cfg, jobs=jobs,
                                     slot_env=["TRIAL_SLOT={slot}"])
        with open(cfg, "rb") as f, open(CONFIG, "rb") as g:
            assert (f.read() == g.read()) == (jobs > 1)  # a copy per trial
        if jobs > 1:
            for alpha in (0.1, 0.5, 0.3):
                assert (tmp_path / name / f"trial_{alpha}" / "trial_config.yaml").exists()
    port, ref = scores["port"], scores["jax"]
    assert set(port) == set(ref) == {0.1, 0.5, 0.3}
    assert max(port, key=port.get) == max(ref, key=ref.get) == 0.5
    base = 0.05 + 1000 * 1e-05  # config.yaml's ATTN_DROP_RATE and BASE_LR
    if jobs == 1:
        assert port == ref
        assert port[0.3] == pytest.approx(base + 0.3)
    else:  # the slot a trial ran in adds 0 or 0.01
        for table in (port, ref):
            assert all(round(v - base - k, 9) in (0.0, 0.01) for k, v in table.items())


def _trial_dirs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".csv"))


def test_main_matches_jax_over_a_stub(tmp_path, capsys):
    stub = _stub(tmp_path)
    argv = ["--train_py", stub, "--attn_drop", "0.05", "0.1", "--alpha", "0.3", "0.4",
            "--lr", "8.5e-6", "3e-5"]
    best, lines, dirs, cfg_bytes = {}, {}, {}, {}
    for name, mod in (("port", run_cli), ("jax", jax_run_cli)):
        cfg = _copy_config(tmp_path / name)
        root = str(tmp_path / name / "RUN1")
        best[name] = mod.main(argv + ["--cfg", cfg, "--root_out", root])
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("BEST:")]
        dirs[name] = _trial_dirs(root)
        with open(cfg, "rb") as f:
            cfg_bytes[name] = f.read().replace(root.encode(), b"<root>")
    assert best["port"] == best["jax"] == (0.1, 0.4, 3e-5)
    assert lines["port"] == lines["jax"] == ["BEST: attn_drop=0.1 alpha=0.4 lr=3e-05"]
    assert dirs["port"] == dirs["jax"] and len(dirs["port"]) == 6
    assert cfg_bytes["port"] == cfg_bytes["jax"]


def test_a_trial_runs_the_port_train_cli():
    cmd = run_cli.train_command("python", "", "c.yaml", "cpu")
    assert cmd == ["python", "-m",
                   "semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli.train_cli",
                   "--cfg", "c.yaml", "--device", "cpu"]
    assert run_cli.train_command("python", "x.py", "c.yaml") == [
        "python", "x.py", "--cfg", "c.yaml"]


def test_sweep_through_the_port_train_cli(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each trial's process: one thread
    data = str(tmp_path / "data")
    generate_synthetic_dataset(data, img_size=32, n_fake_train=4, n_real_train=2,
                               n_val_fake=1, n_val_real=1, n_test_fake=0, n_test_real=0)
    cfg = _copy_config(tmp_path)
    parser = ConfigParser(cfg)
    parser.set_values([
        ("DATA.IMG_SIZE", 32), ("DATA.DATA_PATH", data), ("DATA.NUM_WORKERS", 2),
        ("LIST_DIR", os.path.join(data, "lists")), ("MODEL.PRETRAIN_WEIGHTS", "none"),
        ("MODEL.SWIN.EMBED_DIM", 16), ("MODEL.SWIN.WINDOW_SIZE", 4),
        ("TRAIN.MAX_EPOCHS", 1), ("TRAIN.WARMUP_EPOCHS", 0),
        ("TPU.COMPUTE_DTYPE", "float32"), ("SAVE_BEST_RUN", False)]
        + [(f"MODEL.SWIN.DEPTHS[{i}]", 1) for i in range(4)]
        + [(f"MODEL.SWIN.NUM_HEADS[{i}]", 2) for i in range(4)])
    parser.save()
    root = str(tmp_path / "RUN1")
    best = run_cli.main(["--cfg", cfg, "--root_out", root, "--attn_drop", "0.05",
                         "--alpha", "0.3", "--lr", "1e-4", "--device", "cpu"])
    assert best == (0.05, 0.3, 1e-4)
    assert "BEST: attn_drop=0.05 alpha=0.3 lr=0.0001" in capsys.readouterr().out
    csvs = [os.path.join(root, p) for p in _trial_dirs(root)
            if p.endswith("val_metric_all_epoch.csv")]
    assert len(csvs) == 3
    for path in csvs:
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 1 and float(rows[0]["Score"]) == float(rows[0]["Score"])
