"""The port's LR range test, parity tool and epoch bench, on the CPU:

* ``lr_range_test`` over the port's train step against the JAX package's
  over JAX's, from the same weights and batches with drop rates 0: the
  ``lr`` column of ``lr_range_test.csv`` byte-equal, the train losses
  within 1e-5 (a float32 loss after at most nine AdamW updates of which the
  largest lr is 1e-3); the plot drawn where matplotlib is, skipped with a
  message where it is not (as on the card's machine);
* the parity tool's two arms at a tiny model, and its delta rows with the
  keys of the JAX tool's; both arms start from the weights ``SEED`` gives;
* the epoch bench at 32^2 prints one JSON line with the JAX bench's keys.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    default_config as jax_default_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.metrics.csv_logger import (
    CSVHandler as JaxCSVHandler,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import (
    create_train_state as jax_create_train_state,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.lr_range import (
    lr_range_test as jax_lr_range_test,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.state import (
    make_train_step as jax_make_train_step,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch import native
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import default_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import (
    epoch_bench,
    parity_vs_deploy,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import state
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.lr_range import (
    lr_range_test,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.viz import plots

TINY = dict(img_size=32, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 1),
            window_size=4, drop_path_rate=0.0)
# the JAX epoch bench's JSON keys (JAX tools/epoch_bench.py)
BENCH_KEYS = {"metric", "value", "unit", "compute_only", "host_efficiency",
              "native_decode", "batch"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    rng = np.random.RandomState(0)
    return [{"image": rng.randint(0, 255, (2, 32, 32, 3), np.uint8),
             "label": (rng.rand(2, 32, 32) > 0.8).astype(np.uint8)} for _ in range(4)]


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_lr_range_test_matches_jax(tmp_path):
    jm = JaxMSUNet(**TINY)
    cfg = jax_default_config()
    jstate = jax_create_train_state(jm, cfg, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    model = MSUNet(**TINY)
    model.ms_unet.load_state_dict(flax_to_state_dict(jstate.params), strict=True)
    tstate = state.create_train_state(model, default_config(), device="cpu")
    kw = dict(min_lr=1e-6, max_lr=1e-3, n_steps=10)
    jlrs, jlosses = jax_lr_range_test(jstate, jax_make_train_step(jm, 0.2, 0.8, 0.45,
                                                                  donate=False),
                                      _batches(), str(tmp_path / "jax"), plot=False, **kw)
    lrs, losses = lr_range_test(tstate, state.make_train_step(model, 0.2, 0.8, 0.45),
                                _batches(), str(tmp_path / "port"), **kw)
    assert lrs == jlrs and len(lrs) == 10
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    got = _read_csv(tmp_path / "port" / "lr_range_test.csv")
    want = _read_csv(tmp_path / "jax" / "lr_range_test.csv")
    assert got[0] == want[0] == ["step", "lr", "train_loss", "val_loss"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[3] for r in got[1:]] == ["nan"] * 10
    assert os.path.exists(tmp_path / "port" / "weight_decay_test.png")


def test_lr_range_test_skips_the_plot_without_matplotlib(tmp_path, monkeypatch, capsys):
    def absent(*args, **kwargs):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(plots, "plot_lr_range", absent)
    model = MSUNet(**TINY)
    tstate = state.create_train_state(model, default_config(), device="cpu")
    lrs, losses = lr_range_test(tstate, state.make_train_step(model, 0.2, 0.8, 0.45),
                                _batches(), str(tmp_path), n_steps=3)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "plot skipped (ImportError" in capsys.readouterr().out
    assert len(_read_csv(tmp_path / "lr_range_test.csv")) == 4
    assert not os.path.exists(tmp_path / "weight_decay_test.png")


def test_parity_tool_runs_both_arms(tmp_path, capsys):
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, img_size=32, **parity_vs_deploy.SPLIT)
    args = parity_vs_deploy.build_arg_parser().parse_args(
        ["--img", "32", "--epochs", "2", "--device", "cpu"])
    assert (args.fused_patch, args.deploy_f32) == (True, False)
    tiny = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2), window_size=4)
    a = parity_vs_deploy.run_one("parity", root, str(tmp_path), False, args, tiny)
    b = parity_vs_deploy.run_one("deploy", root, str(tmp_path), True, args, tiny)
    JaxCSVHandler(str(tmp_path / "jax_csv")).close_files()
    header = _read_csv(tmp_path / "jax_csv" / "val_metric_all_epoch.csv")[0]
    assert list(a) == list(b) == header
    assert a["epoch"] == b["epoch"] == "2"
    deltas = parity_vs_deploy.print_deltas(a, b)
    numeric = [k for k in header if not k.startswith("mean_confusion_matrix")]
    assert list(deltas) == numeric and deltas["epoch"] == 0.0
    out = capsys.readouterr().out
    for k in numeric:
        line = (f"  {k:>12s}: parity {float(a[k]):.5f}  deploy {float(b[k]):.5f}  "
                f"delta {deltas[k]:+.5f}")
        assert line in out.splitlines(), line


def test_parity_arms_start_from_the_same_seeded_weights(tmp_path, monkeypatch):
    """As JAX's trainer initialises both arms from ``SEED``, the port's arms
    start from equal weights, whatever the process's torch generator holds."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import trainer

    start = {}

    def record(model, logger, writer, out_dir, config, device=None):
        start[os.path.basename(out_dir)] = model.state_dict()
        os.makedirs(out_dir)
        with open(os.path.join(out_dir, "val_metric_all_epoch.csv"), "w") as f:
            f.write("epoch,Score\n1,0.0\n")
        return "Training Finished!"

    monkeypatch.setattr(trainer, "trainer", record)
    args = parity_vs_deploy.build_arg_parser().parse_args(
        ["--img", "32", "--device", "cpu"])
    tiny = dict(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2), window_size=4)
    for tag, deploy, seed in (("parity", False, 1), ("deploy", True, 2)):
        torch.manual_seed(seed)  # another global generator state each time
        parity_vs_deploy.run_one(tag, str(tmp_path), str(tmp_path), deploy, args, tiny)
    assert list(start["parity"]) == list(start["deploy"])
    for k, v in start["parity"].items():
        assert torch.equal(v, start["deploy"][k]), k


def test_epoch_bench_prints_the_jax_keys(tmp_path, capsys):
    data = str(tmp_path / "data")
    generate_synthetic_dataset(data, img_size=32, n_fake_train=4, n_real_train=4)
    result = epoch_bench.main(["--img", "32", "--merge", "1", "--workers", "2",
                               "--data_dir", data, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert BENCH_KEYS <= set(line)
    assert line["metric"] == "epoch_e2e_32sq_throughput" and line["batch"] == 2
    assert line["native_decode"] is native.available() and line["device"] == "cpu"
    assert line["value"] > 0 and line["compute_only"] > 0
