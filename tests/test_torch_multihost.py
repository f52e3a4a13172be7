"""Rank-sharded input and the data-parallel trainer, on the CPU.

* ``TrainLoader.epoch_batches_merged(..., shard=(pi, pc))``: each shard's
  batches are byte-equal to the JAX package's over two epochs; the shards
  tile the unsharded global stream; each pair keeps its fake; a bad shard
  and a merge the ranks cannot split raise as in JAX.  (JAX
  ``tests/test_multihost.py``.)  ``num_batches(epoch, merge)`` equals
  JAX's and the count of merged batches.
* ``parallel/multihost.py``: ``host_shard`` is ``(0, 1)`` with no process
  group, ``local_merge`` raises as JAX's; ``parallel/mesh.py::shard_batch``
  gives a rank its rows.
* The trainer: ``HARDWARE.N_GPU: 2`` through the port's train CLI (two
  spawned ``gloo`` ranks, ``--device cpu``) against the trainer in one
  process over the same global batches (2 sampler pairs a step), three
  epochs with the encoder frozen and two staged unfreezes: the same CSV
  rows (numbers to 1e-6 absolute and relative: the ranks' mean of two
  half-batch losses and gradients is the one-process mean in another
  order; the per-epoch pixel sums of ~500 move by ~1e-5) and the same best
  Score; the same files, ``config_used.yaml`` a byte copy of ``--cfg``,
  checkpoint keys without DDP's ``module.``, and a ``rank_sync`` line an
  epoch (both ranks' parameters equal; the frozen stages unmoved, every
  unfrozen one moved).  A rank other than 0 writes nothing.  Started as
  ``torchrun`` starts it (two processes, the rank in the environment, a
  localhost port), the train CLI joins one group.
"""

import csv
import json
import logging
import os

import numpy as np
import pytest
import torch
import yaml

from semantic_segmentation_of_stylegan2_artifacts_tpu.data.dataset import (
    SegArtifactDataset as JaxDataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.data.pipeline import (
    TrainLoader as JaxLoader,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import train_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.dataset import (
    SegArtifactDataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.pipeline import TrainLoader
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh, multihost
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import trainer

MERGE = 4  # global pairs a step: a global batch of 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mh"))
    generate_synthetic_dataset(root, img_size=32, seed=6, n_fake_train=12, n_real_train=8)
    return root


def _loaders(root):
    lists = os.path.join(root, "lists")
    port = TrainLoader(SegArtifactDataset(root, lists, "fake_train"),
                       SegArtifactDataset(root, lists, "real_train_all"), img_size=32,
                       seed=3, num_workers=2)
    jax = JaxLoader(JaxDataset(root, lists, "fake_train"),
                    JaxDataset(root, lists, "real_train_all"), img_size=32, seed=3,
                    num_workers=2)
    return port, jax


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["case_name"] == y["case_name"]
        for key in ("image", "label"):
            assert x[key].dtype == y[key].dtype and x[key].tobytes() == y[key].tobytes()


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("pi", [0, 1])
def test_shards_are_byte_equal_to_jax(data, epoch, pi):
    port, jax = _loaders(data)
    got = list(port.epoch_batches_merged(epoch, MERGE, shard=(pi, 2)))
    _same(got, list(jax.epoch_batches_merged(epoch, MERGE, shard=(pi, 2))))
    assert got and all(b["image"].shape[0] == MERGE for b in got)


def test_shards_tile_the_global_stream(data):
    port, _ = _loaders(data)
    global_batches = list(port.epoch_batches_merged(0, MERGE))
    assert len(global_batches) == port.num_batches(0, MERGE)
    for pc in (2, 4):
        per_rank = [list(port.epoch_batches_merged(0, MERGE, shard=(pi, pc)))
                    for pi in range(pc)]
        assert all(len(r) == len(global_batches) for r in per_rank)
        for step, gb in enumerate(global_batches):
            for key in ("image", "label"):
                np.testing.assert_array_equal(
                    np.concatenate([r[step][key] for r in per_rank]), gb[key])
            assert sum((r[step]["case_name"] for r in per_rank), []) == gb["case_name"]


def test_each_rank_pair_keeps_its_fake(data):
    port, _ = _loaders(data)
    for pi in range(2):
        for batch in port.epoch_batches_merged(1, MERGE, shard=(pi, 2)):
            names = batch["case_name"]
            for k in range(0, len(names), 2):
                assert any(n.startswith("09") for n in names[k:k + 2]), names


def test_shard_validation_raises_as_jax(data):
    port, jax = _loaders(data)
    for loader in (port, jax):
        with pytest.raises(ValueError, match="not divisible"):
            next(loader.epoch_batches_merged(0, 3, shard=(0, 2)))
        with pytest.raises(ValueError, match="bad shard"):
            next(loader.epoch_batches_merged(0, 4, shard=(2, 2)))


@pytest.mark.parametrize("merge", [1, 2, 3])
def test_num_batches_matches_jax(data, merge):
    port, jax = _loaders(data)
    for epoch in (0, 9):
        assert port.num_batches(epoch, merge) == jax.num_batches(epoch, merge)
    assert port.num_batches(0, merge) == len(list(port.epoch_batches_merged(0, merge)))


def test_host_shard_and_local_merge(monkeypatch):
    assert multihost.host_shard() == (0, 1)
    assert multihost.local_merge(8) == 8
    monkeypatch.setattr(multihost, "host_shard", lambda: (1, 2))
    assert multihost.local_merge(8) == 4
    with pytest.raises(ValueError, match="global merge 3 not divisible by process_count 2"):
        multihost.local_merge(3)
    batch = {"image": np.arange(8).reshape(4, 2), "case_name": ["a", "b", "c", "d"]}
    got = mesh.shard_batch(batch, 1, 2)
    np.testing.assert_array_equal(got["image"], batch["image"][2:])
    assert got["case_name"] == ["c", "d"]
    assert mesh.shard_batch(batch)["case_name"] == ["c", "d"]  # from host_shard
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_batch(batch, 0, 3)


def _config(path, data, out, **extra):
    cfg = {"DATA": {"IMG_SIZE": 32, "DATA_PATH": data, "NUM_WORKERS": 2},
           "HARDWARE": {"N_GPU": 2},
           "MODEL": {"PRETRAIN_WEIGHTS": "none", "FREEZE_ENCODER": False,
                     "DROP_PATH_RATE": 0.0,
                     "SWIN": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                              "NUM_HEADS": [2, 2, 2, 2], "WINDOW_SIZE": 4}},
           "TRAIN": {"MAX_EPOCHS": 2, "WARMUP_EPOCHS": 1},
           "TPU": {"COMPUTE_DTYPE": "float32", "USE_PALLAS_ATTENTION": False,
                   "FUSED_HEAD": False, "FUSED_PATCH": False},
           "LIST_DIR": os.path.join(data, "lists"), "OUTPUT_DIR": str(out),
           "SAVE_BEST_RUN": True, **extra}
    with open(path, "w") as f:
        f.write("# a comment the copy keeps\n")
        yaml.safe_dump(cfg, f)
    return str(path)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _close(a, b, name):
    assert len(a) == len(b), name
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            try:
                xs, ys = json.loads(x), json.loads(y)
            except ValueError:
                assert x == y, name
                continue
            np.testing.assert_allclose(xs, ys, atol=1e-6, rtol=1e-6, err_msg=name)


def _files(root):
    return sorted(os.path.relpath(os.path.join(b, n), root)
                  for b, _, names in os.walk(root) for n in names
                  if "log" not in os.path.relpath(b, root).split(os.sep))


UNFREEZE = {"FREEZE_ENCODER": True, "STAGE3_UNFREEZE_PERIODE": 0.34,
            "STAGE2_UNFREEZE_PERIODE": 0.67, "STAGE1_UNFREEZE_PERIODE": 1.0,
            "STAGE0_UNFREEZE_PERIODE": 1.0}


def test_two_rank_trainer_matches_one_process(tmp_path, data, monkeypatch):
    """Three epochs with the encoder frozen (stage 3 unfreezes at epoch 1,
    stage 2 at epoch 2) over two ranks and in one process.  The trainer
    rebuilds the DDP wrapper at each unfreeze, so the new stage's gradients
    are all-reduced and both ranks keep equal parameters
    (``check_replicas`` raises otherwise); each ``rank_sync`` line shows
    the frozen stages at their initial values and every trainable stage
    moved."""
    changes = dict(MODEL={**UNFREEZE, "PRETRAIN_WEIGHTS": "none", "DROP_PATH_RATE": 0.0,
                          "SWIN": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                                   "NUM_HEADS": [2, 2, 2, 2], "WINDOW_SIZE": 4}},
                   TRAIN={"MAX_EPOCHS": 3, "WARMUP_EPOCHS": 0})
    one_cfg = load_config(_config(tmp_path / "one.yaml", data, tmp_path / "one", **changes))
    init = mesh.stage_sums(MSUNet.from_config(one_cfg, device="cpu"))
    torch.manual_seed(int(one_cfg.SEED))
    trainer.trainer(MSUNet.from_config(one_cfg, device="cpu"), logging.getLogger("one"),
                    None, one_cfg.OUTPUT_DIR, one_cfg, device="cpu")

    path = _config(tmp_path / "two.yaml", data, tmp_path / "two", **changes)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one torch thread in each spawned rank
    train_cli.main(["--cfg", path, "--device", "cpu"])
    two = str(tmp_path / "two")
    with open(path, "rb") as a, open(os.path.join(two, "config_used.yaml"), "rb") as b:
        assert a.read() == b.read()
    assert _files(two) == sorted(_files(one_cfg.OUTPUT_DIR) + ["config_used.yaml",
                                                               "log.txt"])
    for name in _files(one_cfg.OUTPUT_DIR):
        if name.endswith(".csv"):
            _close(_rows(os.path.join(two, name)),
                   _rows(os.path.join(one_cfg.OUTPUT_DIR, name)), name)
    best = [torch.load(os.path.join(d, "best_model.pth"), weights_only=True)
            for d in (two, one_cfg.OUTPUT_DIR)]
    assert best[0]["epoch"] == best[1]["epoch"]
    assert abs(best[0]["best_score"] - best[1]["best_score"]) <= 1e-6
    assert not any(k.startswith("module.") for k in best[0]["model"])
    with open(os.path.join(two, "log.txt")) as f:
        log = f.read()
    assert "data parallel: 2 ranks" in log and "Training finished" in log
    syncs = [json.loads(ln.split("rank_sync ", 1)[1]) for ln in log.splitlines()
             if "rank_sync " in ln]
    assert [(s["epoch"], s["world"], s["frozen_stages"]) for s in syncs] == [
        (1, 2, [0, 1, 2, 3]), (2, 2, [0, 1, 2]), (3, 2, [0, 1])]
    for s in syncs:
        moved = sorted(k for k, v in s["stage_sums"].items() if v != init[k])
        assert moved == [f"layers.{i}" for i in range(4) if i not in s["frozen_stages"]]


def test_a_rank_other_than_0_writes_nothing(tmp_path, data, monkeypatch):
    cfg = load_config(_config(tmp_path / "r1.yaml", data, tmp_path / "r1"))
    monkeypatch.setattr(trainer, "host_shard", lambda: (1, 2))
    trainer.trainer(MSUNet.from_config(cfg, device="cpu"), logging.getLogger("r1"), None,
                    cfg.OUTPUT_DIR, cfg, device="cpu")
    assert not os.path.exists(cfg.OUTPUT_DIR)


def test_train_cli_under_torchrun_reads_its_rank_from_the_environment(tmp_path, data):
    """Two processes started as ``torchrun`` starts them (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT on localhost) join one group."""
    import socket
    import subprocess
    import sys

    path = _config(tmp_path / "tr.yaml", data, tmp_path / "tr",
                   TRAIN={"MAX_EPOCHS": 1, "WARMUP_EPOCHS": 0})
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli."
         "train_cli", "--cfg", path, "--device", "cpu"], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "OMP_NUM_THREADS": "1"}) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "Training Finished!" in outs[0] and "Training Finished!" not in outs[1]
    with open(os.path.join(tmp_path / "tr", "log.txt")) as f:
        assert '"world": 2' in f.read()
    assert os.path.exists(tmp_path / "tr" / "best_model.pth")
