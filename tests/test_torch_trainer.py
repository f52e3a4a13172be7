"""The slice as a whole: the port's ``trainer`` vs the JAX package's, f32 on
the CPU.

Both run 2 epochs (1 of warm-up) over one synthetic split (8 fake and 4
real train images, 2 fake and 1 real val images, 32^2) from one YAML:
embed 16, depths 1/1/1/1, window 4, float32, the kernel knobs off, drop
rates 0 (no noise is drawn), from equal initial weights (the JAX init
carried across with ``models/weights.py``); the port trains on one torch
thread.  The train loader, the
augmentation and the sampler give both the same batches (held byte-equal
by ``tests/test_torch_data.py``).

Tolerances: the per-epoch mean train loss and mean val loss 1e-5 abs, as in
``tests/test_torch_train.py``; the val soft dice 1e-5 abs; the FPR and the
Score 1e-5 abs as well: a pixel whose probability sits within float32
round-off of the 0.5 threshold would move the FPR by 1/1024 and show.
The 7 CSV files have the same names, headers and columns in each row.
Also ``validation_loss`` against the JAX one (1e-5), over a whole loader
and its first 2 batches.
"""

import csv
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    load_config as jax_load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.data import dataset as jax_dataset
from semantic_segmentation_of_stylegan2_artifacts_tpu.data import pipeline as jax_pipeline
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import inference as jax_inf
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import trainer as jax_trainer
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.state import (
    create_train_state as jax_create_train_state,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.state import (
    make_eval_step as jax_make_eval_step,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data import dataset, pipeline
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import inference, trainer
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import make_eval_step

ATOL = 1e-5


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    data = str(tmp / "data")
    generate_synthetic_dataset(data, img_size=32, n_fake_train=8, n_real_train=4, seed=2)
    cfg = {"DATA": {"IMG_SIZE": 32, "DATA_PATH": data, "NUM_WORKERS": 2},
           "MODEL": {"PRETRAIN_WEIGHTS": "none", "FREEZE_ENCODER": False,
                     "DROP_RATE": 0.0, "ATTN_DROP_RATE": 0.0, "DROP_PATH_RATE": 0.0,
                     "SWIN": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                              "NUM_HEADS": [2, 2, 2, 2], "WINDOW_SIZE": 4}},
           "TRAIN": {"MAX_EPOCHS": 2, "WARMUP_EPOCHS": 1},
           "TPU": {"COMPUTE_DTYPE": "float32", "SOFTMAX_DTYPE": "float32",
                   "USE_PALLAS_ATTENTION": False, "FUSED_HEAD": False,
                   "FUSED_PATCH": False},
           "LIST_DIR": os.path.join(data, "lists"), "SEED": 9, "SAVE_BEST_RUN": True}
    path = str(tmp / "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    jcfg = jax_load_config(path)
    jm = JaxMSUNet.from_config(jcfg)
    jstate = jax_create_train_state(jm, jcfg, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3), jm.dtype))
    pcfg = load_config(path)
    model = MSUNet.from_config(pcfg, device="cpu")
    model.ms_unet.load_state_dict(flax_to_state_dict(jax.device_get(jstate.params)),
                                  strict=True)
    log = logging.getLogger("test_torch_trainer")
    out = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    assert jax_trainer.trainer(jm, log, None, out["jax"], jcfg, state=jstate) \
        == "Training Finished!"
    # one torch thread: oneDNN splits a conv weight gradient's float32 sum
    # over its threads, and not the same way in every process (as
    # tests/test_torch_train.py fixes it)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert trainer.trainer(model, log, None, out["port"], pcfg, device="cpu") \
            == "Training Finished!"
    finally:
        torch.set_num_threads(n_threads)
    return out


def test_csv_files_have_the_jax_names_headers_and_columns(runs):
    names = sorted(n for n in os.listdir(runs["jax"]) if n.endswith(".csv"))
    assert len(names) == 7
    assert sorted(n for n in os.listdir(runs["port"]) if n.endswith(".csv")) == names
    for name in names:
        want, got = _rows(os.path.join(runs["jax"], name)), _rows(os.path.join(runs["port"], name))
        assert got[0] == want[0], name
        assert [len(r) for r in got] == [len(r) for r in want], name
    assert os.path.exists(os.path.join(runs["port"], "best_model.pth"))
    assert os.path.exists(os.path.join(runs["jax"], "best_model.msgpack"))


@pytest.mark.parametrize("column", ["mean_train_loss", "mean_val_loss", "Score"])
def test_epoch_metrics_match_jax(runs, column):
    name = "val_metric_all_epoch.csv"
    want, got = _rows(os.path.join(runs["jax"], name)), _rows(os.path.join(runs["port"], name))
    i = want[0].index(column)
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]] == ["1", "2"]
    np.testing.assert_allclose([float(r[i]) for r in got[1:]],
                               [float(r[i]) for r in want[1:]], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,column", [("val_metric_fake_epoch.csv", "mean_i_soft_dice"),
                                         ("val_metric_real_epoch.csv", "FRP"),
                                         ("val_metric_fake_epoch.csv", "mean_val_loss_fake")])
def test_split_metrics_match_jax(runs, name, column):
    want, got = _rows(os.path.join(runs["jax"], name)), _rows(os.path.join(runs["port"], name))
    i = want[0].index(column)
    np.testing.assert_allclose([float(r[i]) for r in got[1:]],
                               [float(r[i]) for r in want[1:]], atol=ATOL, rtol=0)


def test_final_predictions_have_the_jax_names(runs):
    got = sorted(os.listdir(os.path.join(runs["port"], "final_preds")))
    assert got == sorted(os.listdir(os.path.join(runs["jax"], "final_preds")))
    assert len(got) == 3 * 4  # SHOW_PREDICTIONS 10 > 3 val cases, 4 files each


@pytest.mark.parametrize("n_batches", [0, 2])
def test_validation_loss_matches_jax(tmp_path, n_batches):
    data = str(tmp_path / "data")
    generate_synthetic_dataset(data, img_size=32, seed=6)
    lists = os.path.join(data, "lists")
    kw = dict(img_size=32, depths=(1, 1, 1, 1), embed_dim=16, num_heads=(2, 2, 2, 2),
              window_size=4)
    jm = JaxMSUNet(**kw)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(4)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    model = MSUNet(**kw)
    model.ms_unet.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    want = jax_inf.validation_loss(
        jax_make_eval_step(jm, 0.2, 0.8, 0.45), params,
        jax_pipeline.EvalLoader(jax_dataset.SegArtifactDataset(data, lists, "train"), 32),
        bool_break=n_batches > 0, n_batches=n_batches)
    got = inference.validation_loss(
        make_eval_step(model, 0.2, 0.8, 0.45, device="cpu"),
        pipeline.EvalLoader(dataset.SegArtifactDataset(data, lists, "train"), 32),
        bool_break=n_batches > 0, n_batches=n_batches)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
