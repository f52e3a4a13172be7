"""Which best checkpoint each CLI reads from a directory holding both
formats (fault 10), on the CPU.

A directory holds a JAX ``best_model.msgpack`` (the JAX init from
``PRNGKey(1)``) and a port ``best_model.pth`` (the port's init from seed
99): two different models.  The JAX test CLI reads the ``.msgpack``
(JAX ``cli/test_cli.py::_resolve_checkpoint``); the port's test CLI must
report the same Score, to 1e-6 (float32 forwards of two packages), and a
Score other than the ``.pth`` file's.  The predict CLI keeps the ``.pth``
first, as JAX ``cli/predict_cli.py`` does.  The config is the tiny one of
``tests/test_torch_trainer_features.py``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import pytest

from test_torch_trainer_features import _config, data  # noqa: F401  (fixture)
from semantic_segmentation_of_stylegan2_artifacts_tpu.cli import test_cli as jax_test_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    load_config as jax_load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.checkpoint import (
    save_best as jax_save_best,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import test_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
    MSUNet,
    init_weights,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import checkpoint


@pytest.fixture
def both(tmp_path, data):  # noqa: F811
    cfg_path = _config(tmp_path, data)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    jm = JaxMSUNet.from_config(jax_load_config(cfg_path))
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(1)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    jax_save_best(str(ckpt), params, 1, 0.0)
    model = MSUNet.from_config(load_config(cfg_path), device="cpu")
    init_weights(model, 99)
    checkpoint.CheckpointWriter().save_best(str(ckpt), model, 1, 0.0)
    return cfg_path, str(ckpt)


def _run(cli, cfg_path, ckpt, out, port=True):
    handlers = logging.root.handlers[:]
    try:
        return cli.main(["--cfg", cfg_path, "--check_point_dir", ckpt, "--out_dir", out,
                         "--split", "val"] + (["--device", "cpu"] if port else []))
    finally:
        for h in logging.root.handlers[:]:
            logging.root.removeHandler(h)
            h.close()
        logging.root.handlers[:] = handlers


def test_test_cli_reads_the_checkpoint_jax_reads(both, tmp_path, monkeypatch):
    monkeypatch.setenv("SSA_TPU_COMP_CACHE", "0")  # the JAX CLI's cache stays off
    cfg_path, ckpt = both
    _, want, _ = _run(jax_test_cli, cfg_path, ckpt, str(tmp_path / "jax"), port=False)
    _, got, _ = _run(test_cli, cfg_path, ckpt, str(tmp_path / "port"))
    _, other, _ = _run(test_cli, cfg_path, os.path.join(ckpt, "best_model.pth"),
                       str(tmp_path / "pth"))
    assert abs(got - want) <= 1e-6, (got, want)
    assert abs(other - want) > 1e-6, (other, want)


def test_each_cli_has_its_checkpoint_order(both):
    _, ckpt = both
    assert checkpoint.resolve_checkpoint(ckpt, checkpoint.TEST_ORDER).endswith(
        "best_model.msgpack")
    assert checkpoint.resolve_checkpoint(ckpt).endswith("best_model.pth")
    assert checkpoint.resolve_checkpoint(ckpt, checkpoint.PREDICT_ORDER).endswith(
        "best_model.pth")
    os.remove(os.path.join(ckpt, "best_model.msgpack"))
    assert checkpoint.resolve_checkpoint(ckpt, checkpoint.TEST_ORDER).endswith(
        "best_model.pth")
    os.remove(os.path.join(ckpt, "best_model.pth"))
    os.makedirs(os.path.join(ckpt, "best_model.orbax"))
    for order in (checkpoint.TEST_ORDER, checkpoint.PREDICT_ORDER):
        with pytest.raises(NotImplementedError, match="orbax"):
            checkpoint.resolve_checkpoint(ckpt, order)
