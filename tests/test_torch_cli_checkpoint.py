"""Which best checkpoint each CLI reads from a directory holding both
formats (fault 10), on the CPU.

A directory holds a JAX ``best_model.msgpack`` (the JAX init from
``PRNGKey(1)``) and a port ``best_model.pth`` (the port's init from seed
99): two different models.  The JAX test CLI reads the ``.msgpack``
(JAX ``cli/test_cli.py::_resolve_checkpoint``); the port's test CLI must
report the same Score, to 1e-6 (float32 forwards of two packages), and a
Score other than the ``.pth`` file's.  The predict CLI keeps the ``.pth``
first, as JAX ``cli/predict_cli.py`` does.  A ``best_model.orbax`` comes
last in both orders; an orbax directory is a checkpoint itself (by its
``.orbax`` name or its ``_CHECKPOINT_METADATA``), and a directory without
that file is not one.  On either package's ``best_model.orbax`` the two
test CLIs report the same Score, to 1e-6.  The config is the tiny one of
``tests/test_torch_trainer_features.py``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_trainer_features import _config, data  # noqa: F401  (fixture)
from semantic_segmentation_of_stylegan2_artifacts_tpu.cli import test_cli as jax_test_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    load_config as jax_load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.checkpoint import (
    CheckpointWriter as JaxCheckpointWriter,
)
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
    cfg_path, ckpt = both
    assert checkpoint.resolve_checkpoint(ckpt, checkpoint.TEST_ORDER).endswith(
        "best_model.msgpack")
    assert checkpoint.resolve_checkpoint(ckpt).endswith("best_model.pth")
    assert checkpoint.resolve_checkpoint(ckpt, checkpoint.PREDICT_ORDER).endswith(
        "best_model.pth")
    os.remove(os.path.join(ckpt, "best_model.msgpack"))
    assert checkpoint.resolve_checkpoint(ckpt, checkpoint.TEST_ORDER).endswith(
        "best_model.pth")
    os.remove(os.path.join(ckpt, "best_model.pth"))
    uncommitted = os.path.join(ckpt, "best_model.orbax")
    os.makedirs(uncommitted)  # no _CHECKPOINT_METADATA: not a checkpoint
    for order in (checkpoint.TEST_ORDER, checkpoint.PREDICT_ORDER):
        assert checkpoint.resolve_checkpoint(ckpt, order) == uncommitted
        with pytest.raises(FileNotFoundError, match="not an orbax checkpoint"):
            checkpoint.load_best_state_dict(ckpt, order)
    os.rmdir(uncommitted)
    model = MSUNet.from_config(load_config(cfg_path), device="cpu")
    best = checkpoint.CheckpointWriter(backend="orbax").save_best(ckpt, model, 1, 0.0)
    for order in (checkpoint.TEST_ORDER, checkpoint.PREDICT_ORDER):
        assert checkpoint.resolve_checkpoint(ckpt, order) == best
    # an orbax directory is itself a checkpoint, by its name or its metadata
    assert checkpoint.resolve_checkpoint(best) == best
    renamed = os.path.join(ckpt, "renamed")
    os.rename(best, renamed)
    assert checkpoint.resolve_checkpoint(renamed) == renamed
    sd = checkpoint.load_best_state_dict(renamed)
    assert all(torch.equal(sd[k], v) for k, v in model.ms_unet.state_dict().items())
    with pytest.raises(FileNotFoundError, match="No best_model checkpoint"):
        checkpoint.resolve_checkpoint(ckpt)


@pytest.fixture
def orbax_dirs(tmp_path, data):  # noqa: F811
    """A JAX ``best_model.orbax`` (JAX's init, ``PRNGKey(1)``) and a port one
    (the port's init, seed 99), each alone in its directory."""
    cfg_path = _config(tmp_path, data)
    jm = JaxMSUNet.from_config(jax_load_config(cfg_path))
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(1)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    jax_writer = JaxCheckpointWriter(backend="orbax")
    jax_writer.save_best(str(tmp_path / "jax"), params, 1, 0.0)
    jax_writer.close()
    model = MSUNet.from_config(load_config(cfg_path), device="cpu")
    init_weights(model, 99)
    checkpoint.CheckpointWriter(backend="orbax").save_best(str(tmp_path / "port"), model,
                                                           1, 0.0)
    return cfg_path, str(tmp_path / "jax"), str(tmp_path / "port")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_test_clis_score_orbax_checkpoints_alike(orbax_dirs, tmp_path, monkeypatch, writer):
    """Either package's ``best_model.orbax``: the port's test CLI reports
    the JAX test CLI's Score, to 1e-6, on the directory that holds it and on
    the orbax directory itself."""
    monkeypatch.setenv("SSA_TPU_COMP_CACHE", "0")  # the JAX CLI's cache stays off
    cfg_path, jax_dir, port_dir = orbax_dirs
    ckpt = jax_dir if writer == "jax" else port_dir
    _, want, _ = _run(jax_test_cli, cfg_path, ckpt, str(tmp_path / "jax_out"), port=False)
    _, got, _ = _run(test_cli, cfg_path, ckpt, str(tmp_path / "port_out"))
    _, itself, _ = _run(test_cli, cfg_path, os.path.join(ckpt, "best_model.orbax"),
                        str(tmp_path / "itself"))
    assert abs(got - want) <= 1e-6, (got, want)
    assert itself == got
