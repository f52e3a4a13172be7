"""Port's predict path vs the JAX package, f32 on the CPU.

* ``make_predict_step(..., device="cpu")`` probabilities against the JAX
  ``make_predict_step`` on one uint8 batch with bridged weights
  (tolerance 1e-4 abs).
* ``tiled_predict`` against the JAX one on a non-square image (same
  tolerance).
* The predict CLI over a ``data/synthetic.py`` dataset writes the same
  file names as the JAX CLI from the same ``.pth`` checkpoint.
* With no CUDA and no ``device="cpu"`` the entry points raise.
* Importing the port (the four CLIs, the YAML editor, the trainer, the
  checkpoint modules with the orbax reader and writer, the zstd decoder,
  the LR range test, the plots and the tools among it), decoding a zstd
  frame, writing and reading an orbax checkpoint, and running a CPU forward
  and a recomputed CPU train step, in a fresh process, loads none of jax,
  flax, optax, orbax, tensorstore, zstandard and the JAX package.
"""

import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semantic_segmentation_of_stylegan2_artifacts_tpu.cli import predict_cli as jax_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import inference as jax_inf
from semantic_segmentation_of_stylegan2_artifacts_tpu.train.state import (
    make_predict_step as jax_make_predict_step,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import predict_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import inference
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
    make_predict_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4)
ATOL = 1e-4


@pytest.fixture(scope="module")
def steps():
    jm = JaxMSUNet(**TINY)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    model = MSUNet(**TINY)
    model.ms_unet.load_state_dict(flax_to_state_dict(params), strict=True)
    jstep = jax_make_predict_step(jm)
    return (lambda imgs: jstep(params, jnp.asarray(imgs))), make_predict_step(model, device="cpu")


def test_predict_step_matches_jax(steps):
    jstep, step = steps
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got = step(imgs)
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jstep(imgs)), atol=ATOL, rtol=0)


def test_tiled_predict_matches_jax(steps):
    jstep, step = steps
    img = np.random.default_rng(1).integers(0, 256, (56, 44, 3), dtype=np.uint8)
    want = jax_inf.tiled_predict(lambda _, t: jstep(t), None, img, tile=32, batch_tiles=4)
    got = inference.tiled_predict(step, img, tile=32, batch_tiles=4)
    assert got.shape == (56, 44)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cli_writes_the_jax_cli_file_names(tmp_path, monkeypatch):
    monkeypatch.setenv("SSA_TPU_COMP_CACHE", "0")  # the JAX CLI's cache stays off
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, img_size=32)
    cfg = {"DATA": {"IMG_SIZE": 32, "DATA_PATH": root},
           "MODEL": {"SWIN": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                              "NUM_HEADS": [2, 2, 2, 2], "WINDOW_SIZE": 4}},
           "TPU": {"COMPUTE_DTYPE": "float32", "FUSED_HEAD": False},
           "LIST_DIR": os.path.join(root, "lists")}
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    model = MSUNet.from_config(load_config(cfg_path), device="cpu")
    torch.save(model.state_dict(), ckpt / "best_model.pth")

    handlers = logging.root.handlers[:]
    try:
        jax_cli.main(["--cfg", cfg_path, "--check_point_dir", str(ckpt),
                      "--out_dir", str(tmp_path / "jax_out")])
    finally:
        for h in logging.root.handlers[:]:
            logging.root.removeHandler(h)
            h.close()
        logging.root.handlers[:] = handlers
    preds = predict_cli.main(["--cfg", cfg_path, "--check_point_dir", str(ckpt),
                              "--out_dir", str(tmp_path / "port_out"), "--device", "cpu"])
    assert len(preds) == 3
    names = sorted(os.listdir(tmp_path / "port_out"))
    assert names == sorted(os.listdir(tmp_path / "jax_out"))
    assert sum(n.endswith("_grey_heats.png") for n in names) == 3


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = MSUNet(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_predict_step(model)
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text("DATA:\n  IMG_SIZE: 32\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MSUNet.from_config(load_config(str(cfg_path)))


_IMPORT_CHECK = """
import sys, numpy as np, torch
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import (
    predict_cli, run_cli, test_cli, train_cli)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core import yaml_editor
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch import native
assert native.available()
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import (
    ckpt_inspect, dataset_check, dp_check, epoch_bench, parity_vs_deploy)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import (
    checkpoint, lr_range, ocdbt, optim, orbax, trainer, zarr)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.native import zstd
assert zstd.decompress(bytes.fromhex("28b52ffd2003190000616263")) == b"abc"
import tempfile
with tempfile.TemporaryDirectory() as d:
    orbax.save(d + "/x.orbax", {"a": torch.ones(3), "epoch": 1})
    assert orbax.restore(d + "/x.orbax")["epoch"] == 1
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.viz import (
    artifact_distribution, eval_overlays, plots)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.viz.maps import save_contour_heatmap
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data import build_mask, splits
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import (
    mesh, multihost, spatial, tp)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils import flops, profiling
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import make_predict_step
m = MSUNet(img_size=32, embed_dim=128, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
           window_size=7, fused_attention=True, fused_patch=True, fused_head=True,
           gelu_tanh=True, use_remat=True, remat_policy="dots")
p = make_predict_step(m, device="cpu")(np.zeros((1, 32, 32, 3), np.uint8))
assert p.shape == (1, 32, 32)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import default_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
    create_train_state, make_train_step)
loss = make_train_step(m, 0.2, 0.8, 0.45)(
    create_train_state(m, default_config(), device="cpu"),
    np.zeros((1, 32, 32, 3), np.uint8), np.ones((1, 32, 32), np.uint8), 1e-4)
assert bool(torch.isfinite(loss))
jax_pkg = "semantic_segmentation_of_stylegan2_artifacts_tpu"
banned = ("jax", "flax", "optax", "orbax", "tensorstore", "zstandard")
bad = [n for n in sys.modules if n in banned or n.startswith(tuple(b + "." for b in banned))
       or n == jax_pkg or n.startswith(jax_pkg + ".")]
print("LOADED", bad)
"""


def test_port_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
