"""Port's checkpoints and the CLIs that read them, on the CPU.

* ``CheckpointWriter`` (in the caller's thread and in the background):
  ``best_model.pth`` and ``epoch_N.pth`` round-trip the model and the
  optimizer; the background writer writes what the parameters held when
  ``save_best`` returned, though they change right after; a failed
  background save re-raises from ``wait()``; the ``orbax`` backend's
  directories read back in bits, the AdamW state through optax's layout;
  an unknown backend raises.
* A JAX ``best_model.msgpack`` (the JAX package's ``save_best``) read by
  the port equals ``flax_to_state_dict`` of its params, bit for bit.
* A port ``best_model.pth`` read through the JAX test CLI's conversion path
  (``load_torch_state_dict``, the ``ms_unet.`` prefix stripped,
  ``convert_msunet_state_dict``) gives JAX logits equal to the port's
  within 1e-5 (float32).
* The predict CLI on a directory holding only a JAX ``best_model.msgpack``
  (fault 5), with one class and with two (fault 7: class maps), writes the
  JAX CLI's file names, and its probabilities match the JAX CLI's within
  1e-4 (as ``tests/test_torch_predict.py``).
* ``remap_encoder_keys`` and ``load_pretrained_encoder`` (SegFace and
  ImageNet-1k) give the JAX package's keys and weights for a checkpoint
  made in the test; a missing file leaves the model as it was.
"""

import functools
import logging
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semantic_segmentation_of_stylegan2_artifacts_tpu.cli import predict_cli as jax_predict_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import (
    weight_convert as jax_weight_convert,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models.weight_convert import (
    convert_msunet_state_dict,
    load_torch_state_dict,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import checkpoint as jax_ckpt
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import predict_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import default_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models import weights
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import checkpoint, optim
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
    create_train_state,
    make_train_step,
)

TINY = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4)


@functools.cache
def _jax_params(num_classes=1):
    """A JAX model and its init (compiled once a class count; jax arrays
    are immutable, so the tests share them)."""
    jm = JaxMSUNet(num_classes=num_classes, **TINY)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(num_classes)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    return jm, params


def _trained(seed=0):
    """A tiny model and its AdamW after two steps (moments and steps set)."""
    model = MSUNet(**TINY)
    state = create_train_state(model, default_config(), device="cpu")
    step = make_train_step(model, 0.2, 0.8, 0.45)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        step(state, rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
             (rng.random((2, 32, 32)) > 0.7).astype(np.uint8), 1e-3)
    return model, state


def _equal_trees(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("async_", [False, True])
def test_best_and_last_round_trip(tmp_path, async_):
    model, state = _trained()
    writer = checkpoint.CheckpointWriter(async_=async_)
    best = writer.save_best(str(tmp_path), model, 3, -0.25)
    last = writer.save_last(str(tmp_path), 4, model, state.optimizer, 17, 0.5)
    writer.close()
    assert sorted(os.listdir(tmp_path)) == ["best_model.pth", "epoch_4.pth"]
    got = checkpoint.load_checkpoint(best)
    assert got["epoch"] == 3 and got["best_score"] == -0.25
    assert all(k.startswith("ms_unet.") for k in got["model"])
    fresh = MSUNet(**TINY)
    fresh.load_state_dict(got["model"], strict=True)
    _equal_trees(fresh.state_dict(), model.state_dict())
    got = checkpoint.load_checkpoint(last)
    assert (got["epoch"], got["iter_num"], got["dice"]) == (4, 17, 0.5)
    opt = create_train_state(fresh, default_config(), device="cpu").optimizer
    opt.load_state_dict(got["optimizer"])
    _equal_trees(opt.state_dict(), state.optimizer.state_dict())
    assert int(opt.state_dict()["state"][0]["step"]) == 2


def test_async_writer_snapshots_before_returning(tmp_path, monkeypatch):
    model, _ = _trained()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    gate = threading.Event()
    write = checkpoint.save_checkpoint

    def held(path, payload):  # the background write waits for the gate
        assert gate.wait(timeout=60)
        write(path, payload)

    monkeypatch.setattr(checkpoint, "save_checkpoint", held)
    writer = checkpoint.CheckpointWriter(async_=True)
    path = writer.save_best(str(tmp_path), model, 1, 0.0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert not os.path.exists(path)
    gate.set()
    writer.close()
    _equal_trees(checkpoint.load_checkpoint(path)["model"], want)


def test_async_failure_reraises_from_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    model = MSUNet(**TINY)
    writer = checkpoint.CheckpointWriter(async_=True)
    writer.save_best(str(blocker / "sub"), model, 1, 0.0)
    with pytest.raises(OSError):
        writer.wait()
    writer.close()


def test_orbax_backend_raises(tmp_path):
    """The orbax backend writes directories that read back in bits; only an
    unknown backend raises."""
    model, state = _trained(seed=2)
    writer = checkpoint.CheckpointWriter(backend="orbax")
    best = writer.save_best(str(tmp_path), model, 3, -0.25)
    last = writer.save_last(str(tmp_path), 4, model, state.optimizer, 17, 0.5)
    writer.close()
    assert sorted(os.listdir(tmp_path)) == ["best_model.orbax", "epoch_4.orbax"]
    _equal_trees(checkpoint.load_best_state_dict(best), model.ms_unet.state_dict())
    got = checkpoint.load_orbax(last)
    assert (got["epoch"], got["iter_num"], got["dice"]) == (4, 17, 0.5)
    fresh = MSUNet(**TINY)
    fresh.ms_unet.load_state_dict(got["model"], strict=True)
    opt = create_train_state(fresh, default_config(), device="cpu").optimizer
    optim.load_optax(opt, fresh, got["optimizer"], last)
    _equal_trees(opt.state_dict()["state"], state.optimizer.state_dict()["state"])
    # optax keeps the learning rate as a float32 hyperparameter
    assert opt.param_groups[0]["lr"] == float(np.float32(state.optimizer.param_groups[0]["lr"]))
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        checkpoint.CheckpointWriter(backend="npz")


def test_port_reads_jax_msgpack(tmp_path):
    _, params = _jax_params()
    jax_ckpt.save_best(str(tmp_path), params, 7, 0.125)
    got = checkpoint.load_jax_best(str(tmp_path / "best_model.msgpack"))
    assert got["epoch"] == 7 and got["best_score"] == 0.125
    _equal_trees(got["model"], flax_to_state_dict(jax.device_get(params)))
    _equal_trees(checkpoint.load_best_state_dict(str(tmp_path)), got["model"])
    model = MSUNet(**TINY)
    model.ms_unet.load_state_dict(got["model"], strict=True)


def test_jax_test_cli_path_reads_port_pth(tmp_path):
    model, _ = _trained(seed=4)
    model.eval()
    writer = checkpoint.CheckpointWriter()
    path = writer.save_best(str(tmp_path), model, 2, 0.5)
    jm, template = _jax_params()
    # the conversion of the JAX package's cli/test_cli.py for a .pth
    sd = load_torch_state_dict(path)
    sd = {k[len("ms_unet."):] if k.startswith("ms_unet.") else k: v for k, v in sd.items()}
    params = convert_msunet_state_dict(sd, template)
    x = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), True))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_classes", [1, 2])
def test_predict_cli_on_a_jax_msgpack_dir(tmp_path, monkeypatch, num_classes):
    monkeypatch.setenv("SSA_TPU_COMP_CACHE", "0")  # the JAX CLI's cache stays off
    root = str(tmp_path / "data")
    generate_synthetic_dataset(root, img_size=32, num_classes=num_classes)
    cfg = {"DATA": {"IMG_SIZE": 32, "DATA_PATH": root},
           "MODEL": {"NUM_CLASSES": num_classes,
                     "SWIN": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                              "NUM_HEADS": [2, 2, 2, 2], "WINDOW_SIZE": 4}},
           "TPU": {"COMPUTE_DTYPE": "float32", "FUSED_HEAD": False,
                   "USE_PALLAS_ATTENTION": False, "FUSED_PATCH": False},
           "LIST_DIR": os.path.join(root, "lists")}
    cfg_path = str(tmp_path / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    _, params = _jax_params(num_classes)
    ckpt = str(tmp_path / "ckpt")
    jax_ckpt.save_best(ckpt, params, 1, 0.0)

    handlers = logging.root.handlers[:]
    try:
        want = jax_predict_cli.main(["--cfg", cfg_path, "--check_point_dir", ckpt,
                                     "--out_dir", str(tmp_path / "jax_out")])
    finally:
        for h in logging.root.handlers[:]:
            logging.root.removeHandler(h)
            h.close()
        logging.root.handlers[:] = handlers
    got = predict_cli.main(["--cfg", cfg_path, "--check_point_dir", ckpt,
                            "--out_dir", str(tmp_path / "port_out"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "port_out"))
    assert names == sorted(os.listdir(tmp_path / "jax_out"))
    assert sum(n.endswith("_class_map.png") for n in names) == (3 if num_classes > 1 else 0)
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)


def _encoder_checkpoint(kind, model, seed):
    """A SegFace / ImageNet-1k checkpoint for ``model``'s encoder, keys made
    by inverting the port's prefix table, values random."""
    table = {"segface": weights._SEGFACE_PREFIX_MAP,
             "imagenet1k": weights._IMAGENET1K_PREFIX_MAP}[kind]
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in model.state_dict().items():
        for src, dst in sorted(table, key=lambda kv: -len(kv[1])):
            if key.startswith(dst):
                sd[src + key[len(dst):]] = torch.from_numpy(
                    rng.standard_normal(value.shape).astype(np.float32))
                break
    if kind == "segface":
        sd["backbone.1.decode.weight"] = torch.zeros(3)  # the face parser's head
        return {"state_dict_backbone": sd}
    sd["head.weight"] = torch.zeros(3)  # outside `features`
    return sd


@pytest.mark.parametrize("kind", ["segface", "imagenet1k"])
def test_pretrained_encoder_matches_jax(tmp_path, kind):
    jm, params = _jax_params()
    model = MSUNet(**TINY)
    model.ms_unet.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    path = str(tmp_path / "encoder.pth")
    payload = _encoder_checkpoint(kind, model.ms_unet, 8)
    torch.save(payload, path)
    sd = payload.get("state_dict_backbone", payload)
    assert weights.remap_encoder_keys(sd, kind) == jax_weight_convert.remap_encoder_keys(
        sd, kind)
    n = weights.load_pretrained_encoder(model.ms_unet, path, kind)
    assert n == len([k for k in sd if not k.startswith(("backbone.1.", "head."))])
    want = flax_to_state_dict(jax.device_get(
        jax_weight_convert.load_pretrained_encoder(params, path, kind)))
    _equal_trees(model.ms_unet.state_dict(), want)
    assert weights.load_pretrained_encoder(model.ms_unet, str(tmp_path / "absent.pth"),
                                           kind) == 0
    with pytest.raises(ValueError, match="not found in dictionary"):
        weights.remap_encoder_keys({f"{'backbone.0' if kind == 'segface' else 'features'}"
                                    ".9.weight": torch.zeros(1)}, kind)
