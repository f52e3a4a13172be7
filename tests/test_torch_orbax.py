"""The port's orbax checkpoints (``TPU.CKPT_BACKEND: orbax``), on the CPU,
against the JAX package's (orbax, TensorStore and ``zstandard`` only here,
in the test: the port imports none of them).

* The zstd decoder (``native/zstd.cpp``) returns ``zstandard``'s input for
  its frames at levels 1, 3, 9 and 19, with and without a checksum, with
  and without a content size, several frames and skippable ones in a row;
  a truncated frame, a bad magic, a bad checksum and a dictionary frame
  raise ``ValueError``; CRC-32C gives the published check value.
* OCDBT (``train/ocdbt.py``): the port reads TensorStore's stores, one
  uncompressed and one zstd, split into interior nodes by a small node
  size; TensorStore reads the port's, also with interior nodes.
* zarr (``train/zarr.py``): an array sharded over the 8 virtual devices is
  written one chunk a shard and read back in bits; edge chunks are cut, a
  missing chunk is the fill value; other compressors, filters, ``F`` order
  and zarr3 raise naming the key.
* JAX -> port: a ``best_model.orbax`` and an ``epoch_1.orbax`` of JAX's
  ``CheckpointWriter`` (tiny MSUNet, ``build_optimizer``'s state after two
  updates, unfrozen and with the encoder frozen) read into the port in
  bits; the loaded model's float32 logits match JAX's within 1e-5 (the
  tolerance of the JAX-vs-port forwards in ``test_torch_checkpoint.py``);
  one more update from the loaded AdamW matches optax's within 1e-6.
* Port -> JAX: what the port's ``CheckpointWriter(backend="orbax")``
  writes, synchronous and in the background, reads through JAX's
  ``load_best``, ``restore_checkpoint_orbax`` and the JAX trainer's resume
  (``read_checkpoint_auto`` + ``from_state_dict`` into
  ``build_optimizer``'s state) in bits, and the next update agrees within
  1e-6; its ``_METADATA`` is what JAX's background writer records for the
  same tree.  The port's trainer resumes a JAX ``epoch_1.orbax`` in bits; a
  layout of another frozen set raises.
* The committed fixture ``train/testdata/jax_orbax`` (read on the card by
  ``chip_smoke.py`` phase 17) restores through JAX and through the port to
  its ``values.npz``.  It was made by :func:`write_fixture`; regenerate it
  with ``python -c "import sys; sys.path[:0] = ['.', 'tests'];
  import conftest, test_torch_orbax as t; t.write_fixture()"`` from the
  repository root.
"""

import functools
import logging
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_trainer_features import _config, data  # noqa: F401  (fixture)
from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    default_config as jax_default_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import checkpoint as jax_ckpt
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import optim as jax_optim
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
    default_config,
    load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch import native
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.native import zstd
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import (
    checkpoint,
    ocdbt,
    optim,
    orbax,
    trainer,
    zarr,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
    create_train_state,
)

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

TINY = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4)
FIXTURE = os.path.join(os.path.dirname(checkpoint.__file__), "testdata", "jax_orbax")


# ---- the zstd decoder -------------------------------------------------------
def _corpus():
    rng = np.random.default_rng(0)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    return [b"", b"x",
            b" ".join(words[i] for i in rng.integers(0, 300, 40000)),
            rng.standard_normal(60000).astype(np.float32).tobytes(),
            np.zeros(1 << 20, np.uint8).tobytes(),
            rng.integers(0, 4, 200000, dtype=np.uint8).tobytes(),
            rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()]


@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_zstd_decodes_zstandard_frames(level, checksum):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    for data in _corpus():
        assert zstd.decompress(c.compress(data)) == data
        stream = c.compressobj()  # no content size in the header
        assert zstd.decompress(stream.compress(data) + stream.flush()) == data


def test_zstd_concatenated_and_skippable_frames():
    a, b = _corpus()[2:4]
    skip = struct.pack("<II", 0x184D2A5A, 7) + b"skipped"
    frames = (zstandard.ZstdCompressor(level=3, write_checksum=True).compress(a) + skip
              + zstandard.ZstdCompressor(level=19).compress(b) + skip)
    assert zstd.decompress(frames) == a + b
    assert zstd.bound(frames) == len(a) + len(b)


def _bad(kind):
    data = _corpus()[2]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    if kind == "truncated":
        return frame[:len(frame) // 2]
    if kind == "bad_magic":
        return b"\x29" + frame[1:]
    if kind == "bad_checksum":
        return frame[:-1] + bytes([frame[-1] ^ 1])
    if kind == "dictionary":
        d = zstandard.train_dictionary(2048, [data[i:i + 400] for i in range(0, 80000, 400)])
        return zstandard.ZstdCompressor(dict_data=d).compress(data[:1000])
    return b""


@pytest.mark.parametrize("kind", ["truncated", "bad_magic", "bad_checksum", "dictionary",
                                  "empty"])
def test_zstd_bad_frames_raise(kind):
    with pytest.raises(ValueError, match="zstd: "):
        zstd.decompress(_bad(kind))


def test_zstd_fuzzed_frames_raise_or_decode():
    data = _corpus()[2][:20000]
    frame = zstandard.ZstdCompressor(level=19).compress(data)
    rng = np.random.default_rng(1)
    for _ in range(300):
        g = bytearray(frame)
        for i in rng.integers(0, len(g), 3):
            g[i] = int(rng.integers(0, 256))
        try:
            zstd.decompress(bytes(g))
        except ValueError:
            pass


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"56789", zstd.crc32c(b"1234")) == 0xE3069283


def test_zstd_failed_build_raises(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho no compiler here >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no compiler here"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")
    assert not list((tmp_path / "build").rglob("*.so"))


# ---- OCDBT ------------------------------------------------------------------
def _items(n=400, seed=2):
    rng = np.random.default_rng(seed)
    return {f"k{i:04d}.{'ab' * (i % 4)}/{i % 3}": rng.integers(
        0, 256, int(rng.integers(0, 2500)), dtype=np.uint8).tobytes() for i in range(n)}


@pytest.mark.parametrize("compression", [None, "zstd"])
def test_port_reads_tensorstore_ocdbt(tmp_path, compression):
    items = _items()
    config = {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 100,
              "compression": {"id": "zstd"} if compression else None}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": config}).result()
    with ts.Transaction() as txn:
        for k, v in items.items():
            kv.with_transaction(txn)[k] = v
    store = ocdbt.Store(tmp_path)
    assert store.keys() == sorted(items)
    for k, v in items.items():
        assert store.get(k).tobytes() == v


def test_tensorstore_reads_port_ocdbt(tmp_path, monkeypatch):
    monkeypatch.setattr(ocdbt, "NODE_BYTES", 700)  # interior nodes at this size
    items = _items(seed=3)
    ocdbt.write_store(tmp_path, items.items())
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}"}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v
    with pytest.raises(FileExistsError):
        ocdbt.write_store(tmp_path, items.items())


def test_ocdbt_checks_the_crc(tmp_path):
    ocdbt.write_store(tmp_path, [("a", b"1")])
    path = tmp_path / "manifest.ocdbt"
    data = bytearray(path.read_bytes())
    data[20] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Store(tmp_path)


# ---- zarr -------------------------------------------------------------------
def _bits(x):
    """Bytes of an array of either package (bfloat16 by its bits)."""
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    x = np.asarray(x)
    return x.tobytes()


def _assert_bits(got, want):
    assert tuple(got.shape) == tuple(np.shape(want))
    assert _bits(got) == _bits(want)


def test_sharded_array_reads_in_bits(tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    rng = np.random.default_rng(4)
    w = jax.device_put(rng.standard_normal((16, 6)).astype(np.float32),
                       NamedSharding(mesh, P(("a", "b"), None)))
    h = jax.device_put(jnp.asarray(rng.standard_normal((8, 4)), jnp.bfloat16),
                       NamedSharding(mesh, P("a", "b")))
    path = jax_ckpt.CheckpointWriter(backend="orbax").save_best(
        str(tmp_path), {"w": w, "h": h}, 2, 0.5)
    store = ocdbt.Store(path)
    assert [k for k in store.keys() if k.startswith("model.w/")] == [
        "model.w/.zarray"] + [f"model.w/{i}.0" for i in range(8)]
    assert len([k for k in store.keys() if k.startswith("model.h/")]) == 9
    got = orbax.restore(path)
    _assert_bits(got["model"]["w"], np.asarray(w))
    _assert_bits(got["model"]["h"], np.asarray(h))
    assert got["epoch"] == 2 and got["best_score"] == 0.5


def _zarray(**over):
    meta = zarr.metadata((5, 3), torch.float32)
    meta.update(chunks=[2, 2], **over)
    import json
    return json.dumps(meta).encode()


def test_zarr_edge_chunks_and_fill(tmp_path):
    chunk = np.arange(4, dtype=np.float32).reshape(2, 2)
    items = [("x/.zarray", _zarray(fill_value=7.0)), ("x/0.0", chunk), ("x/2.1", chunk + 10)]
    ocdbt.write_store(tmp_path, items)
    got = zarr.read_array(ocdbt.Store(tmp_path), "x").numpy()
    want = np.full((5, 3), 7.0, np.float32)
    want[0:2, 0:2] = chunk
    want[4:5, 2:3] = (chunk + 10)[:1, :1]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("over,match", [
    ({"compressor": {"id": "blosc"}}, "compressor 'blosc'"),
    ({"filters": [{"id": "delta"}]}, "filters"),
    ({"order": "F"}, "order 'F'"),
    ({"dimension_separator": "/"}, "dimension separator '/'"),
    ({"zarr_format": 3}, "zarr_format 3"),
])
def test_zarr_unsupported_raises_naming_the_key(tmp_path, over, match):
    ocdbt.write_store(tmp_path, [("arr/.zarray", _zarray(**over))])
    with pytest.raises(ValueError, match=f"arr/.zarray: {match}"):
        zarr.read_array(ocdbt.Store(tmp_path), "arr")


# ---- JAX -> port, port -> JAX ---------------------------------------------
@functools.cache
def _jax_model():
    jm = JaxMSUNet(num_classes=1, **TINY)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(3)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    return jm, jax.device_get(params)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.1).astype(p.dtype),
                        params)


FROZEN = {False: set(), True: {0, 1, 2, 3}}


@functools.cache
def _jax_trained(frozen):
    """JAX params and ``build_optimizer``'s state after two updates."""
    _, params = _jax_model()
    tx = jax_optim.build_optimizer(jax_default_config(), params, FROZEN[frozen])
    state = tx.init(params)
    for seed in (1, 2):
        updates, state = tx.update(_grads(params, seed), state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params, updates))
    return tx, params, jax.device_get(state)


def _port_model(sd):
    model = MSUNet(**TINY)
    model.ms_unet.load_state_dict(sd, strict=True)
    return model


def _port_step(model, optimizer, grads):
    g = flax_to_state_dict({"msunet": grads["msunet"]})
    for name, p in model.ms_unet.named_parameters():
        p.grad = g[name].clone() if p.requires_grad else None
    optimizer.step()


def _assert_tree_bits(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_bits(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (int, float)):
        assert got == want and type(got) is type(want), path
    else:
        _assert_bits(got, want)


@pytest.mark.parametrize("frozen", [False, True])
def test_jax_checkpoints_load_into_the_port(tmp_path, frozen):
    jm, _ = _jax_model()
    tx, params, state = _jax_trained(frozen)
    w = jax_ckpt.CheckpointWriter(backend="orbax", async_=frozen)
    best = w.save_best(str(tmp_path), params, 4, 0.75)
    last = w.save_last(str(tmp_path), 1, params, state, 9, 0.5)
    w.close()
    # every tensor in bits
    raw = orbax.restore(last)
    _assert_tree_bits(raw["optimizer"], serialization.to_state_dict(state))
    _assert_tree_bits(raw["model"], params)
    assert (raw["epoch"], raw["iter_num"], raw["dice"]) == (1, 9, 0.5)
    sd = checkpoint.load_best_state_dict(str(tmp_path))
    for k, v in flax_to_state_dict(params).items():
        _assert_bits(sd[k], v)
    assert checkpoint.resolve_checkpoint(best) == best
    # the loaded model's logits
    model = _port_model(sd).eval()
    x = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), True))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, atol=1e-5,
                                   rtol=0)
    # one more update from the loaded AdamW, against optax's
    model.train()
    opt = optim.build_optimizer(default_config(), model, FROZEN[frozen])
    optim.load_optax(opt, model, checkpoint.load_orbax(last)["optimizer"], last)
    assert {float(s["step"]) for s in opt.state.values()} == {2.0}
    grads = _grads(params, 3)
    updates, _ = tx.update(grads, state, params)
    nxt = jax.device_get(jax.tree.map(lambda p, u: p + u, params, updates))
    _port_step(model, opt, grads)
    want = flax_to_state_dict(nxt)
    for name, p in model.ms_unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def _port_trained(frozen):
    torch.manual_seed(0)
    model = MSUNet(**TINY)
    opt = optim.build_optimizer(default_config(), model, FROZEN[frozen])
    template = state_dict_to_flax(model.ms_unet.state_dict())
    for seed in (1, 2):
        _port_step(model, opt, _grads(template, seed))
    return model, opt


@pytest.mark.parametrize("async_", [False, True])
@pytest.mark.parametrize("frozen", [False, True])
def test_port_checkpoints_load_into_jax(tmp_path, frozen, async_):
    model, opt = _port_trained(frozen)
    w = checkpoint.CheckpointWriter(backend="orbax", async_=async_)
    best = w.save_best(str(tmp_path), model, 3, 0.25)
    last = w.save_last(str(tmp_path), 5, model, opt, 11, 0.5)
    w.close()
    assert sorted(os.listdir(tmp_path)) == ["best_model.orbax", "epoch_5.orbax"]
    params = state_dict_to_flax(model.ms_unet.state_dict())
    _, template = _jax_model()
    got = jax_ckpt.load_best(str(tmp_path), params_target=template)
    _assert_tree_bits(jax.device_get(got["model"]), params)
    assert (got["epoch"], got["best_score"]) == (3, 0.25)
    _assert_tree_bits(jax_ckpt.restore_checkpoint_orbax(best)["model"], params)
    # the JAX trainer's resume: raises on any mismatch of the structure
    tx = jax_optim.build_optimizer(jax_default_config(), template, FROZEN[frozen])
    payload = serialization.from_state_dict(
        {"epoch": 0, "model": template, "optimizer": tx.init(template), "iter_num": 0,
         "dice": 0.0}, jax_ckpt.read_checkpoint_auto(last))
    assert (payload["epoch"], payload["iter_num"], payload["dice"]) == (5, 11, 0.5)
    state = jax.device_get(payload["optimizer"])
    _assert_tree_bits(serialization.to_state_dict(state), optim.to_optax(opt, model))
    adam = serialization.to_state_dict(state)
    adam = (adam["inner_states"]["trainable"]["inner_state"] if frozen else adam)
    assert int(adam["count"]) == 2 and int(adam["inner_state"]["0"]["count"]) == 2
    # the next update agrees
    grads = _grads(params, 3)
    updates, _ = tx.update(grads, state, payload["model"])
    nxt = flax_to_state_dict(jax.device_get(jax.tree.map(lambda p, u: p + u,
                                                          payload["model"], updates)))
    _port_step(model, opt, grads)
    for name, p in model.ms_unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), nxt[name].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_trainer_resumes_a_jax_epoch_checkpoint(tmp_path, data):  # noqa: F811
    """``--resume`` from a JAX ``epoch_1.orbax``: the port's trainer starts
    at epoch 2 with JAX's parameters and optax's moments, in bits."""
    _, params, state = _jax_trained(False)  # TINY is the config's model
    writer = jax_ckpt.CheckpointWriter(backend="orbax")
    path = writer.save_last(str(tmp_path / "jax"), 1, params, state, 10, 0.5)
    writer.close()
    cfg = load_config(_config(tmp_path, data))
    model = MSUNet.from_config(cfg, device="cpu")
    train_state = create_train_state(model, cfg, device="cpu")
    trainer.trainer(model, logging.getLogger("orbax.resume"), None, str(tmp_path / "out"),
                    cfg, state=train_state, resume_from=path, device="cpu")  # 2 of 2 epochs
    assert train_state.step == 10
    sd = model.ms_unet.state_dict()
    for k, v in flax_to_state_dict(params).items():
        _assert_bits(sd[k], v)
    _assert_tree_bits(optim.to_optax(train_state.optimizer, model),
                      serialization.to_state_dict(state))


@pytest.mark.parametrize("frozen", [False, True])
def test_metadata_is_what_jax_writes(tmp_path, frozen):
    """``_METADATA`` equals what JAX's background writer records for the
    same tree; ``_CHECKPOINT_METADATA`` differs in its timestamps only."""
    import json

    model, opt = _port_trained(frozen)
    port = checkpoint.CheckpointWriter(backend="orbax").save_last(
        str(tmp_path / "port"), 2, model, opt, 7, 0.5)
    jw = jax_ckpt.CheckpointWriter(backend="orbax", async_=True)
    jax_dir = jw.save_last(str(tmp_path / "jax"), 2, state_dict_to_flax(
        model.ms_unet.state_dict()), optim.to_optax(opt, model), 7, 0.5)
    jw.close()

    def read(path, name):
        with open(os.path.join(path, name)) as f:
            return json.load(f)

    assert read(port, "_METADATA") == read(jax_dir, "_METADATA")
    got, want = (read(p, orbax.CHECKPOINT_METADATA) for p in (port, jax_dir))
    stamps = ("init_timestamp_nsecs", "commit_timestamp_nsecs")
    assert {k: v for k, v in got.items() if k not in stamps} == {
        k: v for k, v in want.items() if k not in stamps}
    assert set(got) == set(want)


def test_load_optax_refuses_another_frozen_set(tmp_path):
    model, opt = _port_trained(True)
    tree = optim.to_optax(opt, model)
    fresh = MSUNet(**TINY)
    unfrozen = optim.build_optimizer(default_config(), fresh, set())
    with pytest.raises(ValueError, match="the frozen stages differ"):
        optim.load_optax(unfrozen, fresh, tree, "epoch_1.orbax")
    with pytest.raises(ValueError, match="not the optax state"):
        optim.load_optax(unfrozen, fresh, {"count": 1}, "epoch_1.orbax")


def test_uncommitted_directory_is_not_a_checkpoint(tmp_path):
    model, _ = _port_trained(False)
    path = checkpoint.CheckpointWriter(backend="orbax").save_best(str(tmp_path), model, 1, 0.0)
    os.remove(os.path.join(path, orbax.CHECKPOINT_METADATA))
    with pytest.raises(FileNotFoundError, match="not an orbax checkpoint"):
        checkpoint.load_best_state_dict(str(tmp_path))
    assert not [n for n in os.listdir(tmp_path) if "tmp" in n]


# ---- the committed fixture ---------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def write_fixture(out=FIXTURE):
    """The fixture: a tiny MSUNet (embed 8, one head a stage) and
    ``build_optimizer``'s state after one update, values on a coarse grid
    so the zstd chunks stay small; ``best_model.orbax`` written by JAX's
    synchronous ``CheckpointWriter(backend="orbax")`` (``jax.Array``
    leaves), ``epoch_1.orbax`` by its background one (``np.ndarray``), and
    ``values.npz`` of every leaf (``best/…``, ``epoch/…``, path by ``/``)."""
    jm = JaxMSUNet(num_classes=1, img_size=32, embed_dim=8, depths=(1, 1, 1, 1),
                   num_heads=(1, 1, 1, 1), window_size=4)
    params = jm.init({"params": jax.random.PRNGKey(7)}, jnp.zeros((1, 32, 32, 3)),
                     True)["params"]
    params = jax.tree.map(lambda p: jnp.round(p * 64) / 64, params)
    tx = jax_optim.build_optimizer(jax_default_config(), params)
    grads = jax.tree.map(lambda p: jnp.round(jnp.sin(jnp.arange(p.size).reshape(p.shape)
                                                     ) * 4) / 8, params)
    updates, state = tx.update(grads, tx.init(params), params)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    w = jax_ckpt.CheckpointWriter(backend="orbax")
    w.save_best(out, params, 1, 0.5)
    w.close()
    w = jax_ckpt.CheckpointWriter(backend="orbax", async_=True)
    w.save_last(out, 1, params, state, 3, 0.25)
    w.close()
    values = {f"best/{k}": np.asarray(v) for k, v in _flat(
        jax.device_get({"model": params, "epoch": 1, "best_score": 0.5})).items()}
    values.update({f"epoch/{k}": np.asarray(v) for k, v in _flat(jax.device_get(
        {"epoch": 1, "model": params, "optimizer": serialization.to_state_dict(state),
         "iter_num": 3, "dice": 0.25})).items()})
    np.savez_compressed(os.path.join(out, "values.npz"), **values)


@pytest.mark.parametrize("name", ["best_model.orbax", "epoch_1.orbax"])
def test_committed_fixture_restores_to_its_npz(name):
    prefix = "best/" if name.startswith("best") else "epoch/"
    with np.load(os.path.join(FIXTURE, "values.npz")) as z:
        want = {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}
    path = os.path.join(FIXTURE, name)
    for tree in (jax.device_get(jax_ckpt.restore_checkpoint_orbax(path)),
                 orbax.restore(path)):
        flat = _flat(tree)
        assert set(flat) == set(want)
        for k, v in want.items():
            _assert_bits(flat[k] if torch.is_tensor(flat[k]) else np.asarray(flat[k]), v)
    size = sum(os.path.getsize(os.path.join(b, f)) for b, _, fs in os.walk(FIXTURE)
               for f in fs)
    assert size <= 2 << 20
