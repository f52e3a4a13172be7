"""Port's data pipeline vs the JAX package, on the CPU: all byte-equal.

* ``data/synthetic.py`` writes the same tree, file for file and byte for
  byte, for one seed.
* ``BatchPatternSampler`` gives the same index lists over 3 epochs.
* ``RandomGenerator`` gives the same image and label bytes for the same
  sample and ``(seed, epoch, index)`` key, over 144 keys (the gray branch,
  p = 0.045, among them); each of the five ops alone gives the same bytes.
* ``TrainLoader.epoch_batches`` (and ``epoch_batches_merged``) give the same
  batches over 3 epochs, with ``DYNAMIC_LOADER`` off and on; both raise the
  same error where the schedule asks for no real image.
* ``EvalLoader`` with batch 3 and ``pad_to_batch``, with labels, gives the
  same batches, and ``SegArtifactDataset`` the same samples.
"""

import os

import numpy as np
import pytest

from semantic_segmentation_of_stylegan2_artifacts_tpu.data import augment as jax_augment
from semantic_segmentation_of_stylegan2_artifacts_tpu.data import dataset as jax_dataset
from semantic_segmentation_of_stylegan2_artifacts_tpu.data import pipeline as jax_pipeline
from semantic_segmentation_of_stylegan2_artifacts_tpu.data.sampler import (
    BatchPatternSampler as JaxSampler,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.data.synthetic import (
    generate_synthetic_dataset as jax_generate,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data import augment, dataset, pipeline
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.sampler import (
    BatchPatternSampler,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)

SIZE = 32
SPLIT = dict(n_fake_train=8, n_real_train=4, n_val_fake=3, n_val_real=2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    generate_synthetic_dataset(root, img_size=SIZE, seed=5, **SPLIT)
    return root


def _tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("num_classes", [1, 3])
def test_synthetic_tree_is_byte_equal(tmp_path, num_classes):
    kw = dict(img_size=40, seed=7, num_classes=num_classes)
    want = jax_generate(str(tmp_path / "jax"), **kw)
    got = generate_synthetic_dataset(str(tmp_path / "port"), **kw)
    assert got == want
    jax_tree, port_tree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    # 10 fake and 6 real images with their masks, 7 split lists
    assert len(port_tree) == 39 and port_tree.keys() == jax_tree.keys()
    for name in jax_tree:
        assert port_tree[name] == jax_tree[name], name


@pytest.mark.parametrize("n_fake,n_real", [(6, 4), (9, 1), (5, 5)])
def test_sampler_index_lists_equal_jax(n_fake, n_real):
    nb = (n_fake + n_real) // 2
    for epoch in range(3):
        want = list(JaxSampler(range(n_fake), range(n_fake, n_fake + n_real), nb, 2, epoch))
        got = list(BatchPatternSampler(range(n_fake), range(n_fake, n_fake + n_real), nb, 2,
                                       epoch))
        assert got == want
        assert all(any(i < n_fake for i in pair) for pair in got)


def test_sampler_rejects_what_jax_rejects():
    for args in [(range(4), range(0), 2, 2, 0), (range(2), range(2), 2, 3, 0),
                 (range(1), range(3), 2, 2, 0)]:
        with pytest.raises(ValueError) as want:
            JaxSampler(*args)
        with pytest.raises(ValueError) as got:
            BatchPatternSampler(*args)
        assert str(got.value) == str(want.value)


def test_random_generator_is_byte_equal(data):
    ds = dataset.SegArtifactDataset(data, os.path.join(data, "lists"), "train")
    port = augment.RandomGenerator([SIZE, SIZE], random_flip_flag=True, seed=11)
    jax = jax_augment.RandomGenerator([SIZE, SIZE], random_flip_flag=True, seed=11)
    draws = []
    for epoch in range(3):
        for idx in range(len(ds)):
            for extra in range(4):
                key = (11, epoch, idx + 100 * extra)
                sample = ds[idx]
                got = port(sample, rng=augment.sample_rng(*key))
                want = jax(sample, rng=jax_augment.sample_rng(*key))
                assert got["image"].dtype == np.uint8 and got["label"].dtype == np.uint8
                np.testing.assert_array_equal(got["image"], want["image"])
                np.testing.assert_array_equal(got["label"], want["label"])
                assert got["case_name"] == want["case_name"]
                draws.append(augment.sample_rng(*key).random(2))
    d = np.array(draws)
    assert ((d[:, 0] > 0.1) & (d[:, 1] < 0.05)).any()  # the gray branch was taken


@pytest.mark.parametrize("ksize", [3, 5])
def test_augment_ops_are_byte_equal(ksize):
    img = np.random.default_rng(ksize).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    for port_op, jax_op in [
            (augment.to_gray(img), jax_augment.to_gray(img)),
            (augment.brightness_contrast(img, 0.07, -0.04),
             jax_augment.brightness_contrast(img, 0.07, -0.04)),
            (augment.hue_saturation_value(img, -3, 17, 2),
             jax_augment.hue_saturation_value(img, -3, 17, 2)),
            (augment.random_gamma(img, 1.07), jax_augment.random_gamma(img, 1.07)),
            (augment.gaussian_blur(img, ksize), jax_augment.gaussian_blur(img, ksize))]:
        np.testing.assert_array_equal(port_op, jax_op)


def _loaders(data, dynamic, seed=3):
    lists = os.path.join(data, "lists")

    def build(mod, ds_mod):
        return mod.TrainLoader(ds_mod.SegArtifactDataset(data, lists, "fake_train"),
                               ds_mod.SegArtifactDataset(data, lists, "real_train_all"),
                               img_size=SIZE, seed=seed, dynamic_loader=dynamic,
                               num_workers=3, prefetch_depth=2)

    return build(pipeline, dataset), build(jax_pipeline, jax_dataset)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["case_name"] == w["case_name"]
        for key in ("image", "label"):
            assert g[key].dtype == w[key].dtype == np.uint8
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("dynamic,epochs", [(False, (0, 1, 2)), (True, (14, 30, 31))])
def test_train_loader_batches_are_byte_equal(data, dynamic, epochs):
    port, jax = _loaders(data, dynamic)
    for epoch in epochs:
        assert port.num_batches(epoch) == jax.num_batches(epoch)
        got = list(port.epoch_batches(epoch))
        _assert_batches_equal(got, list(jax.epoch_batches(epoch)))
        assert got[0]["image"].shape == (2, SIZE, SIZE, 3)
        _assert_batches_equal(list(port.epoch_batches_merged(epoch, 2)),
                              list(jax.epoch_batches_merged(epoch, 2)))


def test_train_loader_raises_as_jax_without_real_images(data):
    port, jax = _loaders(data, True)
    with pytest.raises(ValueError) as want:
        list(jax.epoch_batches(0))
    with pytest.raises(ValueError) as got:
        list(port.epoch_batches(0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("batch_size,pad", [(1, False), (3, True), (3, False)])
def test_eval_loader_batches_are_byte_equal(data, batch_size, pad):
    lists = os.path.join(data, "lists")
    kw = dict(img_size=SIZE, batch_size=batch_size, pad_to_batch=pad)
    got = list(pipeline.EvalLoader(dataset.SegArtifactDataset(data, lists, "val"), **kw))
    want = list(jax_pipeline.EvalLoader(jax_dataset.SegArtifactDataset(data, lists, "val"),
                                        **kw))
    _assert_batches_equal(got, want)
    assert [len(b["case_name"]) for b in got] == ([1] * 5 if batch_size == 1 else [3, 2])
    assert got[-1]["image"].shape[0] == {(1, False): 1, (3, True): 3, (3, False): 2}[
        (batch_size, pad)]
