"""Port's validation metrics and CSV logger vs the JAX package, on the CPU.

* ``case_metrics`` (one case, and a batch of cases reduced each on its own)
  and ``case_metrics_multiclass`` against the JAX package's jitted
  ``compute_case_metrics_jit`` / ``compute_case_metrics_batch_jit`` /
  ``compute_case_metrics_multiclass_jit`` on numpy-seeded maps: random
  masks, an empty mask (a real image), a full mask, probabilities all below
  the threshold; tolerance 1e-6 relative and absolute (float32 sums of up
  to 4,096 values taken in another order).
* ``MetricsAggregator.summarize`` against the JAX aggregator over the same
  cases (1e-6), and its ValueErrors for a split with no real or no fake
  case.
* The 7 CSV files of ``CSVHandler``, headers and one ``write_epoch`` row,
  byte-equal to the JAX ``CSVHandler``'s for the same ``EpochSummary``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.metrics import csv_logger as jax_csv
from semantic_segmentation_of_stylegan2_artifacts_tpu.metrics import segmentation as jax_seg
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.metrics import csv_logger, segmentation

TOL = dict(rtol=1e-6, atol=1e-6)
SIZE = 64


def _maps(kind, seed, shape=(SIZE, SIZE)):
    rng = np.random.default_rng(seed)
    probs = rng.random(shape).astype(np.float32)
    if kind == "random":
        label = (rng.random(shape) > 0.7).astype(np.float32) * 255
    elif kind == "empty":
        label = np.zeros(shape, np.float32)
    elif kind == "full":
        label = np.ones(shape, np.float32)
    else:  # "low": every probability below the threshold
        probs *= 0.4
        label = (rng.random(shape) > 0.5).astype(np.float32)
    return probs, label


def _check(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), err_msg=k, **TOL)


@pytest.mark.parametrize("kind", ["random", "empty", "full", "low"])
@pytest.mark.parametrize("threshold", [0.5, 0.4])
def test_case_metrics_match_jax(kind, threshold):
    probs, label = _maps(kind, 0)
    want = jax_seg.compute_case_metrics_jit(jnp.asarray(probs), jnp.asarray(label), threshold)
    got = segmentation.case_metrics(torch.from_numpy(probs), torch.from_numpy(label),
                                    threshold)
    _check(segmentation.metrics_to_host(got), want)


def test_batched_case_metrics_match_jax():
    cases = [_maps(k, i) for i, k in enumerate(["random", "empty", "full", "low", "random"])]
    probs = np.stack([p for p, _ in cases])
    label = np.stack([lbl for _, lbl in cases])
    want = jax_seg.compute_case_metrics_batch_jit(jnp.asarray(probs), jnp.asarray(label), 0.5)
    got = segmentation.metrics_to_host(segmentation.case_metrics(
        torch.from_numpy(probs), torch.from_numpy(label), 0.5))
    assert got["tp"].shape == (5,)
    _check(got, want)


@pytest.mark.parametrize("labels", ["mixed", "one_class", "background"])
def test_multiclass_metrics_match_jax(labels):
    rng = np.random.default_rng(3)
    probs = rng.random((32, 32, 3)).astype(np.float32)
    lab = {"mixed": rng.integers(0, 4, (32, 32)),
           "one_class": np.where(rng.random((32, 32)) > 0.6, 2, 0),
           "background": np.zeros((32, 32))}[labels].astype(np.uint8)
    want = jax_seg.compute_case_metrics_multiclass_jit(jnp.asarray(probs),
                                                       jnp.asarray(lab), 0.5)
    got = segmentation.case_metrics_multiclass(torch.from_numpy(probs),
                                               torch.from_numpy(lab), 0.5)
    _check(segmentation.metrics_to_host(got), want)


def _cases(kinds):
    port, jax_cases = [], []
    for i, kind in enumerate(kinds):
        probs, label = _maps(kind, 10 + i)
        loss = 0.1 * (i + 1)
        port.append(segmentation.to_case_metrics(f"c{i}", segmentation.metrics_to_host(
            segmentation.case_metrics(torch.from_numpy(probs), torch.from_numpy(label),
                                      0.5)), loss))
        jax_cases.append(jax_seg.to_case_metrics(f"c{i}", jax_seg.compute_case_metrics_jit(
            jnp.asarray(probs), jnp.asarray(label), 0.5), loss))
    return port, jax_cases


def _summaries(kinds):
    port, jax_cases = _cases(kinds)
    pa, ja = segmentation.MetricsAggregator(), jax_seg.MetricsAggregator()
    for p, j in zip(port, jax_cases):
        pa.add(p)
        ja.add(j)
    return pa.summarize(3, 0.25), ja.summarize(3, 0.25)


@pytest.mark.parametrize("kinds", [["random", "empty", "random"],
                                   ["random", "low", "empty", "empty", "full"]])
def test_summary_matches_jax(kinds):
    got, want = _summaries(kinds)
    assert got.score == pytest.approx(got.mean_soft_dice - 10 * got.mean_fpr, abs=1e-12)
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, (list, float)):
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(w, float),
                                       err_msg=field.name, **TOL)
        else:
            assert g == w, field.name


@pytest.mark.parametrize("kinds,match", [(["random", "full"], "no real images"),
                                         (["empty"], "No valid fake"), ([], "at least one")])
def test_summary_raises(kinds, match):
    agg = segmentation.MetricsAggregator()
    for case in _cases(kinds)[0]:
        agg.add(case)
    with pytest.raises(ValueError, match=match):
        agg.summarize(1)


def test_csv_files_are_byte_equal_to_jax(tmp_path):
    # one summary's values through both writers: the bytes depend on the writer
    want = _summaries(["random", "empty", "low"])[1]
    got = segmentation.EpochSummary(**dataclasses.asdict(want))
    with csv_logger.CSVHandler(str(tmp_path / "port")) as h:
        h.write_epoch(got)
    with jax_csv.CSVHandler(str(tmp_path / "jax")) as h:
        h.write_epoch(want)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == sorted(csv_logger.HEADERS)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    header = (tmp_path / "port" / "val_metric_real_epoch.csv").read_bytes().splitlines()[0]
    assert header.endswith(b",FRP")
    assert (tmp_path / "port" / "val_metric_real_batch.csv").read_bytes().startswith(
        b"epoch,batch,accuracy,confusion_matrix_bin, val_loss\r\n")
