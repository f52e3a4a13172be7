"""The port's remaining tool modules against the JAX package's, on the CPU.

* ``utils/flops.py::train_step_flops``: equal for Swin-B and Swin-T widths,
  several sizes, batches and parameter counts.
* ``utils/profiling.py``: ``StepTimer`` as JAX's; ``trace`` writes a
  Chrome trace; ``section_times`` splits one call into its sections.
* ``tools/ckpt_inspect.py``: ``dump_keys`` and ``diff_dumps`` equal JAX's on
  a JAX ``.msgpack`` tree, a JAX best checkpoint and a port ``.pth``.
* ``tools/dataset_check.py::check_dataset`` returns what JAX's returns.
* ``data/splits.py``: the lists written are byte-equal; ``data/build_mask.py``:
  the masks of a CVAT XML are bit-equal.
* ``viz/eval_overlays.py``, ``viz/artifact_distribution.py`` and
  ``viz/maps.py::save_contour_heatmap``: the arrays and the decoded PNGs
  are equal.
"""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semantic_segmentation_of_stylegan2_artifacts_tpu.data import build_mask as jax_bm
from semantic_segmentation_of_stylegan2_artifacts_tpu.data import splits as jax_splits
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.tools import ckpt_inspect as jax_ci
from semantic_segmentation_of_stylegan2_artifacts_tpu.tools import dataset_check as jax_dc
from semantic_segmentation_of_stylegan2_artifacts_tpu.train import checkpoint as jax_ckpt
from semantic_segmentation_of_stylegan2_artifacts_tpu.utils import flops as jax_flops
from semantic_segmentation_of_stylegan2_artifacts_tpu.utils import profiling as jax_prof
from semantic_segmentation_of_stylegan2_artifacts_tpu.viz import artifact_distribution as jax_ad
from semantic_segmentation_of_stylegan2_artifacts_tpu.viz import eval_overlays as jax_eo
from semantic_segmentation_of_stylegan2_artifacts_tpu.viz import maps as jax_maps
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data import build_mask, splits
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import (
    ckpt_inspect,
    dataset_check,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.checkpoint import (
    CheckpointWriter,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils import flops, profiling
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.viz import (
    artifact_distribution,
    eval_overlays,
    maps,
)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tools"))
    generate_synthetic_dataset(root, img_size=32, seed=7)
    return root


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _tree_bytes(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                out[os.path.relpath(os.path.join(base, n), root)] = f.read()
    return out


@pytest.mark.parametrize("img,batch,embed,depths,params", [
    (512, 8, 128, (2, 2, 18, 2), None), (1024, 2, 128, (2, 2, 18, 2), 100_000_000),
    (512, 8, 96, (2, 2, 6, 2), 40_000_000), (32, 2, 16, (1, 1, 1, 1), 10_000)])
def test_train_step_flops_equal_jax(img, batch, embed, depths, params):
    kw = dict(embed_dim=embed, depths=depths, params=params)
    assert flops.train_step_flops(img, batch, **kw) == \
        jax_flops.train_step_flops(img, batch, **kw)


def test_step_timer_and_trace(tmp_path):
    timers = [profiling.StepTimer(warmup=1), jax_prof.StepTimer(warmup=1)]
    for t in timers:
        for _ in range(3):
            with t.step():
                pass
        assert len(t.times) == 2 and t.summary(4).startswith("steps=2")
    assert profiling.StepTimer().images_per_sec(8) != profiling.StepTimer().images_per_sec(8)
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_section_times_split_one_call():
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4).eval()
    x = torch.rand(1, 32, 32, 3)
    out = profiling.section_times(lambda: model(x).sum().backward())
    assert {"embed", "encoder.0", "encoder.3", "decoder.3", "cent1.2",
            "head", "other", "total"} <= set(out)
    assert all(v >= 0 for k, v in out.items() if k != "other")
    assert out["encoder.0"] > 0 and out["head"] > 0
    assert abs(sum(v for k, v in out.items() if k != "total") - out["total"]) < 1e-6
    got = profiling.section_times(lambda: model(x), sections=["head"])
    assert set(got) == {"head", "other", "total"} and got["head"] > 0


def test_ckpt_inspect_equals_jax(tmp_path):
    tree = {"a": {"kernel": np.zeros((3, 4))}, "b": {"bias": np.zeros((4,))}}
    tree_path = str(tmp_path / "x.msgpack")
    jax_ckpt.save_checkpoint(tree_path, tree)
    jm = JaxMSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    best = jax_ckpt.save_best(str(tmp_path), params, 3, 0.5)
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4)
    pth = CheckpointWriter().save_best(str(tmp_path), model, 3, 0.5)
    raw = str(tmp_path / "raw.pth")
    torch.save({"w": torch.zeros(2, 2), "n": 3}, raw)
    dumps = {}
    for path in (tree_path, best, pth, raw):
        dumps[path] = ckpt_inspect.dump_keys(path)
        assert dumps[path] == jax_ci.dump_keys(path), path
    assert ("a.kernel", (3, 4)) in dumps[tree_path] and dumps[raw] == [("w", (2, 2))]
    assert len(dumps[pth]) == len(model.state_dict())
    for a, b in ((best, pth), (pth, best), (tree_path, tree_path)):
        assert ckpt_inspect.diff_dumps(dumps[a], dumps[b]) == \
            jax_ci.diff_dumps(dumps[a], dumps[b])
    out = str(tmp_path / "keys.txt")
    ckpt_inspect.main([pth, "--out", out])
    with open(out) as f:
        assert f.read().splitlines()[0] == f"{dumps[pth][0][0]} {list(dumps[pth][0][1])}"


def test_dataset_check_equals_jax(synth):
    lists = os.path.join(synth, "lists")
    for split in ("train", "val"):
        got = dataset_check.check_dataset(synth, lists, 32, split=split, verbose=False)
        assert got == jax_dc.check_dataset(synth, lists, 32, split=split, verbose=False)
    assert got["n_samples"] == 3


def test_split_lists_are_byte_equal(synth, tmp_path):
    real, fake = os.path.join(synth, "real_images"), os.path.join(synth, "fake_images")
    for name, mod in (("port", splits), ("jax", jax_splits)):
        out = str(tmp_path / name)
        mod.create_splits(real, fake, os.path.join(out, "v1"), split_ratio=(0.6, 0.2, 0.2),
                          fake_ratio_in_train=0.5, val_test_only_fake=False,
                          fake_ratio_in_test=0.5, seed=3)
        mod.create_splits_random(real, fake, os.path.join(out, "v2"), n_val_fake=2,
                                 n_val_real=1, n_test_fake=2, n_test_real=1,
                                 train_real_cap=2, seed=5)
        mod.filter_real_for_train(real, os.path.join(out, "v2"))
        mod.split_train_in_real_and_fake(os.path.join(out, "v2"))
    got, want = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "jax"))
    assert got == want and len(got) == 9
    lists = os.path.join(synth, "lists")
    for split in ("train", "val", "test"):
        assert splits.split_composition(lists, split) == \
            jax_splits.split_composition(lists, split)


XML = textwrap.dedent("""\
    <annotations>
      <version>1.1</version>
      <image id="0" name="091234.png" width="40" height="32">
        <polygon label="Artefakt" points="4.5,4;20,4.2;20,20;4,20"/>
        <polygon label="Artefakt" points="25,3;38,9;30,28"/>
        <polygon label="Other" points="0,0;5,0;5,5"/>
        <polygon label="Artefakt" points="1,1"/>
      </image>
      <image id="1" name="091235.png" width="32" height="24"/>
      <image id="2" name="10001.png" width="16" height="16">
        <polygon label="Artefakt" points="0,0;15,0;8,15;bad;1,2,3"/>
      </image>
    </annotations>
""")


def test_masks_are_bit_equal(tmp_path):
    xml = tmp_path / "ann.xml"
    xml.write_text(XML)
    for name, mod in (("port", build_mask), ("jax", jax_bm)):
        assert mod.build_masks(str(xml), str(tmp_path / name), verbose=False) == 3
    got, want = _tree_bytes(str(tmp_path / "port")), _tree_bytes(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) == ["091234_mask.png", "091235_mask.png",
                                           "10001_mask.png"]
    for n in got:
        a, b = _png(tmp_path / "port" / n), _png(tmp_path / "jax" / n)
        np.testing.assert_array_equal(a, b)
    assert _png(tmp_path / "port" / "091234_mask.png")[10, 10, 0] == 255
    for s in ("1,2;3,4;bad;5,6,7;8,9", "", "0.5,1;2,3.25"):
        assert build_mask.parse_points(s) == jax_bm.parse_points(s)


def test_eval_overlays_equal_jax(synth, tmp_path):
    rng = np.random.default_rng(0)
    pred, gt = rng.random((16, 16)) > 0.5, rng.random((16, 16)) > 0.6
    np.testing.assert_array_equal(eval_overlays.tp_fp_fn_composite(pred, gt),
                                  jax_eo.tp_fp_fn_composite(pred, gt))
    pred_dir = tmp_path / "preds"
    pred_dir.mkdir()
    for case in ("090000", "090001", "10000"):
        heat = (rng.random((32, 32)) * 255).astype(np.uint8)
        Image.fromarray(heat, "L").save(pred_dir / f"{case}_grey_heats.png")
    dices = {}
    for name, mod in (("port", eval_overlays), ("jax", jax_eo)):
        dices[name] = mod.overlay_predictions_with_masks(str(pred_dir), synth,
                                                         str(tmp_path / name))
    assert dices["port"] == dices["jax"] and set(dices["port"]) == {"090000", "090001"}
    for case in dices["port"]:
        np.testing.assert_array_equal(_png(tmp_path / "port" / f"{case}_tp_fp_fn.png"),
                                      _png(tmp_path / "jax" / f"{case}_tp_fp_fn.png"))


def test_artifact_distribution_and_contours_equal_jax(synth, tmp_path):
    masks = os.path.join(synth, "fake_labels")
    for norm in (False, True):
        np.testing.assert_array_equal(
            artifact_distribution.average_mask_heatmap(masks, normalize_per_mask=norm),
            jax_ad.average_mask_heatmap(masks, normalize_per_mask=norm))
    ground = os.path.join(synth, "fake_images", "090000.png")
    a = artifact_distribution.create_heatmap(masks, str(tmp_path / "p.png"), ground)
    b = jax_ad.create_heatmap(masks, str(tmp_path / "j.png"), ground)
    np.testing.assert_array_equal(_png(a), _png(b))

    img = (np.random.default_rng(1).random((32, 32, 3)) * 255).astype(np.uint8)
    heat = np.zeros((32, 32), np.float32)
    heat[8:20, 6:24] = 0.95
    heat[12:16, 10:14] = 0.5
    maps.save_contour_heatmap(img, heat, str(tmp_path / "pc.png"))
    jax_maps.save_contour_heatmap(img, heat, str(tmp_path / "jc.png"))
    np.testing.assert_array_equal(_png(tmp_path / "pc.png"), _png(tmp_path / "jc.png"))
