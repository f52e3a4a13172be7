"""The port's trainer features, on the CPU, port only (32^2, embed 16,
depths 1/1/1/1, window 4, float32, the kernel knobs off).

* Encoder freezing (fault 8): a frozen stage and the patch embedding get no
  gradient, no update and no decay through ``make_train_step``; on
  unfreeze the parameters already trained keep their AdamW moments and
  per-parameter step, the new stage starts fresh; the trainer unfreezes
  the deepest stage first, one a scheduled epoch, and an early stop brings
  the next one forward.
* Resume from ``epoch_N.pth`` continues the epoch, ``iter_num`` and the
  step count (with and without a frozen encoder, whose unfreezes replay).
* A non-finite loss raises ``FloatingPointError``; early stopping ends the
  run; ``TPU.CKPT_BACKEND: orbax`` raises.
* The train and test CLIs on ``--device cpu`` write ``config_used.yaml`` (a
  byte copy of ``--cfg``),
  ``log.txt`` (each ``epoch_timing`` line counting native decodes and none
  by PIL), the 7 CSVs and the checkpoint under the JAX CLIs' file names
  (``.pth`` for ``.msgpack``); without CUDA and without ``--device`` they
  raise; the test CLI's ``--tile`` evaluates 48^2 images through a 32^2
  model.
* ``validate`` over a batch-2 loader with a padded tail gives the batch-1
  summary (1e-6 absolute and relative: float32 sums in another order).
"""

import csv
import itertools
import json
import logging
import os

import numpy as np
import pytest
import torch
import yaml

from semantic_segmentation_of_stylegan2_artifacts_tpu.cli import test_cli as jax_test_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu.cli import train_cli as jax_train_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import test_cli, train_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
    default_config,
    load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.dataset import (
    SegArtifactDataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.pipeline import EvalLoader
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import optim, trainer
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.checkpoint import (
    load_checkpoint,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

TINY = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    generate_synthetic_dataset(root, img_size=32, seed=4)
    return root


def _config(tmp_path, data, **changes):
    cfg = {"DATA": {"IMG_SIZE": 32, "DATA_PATH": data, "NUM_WORKERS": 2},
           "MODEL": {"PRETRAIN_WEIGHTS": "none", "FREEZE_ENCODER": False,
                     "DROP_PATH_RATE": 0.0,
                     "SWIN": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                              "NUM_HEADS": [2, 2, 2, 2], "WINDOW_SIZE": 4}},
           "TRAIN": {"MAX_EPOCHS": 2, "WARMUP_EPOCHS": 1},
           "TPU": {"COMPUTE_DTYPE": "float32", "USE_PALLAS_ATTENTION": False,
                   "FUSED_HEAD": False, "FUSED_PATCH": False},
           "LIST_DIR": os.path.join(data, "lists"), "OUTPUT_DIR": str(tmp_path / "out"),
           "SAVE_BEST_RUN": True}
    for key, value in changes.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    os.makedirs(tmp_path, exist_ok=True)
    path = str(tmp_path / "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


_RUNS = itertools.count()


class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _train(tmp_path, data, resume=None, **changes):
    cfg = load_config(_config(tmp_path, data, **changes))
    model = MSUNet.from_config(cfg, device="cpu")
    log = logging.getLogger(f"features.{next(_RUNS)}")
    log.setLevel(logging.INFO)
    handler = _Log()
    log.addHandler(handler)
    out = str(tmp_path / "out")
    assert trainer.trainer(model, log, None, out, cfg, resume_from=resume,
                           device="cpu") == "Training Finished!"
    return model, handler.lines, out


def _frozen_names(model, stages, patch_embed=True):
    return {n for n, f in optim.frozen_mask(model, stages, patch_embed).items() if f}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
            (rng.random((2, 32, 32)) > 0.7).astype(np.uint8))


def test_frozen_stages_get_no_update_and_no_decay():
    model = MSUNet(**TINY)
    state = create_train_state(model, default_config(), device="cpu")
    state.optimizer = optim.build_optimizer(default_config(), model, {0, 1, 2, 3})
    frozen = _frozen_names(model, {0, 1, 2, 3})
    assert any(".patch_embed." in n for n in frozen)
    assert {n.split(".")[1] for n in frozen} == {"patch_embed", "layers"}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, 0.2, 0.8, 0.45)
    for i in range(2):
        step(state, *_batch(i), 1e-2)
    for n, p in model.named_parameters():
        if n in frozen:
            assert not p.requires_grad and p.grad is None, n
            assert torch.equal(p, before[n]), n  # WEIGHT_DECAY 0.1 would move it
        elif n.endswith("concat_back_dim.1.weight"):
            assert not torch.equal(p, before[n]), n


def test_unfreeze_keeps_moments_and_starts_the_new_stage_fresh():
    model = MSUNet(**TINY)
    cfg = default_config()
    state = create_train_state(model, cfg, device="cpu")
    state.optimizer = optim.build_optimizer(cfg, model, {0, 1, 2, 3})
    step = make_train_step(model, 0.2, 0.8, 0.45)
    step(state, *_batch(0), 1e-3)
    step(state, *_batch(1), 1e-3)
    opt = state.optimizer
    kept = {id(p): {k: v.clone() for k, v in opt.state[p].items()}
            for g in opt.param_groups for p in g["params"]}
    optim.unfreeze(opt, cfg, model, {0, 1, 2})
    assert len(opt.param_groups) == 4
    assert [g["weight_decay"] for g in opt.param_groups] == [0.1, 0.0, 0.1, 0.0]
    assert all(g["lr"] == 1e-3 for g in opt.param_groups)
    stage3 = {n for n, p in model.named_parameters()
              if n.startswith("ms_unet.layers.3.")}
    named = dict(model.named_parameters())
    assert stage3 and all(named[n].requires_grad for n in stage3)
    new_ids = {id(p) for g in opt.param_groups[2:] for p in g["params"]}
    assert new_ids == {id(named[n]) for n in stage3}
    for p_id, saved in kept.items():
        p = next(q for g in opt.param_groups for q in g["params"] if id(q) == p_id)
        for k, v in saved.items():
            assert torch.equal(opt.state[p][k], v)
    step(state, *_batch(2), 1e-3)
    for g_i, g in enumerate(opt.param_groups):
        for p in g["params"]:
            if opt.state[p]:
                assert int(opt.state[p]["step"]) == (1 if g_i >= 2 else 3)
    assert not named["ms_unet.layers.2.blocks.0.attn.qkv.weight"].requires_grad


def test_trainer_unfreezes_deepest_first_and_early_stop_brings_it_forward(tmp_path, data):
    # stage 3 at epoch int(3 * 0.4) = 1, stages 2, 1, 0 at epoch 2, one an epoch
    _, lines, _ = _train(tmp_path, data, **{"MODEL.FREEZE_ENCODER": True,
                                            "TRAIN.MAX_EPOCHS": 3})
    assert [ln for ln in lines if ln.startswith("Unfroze")] == [
        "Unfroze encoder stage 3 at epoch 1", "Unfroze encoder stage 2 at epoch 2"]
    # with lr 0 the Score never improves: patience 1 forces an unfreeze at
    # epoch 2, where none is scheduled before epoch int(4 * 0.99) = 3
    zero = {"TRAIN.BASE_LR": 0.0, "TRAIN.WARMUP_LR": 0.0, "TRAIN.MIN_LR": 0.0}
    periods = {f"MODEL.STAGE{i}_UNFREEZE_PERIODE": 0.99 for i in range(4)}
    _, lines, _ = _train(tmp_path / "x", data, **zero, **periods,
                         **{"MODEL.FREEZE_ENCODER": True, "TRAIN.MAX_EPOCHS": 4,
                            "TRAIN.EARLY_STOPPING_FLAG": True,
                            "TRAIN.EARLY_STOPPING_PATIENCE": 1})
    assert [ln for ln in lines if ln.startswith("Unfroze")] == [
        "Unfroze encoder stage 3 at epoch 2", "Unfroze encoder stage 2 at epoch 3"]


def test_early_stopping_ends_the_run(tmp_path, data):
    zero = {"TRAIN.BASE_LR": 0.0, "TRAIN.WARMUP_LR": 0.0, "TRAIN.MIN_LR": 0.0}
    _, lines, out = _train(tmp_path, data, **zero, **{
        "TRAIN.MAX_EPOCHS": 5, "TRAIN.EARLY_STOPPING_FLAG": True,
        "TRAIN.EARLY_STOPPING_PATIENCE": 2})
    assert any(ln.startswith("Early stopping at epoch 2") for ln in lines)
    with open(os.path.join(out, "val_metric_all_epoch.csv"), newline="") as f:
        assert [r[0] for r in csv.reader(f)][1:] == ["1", "2", "3"]


@pytest.mark.parametrize("freeze", [False, True])
def test_resume_continues_epoch_iter_num_and_step(tmp_path, data, freeze):
    # unfreeze epochs equal at 2 and 3 epochs: stage 3 at 0, stage 2 at 1,
    # stage 1 at int(2 * 0.9) = 1 / int(3 * 0.9) = 2 (one stage an epoch)
    common = {"MODEL.FREEZE_ENCODER": freeze, "SAVE_LAST_RUN": True,
              "MODEL.STAGE3_UNFREEZE_PERIODE": 0.0, "MODEL.STAGE2_UNFREEZE_PERIODE": 0.5}
    model, _, out = _train(tmp_path, data, **common)
    ckpt = os.path.join(out, "epoch_1.pth")
    first = load_checkpoint(ckpt)
    assert first["epoch"] == 1 and first["iter_num"] == 10  # 2 epochs x 5 steps
    _, lines, out2 = _train(tmp_path, data, resume=ckpt,
                            **common, **{"TRAIN.MAX_EPOCHS": 3})
    assert f"Resumed from {ckpt} at epoch 2" in lines
    assert not any("does not match" in ln for ln in lines)
    last = load_checkpoint(os.path.join(out2, "epoch_2.pth"))
    assert last["iter_num"] == 15
    steps = {int(s["step"]) for s in last["optimizer"]["state"].values()}
    # stages 3, 2 and 1 joined at epochs 0, 1 and 2: 15, 10 and 5 steps, as
    # the decoders' 15; without freezing every parameter took 15 steps
    assert steps == ({15, 10, 5} if freeze else {15})
    with open(os.path.join(out2, "val_metric_all_epoch.csv"), newline="") as f:
        assert [r[0] for r in csv.reader(f)][1:] == ["3"]


def test_non_finite_loss_raises(tmp_path, data):
    cfg = load_config(_config(tmp_path, data))
    model = MSUNet.from_config(cfg, device="cpu")
    with torch.no_grad():
        model.ms_unet.output.weight.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        trainer.trainer(model, logging.getLogger("nan"), None, str(tmp_path / "out"), cfg,
                        device="cpu")


def test_orbax_backend_raises(tmp_path, data):
    cfg = load_config(_config(tmp_path, data, **{"TPU.CKPT_BACKEND": "orbax"}))
    with pytest.raises(NotImplementedError, match="orbax"):
        trainer.trainer(MSUNet.from_config(cfg, device="cpu"), None, None,
                        str(tmp_path / "out"), cfg, device="cpu")


def _files(root):
    return sorted(os.path.relpath(os.path.join(b, n), root).replace(".msgpack", ".pth")
                  for b, _, names in os.walk(root) for n in names
                  if "log" not in os.path.relpath(b, root).split(os.sep))


def test_train_and_test_clis_write_the_jax_file_names(tmp_path, data, monkeypatch):
    monkeypatch.setenv("SSA_TPU_COMP_CACHE", "0")  # the JAX CLIs' cache stays off
    out = {}
    for name, train, test in (("jax", jax_train_cli, jax_test_cli),
                              ("port", train_cli, test_cli)):
        cfg = _config(tmp_path / name if name == "port" else tmp_path / "y", data)
        args = ["--device", "cpu"] if name == "port" else []
        handlers = logging.root.handlers[:]
        try:
            train.main(["--cfg", cfg] + args)
            run_dir = load_config(cfg).OUTPUT_DIR
            test.main(["--cfg", cfg, "--check_point_dir", run_dir, "--out_dir",
                       os.path.join(run_dir, "test"), "--split", "val"] + args)
        finally:
            for h in logging.root.handlers[:]:
                logging.root.removeHandler(h)
                h.close()
            logging.root.handlers[:] = handlers
        out[name] = run_dir
    got, want = _files(out["port"]), _files(out["jax"])
    assert got == want
    for name in ("config_used.yaml", "log.txt", "best_model.pth",
                 "val_metric_all_epoch.csv", "test/val_metric_all_epoch.csv",
                 "test/log.txt", "test/config_used.yaml"):
        assert name in got, name
    assert sum(n.startswith("test/predictions/") for n in got) == 3 * 5
    # each epoch_timing line counts the epoch's decodes: all native
    with open(os.path.join(out["port"], "log.txt")) as f:
        timing = [json.loads(ln.split("epoch_timing ", 1)[1]) for ln in f
                  if "epoch_timing " in ln]
    assert timing and all(t["decodes"]["native"] > 0 and t["decodes"]["pil"] == 0
                          for t in timing), timing
    assert load_config(os.path.join(out["port"], "config_used.yaml")) == \
        load_config(_config(tmp_path / "port", data))
    # both CLIs copy --cfg byte for byte, as JAX cli/train_cli.py and
    # cli/test_cli.py do (shutil.copy)
    with open(_config(tmp_path / "port", data), "rb") as f:
        passed = f.read()
    for name in ("config_used.yaml", "test/config_used.yaml"):
        with open(os.path.join(out["port"], name), "rb") as f:
            assert f.read() == passed, name


def test_clis_raise_without_cuda(tmp_path, data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--cfg", cfg])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main(["--cfg", cfg, "--check_point_dir", str(tmp_path), "--out_dir",
                       str(tmp_path / "t")])


def test_validate_drops_the_padded_tail(data):
    lists = os.path.join(data, "lists")
    model = MSUNet(**TINY)
    step = make_eval_step(model, 0.2, 0.8, 0.45, per_sample=True, device="cpu")
    out = []
    for bs in (1, 2):
        loader = EvalLoader(SegArtifactDataset(data, lists, "val"), 32, batch_size=bs,
                            pad_to_batch=bs > 1)
        out.append(trainer.validate(step, loader, 1, 0.5, output_num=2)[4])
    one, padded = out
    assert padded.n_real + padded.n_fake == 3
    # a batch of 2 and a batch of 1 go through the CPU convs in another
    # float32 order: the soft confusion sums (~400) then differ in their
    # last bits, hence 1e-6 relative as well as absolute
    for field in ("score", "mean_soft_dice", "mean_fpr", "mean_val_loss", "mean_conf_soft"):
        np.testing.assert_allclose(getattr(padded, field), getattr(one, field), atol=1e-6,
                                   rtol=1e-6, err_msg=field)


def test_test_cli_tiles_full_size_images(tmp_path):
    data = str(tmp_path / "data")
    generate_synthetic_dataset(data, img_size=48, seed=1)
    cfg = _config(tmp_path, data, **{"DATA.IMG_SIZE": 48})
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"model": MSUNet(**TINY).state_dict()}, ckpt / "best_model.pth")
    dice, score, fpr = test_cli.main(["--cfg", cfg, "--check_point_dir", str(ckpt),
                                      "--out_dir", str(tmp_path / "t"), "--tile", "32",
                                      "--device", "cpu"])
    assert np.isfinite([dice, score, fpr]).all() and score == pytest.approx(dice - 10 * fpr)
    with open(tmp_path / "t" / "val_metric_all_epoch.csv", newline="") as f:
        assert [r[0] for r in csv.reader(f)] == ["epoch", "0"]
    assert len(os.listdir(tmp_path / "t" / "predictions")) == 3 * 5
