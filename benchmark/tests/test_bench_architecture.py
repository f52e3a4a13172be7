"""The lookup from a configuration to its architecture (``architecture.py``):
the MS-UNet's numbers as the harness had them before the lookup existed
(goldens), a configuration that names ``msunet`` against one that names
nothing, an architecture that lives with the tests (``arch_fixture.py``) run
through every consumer at 64^2, and a reference that names no module."""

import copy
import hashlib
import json

import pytest
import torch

from benchmark import architecture, counts, drive, metrics, spec, trace
from benchmark.reference import msunet
from benchmark.reference import train as ref_train
from conftest import ROOT, TINY_TRAFFIC, tiny_cell
from test_bench_arith import _events

# Taken from the harness before the lookup: sha256 of the float32 bytes of
# weights.make(param_shapes(tiny train cell), seed 3, "cpu"), leaf by leaf in
# param_shapes' order; of json.dumps([[name, list(shape)], ...]) of Swin-B's
# shapes at 1024^2; the counts that mfu.* and the rooflines read.
TINY_WEIGHTS_SHA256 = "999e02bcb25c5d0dd899c8a422229ec440d54c469910aa6f0a03f92a8da6c78c"
SWIN_B_SHAPES_SHA256 = "6140b6eb15f6364a70b5647c4defef22fae23f1bccdbb0413d99a9c6fff5b4f1"
SWIN_B_PARAMS, SWIN_B_LEAVES = 152_681_680, 725
COUNTS = {
    "train.swinb_w7.1024b2": {"flops": 12551471587360.0, "attn_ms": 2.9118563231708787,
                              "head_ms": 3.9605765156238624},
    "predict.swinb_w7.1024b4": {"flops": 8366629847040.0, "attn_ms": 1.9412375487805853,
                                "head_ms": 2.6403843437492416},
}
WORKLOADS = sorted(COUNTS)
FIXTURE = "benchmark.tests.arch_fixture"


def _sha(weights_, shapes) -> str:
    h = hashlib.sha256()
    for name, _ in shapes:
        h.update(weights_[name].contiguous().numpy().tobytes())
    return h.hexdigest()


def test_seeded_weights_are_the_parents():
    cell = tiny_cell("train")
    ref = cell.architecture
    arch = ref.arch(cell.config)
    assert ref.name == architecture.DEFAULT
    assert _sha(ref.draw(arch, 3, "cpu"), ref.param_shapes(arch)) == TINY_WEIGHTS_SHA256


@pytest.mark.parametrize("workload", WORKLOADS)
def test_param_shapes_are_the_parents(workload):
    cell = spec.load(workload)
    shapes = cell.architecture.param_shapes(cell.architecture.arch(cell.config))
    blob = json.dumps([[n, list(s)] for n, s in shapes]).encode()
    assert hashlib.sha256(blob).hexdigest() == SWIN_B_SHAPES_SHA256
    assert len(shapes) == SWIN_B_LEAVES
    assert sum(torch.Size(s).numel() for _, s in shapes) == SWIN_B_PARAMS


@pytest.mark.parametrize("workload", WORKLOADS)
def test_counts_are_the_parents(workload):
    """What the count readers read, through the lookup, to the float."""
    cell = spec.load(workload)
    tr = trace.from_events(_events(), steps=2)
    ctx = metrics.Context(cell=cell, trace=tr, device_trace=tr, params=SWIN_B_PARAMS)
    fwd = ctx.forward_flops()
    flops = counts.step_flops(fwd, SWIN_B_PARAMS) if ctx.train else fwd
    assert (flops, ctx.attention_ms(), ctx.head_ms()) == \
        tuple(COUNTS[workload][k] for k in ("flops", "attn_ms", "head_ms"))


def _tree(tmp_path, configs: dict):
    """A checkout's root with one train workload a configuration: name ->
    the file's ``"reference"`` (None: no key), over the tiny cell's config."""
    conf = tiny_cell("train").config
    bench = {"workloads": [], "end_to_end": [], "per_layer": []}
    for d in ("configs", "traffic"):
        (tmp_path / "benchmark" / d).mkdir(parents=True)
    (tmp_path / "benchmark/traffic/tiny.json").write_text(json.dumps(TINY_TRAFFIC["train"]))
    for name, ref in configs.items():
        body = {"name": name, "source": "test", "config": copy.deepcopy(conf)}
        if ref is not None:
            body["reference"] = ref
        (tmp_path / "benchmark/configs" / f"{name}.json").write_text(json.dumps(body))
        bench["workloads"].append({"name": f"train.{name}", "config": name, "traffic": "tiny",
                                   "chips": 1})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_the_real_configurations_name_no_reference():
    for path in (ROOT / "benchmark" / "configs").glob("*.json"):
        assert "reference" not in json.loads(path.read_text()), path


def test_naming_msunet_is_the_default(tmp_path):
    root = _tree(tmp_path, {"plain": None, "named": "msunet"})
    plain, named = spec.load("train.plain", root), spec.load("train.named", root)
    assert plain.architecture.module is named.architecture.module is msunet
    arch = plain.architecture.arch(plain.config)
    assert arch == named.architecture.arch(named.config)
    wp, wn = plain.architecture.draw(arch, 3, "cpu"), named.architecture.draw(arch, 3, "cpu")
    assert wp.keys() == wn.keys() and all(torch.equal(wp[k], wn[k]) for k in wp)
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=torch.Generator().manual_seed(0),
                           dtype=torch.uint8)
    maps = [ref_train.predict_maps(c.architecture, arch, w, images)
            for c, w in ((plain, wp), (named, wn))]
    assert torch.equal(*maps)


@pytest.fixture
def fixture_cell(tmp_path):
    cell = spec.load("train.fixture", _tree(tmp_path, {"fixture": FIXTURE}))
    assert cell.architecture.module.__name__ == FIXTURE
    return cell


def test_a_fixture_architecture_draws_trains_and_predicts(fixture_cell):
    ref, base = fixture_cell.architecture, architecture.default()
    gain = ref.module.GAIN
    arch = ref.arch(fixture_cell.config)
    w = ref.draw(arch, 3, "cpu")
    w_base = base.draw(arch, 3, "cpu")
    # the extra leaf is drawn last, by its own rule; every other leaf as before
    assert set(w) == set(w_base) | {gain}
    assert all(torch.equal(w[k], w_base[k]) for k in w_base)
    assert 1.0 <= float(w[gain]) < 3.0
    # one step, with and without decay: only the gain (the fixture's rule) decays
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=g, dtype=torch.uint8)
    masks = (torch.rand(2, 64, 64, generator=g) > 0.7).to(torch.uint8) * 255
    kw = dict(lr=1e-2, seed=5, ranks=1, loss_abc=(0.2, 0.8, 0.45), betas=(0.9, 0.999),
              eps=1e-8)
    runs = [ref_train.train_readings(ref, arch, {k: v.clone() for k, v in w.items()},
                                     [(images, masks)], weight_decay=wd, **kw)
            for wd in (0.0, 0.5)]
    assert runs[0]["grad_norm"][gain] > 0
    assert runs[0]["change_norm"][gain] != runs[1]["change_norm"][gain]
    qkv = "ms_unet.layers.0.blocks.0.attn.qkv.weight"  # decayed by the MS-UNet's rule
    assert runs[0]["change_norm"][qkv] == runs[1]["change_norm"][qkv]
    # the maps are the MS-UNet's logits times the gain
    with torch.no_grad():
        logits = msunet.Net(arch, w_base).forward(images.float() / 255, msunet.Noise(None, 2))
    want = torch.sigmoid(logits[..., 0] * w[gain])
    assert torch.equal(ref_train.predict_maps(ref, arch, w, images, rows_per_pass=2), want)


def test_a_fixture_architecture_feeds_the_count_readers(fixture_cell):
    tr = trace.from_events(_events(), steps=2)
    ctx = metrics.Context(cell=fixture_cell, trace=tr, device_trace=tr, params=1000,
                          steps_per_s=2.0)
    fwd = 1.0e9 * fixture_cell.batch
    assert metrics.reader("mfu.train").read(ctx) == \
        100.0 * (3.0 * fwd + 10.0 * 1000) * 2.0 / counts.PEAK_BF16_FLOP_S
    least = 3.0 * 1e-3 * fixture_cell.batch
    assert metrics.reader("attn_roofline.train").read(ctx) == \
        pytest.approx(100.0 * least * 2 / 14e-3)  # spans hold 14 us of device time


def test_a_fixture_architecture_names_its_spans(fixture_cell):
    from torch.profiler import ProfilerActivity, profile

    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), torch.nn.Flatten(),
                                torch.nn.Linear(64, 2), torch.nn.Linear(2, 2))
    with drive.layer_spans(model, fixture_cell.architecture.spans), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        model(torch.zeros(1, 3, 4, 4))
    names = [e.name for e in prof.events()]
    assert names.count("bench.attn") == 2 and names.count("bench.head") == 1
    assert not any(hasattr(m, "_bench_spans") and m._bench_spans for m in model.modules())


@pytest.mark.parametrize("reference", ["no_such_reference", "benchmark.no_such_module",
                                       "no_such_package.module"])
def test_a_reference_that_names_no_module_fails_in_load(tmp_path, reference):
    root = _tree(tmp_path, {"broken": reference})
    with pytest.raises(ValueError, match="broken.json") as e:
        spec.load("train.broken", root)
    assert reference in str(e.value)


def test_a_module_without_the_required_parts_fails_in_load(tmp_path):
    root = _tree(tmp_path, {"partial": "benchmark.weights"})
    with pytest.raises(ValueError, match="lacks"):
        spec.load("train.partial", root)


@pytest.mark.parametrize("part", architecture.REQUIRED)
def test_a_module_that_lacks_one_part_fails_in_load(tmp_path, monkeypatch, part):
    """No part falls back on the MS-UNet's: the fixture less ``part`` fails."""
    package = tmp_path / f"without_{part}"
    package.mkdir()
    (package / "__init__.py").write_text("")
    given = [k for k in architecture.REQUIRED if k != part]
    (package / "fixture.py").write_text(
        f"from {FIXTURE} import {', '.join(given)}  # noqa: F401\n")
    module = f"{package.name}.fixture"
    monkeypatch.syspath_prepend(str(tmp_path))
    root = _tree(tmp_path / "tree", {"partial": module})
    with pytest.raises(ValueError, match=rf"lacks \['{part}'\]"):
        spec.load("train.partial", root)


def test_msunet_provides_every_part():
    ref = architecture.load(architecture.DEFAULT)
    assert all(hasattr(ref.module, k) for k in architecture.REQUIRED)
    assert ref.spans == {"WindowAttention": "bench.attn", "FinalPatchExpandX4V2": "bench.head"}


@pytest.mark.parametrize("n_gpu", [1, 4])
def test_a_cell_runs_on_the_cards_its_configuration_states(tmp_path, n_gpu):
    root = _tree(tmp_path, {"ranks": None})
    conf_path = root / "benchmark/configs/ranks.json"
    conf = json.loads(conf_path.read_text())
    conf["config"].setdefault("HARDWARE", {})["N_GPU"] = n_gpu
    conf_path.write_text(json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][0]["chips"] = 4
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    if n_gpu == 4:
        assert spec.load("train.ranks", root).chips == 4
    else:
        with pytest.raises(ValueError, match="HARDWARE.N_GPU 1"):
            spec.load("train.ranks", root)


def test_the_four_card_cell_has_a_configuration_of_four_cards():
    # the four-card configuration waits on disk for its cell
    configs = ROOT / "benchmark" / "configs"
    four = json.loads((configs / "swinb_w7_n4.json").read_text())["config"]
    one = spec.load("train.swinb_w7.1024b2")
    assert four["HARDWARE"]["N_GPU"] == 4
    # config.yaml's numbers but for the card count
    assert {k: v for k, v in four.items() if k != "HARDWARE"} == \
        {k: v for k, v in one.config.items() if k != "HARDWARE"}
