"""The port's own spans (``utils/profiling.py::span``) and the benchmark's
readers of them, on the CPU.

* One train step and one predict batch of a small ``MSUNet`` under
  ``torch.profiler`` open the step's phases, the model's sections, a
  ``ssa.norm`` for every LayerNorm, two ``ssa.roll`` for every attention
  call that pads or shifts, and a ``ssa.upload`` for every copy from host
  memory, nested as the step runs them; the names are those
  ``benchmark/program.py`` reads.
* No range opens without a profiler that records the host.
* Each of the eight readers gives the hand-computed value on a hand-made
  Chrome trace, 0 for a step with no span of its kind, and ``None`` for a
  trace with no program spans.
"""

import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import metrics, program, spec, trace
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import default_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models import layers
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops.window_attention import (
    effective_shift,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import state
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils import profiling

SECTIONS = {"embed", "head"} | {f"encoder.{i}" for i in range(4)} | \
    {f"decoder.{i}" for i in range(4)} | {f"cent1.{i}" for i in range(3)} | \
    {f"cent2.{i}" for i in range(2)}
PHASES = {"train": ["feed", "forward", "loss", "backward", "grad_fill"],
          "predict": ["feed", "forward"]}


def _ancestors(ev):
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        yield ev.name


def _count_calls(model):
    """LayerNorm calls, and attention calls that pad or shift (each opens
    two ``ssa.roll``: the roll and the unroll) or shift (each uploads a
    mask), counted by hooks apart from the spans."""
    seen = Counter()

    def on_norm(mod, args):
        seen["norm"] += 1

    def on_attn(mod, args):
        h, w = args[0].shape[1:3]
        hp, wp, sh, sw = effective_shift(h, w, mod.window_size, mod.shift_size)
        seen["attn"] += 1
        seen["rolled"] += bool((hp, wp) != (h, w) or sh or sw)
        seen["shifted"] += bool(sh or sw)

    for m in model.modules():
        if isinstance(m, layers.LayerNorm):
            m.register_forward_pre_hook(on_norm)
        elif isinstance(m, layers.WindowAttention):
            m.register_forward_pre_hook(on_attn)
    return seen


@pytest.mark.parametrize("entry", ["train", "predict"])
def test_a_step_opens_its_spans_nested(entry):
    torch.manual_seed(0)
    # window 3 on an 8-token grid: every stage pads, the first two shift
    model = MSUNet(img_size=32, embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                   window_size=3)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    lbl = (rng.random((2, 32, 32)) > 0.7).astype(np.uint8)
    if entry == "train":
        st = state.create_train_state(model, default_config(), device="cpu")
        step = state.make_train_step(model, 0.2, 0.8, 0.45)
        run = lambda: step(st, img, lbl, 1e-4)  # noqa: E731
    else:
        predict = state.make_predict_step(model, device="cpu")
        run = lambda: predict(img)  # noqa: E731
    seen = _count_calls(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = [e for e in prof.events() if e.name.startswith("ssa.")]
    names = Counter(e.name for e in events)
    top = program.STEP[entry]
    assert names[top] == 1
    for phase in PHASES[entry]:
        assert names[f"{top}.{phase}"] == 1
    forward = f"{top}.forward"
    assert {n[len("ssa.model."):] for n in names if n.startswith("ssa.model.")} == SECTIONS
    assert names[program.NORM] == seen["norm"] > 0
    assert names[program.ROLL] == 2 * seen["rolled"] > 0
    # the feed's images (and labels), a bias index a call, a mask a shifted call
    feeds = 2 if entry == "train" else 1
    assert names[program.UPLOAD] == feeds + seen["attn"] + seen["shifted"]
    assert seen["shifted"] > 0
    for ev in events:
        up = list(_ancestors(ev))
        if ev.name.startswith(f"{top}."):
            assert up[-1] == top, ev.name
        if ev.name.startswith("ssa.model."):
            assert forward in up and not any(u.startswith("ssa.model.") for u in up)
        if ev.name in (program.NORM, program.ROLL):
            assert any(u.startswith("ssa.model.") for u in up), ev.name
        if ev.name == program.UPLOAD:
            assert top in up
            assert forward in up or f"{top}.feed" in up


def test_no_range_opens_without_a_host_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name) or profiling._OFF)
    model = MSUNet(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4)
    predict = state.make_predict_step(model, device="cpu")
    img = np.zeros((1, 32, 32, 3), np.uint8)
    predict(img)
    assert profiling.span("ssa.x") is profiling._OFF and opened == []
    # a profiler of the device alone (the benchmark's device-only stretch)
    # opens none either; one that records the host opens them all
    start = profiling._noting_activities(lambda self: None)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    keep = profiling._HOST[0]
    try:
        for acts, on in (({ProfilerActivity.CUDA}, False),
                         ({ProfilerActivity.CPU, ProfilerActivity.CUDA}, True)):
            start(types.SimpleNamespace(kineto_activities=acts))
            assert profiling.host_traced() is on
            predict(img)
            assert bool(opened) is on
    finally:
        profiling._HOST[0] = keep
    assert program.STEP["predict"] in opened and program.NORM in opened


# -- the readers ------------------------------------------------------------

CELLS = {"train": "train.swinb_w7.1024b2", "predict": "predict.swinb_w7.1024b4"}


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _span(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


def _events(top):
    """Window 0-100, two steps (0-40, 50-90) on thread 1.  Uploads 5-8 and
    60-61 on thread 1, 20-24 on autograd's thread 2.  A LayerNorm 10-15
    launches kernel A (4 us; forward op seq 7), whose backward on thread 2
    launches B (3 us); a roll 62-66 launches C (2 us); D (5 us) is outside
    every span."""
    return [
        _span(trace.WINDOW_SPAN, 0, 100),
        _span(top, 0, 40), _span(top, 50, 40),
        _span(program.UPLOAD, 5, 3), _span(program.UPLOAD, 20, 4, tid=2),
        _span(program.UPLOAD, 60, 1),
        _span(program.NORM, 10, 5),
        _x("aten::mul", "cpu_op", 11, 3, **{"Sequence number": 7}),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        _x("kA", "kernel", 13, 4, tid=7, correlation=1),
        _x(trace.BACKWARD_PREFIX + "MulBackward0", "cpu_op", 25, 5, tid=2,
           **{"Sequence number": 7}),
        _x("cudaLaunchKernel", "cuda_runtime", 26, 1, tid=2, correlation=2),
        _x("kB", "kernel", 31, 3, tid=7, correlation=2),
        _span(program.ROLL, 62, 4),
        _x("cudaLaunchKernel", "cuda_runtime", 63, 1, correlation=3),
        _x("kC", "kernel", 67, 2, tid=7, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 70, 1, correlation=4),
        _x("kD", "kernel", 72, 5, tid=7, correlation=4),
    ]


def _read(name, entry, events):
    tr = trace.from_events(events, steps=2)
    ctx = metrics.Context(cell=spec.load(CELLS[entry]), trace=tr, device_trace=tr, params=1)
    return metrics.reader(name).read(ctx)


@pytest.mark.parametrize("base,want", [
    ("upload_ms", (3 + 4 + 1) / 2e3),
    ("host_ms", (80 - 8) / 2e3),  # the step's 80 us on thread 1, less the uploads
    ("norm_ms", (4 + 3) / 2e3),  # A and the backward's B
    ("roll_ms", 2 / 2e3),
])
@pytest.mark.parametrize("entry", ["train", "predict"])
def test_reader_on_a_hand_made_trace(base, want, entry):
    other = "predict" if entry == "train" else "train"
    events = _events(program.STEP[entry])
    assert _read(f"{base}.{entry}", entry, events) == pytest.approx(want)
    assert _read(f"{base}.{other}", entry, events) is None
    # a step with no span of the reader's kind reads 0 (the host: the whole step)
    bare = [e for e in events if e["name"] not in (program.UPLOAD, program.NORM,
                                                   program.ROLL)]
    assert _read(f"{base}.{entry}", entry, bare) == pytest.approx(
        80 / 2e3 if base == "host_ms" else 0.0)
    # a port that opens no span of its own: nothing to read
    assert _read(f"{base}.{entry}", entry,
                 [e for e in events if not e["name"].startswith("ssa.")]) is None
    assert metrics.reader(f"{base}.{entry}").combine([1.0, 3.0]) == 2.0
