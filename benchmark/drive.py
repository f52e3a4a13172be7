"""One run of one cell on one rank: set-up, the measured (or traced) window
through the port's own entries, and the comparison with the reference.

Train cells build one train state (``train/state.py::create_train_state``
over ``models/msunet.py::MSUNet.from_config``, the weights then loaded from
the benchmark's seeded draw), drive it through its first ``check_steps``
steps on rows that all differ (the readings the reference follows, and the
warm-up), and hand that same state to the window: a closed loop of steps,
each on the next rows of the pool, the loss read back one step behind as
``train/trainer.py`` does.  Predict cells run ``make_predict_step`` in a
closed loop of one client, each batch's maps copied to the host.  Inputs
come from pinned host memory, so the uint8 copy to the card is part of each
step.

The window is ``seconds`` long on the host's clock; a traced run runs the
same window and then profiles ``trace_steps`` steps more, with the
benchmark's spans around the calls into the modules that the cell's
architecture names (its ``SPANS``: window attention and the head for the
MS-UNet).  After the window, the program's state is freed and the
reference runs on the same rows, weights and noise seeds.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import statistics
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import compare, traffic, weights
from .reference import train as ref_train
from .spec import Cell, port_config

PROFILE_PAD_S = 0.05  # host seconds before and after the traced work
GIB = 2.0 ** 30

FAULTS = ("frozen_state", "half_batch", "no_exchange", "altered_answer")


@dataclass
class Seeds:
    weights: int
    data: int
    noise: int
    sample: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        w, d, n, s = (int(x) for x in np.random.SeedSequence(int(seed)).generate_state(4))
        return cls(w, d, n, s)


@dataclass
class RankResult:
    """What one rank measured; rank 0 combines them."""

    rank: int
    steps: int = 0
    images: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    failed: int = 0
    latencies: List[float] = field(default_factory=list)
    peak_window: int = 0
    peak_process: int = 0
    layer: Dict[str, Optional[float]] = field(default_factory=dict)
    busy_s: float = 0.0
    done: List[float] = field(default_factory=list)  # when each step or batch ended
    reference_s: float = 0.0
    traced_step_s: float = 0.0  # a traced run's device-only stretch, a step
    breakdown: Optional[dict] = None
    stages: Dict[str, float] = field(default_factory=dict)  # set-up: seconds from the start
    checks: Optional[Dict[str, dict]] = None
    program: Optional[dict] = None  # the program's readings for the comparison
    reference: Optional[dict] = None  # the reference's

    def mark(self, stage: str, t_start: float) -> None:
        """Note when a stage of set-up ended."""
        self.stages[stage] = time.perf_counter() - t_start


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0


def _reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


# -- spans ----------------------------------------------------------------

@contextlib.contextmanager
def layer_spans(model: torch.nn.Module, spans: Dict[str, str]):
    """Open a profiler range around every forward call of the modules
    whose class ``spans`` names (class name -> range name)."""
    from torch.autograd.profiler import record_function

    handles = []

    def pre(mod, args, _name):
        mod._bench_spans = getattr(mod, "_bench_spans", []) + [record_function(_name)]
        mod._bench_spans[-1].__enter__()

    def post(mod, args, out):
        mod._bench_spans.pop().__exit__(None, None, None)

    for mod in model.modules():
        name = spans.get(type(mod).__name__)
        if name is not None:
            handles.append(mod.register_forward_pre_hook(
                lambda m, a, _n=name: pre(m, a, _n)))
            handles.append(mod.register_forward_hook(post))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


# -- the loops ------------------------------------------------------------

class StopVote:
    """Whether the window is over, agreed by every rank one step behind
    (a max all-reduce of each rank's clock), so all ranks run the same
    steps; on one rank the clock decides at once."""

    def __init__(self, world: int, dev):
        self.world, self.dev = world, dev

    def cast(self, over: bool):
        if self.world == 1:
            return over
        import torch.distributed as dist

        flag = torch.full((1,), float(over), device=self.dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return flag

    def read(self, vote) -> bool:
        return bool(vote) if self.world == 1 else bool(vote.item() > 0)


def _train_loop(step_fn: Callable[[int], torch.Tensor], first: int, dev, world: int,
                seconds: Optional[float], steps: Optional[int]) -> tuple:
    """Run steps ``first, first+1, ...`` until the window's ``seconds`` pass
    (or ``steps`` are done); returns ``(steps run, non-finite losses,
    seconds)``.  Each loss is read back after the next step is queued."""
    vote = StopVote(world, dev)
    pending: deque = deque()
    bad, k = 0, first
    done: List[float] = []  # host time at which each step's loss was read
    _sync(dev)
    t0 = time.perf_counter()

    def drain_one():
        nonlocal bad
        loss, v = pending.popleft()
        if not math.isfinite(float(loss)):
            bad += 1
        done.append(time.perf_counter() - t0)
        return vote.read(v)

    while True:
        if steps is not None:
            over = k - first >= steps
            if over:
                break
            v = False if world == 1 else vote.cast(False)
        else:
            over = time.perf_counter() - t0 >= seconds
            if over and world == 1:
                break
            v = vote.cast(over)
        pending.append((step_fn(k), v))
        k += 1
        if len(pending) > 1 and drain_one():
            break
    while pending:
        drain_one()
    _sync(dev)
    return k - first, bad, time.perf_counter() - t0, done


def _predict_loop(predict_fn, batch_of, dev, seconds: Optional[float],
                  batches: Optional[int], keep: Callable[[int], bool]) -> tuple:
    """Closed loop of one client: submit a batch, wait for its maps on the
    host, submit the next.  Returns ``(batches, non-finite batches, seconds,
    latencies, kept maps)``."""
    lat, kept, maps, done = [], {}, None, []
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    k = 0
    _sync(dev)
    t0 = time.perf_counter()
    while (batches is None and time.perf_counter() - t0 < seconds) or \
            (batches is not None and k < batches):
        ts = time.perf_counter()
        probs = predict_fn(batch_of(k))
        bad += (~torch.isfinite(probs)).any()
        maps = probs.cpu()
        lat.append(time.perf_counter() - ts)
        done.append(time.perf_counter() - t0)
        if keep(k):
            kept[k] = maps
        k += 1
    _sync(dev)
    if not kept and maps is not None:  # a short window: the last batch stands in
        kept[k - 1] = maps
    return k, int(bad), time.perf_counter() - t0, lat, kept, done


# -- one run ----------------------------------------------------------------

def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _profile(run_window: Callable[[], tuple], model, spans: Dict[str, str], dev, steps: int,
             host: bool = True):
    """Run the window under the profiler; returns the window's result and
    its :class:`trace.Trace`.  ``host``: record the host's operations and the
    layer spans (``spans``, as :func:`layer_spans` takes them) too (what the
    layers' readings need, at a cost of host time that stretches the window);
    else the device's operations alone."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from . import trace

    on_card = torch.device(dev).type == "cuda"
    host = host or not on_card
    acts = ([ProfilerActivity.CPU] if host else []) + \
        ([ProfilerActivity.CUDA] if on_card else [])
    ranges = layer_spans(model, spans) if host else contextlib.nullcontext()
    with ranges, profile(activities=acts) as prof:
        # the profiler keeps only device events that fall inside its own
        # window once moved onto the host's clock: keep the work well inside
        time.sleep(PROFILE_PAD_S)
        torch.zeros(1, device=dev)
        if not host:  # the device-only trace's window starts where this kernel ends
            _sync(dev)
            torch.cuda._sleep(1000)
        with record_function(trace.WINDOW_SPAN) if host else contextlib.nullcontext():
            out = run_window()
        time.sleep(PROFILE_PAD_S)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = trace.load(path, steps)
    finally:
        os.remove(path)
    return out, tr


def _layer_metrics(cell: Cell, tr, dev_tr, params: int, metric_names: Sequence[str],
                   steps_per_s: float) -> dict:
    from . import metrics

    ctx = metrics.Context(cell=cell, trace=tr, device_trace=dev_tr, params=params,
                          steps_per_s=steps_per_s)
    return {name: metrics.reader(name).read(ctx) for name in metric_names}


def run(cell: Cell, seed: int, seconds: float, traced: bool, dev, *, rank: int = 0,
        world: int = 1, t_start: float, faults: Sequence[str] = (),
        reference: bool = True) -> RankResult:
    """One run on this rank.  ``faults`` break the timed path on purpose
    (the benchmark's own tests: see :data:`FAULTS`)."""
    for f in faults:
        if f not in FAULTS:
            raise ValueError(f"unknown fault {f!r}")
    seeds = Seeds.of(seed)
    arch = cell.architecture.arch(cell.config)
    cfg = port_config(cell.config, seeds.noise)
    t = cell.traffic
    res = RankResult(rank=rank)
    res.mark("run_start", t_start)
    if cell.entry == "train":
        return _run_train(cell, cfg, arch, seeds, seconds, traced, dev, rank, world, t_start,
                          faults, reference, res)
    if cell.entry == "predict":
        if world != 1:
            raise ValueError("predict cells run on one card")
        return _run_predict(cell, cfg, arch, seeds, seconds, traced, dev, t_start, faults,
                            reference, res)
    raise ValueError(f"unknown entry {t['entry']!r}")


def _build_model(cell: Cell, cfg, arch, seeds: Seeds, dev):
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet

    model = MSUNet.from_config(cfg, device=dev)
    w = cell.architecture.draw(arch, seeds.weights, dev)
    weights.load_into(model, w)
    return model, w


def _run_train(cell, cfg, arch, seeds, seconds, traced, dev, rank, world, t_start, faults,
               reference, res: RankResult) -> RankResult:
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
        create_train_state,
        make_train_step,
    )

    t = cell.traffic
    batch, pool_rows = cell.batch, int(t["pool"])
    model, w0 = _build_model(cell, cfg, arch, seeds, dev)
    res.mark("model", t_start)
    state = create_train_state(model, cfg, device=dev)
    if world > 1 and "no_exchange" not in faults:
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel.mesh import (
            replicate_state,
        )

        replicate_state(state)
    elif world > 1:  # the fault: no gradient exchange, the loss still averaged
        import torch.distributed as dist

        state.rank, state.world = dist.get_rank(), dist.get_world_size()
    tr_cfg = cfg.TRAIN
    step = make_train_step(model, float(tr_cfg.TVERSKY_LOSS_ALPHA),
                           float(tr_cfg.TVERSKY_LOSS_BETA), float(tr_cfg.LOSS_TVERSKY_BCE_MIX),
                           int(tr_cfg.ACCUMULATION_STEPS), int(cfg.MODEL.NUM_CLASSES))
    if "frozen_state" in faults:
        state.optimizer.step = lambda *a, **k: None
    images, masks = traffic.make_pool(pool_rows, cell.img_size, seeds.data, dev)
    res.mark("state_and_pool", t_start)
    lr = float(tr_cfg.BASE_LR)

    def step_fn(k: int) -> torch.Tensor:
        rows = traffic.rows_of(k, batch, world, rank, pool_rows)
        x, y = images[rows], masks[rows]
        if "half_batch" in faults:
            x, y = x[:batch // 2], y[:batch // 2]
        return step(state, x, y, lr)

    # the first steps: the readings the reference follows, and the warm-up
    n_check = int(t["check_steps"])
    beta1 = float(cfg.TRAIN.OPTIMIZER.BETAS[0])
    named = list(model.named_parameters())
    losses, grad_norms = [], None
    for k in range(n_check):
        losses.append(float(step_fn(k)))
        if k == 0:
            grad_norms = {n: float(_first_grad(state.optimizer, p, beta1).norm())
                          for n, p in named}
    with torch.no_grad():
        change = {n: float((p.detach() - w0[n]).norm()) for n, p in named}
    del w0
    program = {"loss": losses, "grad_norm": grad_norms, "change_norm": change}
    _sync(dev)
    res.peak_process = _peak(dev)
    _reset_peak(dev)
    res.setup_s = time.perf_counter() - t_start
    # the window, as an untraced run has it; a traced run then profiles
    # ``trace_steps`` more steps on the device alone (busy and idle time,
    # NCCL) and as many on the host with it (the layers' spans, what the
    # host did in each gap), and reads the whole step's share of the peak
    # off the untraced window
    n, bad, window_s, res.done = _train_loop(step_fn, n_check, dev, world, seconds, None)
    res.steps, res.images, res.window_s = n, n * batch, window_s
    if traced:
        steps, spans = int(t["trace_steps"]), cell.architecture.spans
        (n1, bad1, _, _), dev_tr = _profile(
            lambda: _train_loop(step_fn, n_check + n, dev, world, None, steps), model, spans,
            dev, steps, host=False)
        (n2, bad2, _, _), tr = _profile(
            lambda: _train_loop(step_fn, n_check + n + n1, dev, world, None, steps), model,
            spans, dev, steps)
        bad += bad1 + bad2
        res.steps += n1 + n2
        names = [m["name"] for m in cell.metrics_layer]
        res.layer = _layer_metrics(cell, tr, dev_tr, sum(p.numel() for _, p in named), names,
                                   n / window_s)
        res.busy_s, res.window_s = dev_tr.busy_us() / 1e6, dev_tr.window_us / 1e6
        res.breakdown = {"device_ops": dev_tr.top_ops(), "idle_gaps": tr.idle_by_host()}
        res.traced_step_s = dev_tr.window_us / 1e6 / steps
    res.failed = bad
    res.peak_window = _peak(dev)
    res.peak_process = max(res.peak_process, res.peak_window)
    del state, step, model, named
    _free()
    res.program = program
    if reference and rank == 0:
        t_ref = time.perf_counter()
        with _reference_numerics():
            res.reference = train_reference(cell, cfg, arch, seeds, images, masks, world, dev)
        res.reference_s = time.perf_counter() - t_ref
        res.checks = compare.judge(compare.train_gaps(program, res.reference), cell.limits)
        _free()
    return res


def _first_grad(opt: torch.optim.Optimizer, p: torch.Tensor, beta1: float) -> torch.Tensor:
    """The first step's gradient as AdamW got it: its first moment after one
    step over ``1 - beta1``."""
    st = opt.state.get(p, {})
    if "exp_avg" not in st:
        return torch.zeros_like(p)
    return st["exp_avg"] / (1.0 - beta1)


def train_reference(cell, cfg, arch, seeds, images, masks, world, dev, fp8: bool = False):
    t = cell.traffic
    n_check, pool_rows = int(t["check_steps"]), int(t["pool"])
    batches = []
    for k in range(n_check):
        rows = traffic.global_rows(k, cell.batch, world, pool_rows)
        batches.append((images[rows].to(dev), masks[rows].to(dev)))
    ref = cell.architecture
    params = ref.draw(arch, seeds.weights, dev)
    tr = cfg.TRAIN
    return ref_train.train_readings(
        ref, arch, params, batches, lr=float(tr.BASE_LR), seed=seeds.noise, ranks=world,
        loss_abc=(float(tr.TVERSKY_LOSS_ALPHA), float(tr.TVERSKY_LOSS_BETA),
                  float(tr.LOSS_TVERSKY_BCE_MIX)),
        betas=tuple(tr.OPTIMIZER.BETAS), eps=float(tr.OPTIMIZER.EPS),
        weight_decay=float(tr.WEIGHT_DECAY), numerics=ref.Numerics(fp8=fp8),
        rows_per_pass=int(t["reference_rows"]))


@contextlib.contextmanager
def _reference_numerics():
    """float32 products without TF32 while the reference runs."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def _run_predict(cell, cfg, arch, seeds, seconds, traced, dev, t_start, faults, reference,
                 res: RankResult) -> RankResult:
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
        make_predict_step,
    )

    t = cell.traffic
    batch, pool_rows = cell.batch, int(t["pool"])
    model, w0 = _build_model(cell, cfg, arch, seeds, dev)
    del w0
    res.mark("model", t_start)
    predict = make_predict_step(model, int(cfg.MODEL.NUM_CLASSES), device=dev)
    if "altered_answer" in faults:
        base = predict

        def predict(x):  # noqa: F811 - the fault: one patch of every map moved
            out = base(x).clone()
            out[:, :16, :16] += 0.25
            return out
    images, _ = traffic.make_pool(pool_rows, cell.img_size, seeds.data, dev)
    res.mark("state_and_pool", t_start)
    if pool_rows % batch:
        raise ValueError(f"pool {pool_rows} is not a multiple of the batch {batch}")

    def batch_of(k: int) -> torch.Tensor:
        lo = (k * batch) % pool_rows
        return images[lo:lo + batch]

    every = int(t["check_every"])
    phase = seeds.sample % every
    for k in range(2):  # warm-up: the cell's one shape
        predict(batch_of(k)).cpu()
    _sync(dev)
    res.peak_process = _peak(dev)
    _reset_peak(dev)
    res.setup_s = time.perf_counter() - t_start
    keep = lambda k: k % every == phase  # noqa: E731
    # the window, then (traced) as for a train cell
    n, bad, window_s, lat, kept, res.done = _predict_loop(predict, batch_of, dev, seconds,
                                                          None, keep)
    res.steps, res.images, res.latencies, res.window_s = n, n * batch, lat, window_s
    if traced:
        n_tr, spans = int(t["trace_steps"]), cell.architecture.spans
        never = lambda k: False  # noqa: E731
        (n1, bad1, _, _, _, _), dev_tr = _profile(
            lambda: _predict_loop(predict, batch_of, dev, None, n_tr, never), model, spans, dev,
            n_tr, host=False)
        (n2, bad2, _, _, _, _), tr = _profile(
            lambda: _predict_loop(predict, batch_of, dev, None, n_tr, never), model, spans, dev,
            n_tr)
        bad += bad1 + bad2
        res.steps += n1 + n2
        res.layer = _layer_metrics(cell, tr, dev_tr, sum(p.numel() for p in model.parameters()),
                                   [m["name"] for m in cell.metrics_layer], n / window_s)
        res.busy_s, res.window_s = dev_tr.busy_us() / 1e6, dev_tr.window_us / 1e6
        res.breakdown = {"device_ops": dev_tr.top_ops(), "idle_gaps": tr.idle_by_host()}
        res.traced_step_s = dev_tr.window_us / 1e6 / n_tr
    res.failed = bad
    res.peak_window = _peak(dev)
    res.peak_process = max(res.peak_process, res.peak_window)
    del predict, model
    _free()
    res.program = {"maps": kept, "batches": {k: batch_of(k) for k in kept}}
    if reference:
        t_ref = time.perf_counter()
        with _reference_numerics():
            res.reference = {"maps": predict_reference(cell, arch, seeds, res.program, dev)}
        res.reference_s = time.perf_counter() - t_ref
        res.checks = compare.judge(compare.predict_gaps(kept, res.reference["maps"]),
                                   cell.limits)
        _free()
    return res


def predict_reference(cell, arch, seeds, program: dict, dev, fp8: bool = False) -> dict:
    """The reference's maps of the batches the program kept."""
    ref = cell.architecture
    params = ref.draw(arch, seeds.weights, dev)
    rows = int(cell.traffic["reference_rows"])
    return {k: ref_train.predict_maps(ref, arch, params, x.to(dev), ref.Numerics(fp8=fp8),
                                      rows_per_pass=rows).cpu()
            for k, x in program["batches"].items()}


def p95(values: Sequence[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def combine(cell: Cell, parts: List[RankResult], device: dict) -> dict:
    """The result line from every rank's :class:`RankResult` (rank 0 first)."""
    r0 = parts[0]
    checks = {k: v for k, v in (r0.checks or {}).items() if not k.startswith("_")}
    correct = bool(checks) and all(c["ok"] for c in checks.values()) and \
        sum(p.failed for p in parts) == 0
    metrics: Dict[str, dict] = {}
    traced = r0.breakdown is not None
    if traced:
        from . import metrics as mm

        for m in cell.metrics_layer:
            vals = [p.layer.get(m["name"]) for p in parts]
            if any(v is None for v in vals):
                continue
            metrics[m["name"]] = {"value": mm.reader(m["name"]).combine(vals),
                                  "unit": m["unit"]}
    else:
        window = max(p.window_s for p in parts)
        e2e = {
            "setup_s": r0.setup_s,
            "peak_mem_gib": max(p.peak_window for p in parts) / GIB,
        }
        if cell.entry == "train":
            e2e["train_img_per_s"] = sum(p.images for p in parts) / window
        else:
            e2e["predict_img_per_s"] = r0.images / r0.window_s
            e2e["predict_ms_p95"] = p95(r0.latencies) * 1e3
        for m in cell.metrics_e2e:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = dict(device)
    dev["memory_peak_bytes"] = max(p.peak_process for p in parts)
    if traced:
        dev["busy_s"] = statistics.fmean(p.busy_s for p in parts)
        dev["window_s"] = statistics.fmean(p.window_s for p in parts)
    out = {"correct": correct, "attempted": r0.steps, "failed": sum(p.failed for p in parts),
           "metrics": metrics, "device": dev}
    if traced:
        out["breakdown"] = r0.breakdown
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return out
