"""Timing and tracing (counterpart of the JAX package's
``utils/profiling.py``).

* :class:`StepTimer`: per-step wall clock with warm-up steps discarded and
  an images/s summary (on the card, synchronise before ``stop``, e.g. by
  reading the loss).
* :func:`trace`: a ``torch.profiler`` context over the CPU and, when there
  is one, the card, writing a Chrome trace into ``log_dir``.
* :func:`section_times`: a per-section time breakdown of one call from
  one trace: the forward of each top-level submodule of a model (its
  kernels included) and the rest of the call (the backward, the optimizer,
  the host's glue).  It takes the place of the JAX package's
  ``tools/perf_breakdown.py`` (one jitted section at a time, timed by a
  host sync), ``tools/hlo_breakdown.py`` and ``utils/hlo_analysis.py``,
  which read XLA's compiled programs and have no other counterpart here.
* :func:`kernel_times`: device ms and launches of each kernel name in one
  call (the collectives' ``nccl*`` kernels among them).  Both it and
  :func:`section_times` leave the card's copies of annotated ranges out.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def mean_s(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def images_per_sec(self, batch_size: int) -> float:
        m = self.mean_s
        return batch_size / m if m and m == m else float("nan")

    def summary(self, batch_size: Optional[int] = None) -> str:
        s = f"steps={len(self.times)} mean={self.mean_s*1000:.1f}ms"
        if batch_size:
            s += f" throughput={self.images_per_sec(batch_size):.2f} img/s"
        return s


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block over the CPU and the card; on exit write
    ``log_dir/trace.json`` (Chrome trace format, for TensorBoard's or
    Perfetto's viewer) unless ``log_dir`` is None.  Yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _card_events(prof) -> list:
    """The card's kernels and copies in a profile.  The card's copies of
    annotated ranges (the optimizer's, DDP's, :func:`section_times`') are
    left out: they overlap the kernels they hold, which would count twice."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def _event_ms(ev, on_device: bool) -> float:
    return (ev.device_time_total if on_device else ev.cpu_time_total) / 1e3


def section_times(fn: Callable[[], object], model: torch.nn.Module,
                  sections: Optional[List[str]] = None) -> Dict[str, float]:
    """ms of each section of one ``fn()`` call, from one profile: the
    forward of each named submodule in ``sections`` (default: the direct
    children of ``model``, or of its ``ms_unet``, with a module list's
    entries in its place), then ``"other"`` for the rest of the call (the
    backward, the optimizer) and ``"total"``.  Device time (every kernel
    of the call) when there is a card, else host time."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    root = getattr(model, "ms_unet", model)
    mods = dict(root.named_modules())
    names = sections or [
        f"{n}.{i}" if isinstance(m, torch.nn.ModuleList) else n
        for n, m in root.named_children()
        for i in (range(len(m)) if isinstance(m, torch.nn.ModuleList) else [0])]
    prefix = "section:"
    hooks = []
    for name in names:
        def pre(mod, args, _name=name):
            mod._section = record_function(prefix + _name)
            mod._section.__enter__()

        def post(mod, args, out):
            mod._section.__exit__(None, None, None)

        hooks += [mods[name].register_forward_pre_hook(pre),
                  mods[name].register_forward_hook(post)]
    on_device = torch.cuda.is_available()
    try:
        if on_device:
            torch.cuda.synchronize()
        with trace(None) as prof:
            with record_function(prefix + "total"):
                fn()
            if on_device:
                torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    out = {name: 0.0 for name in names}
    # every kernel and copy of the call, the backward's (run on autograd's
    # own thread, outside the host's ranges) included
    total = sum(ev.device_time_total for ev in _card_events(prof)) / 1e3 if on_device \
        else 0.0
    for ev in prof.events():
        # a section is the host's range with its kernels summed in; the
        # card's copy of an annotation is left out, or it would count twice
        if ev.device_type != DeviceType.CPU or not ev.name.startswith(prefix):
            continue
        key = ev.name[len(prefix):]
        if key == "total" and not on_device:
            total += ev.cpu_time_total / 1e3
        elif key in out:
            out[key] += _event_ms(ev, on_device)
    out["other"] = total - sum(out.values())
    out["total"] = total
    return out


PROFILE_PAD_S = 0.05  # host seconds before and after the work in a profile


def kernel_times(fn: Callable[[], object], device=None) -> List[Tuple[float, int, str]]:
    """``(device ms, launches, name)`` of every kernel and copy that one
    ``fn()`` call runs on the card ``device`` (default: the current one),
    by one profile, in order of first launch (the collectives' ``nccl*``
    kernels among them)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        with trace(None) as prof:
            # the profiler keeps only the device events whose times, moved
            # onto the host's clock, fall inside its window, and on the H100
            # that move has been seen 3-4 ms off, losing a call's first
            # launches or all of them: keep the card's work well inside
            time.sleep(PROFILE_PAD_S)
            torch.zeros(1, device=dev)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
    rows: Dict[str, List] = {}
    for ev in _card_events(prof):
        row = rows.setdefault(ev.name, [0.0, 0])
        row[0] += ev.device_time_total / 1e3
        row[1] += 1
    return [(ms, n, name) for name, (ms, n) in rows.items()]
