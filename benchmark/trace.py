"""The device trace of a traced run, read from ``torch.profiler``'s Chrome
trace, and the interval arithmetic the per-layer metrics share.

Times are microseconds on the trace's clock.  A device operation is a
kernel, a copy or a memset.  Its launch is the CUDA runtime call with the
same correlation id, on the host thread that made it; a layer owns the
operations launched inside one of its spans (the benchmark's forward spans
around the calls into the layer) and inside the backward of an autograd
node that one of those forward calls made (matched by the node's sequence
number).  NCCL's kernels spin while their rank waits for the others, so
they are left out of the busy time and counted apart.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_PREFIX = "autograd::engine::evaluate_function: "
WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def clip(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def subtract(base: Iterable[Interval], cut: Iterable[Interval]) -> List[Interval]:
    """The parts of ``base`` that no interval of ``cut`` covers."""
    cut = union(cut)
    out = []
    for a, b in union(base):
        i = bisect.bisect_right([c[1] for c in cut], a)
        while a < b and i < len(cut) and cut[i][0] < b:
            if cut[i][0] > a:
                out.append((a, cut[i][0]))
            a = max(a, cut[i][1])
            i += 1
        if a < b:
            out.append((a, b))
    return out


def gaps(busy: Iterable[Interval], window: Interval) -> List[Interval]:
    """The idle stretches of ``window`` between the busy intervals."""
    return subtract([window], busy)


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    correlation: Optional[int]
    launch_tid: Optional[int] = None
    launch_ts: Optional[float] = None


@dataclass
class HostEvent:
    name: str
    cat: str
    tid: int
    start: float
    end: float
    seq: Optional[int] = None


@dataclass
class Trace:
    """One rank's traced window."""

    ops: List[DeviceOp]
    host: List[HostEvent]
    window: Interval
    steps: int
    spans: Dict[str, List[HostEvent]] = field(default_factory=dict)

    # -- device time ---------------------------------------------------------
    def op_intervals(self, nccl: Optional[bool] = None) -> List[Interval]:
        """Device operations in the window: all, only NCCL's, or all but NCCL's."""
        return clip([(o.start, o.end) for o in self.ops
                     if nccl is None or is_nccl(o.name) == nccl], self.window)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        """Union of the device operations that are not NCCL's, in the window."""
        return length(self.op_intervals(nccl=False))

    def nccl_exposed_us(self) -> float:
        """NCCL kernel time in the window that overlaps no other device operation."""
        return length(subtract(self.op_intervals(nccl=True), self.op_intervals(nccl=False)))

    # -- layers --------------------------------------------------------------
    def layer_us(self, span: str) -> Optional[float]:
        """Union of the device time the layer whose forward spans are named
        ``span`` launched in the window, forward and backward; None when the
        window holds no such span."""
        fwd = [s for s in self.spans.get(span, []) if s.end > self.window[0]
               and s.start < self.window[1]]
        if not fwd:
            return None
        by_tid: Dict[int, List[Interval]] = defaultdict(list)
        for s in fwd:
            by_tid[s.tid].append((s.start, s.end))
        fwd_by_tid = {tid: union(iv) for tid, iv in by_tid.items()}
        seqs = set()
        for ev in self.host:
            if ev.seq is not None and ev.cat == "cpu_op" and not ev.name.startswith(
                    BACKWARD_PREFIX) and _inside(fwd_by_tid.get(ev.tid), ev.start):
                seqs.add(ev.seq)
        for ev in self.host:
            if ev.seq in seqs and ev.name.startswith(BACKWARD_PREFIX):
                by_tid[ev.tid].append((ev.start, ev.end))
        owned = {tid: union(iv) for tid, iv in by_tid.items()}
        mine = [(o.start, o.end) for o in self.ops
                if o.launch_tid is not None and _inside(owned.get(o.launch_tid), o.launch_ts)]
        return length(clip(mine, self.window))

    def span_device_us(self, prefix: str) -> float:
        """Union of the device time launched inside host ranges whose name
        starts with ``prefix`` (PyTorch's own ``Optimizer.step#...`` ranges)."""
        by_tid: Dict[int, List[Interval]] = defaultdict(list)
        for ev in self.host:
            if ev.cat == "user_annotation" and ev.name.startswith(prefix):
                by_tid[ev.tid].append((ev.start, ev.end))
        owned = {tid: union(iv) for tid, iv in by_tid.items()}
        mine = [(o.start, o.end) for o in self.ops
                if o.launch_tid is not None and _inside(owned.get(o.launch_tid), o.launch_ts)]
        return length(clip(mine, self.window))

    # -- breakdown -----------------------------------------------------------
    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time, by name: ``[name, s]``
        (a templated kernel's name cut to :data:`NAME_CHARS`)."""
        total: Dict[str, float] = defaultdict(float)
        for a, b, name in ((max(o.start, self.window[0]), min(o.end, self.window[1]), o.name)
                           for o in self.ops):
            if b > a:
                total[name] += (b - a) / 1e6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[short_name(k), v] for k, v in top]

    def idle_by_host(self, n: int = 10) -> List[list]:
        """The device's idle time (NCCL's spin counted idle) by what the host
        was doing when each gap began: the innermost range begun last on any
        host thread (the main one's op, or the autograd thread's backward
        node) that still held that moment; ``[name, s]``, the largest first."""
        host = sorted((e for e in self.host if not e.name.startswith("ProfilerStep")),
                      key=lambda e: e.start)
        starts = [e.start for e in host]
        total: Dict[str, float] = defaultdict(float)
        for a, b in gaps(self.op_intervals(nccl=False), self.window):
            # the range begun last that has not yet ended at ``a``
            label, i = "no host range", bisect.bisect_right(starts, a) - 1
            for j in range(i, max(-1, i - 5000), -1):
                if host[j].end > a:
                    label = host[j].name
                    break
            total[short_name(label)] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


NAME_CHARS = 160


def short_name(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _inside(intervals: Optional[Sequence[Interval]], t: Optional[float]) -> bool:
    if not intervals or t is None:
        return False
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


MARKER_KERNEL = "spin_kernel"  # ``torch.cuda._sleep``'s


def from_events(events: List[dict], steps: int) -> Trace:
    """A :class:`Trace` from Chrome-trace events (``traceEvents``).  The
    window is the benchmark's ``bench.window`` range; a trace of the device
    alone (no host ranges) starts where the marker kernel the benchmark
    launches just before the window ends, and ends with the last device
    operation after it."""
    launches: Dict[int, Tuple[int, float]] = {}
    ops, host = [], []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args", {}) or {}
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))
        if cat in DEVICE_CATS:
            ops.append(DeviceOp(ev.get("name", ""), start, end, args.get("correlation")))
        elif cat in RUNTIME_CATS and args.get("correlation") is not None:
            launches[args["correlation"]] = (ev.get("tid"), start)
        elif cat in HOST_CATS:
            seq = args.get("Sequence number")
            host.append(HostEvent(ev.get("name", ""), cat, ev.get("tid"), start, end,
                                  None if seq is None else int(seq)))
            if cat == "user_annotation" and ev.get("name") == WINDOW_SPAN:
                window = (start, end)
    markers = [o for o in ops if MARKER_KERNEL in o.name]
    if window is None and markers:
        lo = max(o.end for o in markers)
        ops = [o for o in ops if o.start >= lo]
        if ops:
            window = (lo, max(o.end for o in ops))
    if window is None:
        raise ValueError(f"the trace has no {WINDOW_SPAN!r} range and no marker kernel "
                         "with work after it")
    for o in ops:
        if o.correlation in launches:
            o.launch_tid, o.launch_ts = launches[o.correlation]
    spans: Dict[str, List[HostEvent]] = defaultdict(list)
    for e in host:
        if e.cat == "user_annotation" and e.name.startswith(SPAN_PREFIX) \
                and e.name != WINDOW_SPAN:
            spans[e.name].append(e)
    for v in spans.values():
        v.sort(key=lambda e: e.start)
    return Trace(ops, host, window, steps, dict(spans))


def load(path: str, steps: int) -> Trace:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return from_events(data["traceEvents"] if isinstance(data, dict) else data, steps)
