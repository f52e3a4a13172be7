"""The port's own spans as the per-layer metrics read them.

The port opens ``ssa.*`` ranges (``utils/profiling.py::span``) only while
a profiler records the host: ``ssa.step`` / ``ssa.predict`` around a train
step or a predict batch, ``ssa.upload`` around each copy from pageable
host memory inside one, ``ssa.norm`` around every LayerNorm and
``ssa.roll`` around the shift's pad, rolls and crop.  A port without them
(an older checkout) leaves every reading here ``None``; a step with no
span of a kind reads 0.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

from .trace import Interval, clip, length, subtract, union

STEP = {"train": "ssa.step", "predict": "ssa.predict"}
UPLOAD = "ssa.upload"
NORM = "ssa.norm"
ROLL = "ssa.roll"


def spans(tr, name: str) -> list:
    """The host ranges named ``name`` that meet the traced window."""
    return [e for e in tr.host if e.cat == "user_annotation" and e.name == name
            and e.end > tr.window[0] and e.start < tr.window[1]]


def _by_thread(events) -> Dict[int, List[Interval]]:
    out: Dict[int, List[Interval]] = defaultdict(list)
    for e in events:
        out[e.tid].append((e.start, e.end))
    return out


def _steps(ctx, entry: str) -> Optional[list]:
    """The cell's step spans, or None: another entry's cell, or a port
    that opens none."""
    if ctx.cell.entry != entry:
        return None
    return spans(ctx.trace, STEP[entry]) or None


def upload_ms(ctx, entry: str) -> Optional[float]:
    """Host ms a step inside ``ssa.upload`` spans, summed over threads (the
    recompute's uploads run on autograd's)."""
    if _steps(ctx, entry) is None:
        return None
    w = ctx.trace.window
    us = sum(length(clip(iv, w)) for iv in _by_thread(spans(ctx.trace, UPLOAD)).values())
    return us / 1e3 / ctx.steps


def host_ms(ctx, entry: str) -> Optional[float]:
    """Host ms a step the step's thread spends inside its step spans, less
    the time any thread spends in an upload then: what the host takes to
    issue the step."""
    steps = _steps(ctx, entry)
    if steps is None:
        return None
    w = ctx.trace.window
    uploads = union(clip([(e.start, e.end) for e in spans(ctx.trace, UPLOAD)], w))
    us = sum(length(subtract(clip(iv, w), uploads)) for iv in _by_thread(steps).values())
    return us / 1e3 / ctx.steps


def device_ms(ctx, entry: str, name: str) -> Optional[float]:
    """Device ms a step launched inside the spans ``name`` and in the
    backward of what they made (``Trace.layer_us`` over the program's
    spans)."""
    if _steps(ctx, entry) is None:
        return None
    tr = dataclasses.replace(ctx.trace, spans={name: spans(ctx.trace, name)})
    return (tr.layer_us(name) or 0.0) / 1e3 / ctx.steps
