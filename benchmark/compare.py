"""The numbers that decide ``correct``, and their limits.

Train cells: the gap of each of the first steps' losses, relative to the
reference's; for the first step's gradient and for the parameters' change
over the first steps, the worst leaf's gap between the program's norm and
the reference's, relative to the larger of the reference's norm of that
leaf and of the median leaf.  Leaves whose reference gradient is under a
thousandth of the median leaf's (nought to rounding, so moved by AdamW's
round-off alone) are left out of the change.  Predict cells: the widest
and the mean gap between the program's probabilities and the reference's
over the batches kept for the check.

A cell's limits are in ``limits/<workload>.json``: ``{"<number>": limit}``,
and ``"not_compared"``: the numbers that no control or fault separates from
sound runs, which are left out.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

NOUGHT_GRAD = 1e-3  # of the median leaf's gradient norm


def _worst(program: Dict[str, float], ref: Dict[str, float], names) -> tuple:
    med = statistics.median(ref[n] for n in names)
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(program[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(gap):  # a NaN compares false: count it as the worst
            return float("inf"), n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def train_gaps(program: dict, ref: dict) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], ref["loss"]))
    if not all(math.isfinite(x) for x in program["loss"]):
        loss_gap = float("inf")
    names = sorted(ref["grad_norm"])
    grad_gap, grad_leaf = _worst(program["grad_norm"], ref["grad_norm"], names)
    med = statistics.median(ref["grad_norm"][n] for n in names)
    moving = [n for n in names if ref["grad_norm"][n] >= NOUGHT_GRAD * med]
    change_gap, change_leaf = _worst(program["change_norm"], ref["change_norm"], moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "_worst": {"grad": grad_leaf, "change": change_leaf,
                       "left_out": len(names) - len(moving)}}


def predict_gaps(program: Dict[int, torch.Tensor], ref: Dict[int, torch.Tensor]) -> dict:
    if not program:
        return {"prob_gap": float("inf"), "prob_mean_gap": float("inf")}
    gaps = [(program[k].float() - ref[k].float()).abs() for k in sorted(program)]
    top = max(float(g.max()) for g in gaps)
    mean = float(sum(g.double().sum() for g in gaps) / sum(g.numel() for g in gaps))
    if any(not bool(torch.isfinite(program[k]).all()) for k in program):
        top = mean = float("inf")
    return {"prob_gap": top, "prob_mean_gap": mean, "_worst": {"batches": sorted(program)}}


def judge(readings: dict, limits: Optional[dict]) -> Dict[str, dict]:
    """``{number: {"value", "limit", "ok"}}``; a number with no limit is not ok."""
    out = {}
    skip = set((limits or {}).get("not_compared", ()))
    for name, value in readings.items():
        if name.startswith("_") or name in skip:
            continue
        limit = None if limits is None else limits.get(name)
        ok = limit is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": ok}
    if "_worst" in readings:
        out["_detail"] = {"value": 0.0, "limit": None, "ok": True, "detail": readings["_worst"]}
    return out
