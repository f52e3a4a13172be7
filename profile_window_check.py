#!/usr/bin/env python3
"""How often torch.profiler loses the port's kernels, and why.

    python3 profile_window_check.py [--profiles 300]

On one NVIDIA GPU: builds the port's kernels, then profiles five
back-to-back bfloat16 patch merges at the Swin-T shape x (8, 64, 64, 192)
``--profiles`` times with no host padding and as many times with
``PROFILE_PAD_S`` (the port's ``utils/profiling.py``) of host sleep at both
ends of each profile (what that module's ``kernel_times`` does, which
``chip_smoke.kernel_times`` calls), and prints how many profiles lost
launches in each.  For a profile that lost some it prints where the kept
kernels landed against the host ops that launched them (microseconds from
the profile's start): the profiler moves device times onto the host's
clock and drops what lands outside its window.  Last it prints, at three
merge shapes, ``chip_smoke.device_ms`` (profiler) beside
``chip_smoke.queued_event_ms`` (its fallback), mean of ten each.  Exits
non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

MERGE_SHAPES = ((8, 64, 64, 192), (8, 128, 128, 128), (8, 32, 32, 512))


def profile_spans(fn, pad_s: float) -> tuple:
    """(ssa:: kernel launches by name, [first, last] µs of the host ops,
    [first, last] µs of the device events) of one profile of ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    counts = {ev.key: ev.count for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and "ssa::" in ev.key}
    spans = {DeviceType.CPU: [], DeviceType.CUDA: []}
    for ev in prof.events():
        spans.setdefault(ev.device_type, []).extend((ev.time_range.start, ev.time_range.end))
    host, dev = spans[DeviceType.CPU], spans[DeviceType.CUDA]
    return (counts, [min(host), max(host)] if host else None,
            [min(dev), max(dev)] if dev else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profiles", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_window_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import _build
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_patch as fp
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils.profiling import (
        PROFILE_PAD_S,
    )

    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    runs = {}
    for shape in MERGE_SHAPES:
        x32, w, sc, lb, _ = cs.patch_inputs(gen, shape, True)
        x = x32.bfloat16()
        runs[shape] = lambda x=x, w=w, sc=sc, lb=lb: fp.fused_patch_merge(x, sc, lb, w)
    run = runs[MERGE_SHAPES[0]]
    run()
    reps = 5
    for pad_s in (0.0, PROFILE_PAD_S):
        lost = empty = 0
        t0 = time.perf_counter()
        for _ in range(args.profiles):
            counts, host, dev = profile_spans(lambda: [run() for _ in range(reps)], pad_s)
            if counts and min(counts.values()) >= reps:
                continue
            lost += 1
            empty += not counts
            if lost <= 3:
                print(f"  pad {pad_s} s: lost launches; kept {sorted(counts.values())} of "
                      f"{reps} a kernel; host ops at {host} us, device events at {dev} us")
        print(f"pad {pad_s} s: {lost} of {args.profiles} profiles lost launches "
              f"({empty} kept none), {time.perf_counter() - t0:.1f} s", flush=True)
    for shape, fn in runs.items():
        prof = sum(cs.device_ms(fn) for _ in range(10)) / 10
        events = sum(cs.queued_event_ms(fn, reps) for _ in range(10)) / 10
        print(f"merge x{shape} bf16: device_ms (profiler) {prof:.4f} ms, queued CUDA "
              f"events {events:.4f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
