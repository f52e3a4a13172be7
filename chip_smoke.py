#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``csrc/`` and then, in order:

1. prints the card's name and power limit and the build time;
2. checks each forward kernel against its plain PyTorch version at the
   shapes the 512^2 batch-8 predict paths give it (Swin-B, and Swin-T
   where its widths differ: attention at 3/6/12/24 heads, merge at
   C = 96, expand at C/2 = 96/192/384, the GELU+depth-to-space head at
   C = 96), in float32 and in bfloat16, each error beside its stated
   tolerance, and times kernel, plain version and (for attention) one
   ``scaled_dot_product_attention`` call; the patch forwards also by
   device time (warm and cold L2), part by part with their CUDA launches a
   call, achieved TFLOP/s, beside their product as a bf16 ``torch.matmul``
   call (context), with a repeated call's bits, 50 back-to-back bf16 calls
   each equal in bits to the first, and at the corner cases
   ``PATCH_FWD_CORNERS`` (ragged rows, the widths routed to the CUDA-core
   kernels) in float32 and bfloat16, bits and all; attention also by the
   profiler's device time per launch, back to back and with the L2 emptied before
   every launch, with the memory rate it amounts to, a repeated launch's
   bits at every shape, and a phase of corner cases (``ATTENTION_CORNERS``:
   uneven grids, one image, one head, uneven runs of windows, fewer
   windows than blocks, head widths 16, 64, 48 and 24, windows of 16, 25
   and 64 tokens, shifts on one axis) in float32 and bfloat16, forward and
   backward, bits and all; the refine head also at two
   shapes whose tiles are ragged on every side, ``y (3, 13, 21, 2048)`` and
   ``y (1, 5, 3, 2048)`` (inference forward, training forward, backward
   and a repeated backward's bits);
3. drives the predict path of the full Swin-B MS-UNet (512^2, batch 8,
   bfloat16, all kernel knobs on, seeded weights) through
   ``make_predict_step`` with the launch counts zeroed just before and
   read just after, then times it, and runs ``artifact_prediction`` and a
   1024^2 ``tiled_predict``;
4. holds the kernel path's float32 logits against the composed path
   (knobs off) at 512^2, batch 2;
5. checks the training kernels (attention backward, refine-head training
   forward and backward, patch merge and expand backwards, the
   GELU+depth-to-space backward) against their plain versions at the
   shapes of the 512^2 batch-8 train steps, in float32 and bfloat16 (a
   repeated attention, patch or refine-head backward must give the same
   bits), and
   the plain backwards against ``torch.autograd`` of the plain forwards,
   and times kernel, plain version and yardstick; the refine head's
   forward and backward are also timed part by part (each CUDA kernel of
   one call, by the profiler), beside the composed cuDNN head forward
   alone and forward plus backward; the patch backwards also by device
   time (warm and cold L2), part by part with their CUDA launches a call
   and achieved TFLOP/s, beside their products as bf16 ``torch.matmul``
   calls (context), and at the corner cases ``PATCH_BWD_CORNERS`` (ragged
   rows, the widths routed to the CUDA-core kernels) in float32 and
   bfloat16, bits and all;
6. drives the train step of the full Swin-B MS-UNet with every
   ``config.yaml`` knob on (bench.py's step: 512^2, batch 8, bf16 compute,
   f32 params, attention, head and patch kernels, drop-path 0.1) through
   ``make_train_step`` with the launch counts zeroed just before one step
   and read just after, times ten steps on a fixed batch (the loss must
   fall; ms/step and the MFU of ``utils/flops.py``'s count against
   ``BF16_FLOP_PER_S``) and profiles one; then the same with
   ``FUSED_PATCH`` off;
7. holds one float32 train step on the kernel path against the composed
   path (loss and every parameter's gradient) at 512^2, batch 2;
8. drives the Swin-T-width MS-UNet (embed 96, depths 2/2/6/2, heads
   3/6/12/24, window 7, every knob on, 512^2 batch 8 bf16), whose head
   runs the GELU+depth-to-space kernel: its predict forward and its train
   step, each with its launch counts, times and a profile, and a float32
   train step against the composed path;
10. (run before 9, as are 11-13) trains ``config.yaml`` as shipped (Swin-B,
   1024^2, batch 2, bf16, every knob on, attention dropout 0.05, drop-path
   0.1, ``TPU.REMAT: auto``, which resolves to ``high_res`` there as in the
   JAX package; only the paths, ``PRETRAIN_WEIGHTS: none`` and 2 epochs with
   1 of warm-up changed) through the port's train CLI on a synthetic split made by
   ``data/synthetic.py`` (8 fake and 4 real train images, 2 fake and 1 real
   val images), with the launch counts zeroed just before and checked
   after (per train step no attention kernel, attention dropout taking the
   composed path, merge 3/3, expand 6/6, refine 1/1; per validation forward
   52/3/6/1); checks "Training Finished!", finite losses, the 7 CSV headers
   and a strict load of ``best_model.pth``; runs the test CLI on that
   checkpoint over the val split (its Score must equal the trainer's best
   to 1e-6) and the predict CLI, each with its cases/s on the host clock;
   then times the literal-config step (CUDA events, MFU, the profiler's
   device time, peak memory) and an eval forward,
   and prints the trainer's epoch wall time, loader wait a step and
   validation time a case, each beside the card line; every image the
   three CLIs read must decode natively (``native.DECODES``: none by PIL);
11. recomputation: drives phase 6's Swin-B train step (512^2 b8, drop-path
   0.1) under ``TPU.REMAT`` none, full, dots and high_res, each with its
   launch counts (the attention forward again in every recomputed block
   that reaches the loss: 52 / 100 / 100 / 62), ms/step, device time, busy
   share and peak memory; then one float32 step under each policy against
   ``none`` from the same weights and noise (512^2 b2, drop-path on), and
   ``config.yaml``'s own noise at 1024^2 b2 under the ``high_res`` its
   ``auto`` resolves to against ``none``: loss and every gradient within
   ``REMAT_*_TOL``, and whether the bits matched; and bench.py's step at
   ``config.yaml``'s 1024^2 b2 under ``dots`` (JAX's choice there) and
   ``none`` from the same weights, batch and noise: launches, ms/step,
   device time, busy share, peak memory, the loss after one update within
   ``REMAT_LOSS_TOL``;
12. grid search: the port's run CLI over a copy of ``config.yaml`` at 256^2
   on a synthetic split, one epoch a trial, attention dropout 0.05, alpha
   0.3, lr 8.5e-6 (3 trials, one a sweep, each the port's train CLI in its
   own process on the card): every trial's numeric ``Score``, the ``BEST:``
   line, ``config.yaml`` unchanged, and the trials' decodes (their
   ``epoch_timing`` lines) native only;
13. the parity tool at PARITY.md r5's setting (512^2, 15 epochs, both arms;
   launch counts zeroed before each arm: none in the parity arm, the
   kernels in the deploy arm) with its deltas beside r5's, then the epoch
   bench at 512^2 batch 8 over a synthetic 32 + 32 split (its JSON line),
   every decode native;
14. data parallelism on the one card (run before 9): (a) phase 6's step
   through ``DistributedDataParallel`` in a one-rank NCCL group beside the
   plain step from the same weights: launch counts equal to phase 6's,
   losses over three steps within ``DDP_LOSS_TOL`` (and whether the bits
   matched), ms/step, MFU and the step's device time by model section
   (``utils/profiling.py::section_times``); (b) two ranks on the card over
   gloo (NCCL refuses two ranks on one device; NCCL across four cards is
   ``tools/multichip.py``'s, on the four-card machine) training Swin-B
   512^2 in float32 with drop rates 0 over a global batch of 8 (4 + 4) for
   three steps against one process over the same batches
   (``tools/dp_check.py::hold_against_one``, as ``tools/multichip.py``
   holds four NCCL ranks): phase 6's launches a step, losses within
   ``dp_check.LOSS_TOL``, parameters within Adam's bound of 2 x lr x steps
   with at most 1e-3 of them beyond 1e-5; then each rank's ms/step, device
   time of one step (``utils/profiling.py::kernel_times``), MFU and peak
   memory over five bf16 deployment steps; (c) ``config.yaml`` at 256^2 with
   ``FREEZE_ENCODER`` through the train CLI with ``HARDWARE.N_GPU: 2`` on
   two gloo ranks on the card: each epoch's ``rank_sync`` line (the
   trainer raises unless both ranks hold the same parameters) shows the
   frozen stages at their initial values and each unfrozen stage moved;
15. tensor and spatial parallelism on the one card (run before 9): two gloo
   ranks share it (NCCL across four cards: ``tools/multichip.py``) and
   train Swin-B 512^2, batch 2, float32, drop rates 0, every kernel knob
   on, for three steps,
   (a) with ``TPU.MODEL_AXIS`` on a mesh with ``n_model=2``
   (``parallel/tp.py``), (b) with ``TPU.SPATIAL_AXIS`` and ``n_space=2``
   (``parallel/spatial.py``; the stage grids 128/64/32/16 pad to
   133/70/35/21: uneven slabs, shifted windows across the ranks), each
   against one process's composed step from the same seeded weights: no
   kernel launched under the axis (the axis routes them off), losses
   within ``dp_check.LOSS_TOL``, parameters within Adam's bound of 2 x lr x
   steps with at most 1e-3 of them beyond 1e-5; then each rank's ms/step
   (CUDA events), device time of one step (profiler) and peak memory;
16. the native decoder (``native/``; run before 9) over a synthetic split
   at ``config.yaml``'s 1024^2 (16 fake and 12 real train images with their
   masks): (a) every file decoded natively and by PIL, equal in bits, then
   ms per image and per mask of wall time for each decoder on one thread
   and on ``DATA.NUM_WORKERS`` threads, in turns, beside the files' mean
   size; (b) one epoch of ``TrainLoader.epoch_batches_merged`` as the
   trainer builds it (1024^2 b2) with ``SSA_TPU_NATIVE_DECODE`` unset, 0, 0
   and unset: the arms' batches equal in bits, seconds a batch, each arm's
   decodes all native or all PIL; (c) the epoch bench at 1024^2 b2
   (``--merge 1``) in each arm: its JSON line (img/s, ``host_efficiency``,
   loader wait a step, ``native_decode``) and launches equal to phase 6's
   counts a step times its steps; (d) the LR range test (bench.py's step at
   1024^2 b2, 20 steps, lr 1e-7 to 1e-3, plot off) over the loader's
   batches: finite losses, 20 CSV rows, rising lrs, phase 6's launches a
   step, every decode native;
17. orbax checkpoints (run before 9): (a) the fixture under the port's
   ``train/testdata/jax_orbax`` (written by the JAX package's orbax
   backend: zstd OCDBT nodes and chunks) read by the port, every leaf equal
   in bits to its ``values.npz``, and the zstd decoder's MB/s over its
   frames; (b) ``config.yaml``'s Swin-B at 512^2 b2 with drop rates 0, two
   steps with phase 6's launches a step, ``save_best`` and ``save_last``
   through the asynchronous orbax writer (sizes, submit and write
   seconds), both read back in bits (read seconds), one step after
   resuming from ``epoch_1.orbax`` equal in bits (loss and parameters,
   cuDNN deterministic) to the step without the save, and the test CLI's
   Score on the orbax directory against a ``.pth`` of the same weights (to
   1e-6), each run with its launches;
18. Swin-B at window 12 (run before 9; 144 tokens a window, so every
   attention call takes the tiled kernels): (a) the tiled forward and
   backward against their plain versions at the window-12 stage shapes of
   the 512^2 batch-8 paths (grids 132/72/36/24, shift 6; bfloat16 on the
   tiled ``mma.sync`` kernels, float32 on the CUDA-core ones, each route
   asserted) and at ``W12_CORNERS`` (65, 81, 144, 484 and 576 tokens,
   shifted and not, head widths 8, 16, 24, 32, 40, 48, 64, 72, 128; the
   one-block and the split kernels, and each column template of the
   CUDA-core kernels in bfloat16; each case's route asserted), float32 and
   bfloat16, a repeated launch's bits, each timed beside its bound, the plain
   versions and one ``scaled_dot_product_attention`` call, every tiled
   ``mma.sync`` corner no slower than its plain version; then, at the stage
   shapes and every corner, every output element written and nothing
   outside the outputs or the scratch (NaN-filled buffers with NaN guards),
   the inputs unchanged; (b) the window-12 predict step
   with its launch counts (52 tiled attention, 3 merge, 6 expand, 1
   refine), ms/forward, device time, busy share, peak memory; (c) bench.py's
   train step at window 12 (launches 52/48 tiled attention, 3/3, 6/6, 1/1;
   the loss falls over ten steps; ms/step, MFU, device time, busy share,
   peak memory); (d) one float32 train step against the composed path at
   512^2 b2; (e) the predict CLI at ``WINDOW_SIZE: 12`` over phase 10's
   synthetic val split, with its launches;
9. prints the kernels line (the tiled kernels as rows of their own), the
   card line, and last ``{"ok": true, "device": {...}}``.

Any failed phase prints ``chip_smoke: phase <n> <name> failed: <error>``
on stdout, with the shape where a shape check failed, and re-raises: the
exit is non-zero (a failed rank of phase 14 or 15 raises in this process, named
by ``torch.multiprocessing``).  It imports torch, numpy, the standard library and the
port; without a GPU, or without the port beside it, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
BF16_FLOP_PER_S = 989e12    # H100 SXM dense tensor cores
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
B, IMG = 8, 512

# Tolerances on max |kernel - plain|, relative to max(1, max |plain|):
# float32 differs only by summation order; bfloat16 may round an
# intermediate (probs, LN output, conv sum, h1) one ulp apart, which the
# refine head's second conv and LayerNorm can spread.
# The backwards: bfloat16 dS and P may round one ulp apart, which moves
# dq/dk/dv by a bf16 ulp of their size; the refine head's cotangents pass
# two convs and a LayerNorm, as its forward does.  Its conv weight
# gradients are float32 sums of 2.1M products each, taken in another order
# than cuDNN's (split-K partials): 1.8e-4 of max|dW| in float32 on an
# H100, hence 1e-3 there.
# The patch backwards: a bfloat16 dn / z / dz may round one ulp apart, which
# the LayerNorm backward and the dx product carry; their weight gradients
# are float32 sums over up to 32,768 rows in split-K order.  The
# GELU+depth-to-space pair moves each value once: float32 differs by the
# tanh's last bits, bfloat16 by one rounding.
TOL = {
    "window_attention": {"f32": 1e-4, "bf16": 1e-2},
    "window_attention_bwd": {"f32": 1e-4, "bf16": 2e-2},
    "patch_merge": {"f32": 1e-4, "bf16": 1e-2},
    "patch_merge_bwd": {"f32": 1e-4, "bf16": 2e-2},
    "patch_expand": {"f32": 1e-4, "bf16": 1e-2},
    "patch_expand_bwd": {"f32": 1e-4, "bf16": 2e-2},
    "refine_head": {"f32": 1e-4, "bf16": 5e-2},
    "refine_head_res": {"f32": 1e-4, "bf16": 5e-2},
    "refine_head_bwd": {"f32": 1e-3, "bf16": 5e-2},
    "gelu_d2s4": {"f32": 1e-5, "bf16": 1e-2},
    "gelu_d2s4_bwd": {"f32": 1e-5, "bf16": 1e-2},
}
# the tiled kernels (windows of more than 64 tokens) are held to the bars of
# the other attention kernels
TOL["window_attention_tiled"] = TOL["window_attention"]
TOL["window_attention_bwd_tiled"] = TOL["window_attention_bwd"]
E2E_TOL = 1e-3
# plain backward vs torch.autograd of the plain forward, float32: the same
# arithmetic in another order
AUTOGRAD_TOL = 1e-4
# f32 train step, kernel path vs composed path: the loss (a mean over
# 2 x 512^2 pixels) and each gradient relative to max(1, max|g|); the two
# paths sum attention, the patch ops, their backwards and the head in other
# orders, which the blocks' backward compounds
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
PKG = "semantic_segmentation_of_stylegan2_artifacts_tpu_torch"
JAX_PKG = "semantic_segmentation_of_stylegan2_artifacts_tpu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 5, flush=None) -> float:
    """Device time of the port's own kernels in one call of ``fn()``, by the
    profiler, mean over ``reps`` calls: what the card spends, whatever the
    host takes to launch.  With ``flush`` (a buffer larger than the 50 MB
    L2) the buffer is rewritten before every call, so each call finds the
    cache cold."""
    def loop():
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()

    fn()
    seen = []
    for _ in range(3):
        rows = [(ms, count) for ms, count, key in kernel_times(loop) if "ssa::" in key]
        if rows and min(count for _, count in rows) >= reps:
            return sum(ms for ms, _ in rows) / reps
        seen.append([count for _, count in rows])
    # the profiler lost launches in every try (see kernel_times): time the
    # same loop by CUDA events instead, queued behind a sleeping kernel so
    # the host's launch time stays off the device's clock
    ms = queued_event_ms(fn, reps, flush)
    print(f"    device_ms: the profiler kept {seen} of {reps} launches a kernel in "
          f"{len(seen)} profiles; by CUDA events behind a queued sleep: {ms:.4f} ms")
    return ms


def queued_event_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn()`` by a pair of CUDA events around each
    call, all enqueued while a sleeping kernel holds the card, so each pair
    reads the card's time and not the host's."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock: room to enqueue
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound_ms(n_bytes: float, flops: float, op_rate: float = BF16_FLOP_PER_S) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / op_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def multi_err(label, gots, wants, names) -> tuple:
    """Per-output errors printed; returns the largest abs and the largest
    rel error over the outputs."""
    errs = [rel_err(got, want) for got, want in zip(gots, wants)]
    print(f"    {label} abs/rel: " + ", ".join(
        f"{name} {err:.2e}/{rel:.2e}" for name, (err, rel) in zip(names, errs)))
    return max(e for e, _ in errs), max(r for _, r in errs)


class KernelReport:
    """Per-kernel sums over the main path's launches of one forward or
    step.  A Swin-T shape is added with ``count`` 0 and its launches on the
    Swin-T path as ``t_count``: checked and timed, it adds to the errors
    and to the Swin-T sums (:meth:`swin_t`), not to the row."""

    def __init__(self, name, source, replaces):
        self.row = dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
                        replaces=f"{JAX_PKG}/ops/{replaces}", launches=0,
                        max_abs_err=0.0, max_abs_err_f32=0.0, max_rel_err=0.0,
                        ms=0.0, plain_ms=0.0,
                        bound_ms=0.0, bound_by="", library_ms=None)
        self._by = {"bytes": 0.0, "operations": 0.0}
        self.t_sums = [0.0, 0.0, 0.0]  # Swin-T path: ms, plain ms, bound ms

    def extra(self, count, **sums) -> None:
        """Further per-path sums of the row (device time, cold-L2 time)."""
        for key, value in sums.items():
            self.row[key] = self.row.get(key, 0.0) + count * value

    def swin_t(self) -> str:
        ms, plain, bound = self.t_sums
        return f"{self.row['name']} {ms:.4f} / {plain:.4f} / {bound:.4f}"

    def add(self, shape_label, count, errs, ms, plain_ms, b_ms, by, lib_ms=None, t_count=0):
        r = self.row
        name = r["name"]
        for dt in ("f32", "bf16"):
            err, rel = errs[dt]
            tol = TOL[name][dt]
            print(f"  {name} {shape_label} {dt}: max_abs_err {err:.3e} "
                  f"(rel {rel:.3e}, tol {tol:g})")
            if rel > tol:
                raise AssertionError(f"{name} {shape_label} {dt}: {rel:.3e} > {tol:g}")
        lib = "" if lib_ms is None else f" library_ms {lib_ms:.4f}"
        print(f"  {name} {shape_label} x{count}: kernel_ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({by}){lib}")
        r["max_abs_err"] = max(r["max_abs_err"], errs["bf16"][0])
        r["max_rel_err"] = max(r["max_rel_err"], errs["bf16"][1])
        r["max_abs_err_f32"] = max(r["max_abs_err_f32"], errs["f32"][0])
        r["ms"] += count * ms
        r["plain_ms"] += count * plain_ms
        r["bound_ms"] += count * b_ms
        for i, v in enumerate((ms, plain_ms, b_ms)):
            self.t_sums[i] += t_count * v
        self._by[by] += count * b_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + count * lib_ms
        r["bound_by"] = max(self._by, key=self._by.get)


# dim, heads, Swin blocks on the forward path, blocks with a backward in
# the train step (the last stage of each cent decoder, 2 + 2 stage-0 blocks,
# feeds nothing the loss reads)
STAGES = [(128, 4, 8, 4), (256, 8, 6, 6), (512, 16, 36, 36), (1024, 32, 2, 2)]
# the same at Swin-T width (depths 2/2/6/2: 28 forward, 24 backward)
SWIN_T_STAGES = [(96, 3, 8, 4), (192, 6, 6, 6), (384, 12, 12, 12), (768, 24, 2, 2)]
SWIN_T = {"MODEL.SWIN.EMBED_DIM": 96, "MODEL.SWIN.DEPTHS": [2, 2, 6, 2],
          "MODEL.SWIN.NUM_HEADS": [3, 6, 12, 24], "MODEL.SWIN.WINDOW_SIZE": 7}


def stage_shapes(wa, ws=7):
    """(stage, hp, wp, sh, sw) of every attention shape of the path at window
    ``ws`` (shift ``ws // 2`` in every other block)."""
    tokens = IMG // 4
    for stage in range(4):
        g = tokens >> stage
        for shift in (0, ws // 2):
            yield (stage, *wa.effective_shift(g, g, (ws, ws), (shift, shift)))


def sdpa_operands(wa, qkv, bias, wh, ww, heads, sh, sw):
    """The yardstick's inputs: q, k, v partitioned into (B, nW, heads, N, hd)
    and the bias (+ the shift mask) as a bf16 ``attn_mask``."""
    b, hp, wp, c3 = qkv.shape
    hd, n = c3 // 3 // heads, wh * ww
    part = qkv.reshape(b, hp // wh, wh, wp // ww, ww, 3, heads, hd).permute(
        5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, -1, heads, n, hd).contiguous()
    mask = bias[None].expand(part.shape[2], -1, -1, -1)
    if sh or sw:
        sm = torch.as_tensor(wa.shifted_window_mask(hp, wp, wh, ww, sh, sw), device="cuda")
        mask = mask + sm[:, None]
    return part, mask.to(torch.bfloat16).contiguous()


L2_FLUSH_BYTES = 256 << 20  # rewritten between launches to empty the 50 MB L2


def attention_device_times(rep, label, run, n_bytes, flush, count) -> None:
    """Device time of one launch back to back and with the L2 emptied before
    it, and the memory rate the first amounts to."""
    dev, cold = device_ms(run), device_ms(run, flush=flush)
    print(f"  {rep.row['name']} {label}: device_ms {dev:.4f} "
          f"({n_bytes / dev / 1e6:.0f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}), "
          f"cold-L2 device_ms {cold:.4f} ({n_bytes / cold / 1e6:.0f} GB/s)")
    rep.extra(count, device_ms=dev, cold_l2_device_ms=cold)


# (B, Hp, Wp, C, heads, window, sh, sw): what each case is there for
ATTENTION_CORNERS = [
    ((1, 14, 35, 64, 2, (7, 7), 3, 0), "Hp != Wp, one image, shift on one axis"),
    ((3, 21, 28, 32, 1, (7, 7), 0, 0), "one head, unshifted"),
    ((5, 77, 84, 32, 1, (7, 7), 3, 3), "660 windows over more than 132 blocks: uneven runs"),
    ((2, 7, 14, 128, 8, (7, 7), 0, 3), "head width 16, 4 windows"),
    ((1, 7, 7, 2048, 32, (7, 7), 0, 0), "head width 64, one window: fewer windows than blocks"),
    ((3, 21, 14, 192, 3, (7, 7), 2, 3), "head width 64, sh != sw"),
    ((2, 16, 24, 128, 4, (8, 8), 4, 3), "8 x 8 window: 64 tokens, eight key tiles"),
    ((3, 8, 12, 64, 2, (4, 4), 2, 2), "4 x 4 window: one band of rows"),
    ((2, 10, 15, 96, 2, (5, 5), 2, 2), "head width 48: the wmma kernels"),
    ((2, 14, 14, 48, 2, (7, 7), 3, 3), "head width 24: the CUDA-core kernels"),
]


def check_attention_corners(fwa, wa, gen, corners=ATTENTION_CORNERS, timed=False) -> None:
    """Forward and backward against the plain versions, float32 and
    bfloat16, at shapes on every boundary of the kernels' launch plan and
    templates; ``ctx``, ``dqkv`` and ``dbias`` of two launches must have
    equal bits.  A case may name the family (``ROUTE_NAMES``) each type must
    take.  ``timed``: each shape's bf16 forward and backward also by CUDA
    events and device time, beside its bound, the plain versions and one
    ``scaled_dot_product_attention`` call (forward, then backward); a tiled
    ``mma.sync`` kernel must be no slower than its plain version."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (b, hp, wp, dim, heads, (wh, ww), sh, sw), why, *names in corners:
        n, n_win, hd = wh * ww, (hp // wh) * (wp // ww), dim // heads
        kw = dict(wh=wh, ww=ww, heads=heads, sh=sh, sw=sw)
        qkv32 = torch.randn((b, hp, wp, 3 * dim), generator=gen, device="cuda")
        d32 = torch.randn((b, hp, wp, dim), generator=gen, device="cuda")
        bias = torch.randn((heads, n, n), generator=gen, device="cuda")
        for dt in ("f32", "bf16"):
            qkv, d = (qkv32, d32) if dt == "f32" else (qkv32.bfloat16(), d32.bfloat16())
            route = fwa.kernel_route(qkv.dtype, hd, n, sh < wh and sw < ww)
            if names and fwa.ROUTE_NAMES[route] != names[0][dt]:
                raise AssertionError(f"attention {why} {dt}: route {fwa.ROUTE_NAMES[route]}, "
                                     f"not {names[0][dt]}")
            plan = (fwa.fwd_plan(route, b, n_win, heads, n, sms, hd),
                    *fwa.bwd_plan(route, b, n_win, heads, n, sms, hd))
            label = (f"qkv{tuple(qkv.shape)} window {(wh, ww)} heads {heads} shift {(sh, sw)} "
                     f"{dt} (route {route}, forward blocks per head {plan[0]}, backward plan "
                     f"{plan[1]} with partials {plan[2]}; {why})")
            ctx = fwa.window_attention(qkv, bias, **kw)
            got = fwa.window_attention_bwd(qkv, d, bias, **kw)
            rels = {"window_attention": rel_err(
                ctx, fwa.window_attention_reference(qkv, bias, **kw))[1]}
            _, rels["window_attention_bwd"] = multi_err(
                label, got, fwa.window_attention_bwd_reference(qkv, d, bias, **kw),
                ("dqkv", "dbias"))
            again = (fwa.window_attention(qkv, bias, **kw),
                     *fwa.window_attention_bwd(qkv, d, bias, **kw))
            if not all(torch.equal(x, y) for x, y in zip((ctx, *got), again)):
                raise AssertionError(f"attention {label}: a repeated call gave other bits")
            for name, rel in rels.items():
                print(f"  {name} {label}: rel {rel:.3e} (tol {TOL[name][dt]:g})")
                if not rel <= TOL[name][dt]:
                    raise AssertionError(f"{name} {label}: {rel:.3e} > {TOL[name][dt]:g}")
        if not timed:
            continue
        qkv, d = qkv32.bfloat16(), d32.bfloat16()
        fwd = lambda: fwa.window_attention(qkv, bias, **kw)  # noqa: E731
        bwd = lambda: fwa.window_attention_bwd(qkv, d, bias, **kw)  # noqa: E731
        part, mask = sdpa_operands(wa, qkv, bias, wh, ww, heads, sh, sw)
        q, k, v = (t.detach().requires_grad_() for t in part)
        mask.requires_grad_()
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        dout = torch.randn_like(out)
        flops = 2.0 * b * n_win * heads * n * n * hd
        held = fwa.kernel_route(qkv.dtype, hd, n) == fwa.ROUTE_TILED_MMA
        for what, run, plain, lib, n_bytes, ops in (
                ("forward", fwd, lambda: fwa.window_attention_reference(qkv, bias, **kw),
                 lambda: F.scaled_dot_product_attention(part[0], part[1], part[2],
                                                        attn_mask=mask.detach()),
                 nbytes(qkv, bias) + qkv.numel() // 3 * 2, 2 * flops),
                ("backward", bwd,
                 lambda: fwa.window_attention_bwd_reference(qkv, d, bias, **kw),
                 lambda: torch.autograd.grad(out, (q, k, v, mask), dout, retain_graph=True),
                 nbytes(qkv, d, bias) + qkv.numel() * 2 + bias.numel() * 4, 5 * flops)):
            b_ms, by = bound_ms(n_bytes, ops)
            ms, plain_ms = cuda_ms(run, 5), cuda_ms(plain, 2)
            print(f"  window attention {what} qkv{tuple(qkv.shape)} window {(wh, ww)} bf16: "
                  f"kernel_ms {ms:.4f} device_ms {device_ms(run):.4f} plain_ms "
                  f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({by}) library_ms "
                  f"{cuda_ms(lib, 5):.4f}")
            if held and ms > plain_ms:
                raise AssertionError(f"window attention {what} {why}: kernel {ms:.4f} ms "
                                     f"slower than plain {plain_ms:.4f} ms")
        del out


def check_attention_bwd(fwa, wa, gen, stages=STAGES, rep=None, main_path=True, ws=7,
                        route=None) -> KernelReport:
    """``main_path`` False: another width's shapes, checked and timed with
    count 0 and no yardstick.  ``ws``: the window; ``route``: the kernel
    family every shape must take in each type (``{"f32": .., "bf16": ..}``)."""
    rep = rep or KernelReport("window_attention_bwd", "fused_window_attention.cu",
                              "fused_window_attention.py:597")
    n = ws * ws
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for stage, hp, wp, sh, sw in stage_shapes(wa, ws):
        dim, heads, _, blocks = stages[stage]
        hd = dim // heads
        kw = dict(wh=ws, ww=ws, heads=heads, sh=sh, sw=sw)
        qkv32 = torch.randn((B, hp, wp, 3 * dim), generator=gen, device="cuda")
        d32 = torch.randn((B, hp, wp, dim), generator=gen, device="cuda")
        table = torch.randn(((2 * ws - 1) ** 2, heads), generator=gen, device="cuda")
        bias = wa.gather_bias(table, ws, ws, heads).float().contiguous()
        label = f"qkv{tuple(qkv32.shape)} shift{(sh, sw)}"
        errs = {}
        for dt in ("f32", "bf16"):
            qkv, d = (qkv32, d32) if dt == "f32" else (qkv32.bfloat16(), d32.bfloat16())
            if route is not None and fwa.kernel_route(qkv.dtype, hd, n) != route[dt]:
                raise AssertionError(f"{rep.row['name']} {label} {dt}: not route {route[dt]}")
            got = fwa.window_attention_bwd(qkv, d, bias, **kw)
            errs[dt] = multi_err(f"{label} {dt}", got,
                                 fwa.window_attention_bwd_reference(qkv, d, bias, **kw),
                                 ("dqkv", "dbias"))
            # the bias-gradient partials are summed in a fixed order
            if not all(torch.equal(a, b) for a, b in zip(
                    got, fwa.window_attention_bwd(qkv, d, bias, **kw))):
                raise AssertionError(f"{rep.row['name']} {label} {dt}: a repeated call "
                                     "gave other bits")
        qkv, d = qkv32.bfloat16(), d32.bfloat16()
        run = lambda: fwa.window_attention_bwd(qkv, d, bias, **kw)  # noqa: E731
        ms = cuda_ms(run, 10)
        plain = cuda_ms(lambda: fwa.window_attention_bwd_reference(qkv, d, bias, **kw), 2)
        n_win = B * (hp // ws) * (wp // ws)
        n_bytes = nbytes(qkv, d, bias) + qkv.numel() * 2 + bias.numel() * 4
        b_ms, by = bound_ms(n_bytes, 10.0 * n_win * heads * n * n * hd)
        attention_device_times(rep, label, run, n_bytes, flush,
                               blocks // 2 if main_path else 0)
        if not main_path:
            rep.add(f"{label} (Swin-T)", 0, errs, ms, plain, b_ms, by, t_count=blocks // 2)
            continue
        # yardstick: the backward of one SDPA call on pre-partitioned
        # (B, nW, heads, N, hd) with the bias (+ shift mask) as attn_mask
        part, mask = sdpa_operands(wa, qkv, bias, ws, ws, heads, sh, sw)
        mask.requires_grad_()
        q, k, v = (t.detach().requires_grad_() for t in part)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        dout = torch.randn_like(out)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v, mask), dout,
                                                  retain_graph=True), 5)
        del out
        rep.add(label, blocks // 2, errs, ms, plain, b_ms, by, lib)
    return rep


def refine_inputs(gen, batch, ht=IMG // 4, wt=IMG // 4):
    c = 128
    y32 = torch.randn((batch, ht, wt, 16 * c), generator=gen, device="cuda") * 0.5
    p = [torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.03,
         0.1 * torch.randn(c, generator=gen, device="cuda"),
         torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.03,
         0.1 * torch.randn(c, generator=gen, device="cuda"),
         1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
         0.1 * torch.randn(c, generator=gen, device="cuda")]
    return y32, p


BWD_NAMES = ("dy", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta")
# shapes whose conv tiles (8 x 16 pixels in bfloat16, 64-pixel row segments
# in float32), LayerNorm blocks and weight-gradient chunks are all ragged
RAGGED = [(3, 13, 21), (1, 5, 3)]


def check_refine_train(frh, gen) -> tuple:
    """The training forward (out, pre, a2) and the backward (dy and the six
    parameter gradients) against their plain versions."""
    res = KernelReport("refine_head_res", "fused_refine_head.cu", "fused_refine_head.py:455")
    bwd = KernelReport("refine_head_bwd", "fused_refine_head.cu", "fused_refine_head.py:494")
    c = 128
    y32, p = refine_inputs(gen, B)
    fwd_errs, bwd_errs, saved = {}, {}, {}
    for dt in ("f32", "bf16"):
        y = y32 if dt == "f32" else y32.bfloat16()
        got = frh._fwd_kernel(y, frh._prep(y, *p), True)
        want = frh.refine_head_res_reference(y, *p)
        fwd_errs[dt] = multi_err(f"res fwd {dt}", got, want, ("out", "pre", "a2"))
        _, pre, a2 = want
        dout = torch.randn(pre.shape, generator=gen, device="cuda").to(y.dtype)
        del got, want
        torch.cuda.empty_cache()
        args = (y, pre, a2, dout, p[0], p[2], p[4])
        got = frh._bwd_kernel(*args)
        bwd_errs[dt] = multi_err(f"bwd {dt}", got, frh.refine_head_bwd_reference(*args),
                                 BWD_NAMES)
        # every cross-block sum is taken in a fixed order
        if not all(torch.equal(a, b) for a, b in zip(got, frh._bwd_kernel(*args))):
            raise AssertionError(f"refine_head_bwd {dt}: a repeated call gave other bits")
        del got
        saved[dt] = args
        torch.cuda.empty_cache()
    y, pre, a2, dout = saved["bf16"][:4]
    del saved
    prm = frh._prep(y, *p)
    ms_f = cuda_ms(lambda: frh._fwd_kernel(y, prm, True), 3)
    plain_f = cuda_ms(lambda: frh.refine_head_res_reference(y, *p), 2)
    args = (y, pre, a2, dout, p[0], p[2], p[4])
    ms_b = cuda_ms(lambda: frh._bwd_kernel(*args), 3)
    plain_b = cuda_ms(lambda: frh.refine_head_bwd_reference(*args), 2)
    pix = B * IMG * IMG
    conv = 2.0 * pix * c * 9 * c
    res_bytes = 2 * (y.numel() + 3 * pix * c + 2 * 9 * c * c + 2 * c) + 8 * c
    b_f, by_f = bound_ms(res_bytes, 2 * conv)
    bwd_bytes = 2 * (2 * y.numel() + 3 * pix * c + 2 * 9 * c * c) + 4 * (2 * 9 * c * c + 5 * c)
    b_b, by_b = bound_ms(bwd_bytes, 4 * conv)
    res.add(f"y{tuple(y.shape)}", 1, fwd_errs, ms_f, plain_f, b_f, by_f)
    bwd.add(f"y{tuple(y.shape)}", 1, bwd_errs, ms_b, plain_b, b_b, by_b)
    for what, fn in (("training forward", lambda: frh._fwd_kernel(y, prm, True)),
                     ("backward", lambda: frh._bwd_kernel(*args))):
        print(f"  refine head {what} bf16 by part (one call, profiler):")
        for part_ms, count, key in kernel_times(fn):
            if "ssa::" in key:
                print(f"    {part_ms:8.4f} ms x{count} {key[:70]}")
    # context, not a yardstick: no single PyTorch call computes the head;
    # the composed cuDNN path (GELU, depth-to-space, two convs, LayerNorm)
    # forward + backward in bf16
    w = [t.bfloat16().requires_grad_() for t in p]
    yy = y.detach().requires_grad_()

    def composed_fwd():
        x = F.gelu(yy.float(), approximate="tanh").bfloat16()
        x = x.reshape(B, IMG // 4, IMG // 4, 4, 4, c).permute(0, 5, 1, 3, 2, 4).reshape(
            B, c, IMG, IMG)
        x = F.gelu(F.conv2d(x, w[0], w[1], padding=1), approximate="tanh")
        x = F.conv2d(x, w[2], w[3], padding=1).permute(0, 2, 3, 1)
        return F.layer_norm(x, (c,), w[4], w[5])

    def composed_fwd_alone():
        with torch.no_grad():
            composed_fwd()

    both = cuda_ms(lambda: torch.autograd.grad(composed_fwd(), (yy, *w), dout), 3)
    print(f"  refine head composed cuDNN path (context): fwd alone "
          f"{cuda_ms(composed_fwd_alone, 3):.4f} ms, fwd+bwd {both:.4f} ms; "
          f"kernels fwd+bwd {ms_f + ms_b:.4f} ms against a bound of {b_f + b_b:.4f} ms")
    return res, bwd


def check_refine_ragged(frh, gen) -> None:
    """Inference forward, training forward, backward and a repeated
    backward's bits at the ragged shapes, against the plain versions."""
    for shape in RAGGED:
        y32, p = refine_inputs(gen, *shape)
        for dt in ("f32", "bf16"):
            y = y32 if dt == "f32" else y32.bfloat16()
            label = f"y{tuple(y.shape)} {dt}"
            want = frh.refine_head_res_reference(y, *p)
            rels = {"refine_head": rel_err(frh.fused_refine_head(y, *p), want[0])[1]}
            _, rels["refine_head_res"] = multi_err(
                f"res fwd {label}", frh._fwd_kernel(y, frh._prep(y, *p), True), want,
                ("out", "pre", "a2"))
            _, pre, a2 = want
            dout = torch.randn(pre.shape, generator=gen, device="cuda").to(y.dtype)
            args = (y, pre, a2, dout, p[0], p[2], p[4])
            got = frh._bwd_kernel(*args)
            _, rels["refine_head_bwd"] = multi_err(
                f"bwd {label}", got, frh.refine_head_bwd_reference(*args), BWD_NAMES)
            if not all(torch.equal(a, b) for a, b in zip(got, frh._bwd_kernel(*args))):
                raise AssertionError(f"refine_head_bwd {label}: a repeated call gave other bits")
            for name, rel in rels.items():
                print(f"  {name} {label}: rel {rel:.3e} (tol {TOL[name][dt]:g})")
                if not rel <= TOL[name][dt]:
                    raise AssertionError(f"{name} {label}: {rel:.3e} > {TOL[name][dt]:g}")


def check_plain_backwards(fwa, frh, fp, fh, wa, gen) -> None:
    """The plain backwards against torch.autograd of the plain forwards, f32."""
    dim, heads = STAGES[0][:2]
    _, hp, wp, sh, sw = next(s for s in stage_shapes(wa) if s[0] == 0 and s[3])
    kw = dict(wh=7, ww=7, heads=heads, sh=sh, sw=sw)
    qkv = torch.randn((B, hp, wp, 3 * dim), generator=gen, device="cuda").requires_grad_()
    bias = (0.1 * torch.randn((heads, 49, 49), generator=gen, device="cuda")).requires_grad_()
    out = fwa.window_attention_reference(qkv, bias, **kw)
    d = torch.randn_like(out)
    want = torch.autograd.grad(out, (qkv, bias), d)
    got = fwa.window_attention_bwd_reference(qkv.detach(), d, bias.detach(), **kw)
    _, rel = multi_err("attention plain bwd vs autograd f32", got, want, ("dqkv", "dbias"))
    if rel > AUTOGRAD_TOL:
        raise AssertionError(f"attention plain backward: {rel:.3e} > {AUTOGRAD_TOL:g}")
    del qkv, out, d, want, got
    y, p = refine_inputs(gen, 2)
    y.requires_grad_()
    for t in p:
        t.requires_grad_()
    out, pre, a2 = frh.refine_head_res_reference(y, *p)
    d = torch.randn_like(out)
    want = torch.autograd.grad(out, (y, *p), d)
    got = frh.refine_head_bwd_reference(y.detach(), pre.detach(), a2.detach(), d,
                                        p[0].detach(), p[2].detach(), p[4].detach())
    _, rel = multi_err("refine plain bwd vs autograd f32 (b2)", got, want,
                       ("dy", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta"))
    if rel > AUTOGRAD_TOL:
        raise AssertionError(f"refine plain backward: {rel:.3e} > {AUTOGRAD_TOL:g}")
    del y, p, out, pre, a2, d, want, got
    for is_merge, shape in ((True, (2, 64, 64, 96)), (False, (2, 32, 32, 384))):
        x, w, sc, lb, dy = patch_inputs(gen, shape, is_merge)
        t = [x, sc, lb, w] if is_merge else [x, w, sc, lb]
        for v in t:
            v.requires_grad_()
        out = (fp.patch_merge_reference if is_merge else fp.patch_expand_reference)(*t)
        want = torch.autograd.grad(out, t, dy)
        if is_merge:
            got = fp.patch_merge_bwd_reference(x.detach(), dy, sc.detach(), lb.detach(),
                                               w.detach())
            names = ("dx", "dscale", "dbias", "dweight")
        else:
            got = fp.patch_expand_bwd_reference(x.detach(), dy, w.detach(), sc.detach())
            names = ("dx", "dweight", "dscale", "dbias")
        what = "merge" if is_merge else "expand"
        _, rel = multi_err(f"{what} plain bwd vs autograd f32 {shape}", got, want, names)
        if rel > AUTOGRAD_TOL:
            raise AssertionError(f"{what} plain backward: {rel:.3e} > {AUTOGRAD_TOL:g}")
    x = torch.randn((2, 32, 32, 16 * 96), generator=gen, device="cuda").requires_grad_()
    out = fh.gelu_d2s4_reference(x)
    d = torch.randn_like(out)
    want = torch.autograd.grad(out, x, d)
    got = (fh.gelu_d2s4_bwd_reference(x.detach(), d),)
    _, rel = multi_err("gelu+d2s plain bwd vs autograd f32", got, want, ("dx",))
    if rel > AUTOGRAD_TOL:
        raise AssertionError(f"gelu+d2s plain backward: {rel:.3e} > {AUTOGRAD_TOL:g}")


def check_attention(fwa, wa, gen, stages=STAGES, rep=None, main_path=True, ws=7,
                    route=None) -> KernelReport:
    """``main_path`` False: another width's shapes, checked and timed with
    count 0 and no yardstick.  ``ws``: the window; ``route``: the kernel
    family every shape must take in each type (``{"f32": .., "bf16": ..}``)."""
    rep = rep or KernelReport("window_attention", "fused_window_attention.cu",
                              "fused_window_attention.py:561")
    n = ws * ws
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for stage, hp, wp, sh, sw in stage_shapes(wa, ws):
        dim, heads, blocks, _ = stages[stage]
        hd = dim // heads
        kw = dict(wh=ws, ww=ws, heads=heads, sh=sh, sw=sw)
        qkv32 = torch.randn((B, hp, wp, 3 * dim), generator=gen, device="cuda")
        table = torch.randn(((2 * ws - 1) ** 2, heads), generator=gen, device="cuda")
        bias = wa.gather_bias(table, ws, ws, heads).float().contiguous()
        errs = {}
        for dt, qkv in (("f32", qkv32), ("bf16", qkv32.to(torch.bfloat16))):
            if route is not None and fwa.kernel_route(qkv.dtype, hd, n) != route[dt]:
                raise AssertionError(f"{rep.row['name']} {tuple(qkv.shape)} {dt}: not route "
                                     f"{route[dt]}")
            got = fwa.window_attention(qkv, bias, **kw)
            errs[dt] = rel_err(got, fwa.window_attention_reference(qkv, bias, **kw))
            # nothing in the kernel depends on the order blocks run in
            if not torch.equal(got, fwa.window_attention(qkv, bias, **kw)):
                raise AssertionError(f"{rep.row['name']} {dt}: a repeated call gave other "
                                     "bits")
        qkv = qkv32.to(torch.bfloat16)
        run = lambda: fwa.window_attention(qkv, bias, **kw)  # noqa: E731
        ms = cuda_ms(run, 20)
        plain = cuda_ms(lambda: fwa.window_attention_reference(qkv, bias, **kw), 3)
        n_bytes = nbytes(qkv, bias) + qkv.numel() // 3 * 2
        b_ms, by = bound_ms(n_bytes, 4.0 * B * (hp // ws) * (wp // ws) * heads * n * n * hd)
        label = f"qkv{tuple(qkv.shape)} shift{(sh, sw)}"
        attention_device_times(rep, label, run, n_bytes, flush,
                               blocks // 2 if main_path else 0)
        if not main_path:
            rep.add(f"{label} (Swin-T)", 0, errs, ms, plain, b_ms, by, t_count=blocks // 2)
            continue
        # yardstick: one SDPA call on pre-partitioned (B, nW, heads, N, hd)
        part, mask = sdpa_operands(wa, qkv, bias, ws, ws, heads, sh, sw)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            part[0], part[1], part[2], attn_mask=mask), 20)
        rep.add(label, blocks // 2, errs, ms, plain, b_ms, by, lib)
    return rep


def patch_inputs(gen, shape, is_merge):
    """x, torch-layout weight, LN scale/bias and a cotangent for one merge
    or expand at ``shape``, float32."""
    b, h, w, c = shape
    x32 = torch.randn(shape, generator=gen, device="cuda")
    wt = torch.randn((2 * c, 4 * c) if is_merge else (2 * c, c), generator=gen,
                     device="cuda") * 0.05
    ln = 4 * c if is_merge else c // 2
    sc = 1 + 0.1 * torch.randn(ln, generator=gen, device="cuda")
    lb = 0.1 * torch.randn(ln, generator=gen, device="cuda")
    dy_shape = (b, h // 2, w // 2, 2 * c) if is_merge else (b, 2 * h, 2 * w, c // 2)
    dy32 = torch.randn(dy_shape, generator=gen, device="cuda")
    return x32, wt, sc, lb, dy32


# (shape, launches per forward or step on the Swin-B main path, on the
# Swin-T path) of the merges and expands
MERGE_CASES = [((B, 128, 128, 128), 1, 0), ((B, 64, 64, 256), 1, 0), ((B, 32, 32, 512), 1, 0),
               ((B, 128, 128, 96), 0, 1), ((B, 64, 64, 192), 0, 1), ((B, 32, 32, 384), 0, 1)]
EXPAND_CASES = [((B, 16, 16, 1024), 1, 0), ((B, 32, 32, 512), 2, 0), ((B, 64, 64, 256), 3, 0),
                ((B, 16, 16, 768), 0, 1), ((B, 32, 32, 384), 0, 2), ((B, 64, 64, 192), 0, 3)]


def _swin_t(shape, count):
    return f"x{shape}" + ("" if count else " (Swin-T)")


@contextlib.contextmanager
def at(label):
    """Re-raise any error inside with ``label`` (the shape) in front."""
    try:
        yield
    except Exception as e:
        raise RuntimeError(f"{label}: {type(e).__name__}: {e}") from e


STRESS_CALLS = 50


def check_patch(fp, gen) -> tuple:
    """The merge and expand forwards against their plain versions at the
    predict paths' shapes, f32 (the CUDA-core kernels) and bf16 (the
    tensor-core kernels at every Swin-B and Swin-T width): a repeated call's
    bits in both, ``STRESS_CALLS`` back-to-back bf16 calls each equal in bits
    to the first, and the bf16 calls timed by CUDA events, by the profiler's
    device time (warm and with the L2 emptied first) and part by part,
    beside the product as a bf16 ``torch.matmul`` call (context: the port
    never calls it)."""
    merge = KernelReport("patch_merge", "fused_patch.cu", "fused_patch.py:206")
    expand = KernelReport("patch_expand", "fused_patch.cu", "fused_patch.py:357")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for rep, cases in ((merge, MERGE_CASES), (expand, EXPAND_CASES)):
        is_merge = rep is merge
        name = rep.row["name"]
        for shape, count, t_count in cases:
            c = shape[-1]
            label = _swin_t(shape, count)
            x32, w, sc, lb, _ = patch_inputs(gen, shape, is_merge)
            if is_merge:
                run = lambda x: fp.fused_patch_merge(x, sc, lb, w)  # noqa: E731
                plain = lambda x: fp.patch_merge_reference(x, sc, lb, w)  # noqa: E731
                route = fp.merge_route
            else:
                run = lambda x: fp.fused_patch_expand(x, w, sc, lb)  # noqa: E731
                plain = lambda x: fp.patch_expand_reference(x, w, sc, lb)  # noqa: E731
                route = fp.expand_route
            errs = {}
            with at(f"{name} {label}"):
                for dt, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
                    got = run(x)
                    errs[dt] = rel_err(got, plain(x))
                    if not torch.equal(got, run(x)):
                        raise AssertionError(f"{name} {label} {dt}: a repeated call gave "
                                             "other bits")
                x = x32.to(torch.bfloat16)
                outs = [run(x) for _ in range(STRESS_CALLS)]
                bad = [i for i, o in enumerate(outs) if not torch.equal(o, outs[0])]
                if bad:
                    raise AssertionError(f"{name} {label} bf16: calls {bad} of "
                                         f"{STRESS_CALLS} back to back differ in bits "
                                         "from the first")
                del outs
                ms = cuda_ms(lambda: run(x), 20)
                plain_ms = cuda_ms(lambda: plain(x), 3)
                k, n = (4 * c, 2 * c) if is_merge else (c, 2 * c)
                m = x.numel() // k  # GEMM rows
                out_numel = m * n if is_merge else 2 * x.numel()
                ln = 4 * c if is_merge else c // 2
                flops = 2.0 * m * k * n
                b_ms, by = bound_ms(2 * (x.numel() + out_numel + k * n) + 8 * ln, flops)
                dev = device_ms(lambda: run(x))
                cold = device_ms(lambda: run(x), flush=flush)
                parts, n_launch = patch_parts(lambda: run(x))
                # context: the same product as one bf16 torch.matmul call
                a_mk = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
                wk = w.bfloat16().t()
                mm = cuda_ms(lambda: a_mk @ wk, 20)
                del a_mk
            print(f"  {name} {label}: route {route(x.dtype, c)}, device_ms {dev:.4f} "
                  f"({flops / dev / 1e9:.0f} TFLOP/s of {BF16_FLOP_PER_S / 1e12:.0f}), "
                  f"cold-L2 device_ms {cold:.4f}, {n_launch} CUDA launches a call; by part: "
                  f"{', '.join(parts)}; bf16 torch.matmul of the same product (context) "
                  f"{mm:.4f} ms; {STRESS_CALLS} back-to-back calls equal in bits")
            rep.extra(count, device_ms=dev, cold_l2_device_ms=cold, matmul_context_ms=mm)
            rep.add(label, count, errs, ms, plain_ms, b_ms, by, t_count=t_count)
    return merge, expand


# (is merge, shape, why) of the patch forward corner cases: rows ragged
# against the tensor-core kernels' row and product tiles, and widths the
# routing sends to the CUDA-core kernels
PATCH_FWD_CORNERS = [
    (True, (1, 6, 10, 128), "15 merged rows"),
    (True, (1, 2, 2, 512), "one merged row, 4C = 2048"),
    (True, (1, 4, 4, 48), "C = 48: the CUDA-core kernel"),
    (False, (1, 3, 5, 256), "15 rows"),
    (False, (1, 1, 1, 1024), "one row, C/2 = 512"),
    (False, (1, 2, 2, 128), "C/2 = 64: the CUDA-core kernel"),
]


def check_patch_fwd_corners(fp, gen) -> None:
    """Both forwards against their plain versions in float32 and bfloat16
    at ``PATCH_FWD_CORNERS``, with equal bits on a repeated call."""
    worst = {"patch_merge": 0.0, "patch_expand": 0.0}
    for is_merge, shape, why in PATCH_FWD_CORNERS:
        x32, w, sc, lb, _ = patch_inputs(gen, shape, is_merge)
        if is_merge:
            name, route = "patch_merge", fp.merge_route
            run = lambda x: fp.fused_patch_merge(x, sc, lb, w)  # noqa: E731
            plain = lambda x: fp.patch_merge_reference(x, sc, lb, w)  # noqa: E731
        else:
            name, route = "patch_expand", fp.expand_route
            run = lambda x: fp.fused_patch_expand(x, w, sc, lb)  # noqa: E731
            plain = lambda x: fp.patch_expand_reference(x, w, sc, lb)  # noqa: E731
        for dt in ("f32", "bf16"):
            x = x32 if dt == "f32" else x32.bfloat16()
            label = f"x{shape} {dt} (route {route(x.dtype, shape[-1])}; {why})"
            with at(f"{name} {label}"):
                got = run(x)
                _, rel = rel_err(got, plain(x))
                if not torch.equal(got, run(x)):
                    raise AssertionError(f"{name} {label}: a repeated call gave other bits")
            print(f"  {name} {label}: rel {rel:.3e} (tol {TOL[name][dt]:g}), repeat equal "
                  "in bits")
            if not rel <= TOL[name][dt]:
                raise AssertionError(f"{name} {label}: {rel:.3e} > {TOL[name][dt]:g}")
            if dt == "bf16":
                worst[name] = max(worst[name], rel)
    print("  patch forward corners, largest bf16 rel error: " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))


# what each CUDA kernel of a patch call does, by name
PATCH_PARTS = (("mma_ab_round", "product"), ("mma_atb_partial", "split-K dW product"),
               ("expand_dz_mma", "product + LN epilogue"), ("merge_rows_mma", "row pass"),
               ("merge_ln_rows", "row pass (n)"), ("expand_ln_rows", "row pass (LN, scatter)"),
               ("sum_jobs", "fixed-order sums"), ("_fwd_kernel", "CUDA-core kernel"))


def patch_parts(run) -> tuple:
    """Device ms of each CUDA kernel of one call (profiler) and the number
    of CUDA launches the call makes."""
    parts, launches = [], 0
    for ms, count, key in kernel_times(run):
        if "ssa::" not in key:
            continue
        launches += count
        what = next((w for k, w in PATCH_PARTS if k in key), key[:40])
        parts.append(f"{what} {ms:.4f}")
    return parts, launches


def check_patch_bwd(fp, gen) -> tuple:
    """The merge and expand backward kernels (dx and the three parameter
    gradients) against their plain versions, and against themselves on a
    repeated call (equal bits), at both widths; the bf16 calls timed by
    CUDA events, by the profiler's device time (warm and with the L2
    emptied first) and part by part, beside the same products as bf16
    ``torch.matmul`` calls (context: the port never calls them)."""
    merge = KernelReport("patch_merge_bwd", "fused_patch_bwd.cu", "fused_patch.py:227")
    expand = KernelReport("patch_expand_bwd", "fused_patch_bwd.cu", "fused_patch.py:378")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for rep, cases in ((merge, MERGE_CASES), (expand, EXPAND_CASES)):
        is_merge = rep is merge
        for shape, count, t_count in cases:
            c = shape[-1]
            x32, w, sc, lb, dy32 = patch_inputs(gen, shape, is_merge)
            if is_merge:
                run = lambda x, d: fp.patch_merge_bwd(x, d, sc, lb, w)  # noqa: E731
                plain = lambda x, d: fp.patch_merge_bwd_reference(x, d, sc, lb, w)  # noqa: E731
                names = ("dx", "dscale", "dbias", "dweight")
            else:
                run = lambda x, d: fp.patch_expand_bwd(x, d, w, sc)  # noqa: E731
                plain = lambda x, d: fp.patch_expand_bwd_reference(x, d, w, sc)  # noqa: E731
                names = ("dx", "dweight", "dscale", "dbias")
            label = _swin_t(shape, count)
            errs = {}
            for dt in ("f32", "bf16"):
                x, d = (x32, dy32) if dt == "f32" else (x32.bfloat16(), dy32.bfloat16())
                got = run(x, d)
                errs[dt] = multi_err(f"{label} {dt}", got, plain(x, d), names)
                # the parameter gradients are summed in a fixed order: a
                # second call gives the same bits
                if not all(torch.equal(a, b) for a, b in zip(got, run(x, d))):
                    raise AssertionError(f"{rep.row['name']} {label} {dt}: a repeated "
                                         "call gave other bits")
            x, d = x32.bfloat16(), dy32.bfloat16()
            ms = cuda_ms(lambda: run(x, d), 10)
            plain_ms = cuda_ms(lambda: plain(x, d), 3)
            k, n = (4 * c, 2 * c) if is_merge else (c, 2 * c)
            m = x.numel() // k if is_merge else x.numel() // c
            ln = 4 * c if is_merge else c // 2
            # x, dy and the weight read once; dx, the float32 dW and the two
            # float32 LN-parameter gradients written once; merge does two
            # products of 2*m*k*n, expand three of 2*m*c*2c
            n_bytes = 2 * (2 * x.numel() + d.numel() + k * n) + 4 * k * n + 4 * (2 + 2) * ln
            flops = (2 if is_merge else 3) * 2.0 * m * k * n
            b_ms, by = bound_ms(n_bytes, flops)
            dev = device_ms(lambda: run(x, d))
            cold = device_ms(lambda: run(x, d), flush=flush)
            parts, n_launch = patch_parts(lambda: run(x, d))
            # context: the same products as bf16 torch.matmul calls
            wt = w.bfloat16()
            a_mk = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            b_mn = torch.randn((m, n), generator=gen, device="cuda").bfloat16()
            prods = ([lambda: b_mn @ wt, lambda: a_mk.t() @ b_mn] if is_merge else
                     [lambda: a_mk @ wt.t(), lambda: a_mk.t() @ b_mn, lambda: b_mn @ wt])
            mm = cuda_ms(lambda: [p() for p in prods], 10)
            del a_mk, b_mn
            print(f"  {rep.row['name']} {label}: device_ms {dev:.4f} ({flops / dev / 1e9:.0f} "
                  f"TFLOP/s of {BF16_FLOP_PER_S / 1e12:.0f}), cold-L2 device_ms {cold:.4f}, "
                  f"{n_launch} CUDA launches a call; by part: {', '.join(parts)}; bf16 "
                  f"torch.matmul of the same {len(prods)} products (context) {mm:.4f} ms")
            rep.extra(count, device_ms=dev, cold_l2_device_ms=cold, matmul_context_ms=mm)
            rep.add(label, count, errs, ms, plain_ms, b_ms, by, t_count=t_count)
    return merge, expand


# (shape, why) of the patch backward corner cases: rows ragged against the
# tensor-core kernels' row tiles and split-K chunks, and widths the routing
# sends to the CUDA-core kernels
PATCH_BWD_CORNERS = [
    (True, (1, 6, 10, 128), "15 merged rows"),
    (True, (1, 2, 2, 512), "one merged row, 4C = 2048"),
    (True, (1, 4, 4, 48), "C = 48: the CUDA-core kernels"),
    (False, (1, 3, 5, 256), "15 rows"),
    (False, (1, 1, 1, 1024), "one row, C/2 = 512"),
    (False, (1, 2, 2, 128), "C/2 = 64: the CUDA-core kernels"),
]


def check_patch_bwd_corners(fp, gen) -> None:
    """Both backwards against their plain versions in float32 and bfloat16
    at ``PATCH_BWD_CORNERS``, with equal bits on a repeated call."""
    for is_merge, shape, why in PATCH_BWD_CORNERS:
        x32, w, sc, lb, dy32 = patch_inputs(gen, shape, is_merge)
        if is_merge:
            name, route = "patch_merge_bwd", fp.merge_route
            run = lambda x, d: fp.patch_merge_bwd(x, d, sc, lb, w)  # noqa: E731
            plain = lambda x, d: fp.patch_merge_bwd_reference(x, d, sc, lb, w)  # noqa: E731
        else:
            name, route = "patch_expand_bwd", fp.expand_route
            run = lambda x, d: fp.patch_expand_bwd(x, d, w, sc)  # noqa: E731
            plain = lambda x, d: fp.patch_expand_bwd_reference(x, d, w, sc)  # noqa: E731
        for dt in ("f32", "bf16"):
            x, d = (x32, dy32) if dt == "f32" else (x32.bfloat16(), dy32.bfloat16())
            label = f"x{shape} {dt} (route {route(x.dtype, shape[-1])}; {why})"
            got = run(x, d)
            _, rel = multi_err(label, got, plain(x, d), ("0", "1", "2", "3"))
            if not all(torch.equal(a, b) for a, b in zip(got, run(x, d))):
                raise AssertionError(f"{name} {label}: a repeated call gave other bits")
            print(f"  {name} {label}: rel {rel:.3e} (tol {TOL[name][dt]:g})")
            if not rel <= TOL[name][dt]:
                raise AssertionError(f"{name} {label}: {rel:.3e} > {TOL[name][dt]:g}")


def check_gelu_d2s4(fh, gen) -> tuple:
    """The GELU+depth-to-space forward and backward kernels at the Swin-T
    head's shape (8, 128, 128, 16 * 96)."""
    fwd = KernelReport("gelu_d2s4", "fused_head.cu", "fused_head.py:85")
    bwd = KernelReport("gelu_d2s4_bwd", "fused_head.cu", "fused_head.py:104")
    c, ht = 96, IMG // 4
    x32 = torch.randn((B, ht, ht, 16 * c), generator=gen, device="cuda")
    g32 = torch.randn((B, IMG, IMG, c), generator=gen, device="cuda")
    f_errs, b_errs = {}, {}
    for dt in ("f32", "bf16"):
        x, g = (x32, g32) if dt == "f32" else (x32.bfloat16(), g32.bfloat16())
        f_errs[dt] = rel_err(fh.gelu_d2s4_fwd(x), fh.gelu_d2s4_reference(x))
        b_errs[dt] = rel_err(fh.gelu_d2s4_bwd(x, g), fh.gelu_d2s4_bwd_reference(x, g))
    x, g = x32.bfloat16(), g32.bfloat16()
    del x32, g32
    label = f"x{tuple(x.shape)}"
    ms_f = cuda_ms(lambda: fh.gelu_d2s4_fwd(x), 20)
    plain_f = cuda_ms(lambda: fh.gelu_d2s4_reference(x), 3)
    ms_b = cuda_ms(lambda: fh.gelu_d2s4_bwd(x, g), 20)
    plain_b = cuda_ms(lambda: fh.gelu_d2s4_bwd_reference(x, g), 3)
    # each value read once and written once (the backward reads x and the
    # cotangent); float32 operations per value, tanh counted as one: 9 for
    # GELU, 16 for GELU' and the product
    b_f, by_f = bound_ms(2 * nbytes(x), 9.0 * x.numel(), F32_FLOP_PER_S)
    b_b, by_b = bound_ms(3 * nbytes(x), 16.0 * x.numel(), F32_FLOP_PER_S)
    fwd.add(label, 1, f_errs, ms_f, plain_f, b_f, by_f, t_count=1)
    bwd.add(label, 1, b_errs, ms_b, plain_b, b_b, by_b, t_count=1)
    # context, not a yardstick: no single PyTorch call computes either; the
    # composed bf16 GELU and depth-to-space copy, and its autograd backward
    xx = x.detach().requires_grad_()

    def composed():
        y = F.gelu(xx, approximate="tanh").reshape(B, ht, ht, 4, 4, c)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(B, IMG, IMG, c)

    comp_f = cuda_ms(lambda: composed().detach(), 10)
    comp_b = cuda_ms(lambda: torch.autograd.grad(composed(), xx, g), 5)
    print(f"  gelu+d2s composed bf16 (context): fwd {comp_f:.4f} ms, fwd+bwd {comp_b:.4f} ms")
    return fwd, bwd


def check_refine_head(frh, gen) -> KernelReport:
    rep = KernelReport("refine_head", "fused_refine_head.cu", "fused_refine_head.py:455")
    c = 128
    y32, p = refine_inputs(gen, B)
    errs = {dt: rel_err(frh.fused_refine_head(y, *p), frh.refine_head_reference(y, *p))
            for dt, y in (("f32", y32), ("bf16", y32.to(torch.bfloat16)))}
    y = y32.to(torch.bfloat16)
    ms = cuda_ms(lambda: frh.fused_refine_head(y, *p), 3)
    plain_ms = cuda_ms(lambda: frh.refine_head_reference(y, *p), 3)
    pix = B * IMG * IMG
    b_ms, by = bound_ms(2 * (y.numel() + pix * c + 2 * 9 * c * c + 2 * c) + 8 * c,
                        2 * 2.0 * pix * c * 9 * c)
    rep.add(f"y{tuple(y.shape)}", 1, errs, ms, plain_ms, b_ms, by)
    return rep


def kernel_times(fn) -> list:
    """(device ms, launches, name) of every kernel and copy of one call of
    ``fn()`` on the current card (``utils/profiling.py::kernel_times``)."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils import profiling

    return profiling.kernel_times(fn)


def profile_forward(step, images, fwd_ms: float, top: int = 12,
                    what: str = "forward") -> float:
    """Device time by kernel over one call of ``step(images)`` (a forward,
    or a train step), beside its time from CUDA events; returns the total."""
    rows = kernel_times(lambda: step(images))
    if not rows:
        print("profile: the profiler saw no device time")
        return float("nan")
    total = sum(r[0] for r in rows)
    print(f"profile of one {what}: device time {total:.2f} ms over {len(rows)} kernel "
          f"names; busy share {total / fwd_ms:.3f} of the {fwd_ms:.2f} ms {what}")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<4d} {key[:90]}")
    return total


def expect(build, **counts) -> dict:
    """The full launch dict of a path: ``counts``, every other counter 0."""
    unknown = set(counts) - set(build.LAUNCHES)
    if unknown:
        raise KeyError(f"no such launch counters: {sorted(unknown)}")
    return {k: counts.get(k, 0) for k in build.LAUNCHES}


def run_train_step(train_args, build, rng, changes, want, label, n_timed=10, batch=B,
                   img=IMG) -> tuple:
    """A train step of the configuration ``changes`` at ``img``^2 (512)
    batch ``batch`` (8): its launch counts against ``want``, ``n_timed``
    timed steps on one batch (the loss must fall), a profile of one;
    returns the launches and the step's ms (CUDA events), device ms
    (profiler), peak GiB and the losses of the launch-count step (the
    second) and the timed ones."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import (
        TRAIN_CHANGES,
        deployment_config,
        train_batch,
    )
    MSUNet, create_train_state, make_train_step = train_args
    cfg = deployment_config(**TRAIN_CHANGES, **changes,
                            **{"DATA.IMG_SIZE": img})
    model = MSUNet.from_config(cfg)
    state = create_train_state(model, cfg)
    step = make_train_step(model, 0.2, 0.8, 0.45)
    images, labels = train_batch(rng, batch, img)
    step(state, images, labels, 1e-4)  # warm-up: allocator, cuDNN
    torch.cuda.synchronize()
    build.reset_launches()
    second = step(state, images, labels, 1e-4).item()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"{label} train launches per step: {launches}")
    if launches != want:
        raise AssertionError(f"{label} train launch counts {launches} != {want}")
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_timed):
        losses.append(step(state, images, labels, 1e-4))
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [x.item() for x in losses]
    step_ms = start.elapsed_time(end) / n_timed
    peak = torch.cuda.max_memory_allocated() / 2**30
    mfu = step_mfu(cfg, batch, step_ms, sum(p.numel() for p in model.parameters()))
    print(f"{label} train {img}^2 b{batch} bf16: {step_ms:.2f} ms/step (CUDA events), "
          f"{batch * n_timed / wall:.2f} img/s (host clock, synchronised), MFU {mfu:.4f}, peak "
          f"memory {peak:.2f} GiB; loss {losses[0]:.5f} -> {losses[-1]:.5f} over {n_timed} "
          f"steps")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label} train losses not finite and falling: {losses}")
    dev_ms = profile_forward(lambda imgs: step(state, imgs, labels, 1e-4), images,
                             step_ms, top=15, what=f"{label} train step")
    return launches, {"ms": step_ms, "device_ms": dev_ms, "peak_gib": peak,
                      "losses": [second] + losses}


def check_train_e2e(train_args, rng, changes, label):
    """A float32 train step at 512^2 batch 2, kernel path vs composed path."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import (
        COMPOSED,
        TRAIN_CHANGES,
        deployment_config,
        train_batch,
    )
    MSUNet, create_train_state, make_train_step = train_args
    base = {**TRAIN_CHANGES, "MODEL.DROP_PATH_RATE": 0.0, **changes}
    cfg = deployment_config(**base)
    plain_cfg = deployment_config(**base, **COMPOSED)
    kern = MSUNet.from_config(cfg, dtype=torch.float32)
    comp = MSUNet.from_config(plain_cfg, dtype=torch.float32)
    comp.load_state_dict(kern.state_dict())
    images, labels = train_batch(rng, 2)
    loss = {}
    for name, model, c in (("kernel", kern, cfg), ("composed", comp, plain_cfg)):
        state = create_train_state(model, c)
        loss[name] = make_train_step(model, 0.2, 0.8, 0.45)(state, images, labels,
                                                            1e-4).item()
    dl = abs(loss["kernel"] - loss["composed"])
    worst, worst_name = 0.0, ""
    for (name, pk), pc in zip(kern.named_parameters(), comp.parameters()):
        g = pc.grad.abs().max().item()
        rel = (pk.grad - pc.grad).abs().max().item() / max(1.0, g)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_name = rel, name
    print(f"{label} train step f32 512^2 b2, kernel vs composed path: loss "
          f"{loss['kernel']:.7f} vs {loss['composed']:.7f}, |diff| {dl:.3e} (tol "
          f"{TRAIN_LOSS_TOL:g}); worst gradient {worst_name} rel {worst:.3e} (tol "
          f"{TRAIN_GRAD_TOL:g})")
    if not dl <= TRAIN_LOSS_TOL or not worst <= TRAIN_GRAD_TOL:
        raise AssertionError(f"{label} f32 train step: kernel path differs from the "
                             "composed path")


def run_predict(step, images, build, want, label) -> tuple:
    """One predict forward with the launch counts zeroed just before and
    read just after (after a warm-up call), checked against ``want``;
    returns the launches and the probabilities."""
    torch.cuda.reset_peak_memory_stats()
    step(images)  # first call: allocator and cuDNN warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    probs = step(images)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"{label} predict launches per forward: {launches}")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches} != {want}")
    if probs.shape != (B, IMG, IMG) or not torch.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1:
        raise AssertionError(f"{label}: bad predict output {tuple(probs.shape)}")
    return launches, probs


def time_predict(step, images, label) -> float:
    fwd_ms = cuda_ms(lambda: step(images), 3, warmup=0)
    t0 = time.perf_counter()
    n_timed = 3
    for _ in range(n_timed):
        step(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{label} predict 512^2 b{B} bf16: {fwd_ms:.2f} ms/forward (CUDA events), "
          f"{B * n_timed / wall:.2f} img/s (host clock, synchronised), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return fwd_ms


# phase 10: config.yaml as shipped (Swin-B, 1024^2, batch 2, bf16, every knob
# on, attention dropout 0.05, drop-path 0.1) but for these keys; the data is
# a synthetic split of 8 fake and 4 real train images, 2 fake and 1 real val
CLI_EPOCHS = 2
CLI_SPLIT = dict(n_fake_train=8, n_real_train=4, n_val_fake=2, n_val_real=1,
                 n_test_fake=0, n_test_real=0)
CLI_TIMED_STEPS = 5
SCORE_TOL = 1e-6
# launches of one literal-config train step: attention dropout sends every
# training attention call to the composed path (port models/layers.py
# WindowAttention.forward), so no attention kernel runs; and of one eval
# forward at batch 1
CLI_STEP = dict(patch_merge=3, patch_merge_bwd=3, patch_expand=6, patch_expand_bwd=6,
                refine_head_res=1, refine_head_bwd=1)
CLI_FORWARD = dict(window_attention=52, patch_merge=3, patch_expand=6, refine_head=1)


def cli_config(run_dir: str, data: str) -> str:
    """A YAML that takes ``config.yaml`` beside this script as its BASE and
    changes only the data and output paths, the pretrained weights (the
    SegFace file is not in the repo) and the epochs."""
    import os

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config.yaml")
    path = os.path.join(run_dir, "phase10.yaml")
    with open(path, "w") as f:
        f.write(f"BASE: ['{base}']\n"
                f"DATA:\n  DATA_PATH: '{data}'\n"
                f"MODEL:\n  PRETRAIN_WEIGHTS: none\n"
                f"TRAIN:\n  MAX_EPOCHS: {CLI_EPOCHS}\n  WARMUP_EPOCHS: 1\n"
                f"OUTPUT_DIR: '{os.path.join(run_dir, 'train')}'\n"
                f"LIST_DIR: '{os.path.join(data, 'lists')}'\n")
    return path


def run_captured(fn, *args):
    """``fn(*args)`` with its standard output captured and echoed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    print("\n".join("  | " + line for line in buf.getvalue().splitlines()))
    return result, buf.getvalue()


def read_csv(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def check_decodes(native, label: str) -> dict:
    """Every image decode since ``native.reset_decodes()`` went through the
    native decoder, none through PIL."""
    counts = dict(native.DECODES)
    print(f"{label}: image decodes {counts}")
    if counts["pil"] != 0 or counts["native"] <= 0:
        raise AssertionError(f"{label}: decodes {counts}, want native ones only")
    return counts


def training_run(build, card: str) -> None:
    """Phase 10: the train CLI, the test CLI and the predict CLI over a
    synthetic 1024^2 split, then the literal-config step timed on its own."""
    import os
    import shutil

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch import native
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import (
        predict_cli,
        test_cli,
        train_cli,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.dataset import (
        SegArtifactDataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.pipeline import (
        TrainLoader,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.metrics.csv_logger import (
        HEADERS,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
        MSUNet,
        resolve_remat,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(root, "model_out", "chip_smoke_phase10")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        data = os.path.join(run_dir, "data")
        t0 = time.perf_counter()
        generate_synthetic_dataset(data, img_size=2 * IMG, seed=0, **CLI_SPLIT)
        print(f"synthetic split 1024^2 ({CLI_SPLIT}): {time.perf_counter() - t0:.1f} s")
        cfg_path = cli_config(run_dir, data)
        cfg = load_config(cfg_path)
        out = cfg.OUTPUT_DIR
        flags = resolve_remat(cfg)
        print(f"memory policy: TPU.REMAT {cfg.TPU.REMAT!r} resolves to (use_remat, "
              f"remat_high_res, remat_policy) {flags}: high_res, as JAX "
              f"models/msunet.py:501-524 resolves it (1024^2, attention dropout on)")
        if flags != (False, True, ""):
            raise AssertionError(f"config.yaml's memory policy {flags} is not high_res")
        print(f"config: {cfg.DATA.IMG_SIZE}^2 batch {cfg.DATA.BATCH_SIZE} "
              f"{cfg.TPU.COMPUTE_DTYPE} embed {cfg.MODEL.SWIN.EMBED_DIM} depths "
              f"{list(cfg.MODEL.SWIN.DEPTHS)} attn_drop {cfg.MODEL.ATTN_DROP_RATE} "
              f"drop_path {cfg.MODEL.DROP_PATH_RATE} epochs {cfg.TRAIN.MAX_EPOCHS}")

        # -- the train CLI: the main path, counts zeroed just before --
        native.reset_decodes()
        build.reset_launches()
        t0 = time.perf_counter()
        _, text = run_captured(train_cli.main, ["--cfg", cfg_path])
        train_wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        if "Training Finished!" not in text:
            raise AssertionError("the train CLI did not print 'Training Finished!'")
        with open(os.path.join(out, "log.txt")) as f:
            timing = [json.loads(line.split("epoch_timing ", 1)[1])
                      for line in f if "epoch_timing " in line]
        steps = sum(t["steps"] for t in timing)
        forwards = sum(t["val_cases"] for t in timing)
        want = {k: steps * CLI_STEP.get(k, 0) + forwards * CLI_FORWARD.get(k, 0)
                for k in build.LAUNCHES}
        print(f"train CLI: {len(timing)} epochs, {steps} steps, {forwards} val forwards "
              f"in {train_wall:.1f} s; launches {launches}")
        if len(timing) != CLI_EPOCHS or launches != want:
            raise AssertionError(f"train CLI launches {launches} != {want} "
                                 f"({steps} steps x {CLI_STEP} + {forwards} forwards x "
                                 f"{CLI_FORWARD})")
        for name, header in HEADERS.items():
            got = read_csv(os.path.join(out, name))[0]
            if got != header:
                raise AssertionError(f"{name} header {got} != {header}")
        rows = read_csv(os.path.join(out, "val_metric_all_epoch.csv"))[1:]
        losses = [float(r[3]) for r in rows]
        scores = [float(r[6]) for r in rows]
        if len(rows) != CLI_EPOCHS or not all(math.isfinite(x) for x in losses + scores):
            raise AssertionError(f"val_metric_all_epoch.csv rows {rows}")
        best = max(range(len(scores)), key=lambda i: (scores[i], -i))
        print(f"per-epoch mean train loss {losses}, val Score {scores}")
        for t in timing:
            print(f"epoch {t['epoch']}: {t['train_s']:.2f} s wall for {t['steps']} steps "
                  f"({1e3 * t['train_s'] / t['steps']:.1f} ms/step, host clock), loader "
                  f"wait {1e3 * t['loader_wait_s'] / t['steps']:.2f} ms/step; validation "
                  f"{1e3 * t['val_s'] / t['val_cases']:.1f} ms/case over {t['val_cases']} "
                  f"cases; decodes {t['decodes']}; {card}")

        payload = load_checkpoint(os.path.join(out, "best_model.pth"))
        model = MSUNet.from_config(cfg)
        model.load_state_dict(payload["model"], strict=True)
        print(f"best_model.pth: epoch {payload['epoch']}, best_score "
              f"{payload['best_score']!r}, loads strict=True")
        if payload["epoch"] != best + 1 or payload["best_score"] != scores[best]:
            raise AssertionError(f"best checkpoint {payload['epoch']} "
                                 f"{payload['best_score']} != CSV epoch {best + 1}")

        # -- the test CLI on that checkpoint over the val split --
        build.reset_launches()
        t0 = time.perf_counter()
        (dice, score, fpr), _ = run_captured(test_cli.main, [
            "--cfg", cfg_path, "--check_point_dir", out, "--out_dir",
            os.path.join(run_dir, "test"), "--split", "val"])
        test_wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        n_val = CLI_SPLIT["n_val_fake"] + CLI_SPLIT["n_val_real"]
        print(f"test CLI on best_model.pth over {n_val} val cases 1024^2: {test_wall:.2f} s "
              f"in all, {n_val / test_wall:.3f} cases/s (host clock: model build, checkpoint "
              f"load, decode, forward, metrics, the PNG exports); {card}")
        want = expect(build, **{k: n_val * v for k, v in CLI_FORWARD.items()})
        print(f"test CLI: Score {score!r} vs the trainer's best {scores[best]!r} "
              f"(|diff| {abs(score - scores[best]):.3e}, tol {SCORE_TOL:g}); launches "
              f"{launches}")
        if launches != want or not abs(score - scores[best]) <= SCORE_TOL:
            raise AssertionError(f"test CLI: Score {score} / launches {launches} != "
                                 f"{scores[best]} / {want}")

        # -- the predict CLI on the same directory --
        pred_dir = os.path.join(run_dir, "predict")
        t0 = time.perf_counter()
        preds, _ = run_captured(predict_cli.main, [
            "--cfg", cfg_path, "--check_point_dir", out, "--out_dir", pred_dir,
            "--split", "val"])
        pred_wall = time.perf_counter() - t0
        print(f"predict CLI over {n_val} val cases 1024^2: {pred_wall:.2f} s in all, "
              f"{n_val / pred_wall:.3f} cases/s (host clock); {card}")
        pngs = [n for n in os.listdir(pred_dir) if n.endswith(".png")]
        if len(preds) != n_val or len(pngs) != 4 * n_val:
            raise AssertionError(f"predict CLI: {len(preds)} cases, {len(pngs)} files")
        check_decodes(native, "train, test and predict CLIs")

        # -- the literal-config step and an eval forward, timed on their own --
        loader = TrainLoader(SegArtifactDataset(data, cfg.LIST_DIR, "fake_train"),
                             SegArtifactDataset(data, cfg.LIST_DIR, "real_train_all"),
                             img_size=cfg.DATA.IMG_SIZE, seed=int(cfg.SEED),
                             num_workers=2)
        batch = next(iter(loader.epoch_batches(0)))
        images, labels = batch["image"], batch["label"]
        state = create_train_state(model, cfg)
        step = make_train_step(model, float(cfg.TRAIN.TVERSKY_LOSS_ALPHA),
                               float(cfg.TRAIN.TVERSKY_LOSS_BETA),
                               float(cfg.TRAIN.LOSS_TVERSKY_BCE_MIX))
        lr = float(cfg.TRAIN.BASE_LR)
        step(state, images, labels, lr)
        torch.cuda.synchronize()
        build.reset_launches()
        step(state, images, labels, lr)
        torch.cuda.synchronize()
        if dict(build.LAUNCHES) != expect(build, **CLI_STEP):
            raise AssertionError(f"literal-config step launches {build.LAUNCHES}")
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step_losses = [step(state, images, labels, lr) for _ in range(CLI_TIMED_STEPS)]
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / CLI_TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_losses = [x.item() for x in step_losses]
        if not all(math.isfinite(x) for x in step_losses):
            raise AssertionError(f"literal-config step losses {step_losses}")
        rows = kernel_times(lambda: step(state, images, labels, lr))
        dev_ms = sum(r[0] for r in rows)
        mfu = step_mfu(cfg, 2, step_ms, sum(p.numel() for p in model.parameters()))
        print(f"literal-config train step 1024^2 b2 bf16, high_res: {step_ms:.2f} ms/step "
              f"(CUDA events, {CLI_TIMED_STEPS} steps), MFU {mfu:.4f}, device time {dev_ms:.2f} ms "
              f"(profiler, one step; busy {dev_ms / step_ms:.3f}), peak memory {peak:.2f} "
              f"GiB (recomputing nothing it read 309-489 ms and 22.83-22.88 GiB, PERF.md); "
              f"launches {CLI_STEP}; {card}")
        for ms, count, key in sorted(rows, reverse=True)[:12]:
            print(f"  {ms:9.3f} ms {100 * ms / dev_ms:5.1f}% x{count:<4d} {key[:90]}")
        del state, step
        torch.cuda.empty_cache()
        evaluate = make_eval_step(model, float(cfg.TRAIN.TVERSKY_LOSS_ALPHA),
                                  float(cfg.TRAIN.TVERSKY_LOSS_BETA),
                                  float(cfg.TRAIN.LOSS_TVERSKY_BCE_MIX), per_sample=True)
        one = (images[:1], labels[:1])
        evaluate(*one)
        torch.cuda.synchronize()
        build.reset_launches()
        evaluate(*one)
        torch.cuda.synchronize()
        if dict(build.LAUNCHES) != expect(build, **CLI_FORWARD):
            raise AssertionError(f"eval forward launches {build.LAUNCHES}")
        eval_ms = cuda_ms(lambda: evaluate(*one), 3, warmup=0)
        print(f"eval forward 1024^2 b1 bf16: {eval_ms:.2f} ms (CUDA events); launches "
              f"{CLI_FORWARD}; {card}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# phase 11: bench.py's step under each memory policy (TPU.REMAT).  Attention
# forward launches of one step: 52, plus one more in each recomputed block
# whose output reaches the loss (the last stage of each cent decoder, 2 + 2
# blocks, has no backward, so nothing recomputes it): all 48 under full and
# dots (the kernel is no non-batched product, so dots recomputes it, as JAX
# does), and under high_res the 10 blocks of the stages of width <= 256 that
# reach the loss (encoder stages 0 and 1, the main decoder's 256 and 128
# stages, cent decoder 1's 256 stage).  Every other count is the step's own:
# the patch ops and the head are outside the blocks and never recomputed.
REMAT_ATTN_FWD = {"none": 52, "full": 100, "dots": 100, "high_res": 62}
REMAT_TIMED = 5  # timed steps a policy (phase 6 times ten)
# the same step at config.yaml's 1024^2 b2 under dots (JAX's choice at that
# size, JAX models/msunet.py:501-524) and none, from the same weights, batch
# and noise: timed steps an arm
REMAT_BIG_TIMED = 3
# f32, a policy against none from the same weights and noise: the recompute
# replays the forward's kernels and masks, so only library reductions that
# are not deterministic (cuDNN weight gradients) may reorder a sum
REMAT_LOSS_TOL = 1e-6
REMAT_GRAD_TOL = 1e-5


def train_grads(train_args, cfg, images, labels) -> tuple:
    """One float32 train step of ``cfg``'s model from its seeded weights:
    the loss, every parameter's gradient and the state-dict keys."""
    MSUNet, create_train_state, make_train_step = train_args
    model = MSUNet.from_config(cfg, dtype=torch.float32)
    state = create_train_state(model, cfg)
    t = cfg.TRAIN
    loss = make_train_step(model, float(t.TVERSKY_LOSS_ALPHA), float(t.TVERSKY_LOSS_BETA),
                           float(t.LOSS_TVERSKY_BCE_MIX))(state, images, labels, 1e-4)
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, \
        list(model.state_dict())


def check_remat_f32(train_args, cfgs: dict, images, labels, label: str) -> None:
    """Each policy's float32 train step against the first's (``none``): the
    loss within REMAT_LOSS_TOL, each gradient within REMAT_GRAD_TOL of
    max(1, max|g|), the same state-dict keys; says whether the bits matched."""
    names = list(cfgs)
    ref_loss, ref_grads, ref_keys = train_grads(train_args, cfgs[names[0]], images, labels)
    torch.cuda.empty_cache()
    for name in names[1:]:
        loss, grads, keys = train_grads(train_args, cfgs[name], images, labels)
        dl = abs(loss - ref_loss)
        worst, worst_name, bits = 0.0, "", loss == ref_loss
        for n, g in ref_grads.items():
            bits = bits and torch.equal(grads[n], g)
            rel = (grads[n] - g).abs().max().item() / max(1.0, g.abs().max().item())
            if not math.isfinite(rel) or rel > worst:
                worst, worst_name = rel, n
        print(f"{label} f32 train step, {name} vs {names[0]}: loss {loss:.8f} vs "
              f"{ref_loss:.8f}, |diff| {dl:.3e} (tol {REMAT_LOSS_TOL:g}); worst gradient "
              f"{worst_name} rel {worst:.3e} (tol {REMAT_GRAD_TOL:g}); bits "
              f"{'equal' if bits else 'differ'}")
        if not dl <= REMAT_LOSS_TOL or not worst <= REMAT_GRAD_TOL or keys != ref_keys:
            raise AssertionError(f"{label}: the {name} step differs from {names[0]}'s")
        del grads
        torch.cuda.empty_cache()


def remat_at_1024(train_args, build, card: str) -> None:
    """Phase 11's arm at config.yaml's size: bench.py's step at 1024^2 b2
    under dots (JAX's choice there) and none, from the same weights, batch
    and noise: ms/step, device ms, peak GiB, and the loss after one update
    within REMAT_LOSS_TOL."""
    big = {}
    for policy in ("none", "dots"):
        _, big[policy] = run_train_step(
            train_args, build, np.random.default_rng(11), {"TPU.REMAT": policy}, expect(
                build, window_attention=REMAT_ATTN_FWD[policy], window_attention_bwd=48,
                patch_merge=3, patch_merge_bwd=3, patch_expand=6, patch_expand_bwd=6,
                refine_head_res=1, refine_head_bwd=1), f"Swin-B 1024^2 REMAT {policy}",
            n_timed=REMAT_BIG_TIMED, batch=2, img=2 * IMG)
        torch.cuda.empty_cache()
    print(f"memory policies at config.yaml's size, Swin-B train 1024^2 b2 bf16, every knob on "
          f"({card}):")
    for policy, r in big.items():
        print(f"  {policy:9s} {r['ms']:8.2f} ms/step (CUDA events)  {r['device_ms']:8.2f} ms "
              f"device  busy {r['device_ms'] / r['ms']:.3f}  peak {r['peak_gib']:6.2f} GiB  "
              f"losses {', '.join(f'{x:.8f}' for x in r['losses'])}")
    # the second step's loss follows one update from the first step's gradients
    dls = [abs(a - b) for a, b in zip(big["dots"]["losses"], big["none"]["losses"])]
    print(f"1024^2 b2 bf16, dots vs none from the same weights, batch and noise: loss "
          f"|diff| {dls[0]:.3e} after one update (tol {REMAT_LOSS_TOL:g}), at most "
          f"{max(dls):.3e} over {len(dls)} steps; bits "
          f"{'equal' if big['dots']['losses'] == big['none']['losses'] else 'differ'}")
    if not dls[0] <= REMAT_LOSS_TOL:
        raise AssertionError(f"1024^2 b2: dots losses {big['dots']['losses']} != none's "
                             f"{big['none']['losses']}")


def recomputation(train_args, build, rng, card: str) -> None:
    """Phase 11: bench.py's Swin-B step at 512^2 b8 under each policy
    (drop-path 0.1: the stochastic-depth replay on the kernel path), then
    float32 steps against ``none``: at 512^2 b2 with drop-path on, and at
    1024^2 b2 with config.yaml's own noise (attention dropout 0.05 on the
    composed attention) under the policy its ``auto`` resolves to."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import (
        TRAIN_CHANGES,
        deployment_config,
        train_batch,
    )
    import os

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
        load_config,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
        resolve_remat,
    )

    rows = {}
    for policy, attn in REMAT_ATTN_FWD.items():
        _, stats = run_train_step(
            train_args, build, rng, {"TPU.REMAT": policy}, expect(
                build, window_attention=attn, window_attention_bwd=48, patch_merge=3,
                patch_merge_bwd=3, patch_expand=6, patch_expand_bwd=6, refine_head_res=1,
                refine_head_bwd=1), f"Swin-B REMAT {policy}", n_timed=REMAT_TIMED)
        rows[policy] = stats
        torch.cuda.empty_cache()
    print(f"memory policies, Swin-B train 512^2 b{B} bf16, every knob on ({card}):")
    for policy, r in rows.items():
        print(f"  {policy:9s} {r['ms']:8.2f} ms/step (CUDA events)  {r['device_ms']:8.2f} ms "
              f"device  busy {r['device_ms'] / r['ms']:.3f}  peak {r['peak_gib']:6.2f} GiB  "
              f"attention launches {REMAT_ATTN_FWD[policy]}/48")

    remat_at_1024(train_args, build, card)

    images, labels = train_batch(rng, 2)
    check_remat_f32(train_args, {p: deployment_config(**TRAIN_CHANGES,
                                                      **{"TPU.REMAT": p})
                                 for p in REMAT_ATTN_FWD}, images, labels, "Swin-B 512^2 b2")
    torch.cuda.empty_cache()

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config.yaml")
    literal = load_config(path)
    if resolve_remat(literal) != (False, True, ""):
        raise AssertionError(f"config.yaml resolves to {resolve_remat(literal)}")
    none = load_config(path)
    none.defrost()
    none.TPU.REMAT = "none"
    none.freeze()
    big = np.random.default_rng(1)
    images = big.integers(0, 256, (2, 2 * IMG, 2 * IMG, 3), dtype=np.uint8)
    labels = (big.random((2, 2 * IMG, 2 * IMG)) > 0.8).astype(np.uint8)
    check_remat_f32(train_args, {"none": none, "high_res (auto)": literal}, images, labels,
                    "config.yaml 1024^2 b2")


# phase 12: the run CLI's three sweeps over a copy of config.yaml at 256^2,
# one epoch a trial, on a synthetic split: 1 + 2 + 1 trials (one lr: the
# sweep's ranking is shown by alpha's two, and a trial costs ~25 s)
GRID_IMG = 256
GRID_SPLIT = dict(n_fake_train=4, n_real_train=2, n_val_fake=1, n_val_real=1,
                  n_test_fake=0, n_test_real=0)
# one value a sweep: three trials, the fewest the run CLI's three sweeps run
GRID_ARGS = ["--attn_drop", "0.05", "--alpha", "0.3", "--lr", "8.5e-6"]
GRID_TRIALS = 3


def grid_search(card: str) -> None:
    """Phase 12: the port's run CLI, each trial the port's train CLI in a
    process of its own on the card; ``config.yaml`` itself must not change."""
    import hashlib
    import os
    import shutil

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import run_cli
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.yaml_editor import (
        ConfigParser,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    shipped = os.path.join(root, "config.yaml")
    with open(shipped, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    run_dir = os.path.join(root, "model_out", "chip_smoke_phase12")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    cwd = os.getcwd()
    os.chdir(root)  # a trial runs ``python -m <port>.cli.train_cli`` from here
    try:
        data = os.path.join(run_dir, "data")
        generate_synthetic_dataset(data, img_size=GRID_IMG, seed=0, **GRID_SPLIT)
        cfg = os.path.join(run_dir, "config.yaml")
        shutil.copyfile(shipped, cfg)
        parser = ConfigParser(cfg)
        parser.set_values([("DATA.IMG_SIZE", GRID_IMG), ("DATA.DATA_PATH", data),
                           ("LIST_DIR", os.path.join(data, "lists")),
                           ("MODEL.PRETRAIN_WEIGHTS", "none"), ("TRAIN.MAX_EPOCHS", 1),
                           ("TRAIN.WARMUP_EPOCHS", 0), ("SAVE_BEST_RUN", False),
                           ("SHOW_PREDICTIONS", 0)])
        parser.save()
        out = os.path.join(run_dir, "RUN1")
        t0 = time.perf_counter()
        best, text = run_captured(run_cli.main, ["--cfg", cfg, "--root_out", out] + GRID_ARGS)
        wall = time.perf_counter() - t0
        csvs = sorted(os.path.join(d, n) for d, _, files in os.walk(out) for n in files
                      if n == "val_metric_all_epoch.csv")
        scores = []
        decodes = {"native": 0, "pil": 0}
        for path in csvs:
            rows = read_csv(path)
            score = float(rows[-1][rows[0].index("Score")])
            if len(rows) != 2 or not math.isfinite(score):
                raise AssertionError(f"{path}: rows {rows}")
            scores.append((os.path.relpath(os.path.dirname(path), out), score))
            # a trial is a process of its own: its log counts its decodes
            with open(os.path.join(os.path.dirname(path), "log.txt")) as f:
                for line in f:
                    if "epoch_timing " in line:
                        for k, v in json.loads(line.split("epoch_timing ", 1)[1])[
                                "decodes"].items():
                            decodes[k] += v
        best_line = [ln for ln in text.splitlines() if ln.startswith("BEST:")]
        print(f"run CLI: {len(csvs)} trials through the port's train CLI in {wall:.1f} s "
              f"({wall / max(1, len(csvs)):.1f} s a trial, {GRID_IMG}^2, 1 epoch; {card}); "
              f"Score by trial {scores}; {best_line}")
        if len(csvs) != GRID_TRIALS or len(best_line) != 1:
            raise AssertionError(f"run CLI: {len(csvs)} trials, BEST lines {best_line}")
        print(f"run CLI trials' image decodes (their epoch_timing lines): {decodes}")
        if decodes["pil"] != 0 or decodes["native"] <= 0:
            raise AssertionError(f"run CLI trials: decodes {decodes}, want native ones only")
        with open(shipped, "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() != digest:
                raise AssertionError("the run CLI changed config.yaml")
    finally:
        os.chdir(cwd)
        shutil.rmtree(run_dir, ignore_errors=True)


# phase 13: the parity tool at PARITY.md r5's setting, and the epoch bench.
# Launches of one parity-tool train step (depths 2/2/2/2: 20 blocks, of which
# the last stage of each cent decoder, 2 + 2, has no backward) and of one
# validation forward, in the deploy arm; the parity arm launches none
PARITY_IMG, PARITY_EPOCHS = 512, 15
PARITY_STEP = dict(window_attention=20, window_attention_bwd=16, patch_merge=3,
                   patch_merge_bwd=3, patch_expand=6, patch_expand_bwd=6,
                   refine_head_res=1, refine_head_bwd=1)
PARITY_FORWARD = dict(window_attention=20, patch_merge=3, patch_expand=6, refine_head=1)
PARITY_BAR = 1e-4  # PARITY.md r5: deltas within 1e-4 over 15 epochs
# the epoch bench at 512^2 batch 8 over 32 + 32 train images
EPOCH_BENCH_SPLIT = dict(n_fake_train=32, n_real_train=32)
EPOCH_BENCH_ARGS = ["--img", str(PARITY_IMG), "--merge", "4", "--workers", "8"]


class EpochTimings(logging.Handler):
    """Collects the trainer's ``epoch_timing`` log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.epochs = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("epoch_timing "):
            self.epochs.append(json.loads(msg.split(" ", 1)[1]))


def parity_and_epoch_bench(build, card: str) -> None:
    """Phase 13: the parity tool's two arms on one synthetic split (launch
    counts zeroed before each arm and read after it), its deltas beside
    PARITY.md r5's, then the epoch bench's JSON line."""
    import os
    import shutil

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch import native
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import (
        epoch_bench,
        parity_vs_deploy,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(root, "model_out", "chip_smoke_phase13")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    native.reset_decodes()
    try:
        data = os.path.join(run_dir, "data")
        generate_synthetic_dataset(data, img_size=PARITY_IMG, **parity_vs_deploy.SPLIT)
        args = parity_vs_deploy.build_arg_parser().parse_args(
            ["--img", str(PARITY_IMG), "--epochs", str(PARITY_EPOCHS)])
        rows = {}
        for tag, deploy in (("parity", False), ("deploy", True)):
            timing = EpochTimings()
            log = logging.getLogger(tag)
            log.setLevel(logging.INFO)
            log.addHandler(timing)
            build.reset_launches()
            t0 = time.perf_counter()
            try:
                rows[tag], _ = run_captured(parity_vs_deploy.run_one, tag, data, run_dir,
                                            deploy, args)
            finally:
                log.removeHandler(timing)
            launches = dict(build.LAUNCHES)
            steps = sum(t["steps"] for t in timing.epochs)
            forwards = sum(t["val_cases"] for t in timing.epochs)
            want = {k: (steps * PARITY_STEP.get(k, 0) + forwards * PARITY_FORWARD.get(k, 0))
                    if deploy else 0 for k in build.LAUNCHES}
            print(f"parity tool, {tag} arm: {len(timing.epochs)} epochs, {steps} steps, {forwards} "
                  f"val forwards in {time.perf_counter() - t0:.1f} s; launches {launches}")
            if len(timing.epochs) != PARITY_EPOCHS or launches != want:
                raise AssertionError(f"{tag} arm launches {launches} != {want}")
        deltas, _ = run_captured(parity_vs_deploy.print_deltas, rows["parity"],
                                 rows["deploy"])
        if not all(math.isfinite(d) for d in deltas.values()):
            raise AssertionError(f"parity deltas {deltas}")
        print(f"parity deltas at {PARITY_IMG}^2, {PARITY_EPOCHS} epochs (deploy - parity; "
              f"PARITY.md r5: mean_accuracy 0, mean_val_loss -3e-5, mean_train_loss "
              f"+2e-5; bar {PARITY_BAR:g}): " + ", ".join(
                  f"{k} {d:+.6f}{'' if abs(d) <= PARITY_BAR else ' (beyond the bar)'}"
                  for k, d in deltas.items() if k != "epoch") + f"; {card}")

        bench_data = os.path.join(run_dir, "bench")
        generate_synthetic_dataset(bench_data, img_size=PARITY_IMG, **EPOCH_BENCH_SPLIT)
        result, _ = run_captured(epoch_bench.main, EPOCH_BENCH_ARGS + ["--data_dir",
                                                                        bench_data])
        keys = {"metric", "value", "unit", "compute_only", "host_efficiency",
                "native_decode", "batch"}
        if not keys <= set(result) or not result["value"] > 0 or not result["native_decode"]:
            raise AssertionError(f"epoch bench line {result}")
        print(f"epoch bench: {json.dumps(result)}; {card}")
        check_decodes(native, "parity tool and epoch bench")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# phase 14: data parallelism on the one card.  (a) a one-rank NCCL group
# around phase 6's step; (b) two ranks on the card over gloo (NCCL refuses
# two ranks on one device) against one process over the same global
# batches, then each rank's deployment step timed; (c) the staged
# FREEZE_ENCODER unfreeze through the train CLI on two ranks
DP_STEPS = 3            # (b) float32 steps held against one process
DP_TIMED = 5            # (b) bf16 deployment steps timed on each rank
DP_LR = 1e-4
DDP_LOSS_TOL = 1e-6     # (a) one rank: the DDP step is the plain step
UNFREEZE_IMG, UNFREEZE_EPOCHS = 256, 3
UNFREEZE_SPLIT = dict(n_fake_train=4, n_real_train=2, n_val_fake=1, n_val_real=1,
                      n_test_fake=0, n_test_real=0)


def step_mfu(cfg, batch: int, ms: float, n_params: int) -> float:
    """``utils/flops.py``'s count of one train step over its time, against
    the card's bf16 peak."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils.flops import (
        train_step_flops,
    )

    swin = cfg.MODEL.SWIN
    flop = train_step_flops(int(cfg.DATA.IMG_SIZE), batch, patch_size=int(swin.PATCH_SIZE),
                            embed_dim=int(swin.EMBED_DIM), depths=tuple(swin.DEPTHS),
                            window_size=int(swin.WINDOW_SIZE),
                            num_classes=int(cfg.MODEL.NUM_CLASSES), params=n_params)
    return flop / (ms / 1e3) / BF16_FLOP_PER_S


def one_rank_nccl(train_args, build, rng, run_dir: str, card: str, want: dict) -> None:
    """(a): phase 6's step (Swin-B 512^2 b8 bf16, every knob on) through
    DDP in a one-rank NCCL group beside the plain step from the same
    weights: equal launch counts and losses; ms/step, MFU and the step's
    device time by model section."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import (
        TRAIN_CHANGES,
        deployment_config,
        train_batch,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils.profiling import (
        section_times,
    )

    MSUNet, create_train_state, make_train_step = train_args
    cfg = deployment_config(**TRAIN_CHANGES)
    images, labels = train_batch(rng, B)
    dev = mesh.init_process_group(0, 1, "file://" + os.path.join(run_dir, "nccl"), "cuda")
    try:
        print(f"one-rank process group: backend {torch.distributed.get_backend()}, "
              f"device {dev}")
        losses = {}
        for name in ("plain", "ddp"):
            model = MSUNet.from_config(cfg)
            state = create_train_state(model, cfg)
            if name == "ddp":
                mesh.replicate_state(state)
            step = make_train_step(model, 0.2, 0.8, 0.45)
            losses[name] = [step(state, images, labels, 1e-4).item()]
            torch.cuda.synchronize()
            build.reset_launches()
            losses[name].append(step(state, images, labels, 1e-4).item())
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            if launches != want:
                raise AssertionError(f"{name} step launches {launches} != phase 6's {want}")
            losses[name].append(step(state, images, labels, 1e-4).item())
            if name == "plain":
                del state, step, model
                torch.cuda.empty_cache()
        diff = max(abs(a - b) for a, b in zip(losses["plain"], losses["ddp"]))
        print(f"DDP step (one NCCL rank) launches {launches} = phase 6's; losses over 3 "
              f"steps {losses['ddp']} vs plain {losses['plain']}: max |diff| {diff:.3e} "
              f"(tol {DDP_LOSS_TOL:g}; bits {'equal' if diff == 0 else 'differ'})")
        if not diff <= DDP_LOSS_TOL:
            raise AssertionError(f"one-rank DDP losses differ from the plain step by {diff}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, images, labels, 1e-4), 10, warmup=0)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"DDP step Swin-B 512^2 b{B} bf16, one NCCL rank: {ms:.2f} ms/step (CUDA "
              f"events, 10 steps), MFU {step_mfu(cfg, B, ms, n_params):.4f} of "
              f"{BF16_FLOP_PER_S / 1e12:g} TFLOP/s bf16, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
        sections = section_times(lambda: step(state, images, labels, 1e-4), model)
        top = sorted(((v, k) for k, v in sections.items() if k != "total"), reverse=True)
        print(f"DDP step device time by section (profiler, one step): "
              f"{sections['total']:.2f} ms; " +
              ", ".join(f"{k} {v:.2f}" for v, k in top[:8]))
    finally:
        mesh.destroy_process_group()


def two_ranks_gloo(rng, run_dir: str, card: str) -> None:
    """(b): two gloo ranks on the card against one process over the same
    global batches (Swin-B 512^2 float32, drop rates 0), then each rank's
    deployment step timed."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import dp_check

    bf16 = dp_check.deployment_config(**dp_check.TRAIN_CHANGES)
    batches = [dp_check.train_batch(rng, B) for _ in range(DP_STEPS)]
    spec = dp_check.make_spec(
        dp_check.write_config(dp_check.deployment_config(**dp_check.F32),
                              os.path.join(run_dir, "f32.yaml")),
        batches, DP_LR, device="cuda:0", backend="gloo", threads=4,
        timed={"cfg_path": dp_check.write_config(bf16, os.path.join(run_dir, "bf16.yaml")),
               "batch": B, "steps": DP_TIMED})
    t0 = time.perf_counter()
    one = dp_check.run_steps(spec, device="cuda")
    torch.cuda.empty_cache()
    print(f"one process, Swin-B 512^2 f32, global batch {B}, {DP_STEPS} steps at lr "
          f"{DP_LR:g}: {time.perf_counter() - t0:.1f} s")
    print("two ranks on one card over gloo with CUDA tensors: NCCL refuses two ranks on "
          "one device; NCCL across four cards is tools/multichip.py's (four-card machine)")
    ranks, _ = dp_check.hold_against_one(f"two gloo ranks, global batch {B} ({B // 2} + "
                                         f"{B // 2})", spec, 2, os.path.join(run_dir, "ranks"),
                                         one, dp_check.PER_STEP)
    print(f"{DP_TIMED} bf16 deployment steps 512^2 b{B} a rank (DDP, gloo, two ranks sharing "
          f"the card):")
    rows = dp_check.rank_rows("gloo", ranks, B, card)
    n_params = sum(v.numel() for v in one["state_dict"].values())
    print("  MFU a rank: " + ", ".join(f"{step_mfu(bf16, B, r['ms'], n_params):.4f}"
                                       for r in rows))


def unfreeze_config(run_dir: str, data: str) -> str:
    """config.yaml at 256^2 on two ranks with the encoder frozen: stage 3
    unfreezes at epoch 1, stage 2 at epoch 2, stages 1 and 0 not within
    the run."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config.yaml")
    path = os.path.join(run_dir, "unfreeze.yaml")
    with open(path, "w") as f:
        f.write(f"BASE: ['{base}']\n"
                f"DATA:\n  DATA_PATH: '{data}'\n  IMG_SIZE: {UNFREEZE_IMG}\n"
                f"HARDWARE:\n  N_GPU: 2\n"
                f"MODEL:\n  PRETRAIN_WEIGHTS: none\n  FREEZE_ENCODER: true\n"
                f"  STAGE3_UNFREEZE_PERIODE: 0.34\n  STAGE2_UNFREEZE_PERIODE: 0.67\n"
                f"  STAGE1_UNFREEZE_PERIODE: 1.0\n  STAGE0_UNFREEZE_PERIODE: 1.0\n"
                f"TRAIN:\n  MAX_EPOCHS: {UNFREEZE_EPOCHS}\n  WARMUP_EPOCHS: 1\n"
                f"OUTPUT_DIR: '{os.path.join(run_dir, 'unfreeze')}'\n"
                f"LIST_DIR: '{os.path.join(data, 'lists')}'\n")
    return path


def staged_unfreeze(run_dir: str, card: str) -> None:
    """(c): the train CLI with ``HARDWARE.N_GPU: 2`` spawns two gloo ranks
    on the card; its per-epoch ``rank_sync`` lines (the trainer raises
    unless both ranks hold the same parameters) must show each stage equal
    to its initial values while frozen and moved once unfrozen."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import train_cli
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel.mesh import (
        stage_sums,
    )

    data = os.path.join(run_dir, "data")
    generate_synthetic_dataset(data, img_size=UNFREEZE_IMG, seed=0, **UNFREEZE_SPLIT)
    path = unfreeze_config(run_dir, data)
    cfg = load_config(path)
    init = stage_sums(MSUNet.from_config(cfg))
    t0 = time.perf_counter()
    run_captured(train_cli.main, ["--cfg", path, "--device", "cuda:0", "--dist_backend",
                                  "gloo"])
    wall = time.perf_counter() - t0
    with open(os.path.join(cfg.OUTPUT_DIR, "log.txt")) as f:
        syncs = [json.loads(ln.split("rank_sync ", 1)[1]) for ln in f if "rank_sync " in ln]
    print(f"train CLI, N_GPU 2 on one card (gloo), {UNFREEZE_IMG}^2, FREEZE_ENCODER, "
          f"{UNFREEZE_EPOCHS} epochs in {wall:.1f} s with the ranks' start; {card}")
    want_frozen = [[0, 1, 2, 3], [0, 1, 2], [0, 1]]
    if [s["frozen_stages"] for s in syncs] != want_frozen or \
            any(s["world"] != 2 for s in syncs):
        raise AssertionError(f"rank_sync lines {syncs}")
    for s in syncs:
        moved = sorted(k for k, v in s["stage_sums"].items()
                       if abs(v - init[k]) > 1e-6 * max(1.0, abs(init[k])))
        trained = [f"layers.{i}" for i in range(4) if i not in s["frozen_stages"]]
        print(f"  epoch {s['epoch']}: frozen {s['frozen_stages']}, both ranks' parameters "
              f"equal, stages moved since init {moved}")
        if moved != trained:
            raise AssertionError(f"epoch {s['epoch']}: stages moved {moved}, trainable "
                                 f"{trained}")
    with open(os.path.join(cfg.OUTPUT_DIR, "log.txt")) as f:
        if "Training finished" not in f.read():
            raise AssertionError("the two-rank run did not finish")
    if not os.path.exists(os.path.join(cfg.OUTPUT_DIR, "best_model.pth")):
        raise AssertionError("the two-rank run wrote no best checkpoint")


def data_parallel(train_args, build, rng, card: str, want: dict) -> None:
    """Phase 14: (a), (b) and (c) above."""
    import shutil

    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "model_out",
                           "chip_smoke_phase14")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        t0 = time.perf_counter()
        one_rank_nccl(train_args, build, rng, run_dir, card, want)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        two_ranks_gloo(rng, run_dir, card)
        t2 = time.perf_counter()
        staged_unfreeze(run_dir, card)
        print(f"phase 14 parts: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
              f"{time.perf_counter() - t2:.1f} s")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# phase 15: tensor and spatial parallelism on the one card, two gloo ranks
# sharing it (NCCL refuses two ranks on one device).  Each axis trains the
# f32 model with every kernel knob on, which the axis routes off, against one
# process's composed step from the same seeded weights.
SHARD_STEPS = 3         # float32 steps held against one process
SHARD_TIMED = 2         # steps timed on each rank
SHARD_BATCH = 2
SHARD_LR = 1e-4
SHARD_AXES = (("tensor parallel", "TPU.MODEL_AXIS", "model", {"n_model": 2}),
              ("spatial sharding", "TPU.SPATIAL_AXIS", "space", {"n_space": 2}))


def tensor_and_spatial(rng, card: str, device: str = "cuda:0") -> None:
    """Phase 15: each axis of ``SHARD_AXES`` on two gloo ranks against one
    process (``tools/dp_check.py::hold_against_one``)."""
    import shutil

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import dp_check

    run_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "model_out",
                           "chip_smoke_phase15")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        batches = [dp_check.train_batch(rng, SHARD_BATCH) for _ in range(SHARD_STEPS)]
        plain = dp_check.write_config(
            dp_check.deployment_config(**{**dp_check.F32, **dp_check.COMPOSED}),
            os.path.join(run_dir, "composed.yaml"))
        t0 = time.perf_counter()
        one = dp_check.run_steps(dp_check.make_spec(plain, batches, SHARD_LR, device=device))
        print(f"one process, composed, Swin-B {IMG}^2 b{SHARD_BATCH} f32, {SHARD_STEPS} steps: "
              f"losses {one['losses']} in {time.perf_counter() - t0:.1f} s")
        print("tensor and spatial parallelism: two ranks on one card over gloo with CUDA "
              "tensors (NCCL refuses two ranks on one device); NCCL across four cards is "
              "tools/multichip.py's (four-card machine)")
        for reason, key, axis, mesh_kw in SHARD_AXES:
            path = dp_check.write_config(
                dp_check.deployment_config(**{**dp_check.F32, key: axis}),
                os.path.join(run_dir, f"{axis}.yaml"))
            spec = dp_check.make_spec(path, batches, SHARD_LR, device=device, backend="gloo",
                                      threads=4, timed={"cfg_path": path, "batch": SHARD_BATCH,
                                                        "steps": SHARD_TIMED}, **mesh_kw)
            ranks, _ = dp_check.hold_against_one(
                f"{reason} ({axis} axis 2), every kernel knob on, routed off", spec, 2,
                os.path.join(run_dir, axis), one, {})
            print(f"  Swin-B {IMG}^2 b{SHARD_BATCH} f32 step, {SHARD_TIMED} steps:")
            dp_check.rank_rows(axis, ranks, SHARD_BATCH, card)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# phase 16: the native decoder under the loaders at config.yaml's 1024^2.
# 16 fake and 12 real train images: the loader's real ratio of 0.4 draws 10
# real images an epoch beside 16 fake (8 real would be too few, and it
# raises), so an epoch is 26 images, 13 batches of 2
DECODE_SPLIT = dict(n_fake_train=16, n_real_train=12, n_val_fake=0, n_val_real=0,
                    n_test_fake=0, n_test_real=0)
DECODE_REPS = 3  # (a) timed passes of each decoder and thread count, in turns
# (d) the LR range test: 20 steps at b2 over the split's 1024^2 images (the
# loader takes images at the model's size only), the lr swept log-uniformly
# to 10x the largest lr the grid search tries, where the loss stays finite
LR_RANGE_STEPS, LR_RANGE_MIN, LR_RANGE_MAX = 20, 1e-7, 1e-3


@contextlib.contextmanager
def decode_switch(native, on: bool):
    """``SSA_TPU_NATIVE_DECODE`` for the block: unset (native) or 0 (PIL)."""
    old = os.environ.pop(native.SWITCH, None)
    if not on:
        os.environ[native.SWITCH] = "0"
    try:
        yield
    finally:
        os.environ.pop(native.SWITCH, None)
        if old is not None:
            os.environ[native.SWITCH] = old


def decode_rates(native, files, workers: int, size: int, card: str) -> None:
    """16 (a): every file decoded natively and by PIL, equal in bits; then
    ms of wall time a file for each decoder on one thread and on
    ``workers``, in turns."""
    import concurrent.futures as cf

    for path, gray in files:
        if not np.array_equal(native.decode_image(path, gray=gray),
                              native.decode_pil(path, gray)):
            raise AssertionError(f"native and PIL decodes of {path} differ")
    n_img = sum(not gray for _, gray in files)
    print(f"native and PIL decodes equal in bits: {n_img} images and "
          f"{len(files) - n_img} masks at {size}^2")
    decoders = {"native": lambda f: native.decode_image(f[0], gray=f[1]),
                "PIL": lambda f: native.decode_pil(f[0], f[1])}
    with cf.ThreadPoolExecutor(workers) as pool:
        for kind, gray in (("image", False), ("mask", True)):
            group = [f for f in files if f[1] == gray]
            mean_bytes = np.mean([os.path.getsize(p) for p, _ in group])
            times = {(name, t): [] for t in (1, workers) for name in decoders}
            for rep in range(DECODE_REPS):
                order = list(decoders) if rep % 2 == 0 else list(decoders)[::-1]
                for threads in (1, workers):
                    for name in order:
                        t0 = time.perf_counter()
                        if threads == 1:
                            for f in group:
                                decoders[name](f)
                        else:
                            list(pool.map(decoders[name], group))
                        times[(name, threads)].append(
                            1e3 * (time.perf_counter() - t0) / len(group))
            for (name, threads), ms in times.items():
                print(f"  {kind} decode, {name} on {threads} thread(s): "
                      f"{np.median(ms):.3f} ms per {kind} of wall time (median of "
                      f"{DECODE_REPS}: {', '.join(f'{x:.3f}' for x in ms)}); {len(group)} "
                      f"files of {mean_bytes:.0f} bytes on average; {card}")


def loader_arms(native, loader, size: int, card: str) -> None:
    """16 (b): one epoch of the train loader's batches with the switch on,
    off, off and on; every arm's batches equal in bits, seconds a batch."""
    first = None
    for on in (True, False, False, True):
        with decode_switch(native, on):
            native.reset_decodes()
            t0 = time.perf_counter()
            batches = list(loader.epoch_batches_merged(0, 1))
            wall = time.perf_counter() - t0
            counts = dict(native.DECODES)
        n = len(batches)
        want = {"native": 4 * n, "pil": 0} if on else {"native": 0, "pil": 4 * n}
        print(f"  loader, switch {'on' if on else 'off'}: {n} batches of 2 at {size}^2 in "
              f"{wall:.3f} s, {wall / n:.4f} s a batch (host clock, nothing consuming); "
              f"decodes {counts}; {card}")
        if counts != want or n == 0:
            raise AssertionError(f"loader arm: {n} batches, decodes {counts} != {want}")
        if first is None:
            first = batches
            continue
        for got, ref in zip(batches, first):
            for key in ("image", "label"):
                if not np.array_equal(got[key], ref[key]):
                    raise AssertionError(f"loader arms differ in {key} of {got['case_name']}")
        if len(batches) != len(first):
            raise AssertionError(f"loader arms: {len(batches)} != {len(first)} batches")
    print("loader arms' batches equal in bits")


def native_decode(train_args, build, card: str, per_step: dict) -> None:
    """Phase 16: the native decoder on a synthetic 1024^2 split: (a) the decode
    rate alone, (b) the train loader alone, (c) the epoch bench at 1024^2 b2
    in each arm, (d) the LR range test over the loader at 1024^2 b2."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import (
        TRAIN_CHANGES,
        deployment_config,
    )
    import shutil

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch import native
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
        load_config,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.dataset import (
        SegArtifactDataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.pipeline import (
        TrainLoader,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import epoch_bench
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.lr_range import (
        lr_range_test,
    )

    MSUNet, create_train_state, make_train_step = train_args
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "config.yaml"))
    workers = int(cfg.DATA.NUM_WORKERS)
    run_dir = os.path.join(root, "model_out", "chip_smoke_phase16")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        t0 = time.perf_counter()
        native.library()
        print(f"native decoder: built and loaded in {time.perf_counter() - t0:.2f} s "
              f"(g++, decode.cpp; PNG inflate by Python's zlib)")
        data = os.path.join(run_dir, "data")
        lists = os.path.join(data, "lists")
        t0 = time.perf_counter()
        generate_synthetic_dataset(data, img_size=cfg.DATA.IMG_SIZE, seed=0, **DECODE_SPLIT)
        print(f"synthetic split {cfg.DATA.IMG_SIZE}^2 ({DECODE_SPLIT}): "
              f"{time.perf_counter() - t0:.1f} s")
        files = [(os.path.join(data, sub, name), sub.endswith("labels"))
                 for sub in ("fake_images", "real_images", "fake_labels", "real_labels")
                 for name in sorted(os.listdir(os.path.join(data, sub)))]

        # (a) the decode rate alone
        decode_rates(native, files, workers, int(cfg.DATA.IMG_SIZE), card)

        # (b) the loader alone, as the trainer builds it from config.yaml
        def make_loader():
            return TrainLoader(SegArtifactDataset(data, lists, "fake_train"),
                               SegArtifactDataset(data, lists, "real_train_all"),
                               img_size=int(cfg.DATA.IMG_SIZE), seed=int(cfg.SEED),
                               dynamic_loader=bool(cfg.DYNAMIC_LOADER), num_workers=workers,
                               prefetch_depth=int(cfg.TPU.PREFETCH_DEPTH))

        loader_arms(native, make_loader(), int(cfg.DATA.IMG_SIZE), card)

        # (c) the epoch bench at 1024^2 b2 in each arm
        for on in (True, False):
            with decode_switch(native, on):
                native.reset_decodes()
                build.reset_launches()
                result, _ = run_captured(epoch_bench.main, [
                    "--img", str(cfg.DATA.IMG_SIZE), "--merge", "1", "--workers",
                    str(workers), "--data_dir", data])
                launches = dict(build.LAUNCHES)
                counts = dict(native.DECODES)
            want = {k: result["steps"] * v for k, v in per_step.items()}
            arm = "native" if on else "PIL"
            print(f"epoch bench {cfg.DATA.IMG_SIZE}^2 b2, {arm} arm: {result['value']} img/s, "
                  f"host_efficiency {result['host_efficiency']}, loader wait "
                  f"{result['loader_wait_ms_per_step']} ms a step, native_decode "
                  f"{result['native_decode']}; {result['steps']} steps, launches {launches}; "
                  f"decodes {counts}; {card}")
            if launches != want:
                raise AssertionError(f"epoch bench launches {launches} != {want}")
            if result["native_decode"] is not on or counts["pil" if on else "native"] != 0:
                raise AssertionError(f"epoch bench {arm} arm: {result}, decodes {counts}")
            torch.cuda.empty_cache()

        # (d) the LR range test over the loader, bench.py's step at 1024^2 b2
        lr_cfg = deployment_config(**TRAIN_CHANGES,
                                   **{"DATA.IMG_SIZE": int(cfg.DATA.IMG_SIZE)})
        model = MSUNet.from_config(lr_cfg)
        state = create_train_state(model, lr_cfg)
        step = make_train_step(model, 0.2, 0.8, 0.45)
        native.reset_decodes()
        batches = list(make_loader().epoch_batches(0))
        out_dir = os.path.join(run_dir, "lr_range")
        build.reset_launches()
        t0 = time.perf_counter()
        lrs, losses = lr_range_test(state, step, batches, out_dir, min_lr=LR_RANGE_MIN,
                                    max_lr=LR_RANGE_MAX, n_steps=LR_RANGE_STEPS, plot=False)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        rows = read_csv(os.path.join(out_dir, "lr_range_test.csv"))[1:]
        print(f"LR range test {lr_cfg.DATA.IMG_SIZE}^2 b2, {LR_RANGE_STEPS} steps over "
              f"{len(batches)} loader "
              f"batches in {wall:.2f} s: lr {lrs[0]:.3g} -> {lrs[-1]:.3g}, loss "
              f"{', '.join(f'{x:.4f}' for x in losses)}; launches {launches}; {card}")
        want = {k: LR_RANGE_STEPS * v for k, v in per_step.items()}
        if (len(losses) != LR_RANGE_STEPS or len(rows) != LR_RANGE_STEPS
                or not all(math.isfinite(x) for x in losses)
                or not all(a < b for a, b in zip(lrs, lrs[1:]))
                or not math.isclose(lrs[0], LR_RANGE_MIN, rel_tol=1e-9)
                or not math.isclose(lrs[-1], LR_RANGE_MAX, rel_tol=1e-9) or launches != want):
            raise AssertionError(f"LR range test: lrs {lrs}, losses {losses}, {len(rows)} CSV "
                                 f"rows, launches {launches} != {want}")
        check_decodes(native, "LR range test's loader")
        del state, step, model
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


# phase 17: orbax checkpoints.  (a) the committed fixture, which the JAX
# package's orbax backend wrote (zstd OCDBT nodes and zstd chunks), against
# its values.npz; (b) config.yaml's Swin-B at 512^2 b2 with drop rates 0:
# saves, reads, a resumed step and the test CLI on the orbax directory.
ORBAX_IMG = 512
ORBAX_STEPS = 2  # train steps before the saves
ORBAX_SPLIT = dict(n_fake_train=1, n_real_train=1, n_val_fake=2, n_val_real=1,
                   n_test_fake=0, n_test_real=0)
ORBAX_DECODE_REPS = 5


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _as_numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _same_bits(a, b) -> bool:
    a, b = _as_numpy(a), _as_numpy(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize and \
        a.tobytes() == b.tobytes()


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def orbax_fixture(card: str) -> None:
    """Phase 17 (a): the JAX-written fixture read by the port, every leaf in
    bits, and the zstd decoder's rate over the fixture's frames."""
    import struct

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.native import zstd
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import (
        checkpoint,
        ocdbt,
        orbax,
    )

    fixture = os.path.join(os.path.dirname(checkpoint.__file__), "testdata", "jax_orbax")
    with np.load(os.path.join(fixture, "values.npz")) as z:
        values = {k: z[k] for k in z.files}
    frames = []
    for name, prefix in (("best_model.orbax", "best/"), ("epoch_1.orbax", "epoch/")):
        path = os.path.join(fixture, name)
        t0 = time.perf_counter()
        flat = _flat_tree(orbax.restore(path))
        dt = time.perf_counter() - t0
        want = {k[len(prefix):]: v for k, v in values.items() if k.startswith(prefix)}
        bad = sorted(k for k in want if k not in flat or not _same_bits(flat[k], want[k]))
        if set(flat) != set(want) or bad:
            raise AssertionError(f"fixture {name}: leaves differ from values.npz: "
                                 f"{bad[:5]}, extra {sorted(set(flat) - set(want))[:5]}")
        print(f"fixture {name} (written by the JAX package): {len(want)} leaves equal in "
              f"bits to values.npz, restored in {dt:.3f} s")
        store = ocdbt.Store(path)
        frames += [v.tobytes() for v in map(store.get, store.keys())
                   if v[:4].tobytes() == zstd.MAGIC]
        for d, _, files in os.walk(path):
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    head = fh.read(14)
                    if len(head) == 14 and head[:4] in (b"\x0c\xdb\x3a\x2a", b"\x0c\xdb\x20\xde") \
                            and head[13] == 1:  # a zstd-compressed manifest or node
                        length = struct.unpack("<Q", head[4:12])[0]
                        frames.append(fh.read(length - 18))
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    t0 = time.perf_counter()
    for _ in range(ORBAX_DECODE_REPS):
        for f in frames:
            zstd.decompress(f)
    dt = (time.perf_counter() - t0) / ORBAX_DECODE_REPS
    packed = sum(len(f) for f in frames)
    print(f"zstd decoder (native/zstd.cpp, one host thread): {len(frames)} frames of the "
          f"fixture, {packed} bytes -> {decoded} bytes in {dt * 1e3:.2f} ms: "
          f"{decoded / dt / 1e6:.1f} MB/s decoded ({packed / dt / 1e6:.1f} MB/s in); {card}")


def orbax_checkpoints(train_args, build, card: str, per_step: dict) -> None:
    """Phase 17: (a) the fixture; (b) config.yaml's Swin-B at 512^2 b2, drop
    rates 0: ORBAX_STEPS steps (launches ORBAX_STEPS x phase 6's), the
    asynchronous orbax save_best and save_last read back in bits, one step
    after resuming from epoch_N.orbax against the step without the save
    (loss and parameters in bits, cuDNN deterministic), and the test CLI on
    the orbax directory against a .pth of the same weights (Score to 1e-6)."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import train_batch
    import shutil

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import test_cli
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train import checkpoint, optim

    orbax_fixture(card)
    MSUNet, create_train_state, make_train_step = train_args
    root = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(root, "model_out", "chip_smoke_phase17")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                     torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        data = os.path.join(run_dir, "data")
        generate_synthetic_dataset(data, img_size=ORBAX_IMG, seed=0, **ORBAX_SPLIT)
        cfg_path = os.path.join(run_dir, "phase17.yaml")
        with open(cfg_path, "w") as f:
            f.write(f"BASE: ['{os.path.join(root, 'config.yaml')}']\n"
                    f"DATA:\n  DATA_PATH: '{data}'\n  IMG_SIZE: {ORBAX_IMG}\n"
                    f"MODEL:\n  PRETRAIN_WEIGHTS: none\n  DROP_RATE: 0.0\n"
                    f"  ATTN_DROP_RATE: 0.0\n  DROP_PATH_RATE: 0.0\n"
                    f"OUTPUT_DIR: '{os.path.join(run_dir, 'train')}'\n"
                    f"LIST_DIR: '{os.path.join(data, 'lists')}'\n")
        cfg = load_config(cfg_path)
        t = cfg.TRAIN
        loss_args = (float(t.TVERSKY_LOSS_ALPHA), float(t.TVERSKY_LOSS_BETA),
                     float(t.LOSS_TVERSKY_BCE_MIX))
        model = MSUNet.from_config(cfg)
        state = create_train_state(model, cfg)
        step = make_train_step(model, *loss_args)
        rng = np.random.default_rng(17)
        batches = [train_batch(rng, 2, ORBAX_IMG) for _ in range(ORBAX_STEPS + 1)]
        build.reset_launches()
        losses = [step(state, *batches[i], 1e-4).item() for i in range(ORBAX_STEPS)]
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        want = {k: ORBAX_STEPS * v for k, v in per_step.items()}
        print(f"config.yaml Swin-B {ORBAX_IMG}^2 b2, drop rates 0: {ORBAX_STEPS} steps, "
              f"losses {losses}, launches {launches}")
        if launches != want or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"phase 17 steps: launches {launches} != {want} or losses "
                                 f"{losses} not finite")

        # -- the asynchronous orbax saves, then a .pth of the same weights --
        ckpt_dir, pth_dir = os.path.join(run_dir, "orbax"), os.path.join(run_dir, "pth")
        writer = checkpoint.CheckpointWriter(backend="orbax", async_=True)
        t0 = time.perf_counter()
        best = writer.save_best(ckpt_dir, model, ORBAX_STEPS, 0.5)
        last = writer.save_last(ckpt_dir, 1, model, state.optimizer, state.step, 0.25)
        t_submit = time.perf_counter() - t0
        writer.close()
        t_write = time.perf_counter() - t0
        checkpoint.CheckpointWriter().save_best(pth_dir, model, ORBAX_STEPS, 0.5)
        sizes = {n: _dir_bytes(p) for n, p in (("best_model.orbax", best),
                                               ("epoch_1.orbax", last))}
        t0 = time.perf_counter()
        got_best = checkpoint.load_orbax(best)
        t_best = time.perf_counter() - t0
        got_last = checkpoint.load_orbax(last)
        t_read = time.perf_counter() - t0
        sd = model.ms_unet.state_dict()
        bad = [k for k, v in got_best["model"].items() if not _same_bits(v, sd[k])]
        bad += [k for k, v in got_last["model"].items() if not _same_bits(v, sd[k])]
        saved_opt = _flat_tree(got_last["optimizer"])
        live_opt = _flat_tree(optim.to_optax(state.optimizer, model))
        bad += [k for k in live_opt if k not in saved_opt or not _same_bits(saved_opt[k],
                                                                              live_opt[k])]
        params = {n for n, _ in model.ms_unet.named_parameters()}
        if bad or set(saved_opt) != set(live_opt) or set(got_best["model"]) != params:
            raise AssertionError(f"orbax read-back differs: {bad[:5]}")
        print(f"orbax save (async): submit {t_submit:.2f} s (host copies), written "
              f"{t_write:.2f} s after the first save; best_model.orbax "
              f"{sizes['best_model.orbax']} bytes, epoch_1.orbax {sizes['epoch_1.orbax']} "
              f"bytes; read {t_best:.2f} s + {t_read - t_best:.2f} s, "
              f"{len(got_best['model'])} + {len(live_opt)} tensors equal in bits; {card}")

        # -- one step after resuming from epoch_1.orbax against the step
        # without the save --
        resumed = MSUNet.from_config(cfg)
        resumed.ms_unet.load_state_dict(got_last["model"], strict=True)
        state2 = create_train_state(resumed, cfg)
        optim.load_optax(state2.optimizer, resumed, got_last["optimizer"], last)
        state2.step = int(got_last["iter_num"])
        step2 = make_train_step(resumed, *loss_args)
        build.reset_launches()
        l_live = step(state, *batches[-1], 1e-4).item()
        l_resumed = step2(state2, *batches[-1], 1e-4).item()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        diffs = {n: (p - q).abs().max().item() for (n, p), q in zip(
            model.named_parameters(), resumed.parameters()) if not torch.equal(p, q)}
        print(f"step {ORBAX_STEPS + 1}: without the save loss {l_live!r}, resumed from "
              f"epoch_1.orbax loss {l_resumed!r}; parameters differing in bits: "
              f"{len(diffs)} {sorted(diffs.items(), key=lambda kv: -kv[1])[:3]}; "
              f"launches {launches}")
        if l_live != l_resumed or diffs or launches != {k: 2 * v for k, v in per_step.items()}:
            raise AssertionError("the resumed step differs from the step without the save")

        # -- the test CLI: the orbax directory against the .pth of the same weights --
        n_val = ORBAX_SPLIT["n_val_fake"] + ORBAX_SPLIT["n_val_real"]
        want = {k: n_val * CLI_FORWARD.get(k, 0) for k in build.LAUNCHES}
        scores = {}
        for label, ckpt in (("orbax", ckpt_dir), ("pth", pth_dir)):
            build.reset_launches()
            t0 = time.perf_counter()
            (_, score, _), _ = run_captured(test_cli.main, [
                "--cfg", cfg_path, "--check_point_dir", ckpt, "--out_dir",
                os.path.join(run_dir, f"test_{label}"), "--split", "val"])
            scores[label] = score
            launches = dict(build.LAUNCHES)
            print(f"test CLI on the {label} checkpoint: Score {score!r} in "
                  f"{time.perf_counter() - t0:.1f} s; launches {launches}")
            if launches != want:
                raise AssertionError(f"test CLI launches {launches} != {want}")
        if not abs(scores["orbax"] - scores["pth"]) <= SCORE_TOL:
            raise AssertionError(f"test CLI Scores {scores} differ (tol {SCORE_TOL:g})")
        del state, state2, model, resumed
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic[:2]
        torch.use_deterministic_algorithms(deterministic[2])
        shutil.rmtree(run_dir, ignore_errors=True)


# phase 18: Swin-B at window 12 (the geometry of Microsoft's published
# swin_base_patch4_window12_384 and of mmsegmentation's UperNet Swin-B
# 512x512 config; config.yaml's widths otherwise), 144 tokens a window: every
# attention call takes the tiled kernels.  Stage grids 128/64/32/16 pad to
# 132/72/36/24 at 512^2, shift 6 in every other block.
W12 = 12
W12_CHANGES = {"MODEL.SWIN.WINDOW_SIZE": W12}
W12_FORWARD = dict(window_attention_tiled=52, patch_merge=3, patch_expand=6, refine_head=1)
W12_STEP = dict(window_attention_tiled=52, window_attention_bwd_tiled=48, patch_merge=3,
                patch_merge_bwd=3, patch_expand=6, patch_expand_bwd=6, refine_head_res=1,
                refine_head_bwd=1)
# (B, Hp, Wp, C, heads, window, sh, sw): what each case is there for, and the
# family each type takes: bf16 at head widths a multiple of 16 the tiled
# mma.sync kernels (one-block up to 144 tokens, and in the backward up to
# head width 32; split beyond), float32 and other widths the CUDA-core ones,
# whose head width picks the columns a thread owns (OC 1, 2, 4, 8 up to 16,
# 32, 64, 128)
MMA_ROUTES = {"f32": "tiled", "bf16": "tiled mma.sync"}
CORE_ROUTES = {"f32": "tiled", "bf16": "tiled"}
W12_CORNERS = [
    ((2, 10, 26, 64, 2, (5, 13), 2, 6),
     "65 tokens: one row in the last band, keys not a multiple of 8", MMA_ROUTES),
    ((1, 24, 36, 32, 1, (12, 12), 0, 0), "144 tokens unshifted, one image, one head",
     MMA_ROUTES),
    ((2, 24, 24, 96, 6, (12, 12), 6, 6), "144 tokens shifted, head width 16", MMA_ROUTES),
    ((2, 24, 24, 128, 2, (12, 12), 6, 6),
     "head width 64: one-block forward, split backward", MMA_ROUTES),
    ((1, 24, 36, 256, 2, (12, 12), 6, 0),
     "head width 128, shift on one axis: one stage of the forward's ring", MMA_ROUTES),
    ((1, 24, 24, 96, 2, (12, 12), 0, 6), "head width 48: columns past the width",
     MMA_ROUTES),
    ((4, 72, 72, 512, 4, (9, 9), 4, 4),
     "81 tokens, head width 128: split backward, groups of 4 windows", MMA_ROUTES),
    ((1, 44, 44, 128, 2, (22, 22), 11, 11),
     "484 tokens (window 22, shift 11), head width 64: the key split", MMA_ROUTES),
    ((1, 24, 24, 256, 2, (24, 24), 0, 0),
     "576 tokens (window 24): one window, head width 128, the key split", MMA_ROUTES),
    ((2, 36, 24, 72, 3, (12, 12), 6, 6), "head width 24: the CUDA-core kernels in bf16 (OC 2)",
     CORE_ROUTES),
    ((2, 24, 24, 16, 2, (12, 12), 6, 6), "head width 8: the CUDA-core kernels in bf16 (OC 1)",
     CORE_ROUTES),
    ((1, 24, 36, 80, 2, (12, 12), 6, 0), "head width 40: the CUDA-core kernels in bf16 (OC 4)",
     CORE_ROUTES),
    ((1, 24, 24, 144, 2, (12, 12), 0, 6),
     "head width 72: the CUDA-core kernels in bf16 (OC 8)", CORE_ROUTES),
]
GUARD = 4096  # NaN elements before and after every buffer the kernels write


def _guarded(shape, dtype):
    """A NaN-filled buffer with ``GUARD`` elements before and after the
    returned view of ``shape`` (16-byte aligned: GUARD is a multiple of 8)."""
    numel = math.prod(shape)
    buf = torch.full((numel + 2 * GUARD,), float("nan"), dtype=dtype, device="cuda")
    return buf, buf[GUARD:GUARD + numel].view(shape)


def check_attention_guards(build, fwa, gen, cases) -> None:
    """The tiled kernels write every element of ctx, dqkv and dbias and
    nothing outside them or their scratch, and leave their inputs as they
    were (compute-sanitizer does not run on this card): each output and the
    scratch sized as ``bwd_plan`` sizes it lie in NaN-filled buffers with NaN
    guards, launched through the C entry points at the wrappers' plans, in
    both types.  ``cases``: (B, Hp, Wp, C, heads, window, sh, sw)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, hp, wp, dim, heads, (wh, ww), sh, sw in cases:
        n, n_win, hd = wh * ww, (hp // wh) * (wp // ww), dim // heads
        qkv32 = torch.randn((b, hp, wp, 3 * dim), generator=gen, device="cuda")
        d32 = torch.randn((b, hp, wp, dim), generator=gen, device="cuda")
        bias = torch.randn((heads, n, n), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            qkv, d = qkv32.to(dtype), d32.to(dtype)
            route = fwa._route(qkv, wh, ww, heads, sh, sw)
            plan, scratch = fwa.bwd_plan(route, b, n_win, heads, n, sms, hd)
            ints = [b, hp, wp, dim, heads, wh, ww, sh, sw, route]
            inputs = [t.clone() for t in (qkv, d, bias)]
            obuf, out = _guarded((b, hp, wp, dim), dtype)
            gbuf, dqkv = _guarded(tuple(qkv.shape), dtype)
            pbuf, part = _guarded(scratch, torch.float32)
            bbuf, dbias = _guarded((heads, n, n), torch.float32)
            build.launch("window_attention_tiled", "ssa_window_attention_fwd", [qkv, bias, out],
                         ints + [fwa.fwd_plan(route, b, n_win, heads, n, sms, hd)], dtype)
            build.launch("window_attention_bwd_tiled", "ssa_window_attention_bwd",
                         [qkv, d, bias, dqkv, part, dbias], ints + [plan], dtype)
            torch.cuda.synchronize()
            label = (f"qkv{tuple(qkv.shape)} window {(wh, ww)} heads {heads} shift {(sh, sw)} "
                     f"{dtype} route {route}")
            for name, buf, view in (("ctx", obuf, out), ("dqkv", gbuf, dqkv),
                                    ("dbias", bbuf, dbias), ("scratch", pbuf, None)):
                if not (buf[:GUARD].isnan().all() and buf[-GUARD:].isnan().all()):
                    raise AssertionError(f"guards {label}: a write past {name}")
                if view is not None and view.isnan().any():
                    raise AssertionError(f"guards {label}: {name} not wholly written")
            if not all(torch.equal(x, y) for x, y in zip(inputs, (qkv, d, bias))):
                raise AssertionError(f"guards {label}: an input changed")
            print(f"  guards {label}: every output element written, nothing outside")


def window12_cli(build, card: str) -> None:
    """(e): the predict CLI at ``WINDOW_SIZE: 12`` over phase 10's synthetic
    val split (1024^2, seed 0), on a checkpoint of seeded weights."""
    import os
    import shutil

    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import predict_cli
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
        generate_synthetic_dataset,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet

    root = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(root, "model_out", "chip_smoke_phase18")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        data = os.path.join(run_dir, "data")
        generate_synthetic_dataset(data, img_size=2 * IMG, seed=0, **CLI_SPLIT)
        cfg_path = os.path.join(run_dir, "window12.yaml")
        with open(cfg_path, "w") as f:
            f.write(f"BASE: ['{os.path.join(root, 'config.yaml')}']\n"
                    f"DATA:\n  DATA_PATH: '{data}'\n"
                    f"MODEL:\n  PRETRAIN_WEIGHTS: none\n  SWIN:\n    WINDOW_SIZE: {W12}\n"
                    f"LIST_DIR: '{os.path.join(data, 'lists')}'\n")
        ckpt = os.path.join(run_dir, "ckpt")
        os.makedirs(ckpt)
        torch.save(MSUNet.from_config(load_config(cfg_path), device="cpu").state_dict(),
                   os.path.join(ckpt, "best_model.pth"))
        pred_dir = os.path.join(run_dir, "predict")
        n_val = CLI_SPLIT["n_val_fake"] + CLI_SPLIT["n_val_real"]
        build.reset_launches()
        t0 = time.perf_counter()
        preds, _ = run_captured(predict_cli.main, [
            "--cfg", cfg_path, "--check_point_dir", ckpt, "--out_dir", pred_dir,
            "--split", "val"])
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        want = expect(build, **{k: n_val * v for k, v in W12_FORWARD.items()})
        print(f"predict CLI at window 12 over {n_val} val cases 1024^2: {wall:.2f} s in all, "
              f"{n_val / wall:.3f} cases/s (host clock); launches {launches}; {card}")
        pngs = [n for n in os.listdir(pred_dir) if n.endswith(".png")]
        if launches != want or len(preds) != n_val or len(pngs) != 4 * n_val or not all(
                np.isfinite(p).all() for _, p in preds):
            raise AssertionError(f"predict CLI at window 12: {len(preds)} cases, {len(pngs)} "
                                 f"files, launches {launches} != {want}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def window12(train_args, build, fwa, wa, gen, rng, images, card: str) -> tuple:
    """Phase 18: the tiled kernels against their plain versions at the
    window-12 Swin-B 512^2 b8 stage shapes and at ``W12_CORNERS``; the
    window-12 predict step, bench.py's train step and an f32 train step
    against the composed path; the predict CLI.  Returns the two rows."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
        attention_plan,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import (
        deployment_config,
    )
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
        make_predict_step,
    )

    MSUNet = train_args[0]
    t0 = time.perf_counter()
    print(f"(a) tiled kernels vs plain, window {W12} (512^2 batch 8 shapes; ms are bf16):")
    routes = {"f32": fwa.ROUTE_TILED, "bf16": fwa.ROUTE_TILED_MMA}
    attn = check_attention(fwa, wa, gen, ws=W12, route=routes, rep=KernelReport(
        "window_attention_tiled", "fused_window_attention_tiled.cu",
        "fused_window_attention.py:561"))
    torch.cuda.empty_cache()
    attn_bwd = check_attention_bwd(fwa, wa, gen, ws=W12, route=routes, rep=KernelReport(
        "window_attention_bwd_tiled", "fused_window_attention_tiled.cu",
        "fused_window_attention.py:597"))
    torch.cuda.empty_cache()
    check_attention_corners(fwa, wa, gen, W12_CORNERS, timed=True)
    torch.cuda.empty_cache()
    check_attention_guards(build, fwa, gen, [
        (B, hp, wp, STAGES[stage][0], STAGES[stage][1], (W12, W12), sh, sw)
        for stage, hp, wp, sh, sw in stage_shapes(wa, W12)] + [c[0] for c in W12_CORNERS])
    torch.cuda.empty_cache()
    print(f"phase 18 (a): {time.perf_counter() - t0:.1f} s")

    cfg = deployment_config(**W12_CHANGES)
    model = MSUNet.from_config(cfg)
    print("(b) window-12 model: " + "; ".join(attention_plan(model)))
    step = make_predict_step(model)
    launches, _ = run_predict(step, images, build, expect(build, **W12_FORWARD),
                              "Swin-B window 12")
    attn.row["launches"] = launches["window_attention_tiled"]
    fwd_ms = time_predict(step, images, "Swin-B window 12")
    profile_forward(step, images, fwd_ms, what="window-12 forward")
    del step, model
    torch.cuda.empty_cache()

    print("(c) bench.py's train step at window 12:")
    launches, _ = run_train_step(train_args, build, rng, W12_CHANGES,
                                 expect(build, **W12_STEP), "Swin-B window 12")
    attn_bwd.row["launches"] = launches["window_attention_bwd_tiled"]
    torch.cuda.empty_cache()
    print("(d) f32 train step at window 12, kernel vs composed path:")
    check_train_e2e(train_args, rng, W12_CHANGES, "Swin-B window 12")
    torch.cuda.empty_cache()
    print("(e) predict CLI at window 12:")
    window12_cli(build, card)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s; {card}")
    return attn, attn_bwd


@contextlib.contextmanager
def phase(n: int, name: str):
    """Run one phase of the smoke; on any error say which on stdout and
    re-raise, so the exit is non-zero and the failure has a name."""
    try:
        yield
    except BaseException as e:
        print(f"chip_smoke: phase {n} {name} failed: {type(e).__name__}: {e}", flush=True)
        raise


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
            MSUNet,
        )
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import (
            _build,
            fused_head,
            fused_patch,
            fused_refine_head,
            fused_window_attention,
            window_attention,
        )
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.inference import (
            artifact_prediction,
            tiled_predict,
        )
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.train.state import (
            create_train_state,
            make_predict_step,
            make_train_step,
        )
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.dp_check import (
            COMPOSED,
            PER_STEP,
            deployment_config,
        )
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase(1, "card and build"):
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        _build.library()
        print(f"build: {time.perf_counter() - t0:.1f} s")
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"  ptxas: {line.strip()}")

    with phase(2, "forward kernels against their plain versions"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        print("kernels vs plain (512^2 batch 8 shapes; ms are bf16, per launch):")
        attn = check_attention(fused_window_attention, window_attention, gen)
        check_attention(fused_window_attention, window_attention, gen, SWIN_T_STAGES, attn,
                        main_path=False)
        check_attention_corners(fused_window_attention, window_attention, gen)
        merge, expand = check_patch(fused_patch, gen)
        check_patch_fwd_corners(fused_patch, gen)
        torch.cuda.empty_cache()
        refine = check_refine_head(fused_refine_head, gen)
        torch.cuda.empty_cache()
        check_refine_ragged(fused_refine_head, gen)
        gelu_f, gelu_b = check_gelu_d2s4(fused_head, gen)
        torch.cuda.empty_cache()

    with phase(3, "Swin-B predict path"):
        cfg = deployment_config()
        t0 = time.perf_counter()
        model = MSUNet.from_config(cfg)
        n_params = sum(p.numel() for p in model.parameters())
        blocks = sum(len(st.blocks) for mod in (model.ms_unet.layers, model.ms_unet.layers_up,
                                                 model.ms_unet.layers_cent1,
                                                 model.ms_unet.layers_cent2)
                     for st in mod if hasattr(st, "blocks"))
        print(f"model: {n_params} params, {blocks} Swin blocks, dtype {model.dtype}, "
              f"built in {time.perf_counter() - t0:.1f} s")
        step = make_predict_step(model)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
        launches, probs = run_predict(
            step, images, _build, expect(_build, window_attention=52, patch_merge=3,
                                         patch_expand=6, refine_head=1), "Swin-B")
        for r in (attn, merge, expand, refine):
            r.row["launches"] = launches[r.row["name"]]
        fwd_ms = time_predict(step, images, "Swin-B")
        profile_forward(step, images, fwd_ms)

        loader = [{"image": rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
                   "case_name": [f"case{i}_{j}" for j in range(B)]} for i in range(2)]
        preds = artifact_prediction(step, loader)
        assert len(preds) == 2 and all(p.shape == (IMG, IMG) and np.isfinite(p).all()
                                       for _, p in preds)
        big = rng.integers(0, 256, (2 * IMG, 2 * IMG, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        tiled = tiled_predict(step, big, tile=IMG, overlap=0.5, batch_tiles=B)
        print(f"artifact_prediction: {len(preds)} cases; tiled_predict 1024^2 (9 tiles): "
              f"{tiled.shape} in {time.perf_counter() - t0:.2f} s")
        assert tiled.shape == (2 * IMG, 2 * IMG) and np.isfinite(tiled).all()
        del step, model, probs
        torch.cuda.empty_cache()

    with phase(4, "f32 logits, kernel path against the composed path"):
        kern = MSUNet.from_config(cfg, dtype=torch.float32)
        comp = MSUNet.from_config(deployment_config(**COMPOSED),
                                  dtype=torch.float32)
        comp.load_state_dict(kern.state_dict())
        x = torch.from_numpy(images[:2]).cuda().float() / 255.0
        with torch.inference_mode():
            a, b = kern(x), comp(x)
        diff = (a - b).abs().max().item()
        print(f"end-to-end f32 512^2 b2 logits, kernel vs composed path: max_abs_diff "
              f"{diff:.3e} (tol {E2E_TOL:g}); logit range [{b.min().item():.3f}, "
              f"{b.max().item():.3f}]")
        if not math.isfinite(diff) or diff > E2E_TOL:
            raise AssertionError(f"end-to-end diff {diff} > {E2E_TOL}")
        del kern, comp, a, b
        torch.cuda.empty_cache()

    with phase(5, "training kernels against their plain versions"):
        print("training kernels vs plain (512^2 batch 8 train-step shapes; ms are bf16):")
        attn_bwd = check_attention_bwd(fused_window_attention, window_attention, gen)
        check_attention_bwd(fused_window_attention, window_attention, gen, SWIN_T_STAGES,
                            attn_bwd, main_path=False)
        torch.cuda.empty_cache()
        res, bwd = check_refine_train(fused_refine_head, gen)
        torch.cuda.empty_cache()
        merge_bwd, expand_bwd = check_patch_bwd(fused_patch, gen)
        check_patch_bwd_corners(fused_patch, gen)
        torch.cuda.empty_cache()
        check_plain_backwards(fused_window_attention, fused_refine_head, fused_patch,
                              fused_head, window_attention, gen)
        torch.cuda.empty_cache()

    train_args = (MSUNet, create_train_state, make_train_step)
    with phase(6, "Swin-B train step, every knob on, then FUSED_PATCH off"):
        # 48 backwards for 52 forwards: the last stage of each cent decoder (2 +
        # 2 blocks) feeds nothing the loss reads (the reference drops its
        # output), so autograd runs no backward through it.  Every merge and
        # expand has a backward: cent decoder 2's expand feeds skip 0, cent
        # decoder 1's two feed skips 1 and 0, the main decoder's three the head.
        launches, _ = run_train_step(train_args, _build, rng, {}, expect(_build, **PER_STEP),
                                     "Swin-B")
        for r in (attn_bwd, res, bwd, merge_bwd, expand_bwd):
            r.row["launches"] = launches[r.row["name"]]
        phase6_launches = launches
        torch.cuda.empty_cache()
        run_train_step(train_args, _build, rng, {"TPU.FUSED_PATCH": False}, expect(
            _build, window_attention=52, window_attention_bwd=48, refine_head_res=1,
            refine_head_bwd=1), "Swin-B FUSED_PATCH off")
        torch.cuda.empty_cache()

    with phase(7, "Swin-B f32 train step against the composed path"):
        check_train_e2e(train_args, rng, {}, "Swin-B")
        torch.cuda.empty_cache()

    with phase(8, "Swin-T predict, train step and f32 train check"):
        cfg = deployment_config(**SWIN_T)
        model = MSUNet.from_config(cfg)
        print(f"Swin-T model: {sum(p.numel() for p in model.parameters())} params, head "
              f"GELU+depth-to-space kernel {model.ms_unet.up.fused_gelu_d2s}")
        step = make_predict_step(model)
        launches, _ = run_predict(
            step, images, _build, expect(_build, window_attention=28, patch_merge=3,
                                         patch_expand=6, gelu_d2s4=1), "Swin-T")
        gelu_f.row["launches"] = launches["gelu_d2s4"]
        fwd_ms = time_predict(step, images, "Swin-T")
        profile_forward(step, images, fwd_ms, what="Swin-T forward")
        del step, model
        torch.cuda.empty_cache()
        launches, _ = run_train_step(
            train_args, _build, rng, SWIN_T, expect(
                _build, window_attention=28, window_attention_bwd=24, patch_merge=3,
                patch_merge_bwd=3, patch_expand=6, patch_expand_bwd=6, gelu_d2s4=1,
                gelu_d2s4_bwd=1), "Swin-T")
        gelu_b.row["launches"] = launches["gelu_d2s4_bwd"]
        torch.cuda.empty_cache()
        check_train_e2e(train_args, rng, SWIN_T, "Swin-T")

    with phase(10, "training run through the CLIs"):
        training_run(_build, card)
        torch.cuda.empty_cache()

    with phase(11, "recomputation"):
        recomputation(train_args, _build, rng, card)
        torch.cuda.empty_cache()

    with phase(12, "grid search"):
        grid_search(card)

    with phase(13, "parity and epoch bench"):
        parity_and_epoch_bench(_build, card)
        torch.cuda.empty_cache()

    with phase(14, "data parallel"):
        data_parallel(train_args, _build, rng, card, phase6_launches)
        torch.cuda.empty_cache()

    with phase(15, "tensor and spatial parallelism"):
        t0 = time.perf_counter()
        tensor_and_spatial(rng, card)
        print(f"phase 15: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    with phase(16, "native decode"):
        t0 = time.perf_counter()
        native_decode(train_args, _build, card, phase6_launches)
        print(f"phase 16: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    with phase(17, "orbax checkpoints"):
        t0 = time.perf_counter()
        orbax_checkpoints(train_args, _build, card, phase6_launches)
        print(f"phase 17: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    with phase(18, "Swin-B at window 12: the tiled attention kernels"):
        attn12, attn12_bwd = window12(train_args, _build, fused_window_attention,
                                      window_attention, gen, rng, images, card)
        torch.cuda.empty_cache()

    with phase(9, "report"):
        reports = [attn, attn_bwd, attn12, attn12_bwd, merge, merge_bwd, expand, expand_bwd,
                   refine, res, bwd, gelu_f, gelu_b]
        if len(reports) != len(_build.LAUNCHES):
            raise AssertionError(f"{len(reports)} kernel rows for {len(_build.LAUNCHES)} "
                                 "launch counters")
        print("Swin-T path, per forward or step, kernel / plain / bound ms (bf16): " +
              "; ".join(r.swin_t() for r in reports if r.t_sums[0]))
        print(json.dumps({"kernels": [r.row for r in reports]}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
