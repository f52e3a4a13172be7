#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``csrc/`` and then, in order:

1. prints the card's name and power limit and the build time;
2. checks each kernel against its plain PyTorch version at the shapes the
   512^2 batch-8 predict path gives it, in float32 and in bfloat16, each
   error beside its stated tolerance, and times kernel, plain version and
   (for attention) one ``scaled_dot_product_attention`` call;
3. drives the predict path of the full Swin-B MS-UNet (512^2, batch 8,
   bfloat16, all three kernel knobs on, seeded weights) through
   ``make_predict_step`` with the launch counts zeroed just before and
   read just after, then times it, and runs ``artifact_prediction`` and a
   1024^2 ``tiled_predict``;
4. holds the kernel path's float32 logits against the composed path
   (knobs off) at 512^2, batch 2;
5. checks the training kernels (attention backward, refine-head training
   forward and backward) against their plain versions at the shapes of the
   512^2 batch-8 train step, in float32 and bfloat16, and the plain
   backwards against ``torch.autograd`` of the plain forwards, and times
   kernel, plain version and yardstick;
6. drives the train step of the full Swin-B MS-UNet (bench.py's
   configuration: 512^2, batch 8, bf16 compute, f32 params, attention and
   head kernels on, FUSED_PATCH off, drop-path 0.1) through
   ``make_train_step`` with the launch counts zeroed just before one step
   and read just after, times ten steps on a fixed batch (the loss must
   fall) and profiles one;
7. holds one float32 train step on the kernel path against the composed
   path (loss and every parameter's gradient) at 512^2, batch 2, and
   checks that a train step with FUSED_PATCH on raises;
8. prints the kernels line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  It imports torch, numpy, the
standard library and the port; without a GPU, or without the port beside
it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
BF16_FLOP_PER_S = 989e12    # H100 SXM dense tensor cores
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
TOL = {
    "window_attention": {"f32": 1e-4, "bf16": 1e-2},
    "window_attention_bwd": {"f32": 1e-4, "bf16": 2e-2},
    "patch_merge": {"f32": 1e-4, "bf16": 1e-2},
    "patch_expand": {"f32": 1e-4, "bf16": 1e-2},
    "refine_head": {"f32": 1e-4, "bf16": 5e-2},
    "refine_head_res": {"f32": 1e-4, "bf16": 5e-2},
    "refine_head_bwd": {"f32": 1e-3, "bf16": 5e-2},
}
E2E_TOL = 1e-3
# plain backward vs torch.autograd of the plain forward, float32: the same
# arithmetic in another order
AUTOGRAD_TOL = 1e-4
# f32 train step, kernel path vs composed path: the loss (a mean over
# 2 x 512^2 pixels) and each gradient relative to max(1, max|g|); the two
# paths sum attention, its backward and the head in other orders, which
# the 52 blocks' backward compounds
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


def bound_ms(n_bytes: float, flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
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
    """Per-kernel sums over the main path's launches of one forward."""

    def __init__(self, name, source, replaces):
        self.row = dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
                        replaces=f"{JAX_PKG}/ops/{replaces}", launches=0,
                        max_abs_err=0.0, max_abs_err_f32=0.0, ms=0.0, plain_ms=0.0,
                        bound_ms=0.0, bound_by="", library_ms=None)
        self._by = {"bytes": 0.0, "operations": 0.0}

    def add(self, shape_label, count, errs, ms, plain_ms, b_ms, by, lib_ms=None):
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
        r["max_abs_err_f32"] = max(r["max_abs_err_f32"], errs["f32"][0])
        r["ms"] += count * ms
        r["plain_ms"] += count * plain_ms
        r["bound_ms"] += count * b_ms
        self._by[by] += count * b_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + count * lib_ms
        r["bound_by"] = max(self._by, key=self._by.get)


# dim, heads, Swin blocks on the forward path, blocks with a backward in
# the train step (the last stage of each cent decoder, 2 + 2 stage-0 blocks,
# feeds nothing the loss reads)
STAGES = [(128, 4, 8, 4), (256, 8, 6, 6), (512, 16, 36, 36), (1024, 32, 2, 2)]


def stage_shapes(wa):
    """(stage, shift, hp, wp, sh, sw) of every attention shape of the path."""
    ws, tokens = 7, IMG // 4
    for stage in range(4):
        g = tokens >> stage
        for shift in (0, 3):
            yield (stage, *wa.effective_shift(g, g, (ws, ws), (shift, shift)))


def check_attention_bwd(fwa, wa, gen) -> KernelReport:
    rep = KernelReport("window_attention_bwd", "fused_window_attention.cu",
                       "fused_window_attention.py:597")
    ws, n = 7, 49
    for stage, hp, wp, sh, sw in stage_shapes(wa):
        dim, heads, _, blocks = STAGES[stage]
        kw = dict(wh=ws, ww=ws, heads=heads, sh=sh, sw=sw)
        qkv32 = torch.randn((B, hp, wp, 3 * dim), generator=gen, device="cuda")
        d32 = torch.randn((B, hp, wp, dim), generator=gen, device="cuda")
        table = torch.randn(((2 * ws - 1) ** 2, heads), generator=gen, device="cuda")
        bias = wa.gather_bias(table, ws, ws, heads).float().contiguous()
        label = f"qkv{tuple(qkv32.shape)} shift{(sh, sw)}"
        errs = {}
        for dt in ("f32", "bf16"):
            qkv, d = (qkv32, d32) if dt == "f32" else (qkv32.bfloat16(), d32.bfloat16())
            errs[dt] = multi_err(f"{label} {dt}", fwa.window_attention_bwd(qkv, d, bias, **kw),
                                 fwa.window_attention_bwd_reference(qkv, d, bias, **kw),
                                 ("dqkv", "dbias"))
        qkv, d = qkv32.bfloat16(), d32.bfloat16()
        ms = cuda_ms(lambda: fwa.window_attention_bwd(qkv, d, bias, **kw), 10)
        plain = cuda_ms(lambda: fwa.window_attention_bwd_reference(qkv, d, bias, **kw), 2)
        # yardstick: the backward of one SDPA call on pre-partitioned
        # (B, nW, heads, 49, hd) with the bias (+ shift mask) as attn_mask
        hd = dim // heads
        part = qkv.reshape(B, hp // ws, ws, wp // ws, ws, 3, heads, hd).permute(
            5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B, -1, heads, n, hd).contiguous()
        mask = bias[None].expand(part.shape[2], -1, -1, -1)
        if sh or sw:
            sm = torch.as_tensor(wa.shifted_window_mask(hp, wp, ws, ws, sh, sw), device="cuda")
            mask = mask + sm[:, None]
        mask = mask.to(torch.bfloat16).contiguous().requires_grad_()
        q, k, v = (t.detach().requires_grad_() for t in part)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        dout = torch.randn_like(out)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v, mask), dout,
                                                  retain_graph=True), 5)
        del out
        n_win = B * (hp // ws) * (wp // ws)
        b_ms, by = bound_ms(nbytes(qkv, d, bias) + qkv.numel() * 2 + bias.numel() * 4,
                            10.0 * n_win * heads * n * n * hd)
        rep.add(label, blocks // 2, errs, ms, plain, b_ms, by, lib)
    return rep


def refine_inputs(gen, batch):
    c, ht = 128, IMG // 4
    y32 = torch.randn((batch, ht, ht, 16 * c), generator=gen, device="cuda") * 0.5
    p = [torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.03,
         0.1 * torch.randn(c, generator=gen, device="cuda"),
         torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.03,
         0.1 * torch.randn(c, generator=gen, device="cuda"),
         1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
         0.1 * torch.randn(c, generator=gen, device="cuda")]
    return y32, p


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
        bwd_errs[dt] = multi_err(f"bwd {dt}", frh._bwd_kernel(*args),
                                 frh.refine_head_bwd_reference(*args),
                                 ("dy", "dw1", "db1", "dw2", "db2", "dgamma", "dbeta"))
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
    # context, not a yardstick: no single PyTorch call computes the head;
    # the composed cuDNN path (GELU, depth-to-space, two convs, LayerNorm)
    # forward + backward in bf16
    w = [t.bfloat16().requires_grad_() for t in p]
    yy = y.detach().requires_grad_()

    def composed():
        x = F.gelu(yy.float(), approximate="tanh").bfloat16()
        x = x.reshape(B, IMG // 4, IMG // 4, 4, 4, c).permute(0, 5, 1, 3, 2, 4).reshape(
            B, c, IMG, IMG)
        x = F.gelu(F.conv2d(x, w[0], w[1], padding=1), approximate="tanh")
        x = F.conv2d(x, w[2], w[3], padding=1).permute(0, 2, 3, 1)
        out = F.layer_norm(x, (c,), w[4], w[5])
        torch.autograd.grad(out, (yy, *w), dout)

    print(f"  refine head composed cuDNN path fwd+bwd (context): "
          f"{cuda_ms(composed, 3):.4f} ms")
    return res, bwd


def check_plain_backwards(fwa, frh, wa, gen) -> None:
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


def check_attention(fwa, wa, gen) -> KernelReport:
    rep = KernelReport("window_attention", "fused_window_attention.cu",
                       "fused_window_attention.py:561")
    ws, tokens = 7, IMG // 4
    for stage, (dim, heads, blocks) in enumerate(
            [(128, 4, 8), (256, 8, 6), (512, 16, 36), (1024, 32, 2)]):
        g = tokens >> stage
        for shift in (0, 3):
            hp, wp, sh, sw = wa.effective_shift(g, g, (ws, ws), (shift, shift))
            kw = dict(wh=ws, ww=ws, heads=heads, sh=sh, sw=sw)
            qkv32 = torch.randn((B, hp, wp, 3 * dim), generator=gen, device="cuda")
            table = torch.randn(((2 * ws - 1) ** 2, heads), generator=gen, device="cuda")
            bias = wa.gather_bias(table, ws, ws, heads).float().contiguous()
            errs = {}
            for dt, qkv in (("f32", qkv32), ("bf16", qkv32.to(torch.bfloat16))):
                errs[dt] = rel_err(fwa.window_attention(qkv, bias, **kw),
                                   fwa.window_attention_reference(qkv, bias, **kw))
            qkv = qkv32.to(torch.bfloat16)
            ms = cuda_ms(lambda: fwa.window_attention(qkv, bias, **kw), 20)
            plain = cuda_ms(lambda: fwa.window_attention_reference(qkv, bias, **kw), 3)
            # yardstick: one SDPA call on pre-partitioned (B, nW, heads, 49, hd)
            n, hd = ws * ws, dim // heads
            part = qkv.reshape(B, hp // ws, ws, wp // ws, ws, 3, heads, hd).permute(
                5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B, -1, heads, n, hd).contiguous()
            mask = bias[None].expand(part.shape[2], -1, -1, -1)
            if sh or sw:
                sm = torch.as_tensor(wa.shifted_window_mask(hp, wp, ws, ws, sh, sw),
                                     device="cuda")
                mask = mask + sm[:, None]
            mask = mask.to(torch.bfloat16).contiguous()
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                part[0], part[1], part[2], attn_mask=mask), 20)
            b_ms, by = bound_ms(nbytes(qkv, bias) + qkv.numel() // 3 * 2,
                                4.0 * B * (hp // ws) * (wp // ws) * heads * n * n * hd)
            rep.add(f"qkv{tuple(qkv.shape)} shift{(sh, sw)}", blocks // 2, errs, ms,
                    plain, b_ms, by, lib)
    return rep


def check_patch(fp, gen) -> tuple:
    merge = KernelReport("patch_merge", "fused_patch.cu", "fused_patch.py:206")
    expand = KernelReport("patch_expand", "fused_patch.cu", "fused_patch.py:357")
    cases = [(merge, (B, 128, 128, 128), 1), (merge, (B, 64, 64, 256), 1),
             (merge, (B, 32, 32, 512), 1), (expand, (B, 16, 16, 1024), 1),
             (expand, (B, 32, 32, 512), 2), (expand, (B, 64, 64, 256), 3)]
    for rep, shape, count in cases:
        c = shape[-1]
        is_merge = rep is merge
        x32 = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn((2 * c, 4 * c) if is_merge else (2 * c, c), generator=gen,
                        device="cuda") * 0.05
        ln = 4 * c if is_merge else c // 2
        sc = 1 + 0.1 * torch.randn(ln, generator=gen, device="cuda")
        lb = 0.1 * torch.randn(ln, generator=gen, device="cuda")
        if is_merge:
            run = lambda x: fp.fused_patch_merge(x, sc, lb, w)  # noqa: E731
            plain = lambda x: fp.patch_merge_reference(x, sc, lb, w)  # noqa: E731
        else:
            run = lambda x: fp.fused_patch_expand(x, w, sc, lb)  # noqa: E731
            plain = lambda x: fp.patch_expand_reference(x, w, sc, lb)  # noqa: E731
        errs = {dt: rel_err(run(x), plain(x))
                for dt, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16)))}
        x = x32.to(torch.bfloat16)
        ms = cuda_ms(lambda: run(x), 20)
        plain_ms = cuda_ms(lambda: plain(x), 3)
        k, n = (4 * c, 2 * c) if is_merge else (c, 2 * c)
        m = x.numel() // k  # GEMM rows
        out_numel = m * n if is_merge else 2 * x.numel()
        b_ms, by = bound_ms(2 * (x.numel() + out_numel + k * n) + 8 * ln,
                            2.0 * m * k * n)
        rep.add(f"x{shape}", count, errs, ms, plain_ms, b_ms, by)
    return merge, expand


def check_refine_head(frh, gen) -> KernelReport:
    rep = KernelReport("refine_head", "fused_refine_head.cu", "fused_refine_head.py:455")
    c, ht = 128, IMG // 4
    y32 = torch.randn((B, ht, ht, 16 * c), generator=gen, device="cuda") * 0.5
    p = [torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.03,
         0.1 * torch.randn(c, generator=gen, device="cuda"),
         torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.03,
         0.1 * torch.randn(c, generator=gen, device="cuda"),
         1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
         0.1 * torch.randn(c, generator=gen, device="cuda")]
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


def profile_forward(step, images, fwd_ms: float, top: int = 12,
                    what: str = "forward") -> None:
    """Device time by kernel over one call of ``step(images)`` (a forward,
    or a train step) by torch.profiler (CUPTI), beside its time from CUDA
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(images)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append((dev_us / 1e3, ev.count, ev.key))
    if not rows:
        print("profile: the profiler saw no device time")
        return
    total = sum(r[0] for r in rows)
    print(f"profile of one {what}: device time {total:.2f} ms over {len(rows)} kernel "
          f"names; busy share {total / fwd_ms:.3f} of the {fwd_ms:.2f} ms {what}")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<4d} {key[:90]}")


def deployment_config(default_config, **changes):
    """config.yaml's deployment model at 512^2; ``changes`` maps dotted
    keys to values (``{"TPU.FUSED_PATCH": False}``)."""
    cfg = default_config()
    cfg.DATA.IMG_SIZE = IMG
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.SOFTMAX_DTYPE = "bfloat16"
    for knob in ("USE_PALLAS_ATTENTION", "GELU_TANH", "FUSED_HEAD", "FUSED_PATCH"):
        cfg.TPU[knob] = True
    cfg.SEED = 120
    for key, value in changes.items():
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = node[part]
        node[leaf] = value
    cfg.freeze()
    return cfg


# bench.py's train step (bench.py:153-163, 216): FUSED_PATCH off (the patch
# backwards are not ported yet), no dropout, drop-path 0.1
TRAIN_CHANGES = {"TPU.FUSED_PATCH": False, "MODEL.DROP_RATE": 0.0,
                 "MODEL.ATTN_DROP_RATE": 0.0, "MODEL.DROP_PATH_RATE": 0.1}


def train_batch(rng, batch):
    images = rng.integers(0, 256, (batch, IMG, IMG, 3), dtype=np.uint8)
    labels = (rng.random((batch, IMG, IMG)) > 0.8).astype(np.uint8)
    return images, labels


def run_train_step(default_config, MSUNet, create_train_state, make_train_step,
                   build, rng) -> dict:
    """Phase 6: the train step at full Swin-B width; returns its launches."""
    cfg = deployment_config(default_config, **TRAIN_CHANGES)
    model = MSUNet.from_config(cfg)
    state = create_train_state(model, cfg)
    step = make_train_step(model, 0.2, 0.8, 0.45)
    images, labels = train_batch(rng, B)
    step(state, images, labels, 1e-4)  # warm-up: allocator, cuDNN
    torch.cuda.synchronize()
    build.reset_launches()
    step(state, images, labels, 1e-4)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"train launches per step: {launches}")
    # 48 backwards for 52 forwards: the last stage of each cent decoder (2 + 2
    # blocks) feeds nothing the loss reads (the reference drops its output),
    # so autograd runs no backward through it
    want = {"window_attention": 52, "window_attention_bwd": 48, "refine_head_res": 1,
            "refine_head_bwd": 1, "patch_merge": 0, "patch_expand": 0, "refine_head": 0}
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    torch.cuda.reset_peak_memory_stats()
    n_timed = 10
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
    print(f"train 512^2 b{B} bf16: {step_ms:.2f} ms/step (CUDA events), "
          f"{B * n_timed / wall:.2f} img/s (host clock, synchronised), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    profile_forward(lambda imgs: step(state, imgs, labels, 1e-4), images, step_ms,
                    top=15, what="train step")
    return launches


def check_train_e2e(default_config, MSUNet, create_train_state, make_train_step, rng):
    """Phase 7: a float32 train step, kernel path vs composed path."""
    cfg = deployment_config(default_config, **{**TRAIN_CHANGES, "MODEL.DROP_PATH_RATE": 0.0})
    plain_cfg = deployment_config(default_config, **{
        **TRAIN_CHANGES, "MODEL.DROP_PATH_RATE": 0.0, "TPU.USE_PALLAS_ATTENTION": False,
        "TPU.FUSED_HEAD": False, "TPU.SOFTMAX_DTYPE": "float32"})
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
    print(f"train step f32 512^2 b2, kernel vs composed path: loss {loss['kernel']:.7f} vs "
          f"{loss['composed']:.7f}, |diff| {dl:.3e} (tol {TRAIN_LOSS_TOL:g}); worst gradient "
          f"{worst_name} rel {worst:.3e} (tol {TRAIN_GRAD_TOL:g})")
    if not dl <= TRAIN_LOSS_TOL or not worst <= TRAIN_GRAD_TOL:
        raise AssertionError("f32 train step: kernel path differs from the composed path")


def check_patch_guard(default_config, MSUNet, create_train_state, make_train_step, rng):
    """Phase 7b: with FUSED_PATCH on, a train step raises (no patch backward)."""
    cfg = deployment_config(default_config, **{**TRAIN_CHANGES, "TPU.FUSED_PATCH": True,
                                               "MODEL.SWIN.DEPTHS": [2, 2, 2, 2]})
    model = MSUNet.from_config(cfg)
    images, labels = train_batch(rng, 1)
    try:
        make_train_step(model, 0.2, 0.8, 0.45)(create_train_state(model, cfg), images,
                                               labels, 1e-4)
    except NotImplementedError as e:
        print(f"FUSED_PATCH guard: a train step raised NotImplementedError: {e}")
        return
    raise AssertionError("a train step with FUSED_PATCH on did not raise")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import (
            default_config,
        )
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import (
            MSUNet,
        )
        from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import (
            _build,
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
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    # -- 2. each kernel against its plain version at the main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("kernels vs plain (512^2 batch 8 shapes; ms are bf16, per launch):")
    reports = [check_attention(fused_window_attention, window_attention, gen)]
    reports += list(check_patch(fused_patch, gen))
    reports.append(check_refine_head(fused_refine_head, gen))
    torch.cuda.empty_cache()

    # -- 3. the predict path at full Swin-B width
    cfg = deployment_config(default_config)
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
    step(images)  # first call: allocator and cuDNN warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    probs = step(images)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"predict launches per forward: {launches}")
    want = {"window_attention": 52, "window_attention_bwd": 0, "patch_merge": 3,
            "patch_expand": 6, "refine_head": 1, "refine_head_res": 0, "refine_head_bwd": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if probs.shape != (B, IMG, IMG) or not torch.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1:
        raise AssertionError(f"bad predict output {tuple(probs.shape)}")
    for r in reports:
        r.row["launches"] = launches[r.row["name"]]
    fwd_ms = cuda_ms(lambda: step(images), 3, warmup=0)
    t0 = time.perf_counter()
    n_timed = 3
    for _ in range(n_timed):
        step(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"predict 512^2 b{B} bf16: {fwd_ms:.2f} ms/forward (CUDA events), "
          f"{B * n_timed / wall:.2f} img/s (host clock, synchronised), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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

    # -- 4. end-to-end: kernel path vs composed path, float32
    kern = MSUNet.from_config(cfg, dtype=torch.float32)
    plain_cfg = default_config()
    plain_cfg.merge_from_dict(cfg.to_dict())
    for knob in ("USE_PALLAS_ATTENTION", "FUSED_HEAD", "FUSED_PATCH"):
        plain_cfg.TPU[knob] = False
    plain_cfg.TPU.SOFTMAX_DTYPE = "float32"
    comp = MSUNet.from_config(plain_cfg, dtype=torch.float32)
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

    # -- 5. the training kernels at the train step's shapes
    print("training kernels vs plain (512^2 batch 8 train-step shapes; ms are bf16):")
    attn_bwd = check_attention_bwd(fused_window_attention, window_attention, gen)
    torch.cuda.empty_cache()
    res, bwd = check_refine_train(fused_refine_head, gen)
    torch.cuda.empty_cache()
    check_plain_backwards(fused_window_attention, fused_refine_head, window_attention, gen)
    torch.cuda.empty_cache()

    # -- 6. the train step at full Swin-B width
    train_args = (default_config, MSUNet, create_train_state, make_train_step)
    launches = run_train_step(*train_args, _build, rng)
    for r in (attn_bwd, res, bwd):
        r.row["launches"] = launches[r.row["name"]]
    reports = [reports[0], attn_bwd, *reports[1:], res, bwd]
    torch.cuda.empty_cache()

    # -- 7. f32 train step, kernel vs composed; the FUSED_PATCH guard
    check_train_e2e(*train_args, rng)
    torch.cuda.empty_cache()
    check_patch_guard(*train_args, rng)

    print(json.dumps({"kernels": [r.row for r in reports]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
