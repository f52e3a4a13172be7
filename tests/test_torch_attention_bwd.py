"""Port's window-attention backward vs the JAX package, f32 on the CPU.

* The kernel-path op's ``torch.autograd`` gradients (the
  ``autograd.Function`` with its plain forward and plain backward on the
  CPU) against ``jax.vjp`` of ``fused_shifted_window_attention`` with the
  Pallas kernels in interpret mode, for the input, every weight and the
  bias table, on the cases of ``tests/test_fused_window_attention.py``.
* The core directly: ``(dqkv, dbias)`` of the Function against
  ``jax.vjp`` of the JAX ``_attn_core`` on rolled, padded qkv.
* The plain backward against ``torch.autograd`` of the plain forward.

Tolerance: atol = rtol = 3e-5, the bar of the JAX package's own VJP test
(float32 sums in another order; the bias gradient sums every window).

* The backward's launch plan (blocks per head, runs of windows, the
  scratch of per-block bias-gradient partials) as a pure function, for the
  ``mma.sync`` kernels and for the grouped CUDA-core and ``wmma`` kernels.
* The gradients at the ragged shapes of the card's corner-case phase
  against ``jax.vjp`` of the JAX kernel op (interpret mode) where its gate
  takes the shape, else of the composed JAX op: float32, max abs error
  <= 1e-4 of max(1, max |gradient|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import (
    fused_window_attention as jax_fwa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops.window_attention import (
    shifted_window_mask_dev,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import (
    fused_window_attention as fwa,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops.window_attention import (
    effective_shift,
)
from test_torch_window_attention import PLAN_SHAPES, RAGGED, check_plan, jax_op, ragged_inputs

TOL = dict(atol=3e-5, rtol=3e-5)
KEYS = ("x", "qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias", "bias_table")

CASES = [
    # (H, W, C, heads, window, shift)
    (14, 14, 16, 2, (7, 7), (0, 0)),
    (14, 14, 16, 2, (7, 7), (3, 3)),
    (16, 16, 16, 2, (7, 7), (0, 0)),
    (16, 16, 16, 2, (7, 7), (3, 3)),
    (10, 12, 24, 3, (5, 5), (2, 2)),
    (7, 7, 16, 2, (7, 7), (3, 3)),
    (7, 77, 16, 2, (7, 7), (3, 0)),
    (28, 98, 16, 2, (7, 7), (3, 3)),
    (14, 147, 16, 2, (7, 7), (0, 3)),
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fwa, "INTERPRET", True)


def _inputs(h, w, c, heads, window, seed=0):
    rng = np.random.default_rng(seed)
    table = (2 * window[0] - 1) * (2 * window[1] - 1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = dict(x=f(2, h, w, c) * 0.5, qkv_kernel=f(c, 3 * c) * 0.1,
               qkv_bias=f(3 * c) * 0.1, proj_kernel=f(c, c) * 0.1,
               proj_bias=f(c) * 0.1, bias_table=f(table, heads) * 0.1)
    return inp, f(2, h, w, c)


@pytest.mark.parametrize("h,w,c,heads,window,shift", CASES)
def test_op_vjp_matches_jax(h, w, c, heads, window, shift):
    inp, cot = _inputs(h, w, c, heads, window)
    kw = dict(window_size=window, shift_size=shift, num_heads=heads)
    _, vjp = jax.vjp(lambda *a: jax_fwa.fused_shifted_window_attention(*a, **kw),
                     *[jnp.asarray(inp[k]) for k in KEYS])
    want = dict(zip(KEYS, vjp(jnp.asarray(cot))))
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in inp.items()}
    # torch layout (out, in) for the two projections
    args = [t["x"], t["qkv_kernel"].T, t["qkv_bias"], t["proj_kernel"].T, t["proj_bias"],
            t["bias_table"]]
    out = fwa.fused_shifted_window_attention(*args, **kw)
    out.backward(torch.from_numpy(cot))
    for k in KEYS:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("h,w,c,heads,window,shift", [CASES[0], CASES[3], CASES[4]])
def test_core_vjp_matches_jax(h, w, c, heads, window, shift):
    wh, ww = window
    n = wh * ww
    hp, wp, sh, sw = effective_shift(h, w, window, shift)
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((2, hp, wp, 3 * c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((heads, n, n))).astype(np.float32)
    dctx = rng.standard_normal((2, hp, wp, c)).astype(np.float32)
    masked = bool(sh or sw)
    mask = (shifted_window_mask_dev(hp, wp, wh, ww, sh, sw).reshape(hp // wh, wp // ww, n, n)
            if masked else jnp.zeros((1, 1, n, n), jnp.float32))
    _, vjp = jax.vjp(lambda q, b: jax_fwa._attn_core(q, b, mask, wh, ww, heads, masked),
                     jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(jnp.asarray(dctx))
    q = torch.from_numpy(qkv).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    fwa.window_attention(q, b, wh=wh, ww=ww, heads=heads, sh=sh, sw=sw).backward(
        torch.from_numpy(dctx))
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(want_dqkv), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_dbias), **TOL)


@pytest.mark.parametrize("shift", [0, 3])
def test_plain_backward_matches_autograd(shift):
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 14, 21, 48)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal((2, 49, 49))).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((2, 14, 21, 16)).astype(np.float32))
    kw = dict(wh=7, ww=7, heads=2, sh=shift, sw=shift)
    q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    want = torch.autograd.grad(fwa.window_attention_reference(q, b, **kw), (q, b), d)
    got = fwa.window_attention_bwd_reference(qkv, d, bias, **kw)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), **TOL)


@pytest.mark.parametrize("sms", [132, 108, 1])
@pytest.mark.parametrize("batch,n_win,heads", PLAN_SHAPES)
def test_backward_launch_plan_and_scratch(batch, n_win, heads, sms):
    chunks = check_plan(batch, n_win, heads, sms, fwa.BWD_BLOCKS_PER_SM)
    for n, cols in ((49, 56), (16, 56), (56, 56), (57, 64), (64, 64)):
        plan, scratch = fwa.bwd_plan(fwa.ROUTE_MMA, batch, n_win, heads, n, sms)
        # one (heads, N, columns) partial per block of a head: block
        # chunk * heads + head writes row (chunk, head); rows padded to the
        # kernel's key tiles
        assert plan == chunks and scratch == (chunks, heads, n, cols)


@pytest.mark.parametrize("route", [fwa.ROUTE_CORE, fwa.ROUTE_WMMA])
@pytest.mark.parametrize("batch,n_win,heads", PLAN_SHAPES)
def test_grouped_backward_plan_covers_every_window_once(batch, n_win, heads, route):
    total = batch * n_win
    group, (partials, *rest) = fwa.bwd_plan(route, batch, n_win, heads, 49, 132)
    assert group == fwa.bwd_group(total, heads) and 1 <= group <= 32
    assert rest == [heads, 49, 49]
    # block i walks windows [i * group, (i + 1) * group): the last may be short
    assert partials >= 1 and (partials - 1) * group < total <= partials * group


@pytest.mark.parametrize("b,h,w,c,heads,window,shift", RAGGED)
def test_ragged_vjp_matches_jax(b, h, w, c, heads, window, shift):
    inp, cot = ragged_inputs(b, h, w, c, heads, window, seed=4)
    kw = dict(window_size=window, shift_size=shift, num_heads=heads)
    op = jax_op((b, h, w, c), window, heads)
    _, vjp = jax.vjp(lambda *a: op(*a, **kw), *[jnp.asarray(inp[k]) for k in KEYS])
    want = dict(zip(KEYS, vjp(jnp.asarray(cot))))
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in inp.items()}
    args = [t["x"], t["qkv_kernel"].T, t["qkv_bias"], t["proj_kernel"].T, t["proj_bias"],
            t["bias_table"]]
    fwa.fused_shifted_window_attention(*args, **kw).backward(torch.from_numpy(cot))
    for k in KEYS:
        w_ = np.asarray(want[k])
        err = np.abs(t[k].grad.numpy() - w_).max() / max(1.0, np.abs(w_).max())
        assert err <= 1e-4, (k, err)
