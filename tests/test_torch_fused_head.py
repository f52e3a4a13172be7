"""Port's GELU + x4 depth-to-space head vs the JAX package, on the CPU.

* ``fused_gelu_d2s4`` forward (its plain version on the CPU) against the
  JAX ``fused_gelu_d2s4`` with the Pallas kernel in interpret mode, at
  ``tests/test_fused_head.py``'s shapes and a Swin-T one (C = 96): 1e-6 in
  float32, 2e-2 in bfloat16; its VJP against ``jax.vjp``, 1e-5; the plain
  backward against ``torch.autograd`` of the plain forward.
* The head module at embed 16 with tanh GELU and ``FUSED_HEAD``, where both
  packages take the GELU+depth-to-space route (the refine-head gate fails):
  output and the input's gradient 1e-5 abs, the parameters' gradients
  (sums over every pixel, in another order) 1e-6 of their largest
  magnitude.
* The head's three routes, and the repair of ``FUSED_HEAD`` with erf GELU:
  the port used to raise there; now a model with ``GELU_TANH: false`` and
  ``FUSED_HEAD: true`` runs the composed erf head, and its logits and
  gradients equal the JAX model's (which also runs the composed head),
  5e-4 abs for the logits (``PARITY.md``'s assembled-graph bar) and each
  parameter's gradient within 1e-5 of its largest magnitude (sums over
  every pixel through the whole graph, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import layers as jax_layers
from semantic_segmentation_of_stylegan2_artifacts_tpu.ops import (
    fused_head as jax_fh,
    fused_refine_head as jax_frh,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models import layers
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.ops import fused_head

SHAPES = [(1, 8, 8, 32), (2, 4, 16, 16), (1, 4, 4, 16 * 96)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (jax_fh, jax_frh):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(shape, dtype):
    x = _x(shape)
    want = jax_fh.fused_gelu_d2s4(jnp.asarray(x, getattr(jnp, dtype)))
    got = fused_head.fused_gelu_d2s4(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == (shape[0], 4 * shape[1], 4 * shape[2], shape[3] // 16)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_matches_jax(shape):
    x = _x(shape, seed=1)
    g = _x((shape[0], 4 * shape[1], 4 * shape[2], shape[3] // 16), seed=2)
    _, vjp = jax.vjp(jax_fh.fused_gelu_d2s4, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    fused_head.fused_gelu_d2s4(tx).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-5)


def test_plain_backward_matches_autograd():
    x = torch.from_numpy(_x((2, 3, 5, 16 * 24), seed=3)).requires_grad_()
    out = fused_head.gelu_d2s4_reference(x)
    g = torch.from_numpy(_x(tuple(out.shape), seed=4))
    (want,) = torch.autograd.grad(out, x, g)
    got = fused_head.gelu_d2s4_bwd_reference(x.detach(), g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_kernel_shapes():
    assert fused_head.kernel_supported((8, 128, 128, 16 * 96), torch.bfloat16)
    assert fused_head.kernel_supported((1, 8, 8, 16 * 4), torch.float32)
    assert not fused_head.kernel_supported((1, 8, 8, 16 * 4), torch.bfloat16)
    assert not fused_head.kernel_supported((1, 8, 8, 24), torch.float32)


def _head_params(dim, seed=5):
    rng = np.random.default_rng(seed)
    return {"expand": {"kernel": rng.standard_normal((dim, 16 * dim)).astype(np.float32) * 0.2},
            "refine1": {"kernel": rng.standard_normal((3, 3, dim, dim)).astype(np.float32) * 0.1,
                        "bias": rng.standard_normal(dim).astype(np.float32) * 0.1},
            "refine2": {"kernel": rng.standard_normal((3, 3, dim, dim)).astype(np.float32) * 0.1,
                        "bias": rng.standard_normal(dim).astype(np.float32) * 0.1},
            "norm": {"scale": (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
                     "bias": rng.standard_normal(dim).astype(np.float32) * 0.1}}


def _head_state_dict(p):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (a writable copy)
    return {"expand.weight": t(p["expand"]["kernel"].T),
            "refine1.weight": t(p["refine1"]["kernel"].transpose(3, 2, 0, 1)),
            "refine1.bias": t(p["refine1"]["bias"]),
            "refine2.weight": t(p["refine2"]["kernel"].transpose(3, 2, 0, 1)),
            "refine2.bias": t(p["refine2"]["bias"]),
            "norm.weight": t(p["norm"]["scale"]), "norm.bias": t(p["norm"]["bias"])}


def test_head_gelu_d2s_route_matches_jax(monkeypatch):
    dim = 16
    params = _head_params(dim)
    x = _x((2, 4, 4, dim), seed=6)
    dout = _x((2, 16, 16, dim), seed=7)
    jm = jax_layers.FinalPatchExpandX4V2(dim=dim, gelu_tanh=True, fused_head=True)
    out, vjp = jax.vjp(lambda p, v: jm.apply({"params": p}, v), params, jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(dout))

    calls = []
    real = fused_head.fused_gelu_d2s4
    monkeypatch.setattr(fused_head, "fused_gelu_d2s4",
                        lambda v: calls.append(v.shape) or real(v))
    mod = layers.FinalPatchExpandX4V2(dim, gelu_tanh=True, fused=True, dtype=torch.float32)
    mod.load_state_dict(_head_state_dict(params))
    tx = torch.from_numpy(x).requires_grad_()
    got = mod(tx)
    got.backward(torch.from_numpy(dout))
    assert calls == [(2, 4, 4, 16 * dim)]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=1e-5)
    want = _head_state_dict(jax.tree_util.tree_map(np.asarray, dparams))
    for name, p in mod.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-6 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("dim,gelu_tanh,fused,route", [
    (128, True, True, "refine"), (96, True, True, "gelu_d2s"), (16, True, True, "gelu_d2s"),
    (128, False, True, "composed"), (96, False, True, "composed"), (128, True, False, "composed")])
def test_head_routes(dim, gelu_tanh, fused, route):
    head = layers.FinalPatchExpandX4V2(dim, gelu_tanh=gelu_tanh, fused=fused,
                                       dtype=torch.float32)
    assert head.fused_refine == (route == "refine")
    assert head.fused_gelu_d2s == (route == "gelu_d2s")


TINY = dict(img_size=32, embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
            window_size=4)


def test_erf_gelu_with_fused_head_matches_jax_composed_head():
    jm = JaxMSUNet(gelu_tanh=False, fused_head=True, **TINY)
    x = np.random.default_rng(8).random((2, 32, 32, 3)).astype(np.float32)
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                     jnp.zeros((1, 32, 32, 3)), True))()["params"]
    r = _x((2, 32, 32, 1), seed=9)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), True)
        return jnp.sum(out * r), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = MSUNet(gelu_tanh=False, fused_head=True, **TINY)
    assert not model.ms_unet.up.fused_refine and not model.ms_unet.up.fused_gelu_d2s
    model.ms_unet.load_state_dict(flax_to_state_dict(params), strict=True)
    got = model.eval()(torch.from_numpy(x))
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4, rtol=0)
    # the last stage of each cent decoder feeds nothing the logits read
    tgrads = state_dict_to_flax({k: torch.zeros_like(p) if p.grad is None else p.grad
                                 for k, p in model.ms_unet.named_parameters()})
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        node = tgrads
        for k in path:
            node = node[k.key]
        g = np.asarray(g)
        np.testing.assert_allclose(node, g, atol=1e-5 * max(1.0, np.abs(g).max()), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
