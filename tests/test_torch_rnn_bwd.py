"""The port's GRU backward (the plain reverse loop that is the CUDA
kernel's oracle, the autograd Function around both kernels, and the layer
and multi-layer gradients) against the JAX package: its Pallas custom VJP
(``rnn_pallas._bwd_rule``, the single-block kernel) and its streamed twin,
both run in interpret mode on the CPU as ``tests/test_rnn_pallas.py`` runs
them, and against ``torch.nn.GRU``'s own gradients.

Tolerances: 1e-5 absolute in float32 (the same recurrence summed in
another order); ``gradcheck`` in float64 at its defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu.ops import rnn as jrnn
from icassp2022_depression_tpu.ops import rnn_pallas
from icassp2022_depression_tpu_torch.ops import rnn as trnn
from icassp2022_depression_tpu_torch.ops import rnn_cuda
from icassp2022_depression_tpu_torch.ops import prng as tprng

ATOL = 1e-5
NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def _inputs(seed, t, b, h):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((t, b, 3 * h)).astype(np.float32)
    w = (rng.uniform(-1, 1, (h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.uniform(-1, 1, (1, 3 * h)) / np.sqrt(h)).astype(np.float32)
    dys = rng.standard_normal((t, b, h)).astype(np.float32)
    return xp, w, bias, dys


def _layer(seed, d, h):
    jp = jrnn.init_params(jax.random.PRNGKey(seed), "gru", d, h, 1,
                          False)[0]["fwd"]
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("t,b,h", [(3, 4, 8), (3, 1, 32), (7, 3, 16),
                                   (1, 2, 8)])
def test_gru_sequence_bwd_torch_matches_pallas_bwd_rule(t, b, h):
    xp, w, bias, dys = _inputs(t * 100 + b, t, b, h)
    ys = rnn_pallas.gru_sequence(jnp.asarray(xp), jnp.asarray(w),
                                 jnp.asarray(bias))
    want = rnn_pallas._bwd_rule(
        (jnp.asarray(xp), jnp.asarray(w), jnp.asarray(bias), ys),
        jnp.asarray(dys))
    got = rnn_cuda.gru_sequence_bwd_torch(
        *(torch.from_numpy(a) for a in (xp, w, bias, np.array(ys), dys)))
    for name, g, j in zip(("dxp", "dw_hh_t", "db_hh"), got, want):
        assert tuple(g.shape) == j.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL, err_msg=name)


def _layer_grads_jax(fn, jp, x, seed):
    """jax.grad of a fixed random projection of (ys, h_last)."""
    rng = np.random.default_rng(seed)

    def loss(p, x):
        ys, h_last = fn(p, x)
        cy = rng.standard_normal(ys.shape).astype(np.float32)
        ch = rng.standard_normal(h_last.shape).astype(np.float32)
        return jnp.sum(ys * cy) + jnp.sum(h_last * ch)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return gp, gx


def _layer_grads_torch(tp, x, reverse, seed):
    rng = np.random.default_rng(seed)
    xt = torch.from_numpy(x).requires_grad_()
    ys, h_last = trnn.gru_layer(tp, xt, reverse)
    cy = torch.from_numpy(rng.standard_normal(tuple(ys.shape))
                          .astype(np.float32))
    ch = torch.from_numpy(rng.standard_normal(tuple(h_last.shape))
                          .astype(np.float32))
    loss = (ys * cy).sum() + (h_last * ch).sum()
    grads = torch.autograd.grad(loss, [xt] + [tp[k] for k in NAMES])
    return dict(zip(("x",) + NAMES, grads))


def _assert_layer_grads(got, gp, gx):
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(gx), rtol=0,
                               atol=ATOL, err_msg="x")
    for k in NAMES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(gp[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_grads_match_jax_pallas_layer(reverse):
    jp, tp = _layer(1, 12, 16)
    x = np.random.default_rng(2).standard_normal((4, 3, 12)).astype(
        np.float32)
    gp, gx = _layer_grads_jax(
        lambda p, x: rnn_pallas.gru_layer(p, x, reverse), jp, x, 3)
    _assert_layer_grads(_layer_grads_torch(tp, x, reverse, 3), gp, gx)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_grads_match_jax_streamed_layer(reverse):
    """T = 40 over chunks of 8: the contract of the streamed backward
    kernel (``_gru_stream_bwd_kernel``), which the port's one kernel
    covers for every T."""
    jp, tp = _layer(4, 6, 8)
    x = np.random.default_rng(5).standard_normal((3, 40, 6)).astype(
        np.float32)
    gp, gx = _layer_grads_jax(
        lambda p, x: rnn_pallas.gru_layer_streamed(p, x, reverse, chunk=8),
        jp, x, 6)
    _assert_layer_grads(_layer_grads_torch(tp, x, reverse, 6), gp, gx)


@pytest.mark.parametrize("plain", [True, False])
def test_gru_sequence_function_gradcheck(plain):
    """Both branches of the Function on CPU tensors: ``plain`` (backend
    "torch") and the wrapper dispatch, which takes the plain versions
    because the tensors lie on the CPU."""
    g = torch.Generator().manual_seed(0)
    t, b, h = 5, 3, 6
    xp = torch.randn(t, b, 3 * h, generator=g, dtype=torch.float64)
    w = torch.randn(h, 3 * h, generator=g, dtype=torch.float64) * 0.3
    bias = torch.randn(1, 3 * h, generator=g, dtype=torch.float64) * 0.3
    inputs = tuple(a.requires_grad_() for a in (xp, w, bias))
    assert torch.autograd.gradcheck(
        lambda *a: rnn_cuda.GRUSequence.apply(*a, plain), inputs)


def test_rnn_module_grads_match_torch_gru():
    """Two layers through the Function: every gradient reaches its
    ``nn.GRU``-named parameter (``weight_hh_l{k}`` through the transpose
    in ``gru_layer``, ``bias_hh`` through its [1, 3H] reshape)."""
    mod = trnn.RNN(6, 8, 2, key=tprng.prng_key(0))
    ref = torch.nn.GRU(6, 8, 2, batch_first=True)
    ref.load_state_dict(mod.state_dict(), strict=True)
    x = torch.randn(3, 4, 6, generator=torch.Generator().manual_seed(1))
    cy = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(2))
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    y, _, _ = mod(xa)
    y_ref, _ = ref(xb)
    (y * cy).sum().backward()
    (y_ref * cy).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=ATOL)
    ref_params = dict(ref.named_parameters())
    for name, p in mod.named_parameters():
        torch.testing.assert_close(p.grad, ref_params[name].grad, rtol=0,
                                   atol=ATOL, msg=name)


def test_wrappers_use_plain_versions_on_cpu_and_never_detach():
    xp, w, bias, dys = (torch.from_numpy(a) for a in _inputs(0, 3, 2, 8))
    before = (rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES)
    ys = rnn_cuda.gru_sequence(xp, w, bias)
    for a, b in zip(rnn_cuda.gru_sequence_bwd(xp, w, bias, ys, dys),
                    rnn_cuda.gru_sequence_bwd_torch(xp, w, bias, ys, dys)):
        assert torch.equal(a, b)
    assert (rnn_cuda.LAUNCHES, rnn_cuda.BWD_LAUNCHES) == before
    # the plain recurrence on a CPU input that requires grad keeps its graph
    out = rnn_cuda.gru_sequence(xp.clone().requires_grad_(), w, bias)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), ys)
    with torch.no_grad():
        assert rnn_cuda.gru_sequence(xp.requires_grad_(), w,
                                     bias).grad_fn is None


@pytest.mark.parametrize("t,b,h", [(3, 8, 256), (3, 2, 256), (3, 24, 256),
                                   (256, 16, 256), (7, 3, 200), (3, 40, 256),
                                   (5, 9, 512), (1, 1, 8), (3, 4, 254)])
def test_gru_bwd_plan_covers_every_cell_once(t, b, h):
    """The backward kernel's plan (``rnn_cuda.gru_bwd_plan``): at the audio
    model's H = 256 (training, eval and streamed shapes), a ragged H and a
    wide one, a step tile that ``csrc/gru_bwd.cu`` compiles, slabs and row
    tiles that cover every cell and row exactly once (64 blocks at
    H = 256 up to 32 rows), and weight-product parts that cover the T*B
    rows exactly once, none empty, as the C entry cuts them; at an H the
    16-byte copies cannot take, the one-block-per-row route."""
    import re

    from icassp2022_depression_tpu_torch import _build

    compiled = {tuple(map(int, m)) for m in re.findall(
        r"^    GRU_BWD_TILE\((\d+), (\d+)\)$",
        (_build.CSRC / "gru_bwd.cu").read_text(), re.M)}
    assert compiled == set(rnn_cuda.BWD_TILES)
    plan = rnn_cuda.gru_bwd_plan(b, h, steps=t)
    if h % 4:
        assert plan == {"route": "sequence", "cells": 0, "rows": 0,
                        "slabs": 1, "row_tiles": b, "splits": 1}
        return
    assert plan["route"] == "step"
    cells, rows = plan["cells"], plan["rows"]
    assert (cells, rows) in compiled
    cover_h, cover_b = np.zeros(h, int), np.zeros(b, int)
    for s in range(plan["slabs"]):
        assert s * cells < h                 # no empty slab
        cover_h[s * cells:(s + 1) * cells] += 1
    for r in range(plan["row_tiles"]):
        assert r * rows < b                  # no empty row tile
        cover_b[r * rows:(r + 1) * rows] += 1
    assert (cover_h == 1).all() and (cover_b == 1).all()
    if h == 256 and b <= 32:
        assert plan["slabs"] * plan["row_tiles"] == 64
    k, splits = t * b, plan["splits"]
    chunk = 32 * rnn_cuda._cdiv(rnn_cuda._cdiv(k, splits), 32)  # as in C
    assert 1 <= splits <= 64 and (splits - 1) * chunk < k <= splits * chunk
    assert rnn_cuda.gru_bwd_plan(b, h, "sequence", steps=t)["route"] \
        == "sequence"


def test_gru_bwd_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="no route"):
        rnn_cuda.gru_bwd_plan(8, 254, "step", steps=3)
    with pytest.raises(ValueError, match="no route"):
        rnn_cuda.gru_bwd_plan(8, 256, "persistent", steps=3)


@pytest.mark.parametrize("route", ["step", "sequence", "bogus"])
def test_gru_bwd_wrapper_takes_plain_backward_on_cpu_whatever_the_plan(
        route):
    """On CPU tensors ``gru_sequence_bwd`` runs the plain backward and
    launches nothing, whatever ``plan`` says."""
    xp, w, bias, dys = (torch.from_numpy(a) for a in _inputs(3, 3, 2, 8))
    ys = rnn_cuda.gru_sequence_torch(xp, w, bias)
    plan = ({"route": "bogus"} if route == "bogus"
            else rnn_cuda.gru_bwd_plan(2, 8, route, steps=3))
    before = rnn_cuda.BWD_LAUNCHES
    got = rnn_cuda.gru_sequence_bwd(xp, w, bias, ys, dys, plan=plan)
    want = rnn_cuda.gru_sequence_bwd_torch(xp, w, bias, ys, dys)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert rnn_cuda.BWD_LAUNCHES == before


@pytest.mark.parametrize("cell,t,b,h", [
    ("gru", 3, 8, 256), ("gru", 256, 16, 256), ("gru", 64, 16, 256),
    ("gru", 128, 16, 256), ("gru", 3, 24, 256), ("lstm", 3, 4, 128),
    ("lstm", 256, 16, 128), ("lstm", 128, 16, 128), ("lstm", 3, 112, 512),
    ("lstm", 128, 488, 512)])
def test_streamed_counter_shapes_are_where_jax_streams(cell, t, b, h):
    """A backward call counts as TPU kernel #3 / #5 exactly where the JAX
    package's ``_pallas_fits`` sends the layer to its streamed kernels."""
    p = {"w_hh": np.zeros(((3 if cell == "gru" else 4) * h, h), np.float32)}
    x = np.zeros((b, t, h), np.float32)
    gates = 3 if cell == "gru" else 4
    assert rnn_cuda.streamed(t, b, h, gates) == (
        not jrnn._pallas_fits(p, x, cell))
