"""The port's LSTM (the plain forward and backward that are the CUDA
kernels' oracles, the autograd Function around both kernels, the layer and
the bidirectional multi-layer ``rnn(cell="lstm")``) against the JAX
package: its Pallas forward and custom VJPs (``rnn_pallas.lstm_sequence``,
``_lstm_bwd_rule`` and the streamed ``_lstm_stream_bwd_rule``), run in
interpret mode on the CPU as ``tests/test_rnn_pallas.py`` runs them, and
against ``torch.nn.LSTM``.

Every backward runs with a nonzero cell-state cotangent ``dcs``: the text
model never reads ``c_n``, so a zero ``dcs`` would hide a wrong path.

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
    xp = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    w = (rng.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.uniform(-1, 1, (1, 4 * h)) / np.sqrt(h)).astype(np.float32)
    dys = rng.standard_normal((t, b, h)).astype(np.float32)
    dcs = rng.standard_normal((t, b, h)).astype(np.float32)
    return xp, w, bias, dys, dcs


def _close(got, want, names):
    for name, g, j in zip(names, got, want):
        assert tuple(g.shape) == tuple(j.shape), name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("t,b,h", [(3, 4, 8), (3, 2, 16), (7, 3, 12),
                                   (1, 2, 8)])
def test_lstm_sequence_torch_matches_pallas(t, b, h):
    """Forward (ys, cs) and the backward with nonzero dcs against the
    single-block Pallas kernels (``_lstm_stream_fwd_kernel`` at chunk == T,
    ``_lstm_bwd_kernel``)."""
    xp, w, bias, dys, dcs = _inputs(t * 100 + b, t, b, h)
    jx = [jnp.asarray(a) for a in (xp, w, bias)]
    ys, cs = rnn_pallas.lstm_sequence(*jx)
    got = rnn_cuda.lstm_sequence_torch(
        *(torch.from_numpy(a) for a in (xp, w, bias)))
    _close(got, (ys, cs), ("ys", "cs"))
    want = rnn_pallas._lstm_bwd_rule((*jx, ys, cs),
                                     (jnp.asarray(dys), jnp.asarray(dcs)))
    got = rnn_cuda.lstm_sequence_bwd_torch(
        *(torch.from_numpy(np.array(a))
          for a in (xp, w, bias, ys, cs, dys, dcs)))
    _close(got, want, ("dxp", "dw_hh_t", "db_hh"))


@pytest.mark.parametrize("chunk", [1, 4])
def test_lstm_sequence_bwd_torch_matches_streamed_rule(chunk):
    """The streamed backward (``_lstm_stream_bwd_kernel``) at chunk < T:
    the port's one backward covers it for every T."""
    t, b, h = 12, 3, 8
    xp, w, bias, dys, dcs = _inputs(chunk, t, b, h)
    jx = [jnp.asarray(a) for a in (xp, w, bias)]
    ys, cs = rnn_pallas.lstm_sequence_streamed(*jx, chunk)
    want = rnn_pallas._lstm_stream_bwd_rule(
        chunk, (*jx, ys, cs), (jnp.asarray(dys), jnp.asarray(dcs)))
    got = rnn_cuda.lstm_sequence_bwd_torch(
        *(torch.from_numpy(np.array(a))
          for a in (xp, w, bias, ys, cs, dys, dcs)))
    _close(got, want, ("dxp", "dw_hh_t", "db_hh"))


@pytest.mark.parametrize("plain", [True, False])
def test_lstm_sequence_function_gradcheck(plain):
    """Both outputs feed the checked function, so ``dcs`` is nonzero; both
    branches of the Function on CPU tensors (``plain``, and the wrapper
    dispatch, which takes the plain versions on the CPU)."""
    g = torch.Generator().manual_seed(0)
    t, b, h = 5, 3, 4
    xp = torch.randn(t, b, 4 * h, generator=g, dtype=torch.float64)
    w = torch.randn(h, 4 * h, generator=g, dtype=torch.float64) * 0.4
    bias = torch.randn(1, 4 * h, generator=g, dtype=torch.float64) * 0.4
    inputs = tuple(a.requires_grad_() for a in (xp, w, bias))
    assert torch.autograd.gradcheck(
        lambda *a: rnn_cuda.LSTMSequence.apply(*a, plain), inputs)


def _params(seed, d, h, num_layers, bidirectional):
    jp = jrnn.init_params(jax.random.PRNGKey(seed), "lstm", d, h, num_layers,
                          bidirectional)
    tp = [{dirn: {k: torch.from_numpy(np.array(v)).requires_grad_()
                  for k, v in p.items()}
           for dirn, p in layer.items()} for layer in jp]
    return jp, tp


def test_bidirectional_two_layer_lstm_matches_jax_pallas():
    """Outputs, h_n, c_n (torch's order: l0 fwd, l0 bwd, l1 fwd, l1 bwd)
    and every gradient, through a loss that reads all three."""
    jp, tp = _params(3, 10, 8, 2, True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 10)).astype(np.float32)
    cy = rng.standard_normal((4, 3, 16)).astype(np.float32)
    ch = rng.standard_normal((4, 4, 8)).astype(np.float32)
    cc = rng.standard_normal((4, 4, 8)).astype(np.float32)

    def jloss(p, x):
        y, h_n, c_n = jrnn.rnn(p, x, "lstm", backend="pallas")
        return (jnp.sum(y * cy) + jnp.sum(h_n * ch) + jnp.sum(c_n * cc),
                (y, h_n, c_n))

    (_, outs), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jp,
                                                           jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, h_n, c_n = trnn.rnn(tp, xt, "lstm")
    _close((y, h_n, c_n), outs, ("y", "h_n", "c_n"))
    loss = ((y * torch.from_numpy(cy)).sum() + (h_n * torch.from_numpy(ch))
            .sum() + (c_n * torch.from_numpy(cc)).sum())
    loss.backward()
    _close((xt.grad,), (gx,), ("x",))
    for k, layer in enumerate(tp):
        for dirn, p in layer.items():
            _close([p[n].grad for n in NAMES],
                   [gp[k][dirn][n] for n in NAMES],
                   [f"l{k}/{dirn}/{n}" for n in NAMES])


def test_lstm_layer_reverse_and_c_last_match_pallas_layer():
    jp, tp = _params(5, 6, 8, 1, False)
    x = np.random.default_rng(6).standard_normal((3, 5, 6)).astype(
        np.float32)
    for reverse in (False, True):
        want = rnn_pallas.lstm_layer(jp[0]["fwd"], jnp.asarray(x), reverse)
        got = trnn.lstm_layer(tp[0]["fwd"], torch.from_numpy(x), reverse)
        _close(got, want, ("ys", "h_last", "c_last"))


def test_rnn_module_matches_torch_lstm():
    """Parameter names are nn.LSTM's, and so are outputs and gradients."""
    mod = trnn.RNN(6, 8, 2, True, cell="lstm", init="xavier",
                   key=tprng.prng_key(0))
    ref = torch.nn.LSTM(6, 8, 2, batch_first=True, bidirectional=True)
    assert set(mod.state_dict()) == set(ref.state_dict())
    ref.load_state_dict(mod.state_dict(), strict=True)
    x = torch.randn(3, 4, 6, generator=torch.Generator().manual_seed(1))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    y, h_n, c_n = mod(xa)
    y_ref, (h_ref, c_ref) = ref(xb)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(h_n, h_ref.transpose(0, 1), rtol=0, atol=ATOL)
    torch.testing.assert_close(c_n, c_ref.transpose(0, 1), rtol=0, atol=ATOL)
    (y.sum() + c_n.square().sum()).backward()
    (y_ref.sum() + c_ref.square().sum()).backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=ATOL)
    ref_params = dict(ref.named_parameters())
    for name, p in mod.named_parameters():
        torch.testing.assert_close(p.grad, ref_params[name].grad, rtol=0,
                                   atol=ATOL, msg=name)


def test_lstm_wrappers_use_plain_versions_on_cpu():
    xp, w, bias, dys, dcs = (torch.from_numpy(a)
                             for a in _inputs(0, 3, 2, 8))
    before = (rnn_cuda.LSTM_LAUNCHES, rnn_cuda.LSTM_BWD_LAUNCHES)
    ys, cs = rnn_cuda.lstm_sequence(xp, w, bias)
    for a, b in zip((ys, cs), rnn_cuda.lstm_sequence_torch(xp, w, bias)):
        assert torch.equal(a, b)
    for a, b in zip(
            rnn_cuda.lstm_sequence_bwd(xp, w, bias, ys, cs, dys, dcs),
            rnn_cuda.lstm_sequence_bwd_torch(xp, w, bias, ys, cs, dys, dcs)):
        assert torch.equal(a, b)
    assert (rnn_cuda.LSTM_LAUNCHES, rnn_cuda.LSTM_BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trnn.lstm_layer({"w_ih": torch.zeros(32, 4), "w_hh": w,
                         "b_ih": torch.zeros(32), "b_hh": torch.zeros(32)},
                        torch.zeros(2, 3, 4), backend="cuda")


@pytest.mark.parametrize("b,h", [(8, 512), (24, 512), (112, 512),
                                 (488, 512), (3, 512), (48, 512), (200, 512),
                                 (4, 128), (2, 128), (24, 128), (16, 128),
                                 (3, 100), (8, 102)])
def test_lstm_fwd_plan_covers_every_cell_once(b, h):
    """The forward kernel's plan (``rnn_cuda.lstm_fwd_plan``): at the
    stand-in's H = 512 (served, extraction and ragged batches) and the text
    model's H = 128 (training, eval and streamed batches) a step tile that
    the C entry compiles, slabs and row tiles that cover every cell and row
    exactly once, at least 100 blocks at the stand-in's served and
    extraction shapes; at an H the 16-byte copies cannot take, a
    ValueError."""
    import re

    from icassp2022_depression_tpu_torch import _build

    compiled = {tuple(map(int, m)) for m in re.findall(
        r"^  LSTM_FWD_TILE\((\d+), (\d+), \d+\)$",
        (_build.CSRC / "lstm_fwd.cu").read_text(), re.M)}
    assert compiled == set(rnn_cuda.LSTM_FWD_TILES)
    if h % 4:
        with pytest.raises(ValueError, match="no route"):
            rnn_cuda.lstm_fwd_plan(b, h)
        return
    plan = rnn_cuda.lstm_fwd_plan(b, h)
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
    if h == 512 and b in (8, 24, 112, 488):
        assert plan["slabs"] * plan["row_tiles"] >= 100


def test_lstm_fwd_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="no route"):
        rnn_cuda.lstm_fwd_plan(8, 102)


@pytest.mark.parametrize("t,b,h", [(3, 4, 128), (3, 2, 128), (3, 24, 128),
                                   (256, 16, 128), (7, 3, 100), (3, 48, 128),
                                   (5, 9, 512), (1, 1, 8), (3, 4, 102)])
def test_lstm_bwd_plan_covers_every_cell_once(t, b, h):
    """The backward kernel's plan (``rnn_cuda.lstm_bwd_plan``): at the text
    model's H = 128 (training, eval and streamed shapes), a ragged H and a
    wide one, a step tile that ``csrc/lstm_bwd.cu`` compiles, slabs and row
    tiles that cover every cell and row exactly once (64 blocks at
    H = 128 up to 32 rows), and weight-product parts that cover the T*B
    rows exactly once, none empty, as the C entry cuts them; at an H the
    16-byte copies cannot take, a ValueError."""
    import re

    from icassp2022_depression_tpu_torch import _build

    compiled = {tuple(map(int, m)) for m in re.findall(
        r"^  LSTM_BWD_TILE\((\d+), (\d+)\)$",
        (_build.CSRC / "lstm_bwd.cu").read_text(), re.M)}
    assert compiled == set(rnn_cuda.BWD_TILES)
    if h % 4:
        with pytest.raises(ValueError, match="no route"):
            rnn_cuda.lstm_bwd_plan(b, h, steps=t)
        return
    plan = rnn_cuda.lstm_bwd_plan(b, h, steps=t)
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
    if h == 128 and b <= 32:
        assert plan["slabs"] * plan["row_tiles"] == 64
    k, splits = t * b, plan["splits"]
    chunk = 32 * rnn_cuda._cdiv(rnn_cuda._cdiv(k, splits), 32)  # as in C
    assert 1 <= splits <= 64 and (splits - 1) * chunk < k <= splits * chunk


def test_lstm_bwd_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="no route"):
        rnn_cuda.lstm_bwd_plan(8, 102, steps=3)


@pytest.mark.parametrize("route", ["step", "bogus"])
def test_lstm_bwd_wrapper_takes_plain_backward_on_cpu_whatever_the_plan(
        route):
    """On CPU tensors ``lstm_sequence_bwd`` runs the plain backward and
    launches nothing, whatever ``plan`` says."""
    xp, w, bias, dys, dcs = (torch.from_numpy(a)
                             for a in _inputs(3, 3, 2, 8))
    ys, cs = rnn_cuda.lstm_sequence_torch(xp, w, bias)
    plan = ({"route": "bogus"} if route == "bogus"
            else rnn_cuda.lstm_bwd_plan(2, 8, steps=3))
    before = rnn_cuda.LSTM_BWD_LAUNCHES
    got = rnn_cuda.lstm_sequence_bwd(xp, w, bias, ys, cs, dys, dcs,
                                     plan=plan)
    want = rnn_cuda.lstm_sequence_bwd_torch(xp, w, bias, ys, cs, dys, dcs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert rnn_cuda.LSTM_BWD_LAUNCHES == before
