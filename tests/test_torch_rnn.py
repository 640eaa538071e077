"""The port's GRU (plain recurrence, backend seam, multi-layer and
bidirectional wrapper) against the JAX package's Pallas kernel, run in
interpret mode on the CPU as ``tests/test_rnn_pallas.py`` runs it, and
against its scan path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu.ops import rnn as jrnn
from icassp2022_depression_tpu.ops import rnn_pallas
from icassp2022_depression_tpu_torch import _build
from icassp2022_depression_tpu_torch.ops import rnn as trnn
from icassp2022_depression_tpu_torch.ops import rnn_cuda
from icassp2022_depression_tpu_torch.ops import prng as tprng

ATOL = 1e-5


def _layers(seed, d, h, num_layers, bidirectional):
    """JAX params + the same numbers as torch tensors."""
    jp = jrnn.init_params(jax.random.PRNGKey(seed), "gru", d, h, num_layers,
                          bidirectional)
    tp = [{dirn: {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
           for dirn, p in layer.items()} for layer in jp]
    return jp, tp


@pytest.mark.parametrize("t,b,h", [(3, 4, 8), (3, 1, 32), (7, 3, 16)])
def test_gru_sequence_torch_matches_pallas_kernel(t, b, h):
    rng = np.random.default_rng(t * 100 + b)
    xp = rng.standard_normal((t, b, 3 * h)).astype(np.float32)
    w = (rng.uniform(-1, 1, (h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.uniform(-1, 1, (1, 3 * h)) / np.sqrt(h)).astype(np.float32)
    want = np.asarray(rnn_pallas.gru_sequence(jnp.asarray(xp), jnp.asarray(w),
                                              jnp.asarray(bias)))
    got = rnn_cuda.gru_sequence_torch(torch.from_numpy(xp),
                                      torch.from_numpy(w),
                                      torch.from_numpy(bias))
    assert tuple(got.shape) == (t, b, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_gru_sequence_wrapper_uses_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.standard_normal((3, 2, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 24)).astype(np.float32))
    bias = torch.zeros(1, 24)
    before = rnn_cuda.LAUNCHES
    assert torch.equal(rnn_cuda.gru_sequence(xp, w, bias),
                       rnn_cuda.gru_sequence_torch(xp, w, bias))
    assert rnn_cuda.LAUNCHES == before


@pytest.mark.parametrize("b,h", [(8, 256), (2, 256), (24, 256), (16, 256),
                                 (1, 256), (3, 200), (40, 256), (100, 256),
                                 (200, 256), (9, 512), (1, 8), (4, 254),
                                 (512, 256), (1024, 256)])
def test_gru_fwd_plan_covers_every_cell_once(b, h):
    """The forward kernel's plan (``rnn_cuda.gru_fwd_plan``): at the audio
    model's H = 256 (serving, training, eval and streamed batches, and
    cross-corpus evaluation's power-of-two batches of windows), a
    ragged H and a wide one, a step tile that ``csrc/gru_fwd.cu`` compiles,
    slabs and row tiles that cover every cell and row exactly once with
    none empty (4-cell slabs and at most 32-row tiles at every B: 64 slabs
    at H = 256); at an H the 16-byte copies cannot take, the
    one-block-per-row route."""
    import re

    compiled = {tuple(map(int, m)) for m in re.findall(
        r"^  GRU_FWD_TILE\((\d+), (\d+), \d+\)$",
        (_build.CSRC / "gru_fwd.cu").read_text(), re.M)}
    assert compiled == set(rnn_cuda.GRU_FWD_TILES)
    plan = rnn_cuda.gru_fwd_plan(b, h)
    if h % 4:
        assert plan == {"route": "sequence", "cells": 0, "rows": 0,
                        "slabs": 1, "row_tiles": b}
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
    assert cells == 4 and rows <= 32
    if h == 256:
        assert plan["slabs"] == 64
    assert rnn_cuda.gru_fwd_plan(b, h, "sequence")["route"] == "sequence"


def test_gru_fwd_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="no route"):
        rnn_cuda.gru_fwd_plan(8, 254, "step")
    with pytest.raises(ValueError, match="no route"):
        rnn_cuda.gru_fwd_plan(8, 256, "persistent")


@pytest.mark.parametrize("route", ["step", "sequence", "bogus"])
def test_gru_sequence_wrapper_takes_plain_forward_on_cpu_whatever_the_plan(
        route):
    """On CPU tensors ``gru_sequence`` runs the plain recurrence and
    launches nothing, whatever ``plan`` says."""
    rng = np.random.default_rng(4)
    xp = torch.from_numpy(rng.standard_normal((3, 2, 24)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (8, 24)) / np.sqrt(8)
                          ).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, (1, 24)).astype(np.float32))
    plan = ({"route": "bogus"} if route == "bogus"
            else rnn_cuda.gru_fwd_plan(2, 8, route))
    before = rnn_cuda.LAUNCHES
    assert torch.equal(rnn_cuda.gru_sequence(xp, w, bias, plan=plan),
                       rnn_cuda.gru_sequence_torch(xp, w, bias))
    assert rnn_cuda.LAUNCHES == before
    assert "gru_fwd" not in rnn_cuda._fns


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_matches_pallas_layer(reverse):
    jp, tp = _layers(1, 12, 16, 1, False)
    x = np.random.default_rng(2).standard_normal((4, 3, 12)).astype(np.float32)
    ys_j, h_j = rnn_pallas.gru_layer(jp[0]["fwd"], jnp.asarray(x), reverse)
    ys_t, h_t = trnn.gru_layer(tp[0]["fwd"], torch.from_numpy(x), reverse)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("num_layers,bidirectional,backend", [
    (1, False, "pallas"), (2, False, "pallas"), (2, True, "pallas"),
    (2, True, "xla")])
def test_rnn_matches_jax(num_layers, bidirectional, backend):
    jp, tp = _layers(3, 10, 16, num_layers, bidirectional)
    x = np.random.default_rng(4).standard_normal((5, 3, 10)).astype(np.float32)
    y_j, hn_j, cn_j = jrnn.rnn(jp, jnp.asarray(x), "gru", backend=backend)
    y_t, hn_t, cn_t = trnn.rnn(tp, torch.from_numpy(x), "gru")
    assert cn_j is None and cn_t is None
    assert tuple(hn_t.shape) == hn_j.shape
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(hn_t.numpy(), np.asarray(hn_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_module_matches_torch_gru(bidirectional):
    """Parameter names are nn.GRU's, and so are the outputs."""
    mod = trnn.RNN(6, 8, 2, bidirectional,
                   key=tprng.prng_key(0))
    ref = torch.nn.GRU(6, 8, 2, batch_first=True,
                       bidirectional=bidirectional)
    assert set(mod.state_dict()) == set(ref.state_dict())
    ref.load_state_dict(mod.state_dict(), strict=True)
    mod.eval()
    x = torch.randn(3, 4, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, h_n, _ = mod(x)
        y_ref, h_ref = ref(x)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(h_n, h_ref.transpose(0, 1), rtol=0, atol=ATOL)


def test_backend_seam():
    x = torch.zeros(2, 3, 4)
    assert trnn.resolve_backend("auto", x) == "torch"
    assert trnn.resolve_backend("torch", x) == "torch"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trnn.resolve_backend("cuda", x)
    with pytest.raises(ValueError, match="backend must be one of"):
        trnn.resolve_backend("pallas", x)
    _, tp = _layers(0, 4, 8, 1, False)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trnn.rnn(tp, x, "gru", backend="cuda")


def test_lstm_and_xavier_name_the_text_slice():
    """The text slice's cell and init exist; unknown ones still raise."""
    layers = trnn.init_params("lstm", 4, 8, 2, True, init="xavier")
    assert [sorted(layer) for layer in layers] == [["bwd", "fwd"]] * 2
    assert tuple(layers[1]["bwd"]["w_ih"].shape) == (32, 16)
    y, h_n, c_n = trnn.rnn(layers, torch.zeros(1, 3, 4), "lstm")
    assert tuple(y.shape) == (1, 3, 16)
    assert tuple(h_n.shape) == tuple(c_n.shape) == (1, 4, 8)
    with pytest.raises(ValueError, match="unknown cell"):
        trnn.init_params("rnn", 4, 8, 1, False)
    with pytest.raises(ValueError, match="unknown init"):
        trnn.init_params("gru", 4, 8, 1, False, init="orthogonal")
    with pytest.raises(ValueError, match="unknown cell"):
        trnn.rnn([], torch.zeros(1, 3, 4), "rnn")


def test_kernel_module_imports_without_building():
    """Importing the kernel module and the builder compiles nothing; the
    library path is keyed by the source and lies in the ignored _build/."""
    assert rnn_cuda._fns == {}
    for name in ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd"):
        assert name not in _build._loaded
        so = _build.library_path(name)
        assert so.parent == _build.BUILD_DIR
        assert so.name.startswith(f"lib{name}-")
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
