"""The port's LSTMP cell (the ELMo biLM's LSTM with projection: the plain
forward and backward that are the CUDA kernels' oracles, the autograd
Function around both kernels and the layer) against the JAX package: its
Pallas streaming kernel and custom VJP (``rnn_pallas.lstmp_layer_streamed``
/ ``lstmp_sequence_streamed``), run in interpret mode on the CPU with a
slab smaller than C so the slab loop is exercised, and its scan
(``rnn.lstmp_layer``).

Weights are scaled so both clips engage; every backward runs with a
nonzero cotangent of the pre-clip cell states.  Tolerances: 1e-5 absolute
in float32 (the same recurrence summed in another order); ``gradcheck`` in
float64 at its defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu.ops import rnn as jrnn
from icassp2022_depression_tpu.ops import rnn_pallas
from icassp2022_depression_tpu_torch.ops import rnn as trnn
from icassp2022_depression_tpu_torch.ops import rnn_cuda

ATOL = 1e-5
NAMES = ("w_x", "w_h", "b", "w_p")


def _params(seed, d, c, p, scale):
    rng = np.random.default_rng(seed)
    return {"w_x": (rng.uniform(-1, 1, (4 * c, d)) * scale / np.sqrt(d)),
            "w_h": (rng.uniform(-1, 1, (4 * c, p)) * scale / np.sqrt(p)),
            "b": rng.uniform(-0.5, 0.5, (4 * c,)),
            "w_p": (rng.uniform(-1, 1, (p, c)) * scale / np.sqrt(c))}


def _np(params):
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def _x(seed, b, t, d):
    return np.random.default_rng(seed + 1).standard_normal(
        (b, t, d)).astype(np.float32)


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.asarray(want).shape, name
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL,
                               err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("clip", [3.0, 0.0])
def test_lstmp_layer_matches_pallas_streamed(reverse, clip):
    """ys, h_last, c_last of the port's layer (plain recurrence on the CPU)
    against the streaming Pallas kernel at slab 16 < C = 32."""
    p = _np(_params(0, 12, 32, 8, 6.0))
    x = _x(0, 3, 7, 12) * 3
    want = rnn_pallas.lstmp_layer_streamed(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        reverse=reverse, cell_clip=clip, proj_clip=clip, slab=16)
    got = trnn.lstmp_layer({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), reverse, clip, clip)
    for name, g, w in zip(("ys", "h_last", "c_last"), got, want):
        _close(g, w, name)
    if clip:   # both clips engaged
        ys, _, cpre, _ = rnn_cuda.lstmp_sequence_torch(*(
            t.contiguous() for t in (
                torch.matmul(torch.from_numpy(x), torch.from_numpy(p["w_x"]).t())
                .transpose(0, 1).reshape(7, 3, 4, 32),
                torch.from_numpy(p["w_h"]).t().reshape(8, 4, 32),
                torch.from_numpy(p["b"]).reshape(1, 4, 32),
                torch.from_numpy(p["w_p"]).t())))
        assert float(cpre.abs().max()) > clip
        assert float(ys.abs().max()) == clip


def test_lstmp_layer_matches_jax_scan_and_backend_torch():
    p = _np(_params(1, 16, 24, 16, 2.0))
    x = _x(1, 4, 5, 16)
    want = jrnn.lstmp_layer({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), backend="xla")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for backend in ("auto", "torch"):
        got = trnn.lstmp_layer(tp, torch.from_numpy(x), backend=backend)
        for name, g, w in zip(("ys", "h_last", "c_last"), got, want):
            _close(g, w, f"{backend} {name}")


def _sequence_inputs(seed, t, b, c, p, scale=3.0):
    rng = np.random.default_rng(seed)
    xp4 = (rng.standard_normal((t, b, 4, c)) * 2).astype(np.float32)
    w_h_t3 = (rng.uniform(-1, 1, (p, 4, c)) * scale / np.sqrt(p)
              ).astype(np.float32)
    b3 = rng.uniform(-0.5, 0.5, (1, 4, c)).astype(np.float32)
    w_p_t = (rng.uniform(-1, 1, (c, p)) * scale / np.sqrt(c)
             ).astype(np.float32)
    dys = rng.standard_normal((t, b, p)).astype(np.float32)
    dcpre = rng.standard_normal((t, b, c)).astype(np.float32)
    return (xp4, w_h_t3, b3, w_p_t), (dys, dcpre)


@pytest.mark.parametrize("t,b,c,p,clip", [(6, 3, 32, 8, 3.0),
                                          (5, 2, 16, 16, 3.0),
                                          (4, 3, 32, 8, 0.0),
                                          (1, 2, 16, 8, 3.0)])
def test_lstmp_sequence_grads_match_jax_custom_vjp(t, b, c, p, clip):
    """The four gradients of ``LSTMPSequence`` (the plain backward on the
    CPU, weight gradients as three products) against ``jax.vjp`` through
    ``lstmp_sequence_streamed``'s custom VJP (the Pallas backward kernel in
    interpret mode), with a nonzero cotangent of the pre-clip cells."""
    ins, (dys, dcpre) = _sequence_inputs(t * 10 + b, t, b, c, p)
    jins = [jnp.asarray(a) for a in ins]
    (ys, cpre), vjp = jax.vjp(
        lambda *a: rnn_pallas.lstmp_sequence_streamed(*a, c // 2, clip,
                                                      clip), *jins)
    want = vjp((jnp.asarray(dys), jnp.asarray(dcpre)))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    got_ys, got_cpre = rnn_cuda.LSTMPSequence.apply(*tins, clip, clip, False)
    _close(got_ys, ys, "ys")
    _close(got_cpre, cpre, "cpre")
    grads = torch.autograd.grad((got_ys, got_cpre), tins,
                                (torch.from_numpy(dys),
                                 torch.from_numpy(dcpre)))
    for name, g, w in zip(("dxp4", "dw_h_t3", "db3", "dw_p_t"), grads, want):
        _close(g, w, name)


def test_lstmp_bwd_torch_matches_pallas_bwd_rule_on_its_residuals():
    """The plain backward fed the forward residuals of the Pallas kernel
    gives the Pallas rule's dgates: the clip masks are decided on the same
    numbers."""
    t, b, c, p = 5, 3, 32, 8
    ins, (dys, dcpre) = _sequence_inputs(7, t, b, c, p)
    jins = [jnp.asarray(a) for a in ins]
    ys, hpre, cpre, hf = rnn_pallas._lstmp_stream_fwd(*jins, 16, 3.0, 3.0)
    want = rnn_pallas._lstmp_stream_bwd_rule(
        16, 3.0, 3.0, (*jins, ys, hpre, cpre, hf),
        (jnp.asarray(dys), jnp.asarray(dcpre)))
    tt = [torch.from_numpy(np.array(a))
          for a in (*ins, ys, hpre, cpre, dys, dcpre)]
    dgates, dhpre = rnn_cuda.lstmp_sequence_bwd_torch(*tt)
    _close(dgates, want[0], "dgates")
    wg = rnn_cuda.lstmp_weight_grads(dgates, dhpre, tt[4],
                                     torch.from_numpy(np.array(hf)))
    for name, g, w in zip(("dw_h_t3", "db3", "dw_p_t"), wg, want[1:]):
        _close(g, w, name)
    # the forward's residuals agree too
    for name, g, w in zip(("ys", "hpre", "cpre", "hf"),
                          rnn_cuda.lstmp_sequence_torch(*tt[:4]),
                          (ys, hpre, cpre, hf)):
        _close(g, w, name)


@pytest.mark.parametrize("plain", [False, True])
def test_lstmp_sequence_function_gradcheck(plain):
    rng = np.random.default_rng(3)
    t, b, c, p = 3, 2, 4, 3
    ins = [torch.from_numpy(a).double().requires_grad_() for a in (
        rng.standard_normal((t, b, 4, c)), rng.uniform(-1, 1, (p, 4, c)),
        rng.uniform(-1, 1, (1, 4, c)), rng.uniform(-1, 1, (c, p)))]
    # large clips: gradcheck's finite differences must not straddle a clip
    assert torch.autograd.gradcheck(
        lambda *a: rnn_cuda.LSTMPSequence.apply(*a, 50.0, 50.0, plain), ins)


def test_lstmp_wrappers_use_plain_versions_on_cpu():
    """On CPU tensors the wrappers run the plain versions, launch nothing
    and build nothing; the forward refuses no CPU input."""
    ins, (dys, dcpre) = _sequence_inputs(11, 3, 2, 16, 8)
    tt = [torch.from_numpy(a) for a in ins]
    before = (rnn_cuda.LSTMP_LAUNCHES, rnn_cuda.LSTMP_BWD_LAUNCHES)
    got = rnn_cuda.lstmp_sequence(*tt)
    want = rnn_cuda.lstmp_sequence_torch(*tt)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    bwd = rnn_cuda.lstmp_sequence_bwd(*tt, got[0], got[1], got[2],
                                      torch.from_numpy(dys),
                                      torch.from_numpy(dcpre))
    ref = rnn_cuda.lstmp_sequence_bwd_torch(*tt, got[0], got[1], got[2],
                                            torch.from_numpy(dys),
                                            torch.from_numpy(dcpre))
    assert all(torch.equal(g, w) for g, w in zip(bwd, ref))
    assert (rnn_cuda.LSTMP_LAUNCHES, rnn_cuda.LSTMP_BWD_LAUNCHES) == before
    assert "lstmp_fwd" not in rnn_cuda._fns
    with pytest.raises(ValueError, match=r"\[T, B, 4, C\]"):
        rnn_cuda._lstmp_dims(tt[0][0], tt[1])


def test_init_lstmp_draws_the_jax_weights():
    """Seeded LSTMP weights: the port's threefry draws the JAX package's
    uniforms bit for bit."""
    from icassp2022_depression_tpu_torch.ops import prng

    want = jrnn.init_lstmp(jax.random.PRNGKey(5), 12, 20, 8)
    got = trnn.init_lstmp(prng.prng_key(5), 12, 20, 8)
    for k in NAMES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _fwd_compiled():
    """The forward's compiled step tiles (cells, rows), resident row tiles
    and register dims, read off ``csrc/lstmp_fwd.cu``."""
    import re

    from icassp2022_depression_tpu_torch import _build

    source = (_build.CSRC / "lstmp_fwd.cu").read_text()
    tiles = {tuple(map(int, m)) for m in re.findall(
        r"^  LSTMP_FWD_TILE\((\d+), (\d+)\)$", source, re.M)}
    rows = {int(m) for m in re.findall(
        r"^  LSTMP_FWD_RESIDENT\((\d+)\)$", source, re.M)}
    reg = int(re.search(r"constexpr int KR = (\d+);", source).group(1))
    return tiles, rows, reg


@pytest.mark.parametrize("b,c,p", [(8, 4096, 512), (24, 4096, 512),
                                   (128, 4096, 512), (104, 4096, 512),
                                   (3, 384, 128), (32, 4096, 512)])
def test_lstmp_fwd_plan_covers_every_cell_once(b, c, p):
    """The forward kernel's split (``rnn_cuda.lstmp_fwd_plan``), on an H100
    and with no SMs for the resident route (the step route's plan at every
    row count): a tile the C entry compiles for the plan's route, slabs and
    row tiles that cover every cell and row exactly once, 128 blocks at the
    zhs width, and a partial scratch ``[slabs, B, P]`` within twice
    ``w_p_t``'s size."""
    tiles, resident_rows, _ = _fwd_compiled()
    assert len(tiles) == 5
    assert resident_rows == set(rnn_cuda.LSTMP_RESIDENT_ROWS)
    for sms in (rnn_cuda.H100_SMS, 0):
        plan = rnn_cuda.lstmp_fwd_plan(b, c, p, sms=sms)
        assert (plan["route"] == "step") == (sms == 0 or b > 32)
        cells, rows = plan["cells"], plan["rows"]
        if plan["route"] == "resident":
            assert cells == 32 and rows in resident_rows
            assert plan["row_tiles"] == 1 and b <= rows
        else:
            assert (cells, rows) in tiles
        cover_c, cover_b = np.zeros(c, int), np.zeros(b, int)
        for s in range(plan["slabs"]):
            assert s * cells < c                 # no empty slab
            cover_c[s * cells:(s + 1) * cells] += 1
        for r in range(plan["row_tiles"]):
            assert r * rows < b                  # no empty row tile
            cover_b[r * rows:(r + 1) * rows] += 1
        assert (cover_c == 1).all() and (cover_b == 1).all()
        assert plan["scratch"] == (plan["slabs"], b, p)
        assert np.prod(plan["scratch"]) <= 2 * c * p
        if c == 4096:
            assert plan["slabs"] * plan["row_tiles"] == 128


@pytest.mark.parametrize("b,c,p", [(8, 4096, 512), (24, 4096, 512),
                                   (104, 4096, 512), (128, 4096, 512),
                                   (3, 384, 128)])
def test_lstmp_bwd_plan_covers_every_cell_once(b, c, p):
    """The backward kernel's step route (``rnn_cuda.lstmp_bwd_plan``): a
    tile the C entry compiles, slabs and row tiles that cover every cell
    and row exactly once with none empty, 128 slabs at the zhs width, a
    partial-carry scratch ``[slabs, B, P]``, and one allocation holding
    the carry [B, C] and the partials, as the C entry cuts it."""
    import re

    from icassp2022_depression_tpu_torch import _build

    compiled = {tuple(map(int, m)) for m in re.findall(
        r"^  LSTMP_BWD_TILE\((\d+), (\d+)\)$",
        (_build.CSRC / "lstmp_bwd.cu").read_text(), re.M)}
    assert compiled == set(rnn_cuda.LSTMP_BWD_TILES)
    plan = rnn_cuda.lstmp_bwd_plan(b, c, p)
    assert plan["route"] == "step"
    cells, rows = plan["cells"], plan["rows"]
    assert (cells, rows) in compiled
    cover_c, cover_b = np.zeros(c, int), np.zeros(b, int)
    for s in range(plan["slabs"]):
        assert s * cells < c                 # no empty slab
        cover_c[s * cells:(s + 1) * cells] += 1
    for r in range(plan["row_tiles"]):
        assert r * rows < b                  # no empty row tile
        cover_b[r * rows:(r + 1) * rows] += 1
    assert (cover_c == 1).all() and (cover_b == 1).all()
    assert plan["scratch"] == (plan["slabs"], b, p)
    if c == 4096:
        assert plan["slabs"] == 128
    scratch = rnn_cuda._lstmp_bwd_scratch(plan, b, c, "cpu")
    assert scratch.numel() == b * c + plan["slabs"] * b * p


def test_lstmp_bwd_plan_refuses_what_no_route_takes():
    """The kernel's 16-byte copies need C and P in multiples of 4."""
    for c, p in ((386, 128), (384, 130)):
        with pytest.raises(ValueError, match="no route"):
            rnn_cuda.lstmp_bwd_plan(3, c, p)


@pytest.mark.parametrize("plan_of", ["step", "another_shape", "bogus"])
def test_lstmp_bwd_wrapper_takes_plain_backward_on_cpu_whatever_the_plan(
        plan_of):
    """On CPU tensors ``lstmp_sequence_bwd`` runs the plain backward and
    launches nothing, whatever ``plan`` says: its own shape's plan, the
    plan of a 128-row batch, or no plan at all."""
    ins, (dys, dcpre) = _sequence_inputs(13, 4, 2, 16, 8)
    tt = [torch.from_numpy(a) for a in ins]
    res = rnn_cuda.lstmp_sequence_torch(*tt)[:3]
    cot = (torch.from_numpy(dys), torch.from_numpy(dcpre))
    plan = {"step": rnn_cuda.lstmp_bwd_plan(2, 16, 8),
            "another_shape": rnn_cuda.lstmp_bwd_plan(128, 4096, 512),
            "bogus": {"route": "bogus"}}[plan_of]
    before = rnn_cuda.LSTMP_BWD_LAUNCHES
    got = rnn_cuda.lstmp_sequence_bwd(*tt, *res, *cot, plan=plan)
    want = rnn_cuda.lstmp_sequence_bwd_torch(*tt, *res, *cot)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rnn_cuda.LSTMP_BWD_LAUNCHES == before
    assert "lstmp_bwd" not in rnn_cuda._fns


def _c_entry_args(source: str, symbol: str) -> tuple:
    """(pointers, ints, floats) before the stream in a C entry's
    signature."""
    import re

    sig = re.search(symbol + r"\(([^)]*)\)", source).group(1)
    params = [a.strip() for a in sig.split(",")]
    assert params[-1] == "void* stream", params
    pointers = sum("*" in a for a in params[:-1])
    ints = sum(a.startswith("int ") for a in params[:-1])
    floats = sum(a.startswith("float ") for a in params[:-1])
    assert pointers + ints + floats == len(params) - 1, params
    return pointers, ints, floats


@pytest.mark.parametrize("name", sorted(rnn_cuda._ENTRIES))
def test_c_entry_signatures_match_the_bindings(name):
    """Each ``_ENTRIES`` binding names the argument counts of its C entry
    in ``csrc/<name>.cu`` (ctypes would pass a mismatched call silently);
    the LSTMP forward takes the partial scratch, the resident route's
    barrier word, the route, the tile and the shared-memory dims."""
    from icassp2022_depression_tpu_torch import _build

    symbol, *counts = rnn_cuda._ENTRIES[name]
    source = (_build.CSRC / f"{name}.cu").read_text()
    assert _c_entry_args(source, symbol) == tuple(counts)
    if name == "lstmp_fwd":
        assert tuple(counts) == (10, 8, 2)


ZHS = (4096, 512)


@pytest.mark.parametrize("c,p", [ZHS, (384, 128)])
@pytest.mark.parametrize("b", [1, 3, 8, 24, 32, 33, 64, 96, 128])
def test_lstmp_fwd_plan_route_by_rows(b, c, p):
    """One row tile (at most 32 rows) takes the resident route, at the zhs
    width and at a small one; more rows take the step route, whose plan is
    the one it always had: 32-cell slabs and at most 32-row tiles up to 64
    rows, 64 x 64 tiles above."""
    plan = rnn_cuda.lstmp_fwd_plan(b, c, p)
    if b <= rnn_cuda.LSTMP_RESIDENT_MAX_ROWS:
        assert plan["route"] == "resident"
        assert (plan["cells"], plan["rows"]) == (32, 8 * -(-b // 8))
        assert plan["slabs"] == -(-c // 32)
        return
    assert plan["route"] == "step"
    want = {33: (32, 24, 2), 64: (32, 32, 2), 96: (64, 64, 2),
            128: (64, 64, 2)}[b]
    assert (plan["cells"], plan["rows"], plan["row_tiles"]) == want
    assert plan == rnn_cuda.lstmp_fwd_plan(b, c, p, sms=0)


@pytest.mark.parametrize("b", rnn_cuda.LSTMP_RESIDENT_ROWS)
@pytest.mark.parametrize("c,p", [ZHS, (384, 128), (4096, 12), (64, 500)])
def test_lstmp_resident_blocks_and_dims_cover_every_cell_once(b, c, p):
    """The resident route: one block a 32-cell slab, together covering
    every cell once and no more blocks than an H100's SMs; every W_h dim of
    each of the gate product's 4 parts in registers, shared memory or L2
    exactly once, the register dims the source's, the shared ones a
    multiple of 4 (16-byte reads of h) within an sm_90 block's shared
    memory beside h, a pass's partials and the hf slab.  At the zhs
    geometry the shared memory holds every dim the registers do not at 8
    rows; at 32 rows it holds 68, where room for 71 is left (71 dims would
    start the L2 reads of h off a 16-byte boundary)."""
    _, _, reg = _fwd_compiled()
    plan = rnn_cuda.lstmp_fwd_plan(b, c, p)
    assert plan["route"] == "resident" and plan["scratch"] == (
        plan["slabs"], b, p)
    cover = np.zeros(c, int)
    for s in range(plan["slabs"]):
        assert s * 32 < c                    # no empty block
        cover[s * 32:(s + 1) * 32] += 1
    assert (cover == 1).all() and plan["slabs"] <= rnn_cuda.H100_SMS
    part = 4 * -(-p // 16)
    in_reg, in_smem, in_l2 = plan["dims"]
    assert in_reg == min(reg, part) and in_smem % 4 == 0 and in_l2 >= 0
    assert in_reg + in_smem + in_l2 == part and 4 * part >= p
    smem = 4 * (4 * in_smem * 128 + b * p + 4 * 8 * 128 + b * 32)
    assert smem <= rnn_cuda.SM90_SMEM_PER_BLOCK
    if (c, p) == ZHS:
        assert plan["slabs"] == 128
        assert plan["dims"] == {8: (32, 96, 0), 16: (32, 88, 8),
                                24: (32, 80, 16), 32: (32, 68, 28)}[b]


def test_lstmp_fwd_plan_refuses_or_steps_where_resident_cannot_run():
    """The resident route needs its blocks on distinct SMs (a card with
    fewer SMs than slabs takes the step route), P at most 512 (two
    projection columns a thread), C a multiple of 4 and one row tile;
    elsewhere the plan is the step route's."""
    assert rnn_cuda.lstmp_fwd_plan(8, *ZHS, sms=114)["route"] == "step"
    assert rnn_cuda.lstmp_fwd_plan(8, *ZHS, sms=128)["route"] == "resident"
    assert rnn_cuda.lstmp_fwd_plan(8, 4096, 516)["route"] == "step"
    for b, c, p, sms in ((8, 4096, 512, 114), (8, 4096, 516, 132),
                         (33, 4096, 512, 132), (8, 4098, 512, 132)):
        assert rnn_cuda.lstmp_fwd_plan(b, c, p, sms=sms) == \
            rnn_cuda.lstmp_fwd_plan(b, c, p, sms=0)


def test_launch_counts_carry_the_resident_route():
    """``lstmp_fwd_resident`` is one of ``launch_counts()``'s sources; a
    CPU call of the forward moves neither LSTMP counter."""
    counts = rnn_cuda.launch_counts()
    assert "lstmp_fwd_resident" in counts and "lstmp_fwd" in counts
    assert rnn_cuda.COUNTERS["lstmp_fwd_resident"][1] == \
        "LSTMP_RESIDENT_LAUNCHES"
    ins, _ = _sequence_inputs(17, 3, 8, 16, 8)
    rnn_cuda.lstmp_sequence(*(torch.from_numpy(a) for a in ins))
    assert rnn_cuda.launch_counts() == counts
