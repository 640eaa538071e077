"""The LSTMP forward's resident route (``csrc/lstmp_fwd.cu``, one
cooperative launch a sequence) on the card: against the plain recurrence,
bitwise on reruns, counted once a call, free of host synchronisation, and
left to the step route above one row tile.  Needs an NVIDIA card and
``nvcc``; skips without them.  On the card (which has no JAX, so without
the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_lstmp_card.py
"""

import pytest
import torch

from icassp2022_depression_tpu_torch.ops import rnn_cuda

pytestmark = pytest.mark.card

#: ``chip_smoke.py``'s KERNEL_TOL: every output within this share of its
#: reference's largest magnitude (float32 sums in another order)
KERNEL_TOL = 1e-5
ZHS = (4096, 512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the LSTMP kernels are CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _inputs(t, b, c, p, weights="init", seed=0):
    """(xp4, w_h_t3, b3, w_p_t) as ``chip_smoke.py::_lstmp_inputs`` draws
    them: "init" at ``init_lstmp``'s bounds, "clips" scaled so both +-3
    clips engage."""
    gen = torch.Generator().manual_seed(seed)
    gain = 1.0 if weights == "init" else 0.5
    xp4 = torch.randn((t, b, 4, c), generator=gen)
    w_h = (torch.rand((p, 4, c), generator=gen) * 2 - 1) * gain / p ** 0.5
    if weights == "init":
        b3 = torch.zeros((1, 4, c))
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) / c ** 0.5
    else:
        xp4 = xp4 * 2
        b3 = torch.rand((1, 4, c), generator=gen) - 0.5
        b3[:, :2] += 2.0
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) * 6 / c ** 0.5
    return tuple(a.cuda() for a in (xp4, w_h, b3, w_p))


def _rel(got, want) -> float:
    return max(((g - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("t,b,c,p,weights", [
    (1, 8, *ZHS, "init"), (16, 8, *ZHS, "clips"), (128, 8, *ZHS, "init"),
    (128, 24, *ZHS, "init"), (128, 32, *ZHS, "init"),
    (7, 3, 384, 128, "clips")])
def test_resident_route_matches_plain_recurrence(t, b, c, p, weights, dev):
    plan = rnn_cuda.lstmp_fwd_plan(b, c, p, sms=rnn_cuda._sms(0))
    assert plan["route"] == "resident"
    args = _inputs(t, b, c, p, weights)
    got = rnn_cuda.lstmp_sequence(*args)
    want = rnn_cuda.lstmp_sequence_torch(*args)
    torch.cuda.synchronize()
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert _rel(got, want) <= KERNEL_TOL
    if weights == "clips":    # both clips engaged
        assert want[2].abs().max().item() > 3.0
        assert want[1].abs().max().item() > 3.0
        assert got[0].abs().max().item() == 3.0


@pytest.mark.parametrize("b", [8, 32])
def test_resident_and_step_routes_agree(b, dev):
    args = _inputs(64, b, *ZHS, "clips", seed=1)
    step = rnn_cuda.lstmp_sequence(
        *args, plan=rnn_cuda.lstmp_fwd_plan(b, *ZHS, sms=0))
    resident = rnn_cuda.lstmp_sequence(*args)
    assert _rel(resident, step) <= KERNEL_TOL


def test_resident_route_reruns_bitwise_and_counts_once(dev):
    args = _inputs(128, 8, *ZHS, "clips", seed=2)
    first = rnn_cuda.lstmp_sequence(*args)
    before = rnn_cuda.launch_counts()
    again = [rnn_cuda.lstmp_sequence(*args) for _ in range(3)]
    after = rnn_cuda.launch_counts()
    assert all(torch.equal(a, f) for run in again for a, f in zip(run, first))
    assert after["lstmp_fwd"] - before["lstmp_fwd"] == 3
    assert after["lstmp_fwd_resident"] - before["lstmp_fwd_resident"] == 3


@pytest.mark.parametrize("b", [33, 96])
def test_more_than_one_row_tile_takes_the_step_route(b, dev):
    assert rnn_cuda.lstmp_fwd_plan(b, *ZHS)["route"] == "step"
    args = _inputs(6, b, *ZHS, "clips", seed=3)
    before = rnn_cuda.launch_counts()
    got = rnn_cuda.lstmp_sequence(*args)
    after = rnn_cuda.launch_counts()
    assert after["lstmp_fwd"] - before["lstmp_fwd"] == 1
    assert after["lstmp_fwd_resident"] == before["lstmp_fwd_resident"]
    assert _rel(got, rnn_cuda.lstmp_sequence_torch(*args)) <= KERNEL_TOL


def test_resident_route_makes_no_host_synchronisation(dev):
    args = _inputs(32, 8, *ZHS, seed=4)
    rnn_cuda.lstmp_sequence(*args)      # first use: build, barrier state
    torch.cuda.synchronize()
    before = rnn_cuda.LSTMP_RESIDENT_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rnn_cuda.lstmp_sequence(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rnn_cuda.LSTMP_RESIDENT_LAUNCHES == before + 1
    assert torch.isfinite(out[0]).all()
