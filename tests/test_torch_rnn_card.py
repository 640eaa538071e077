"""The GRU and LSTM kernels' wrappers on the card: inputs that are views
off a 16-byte boundary (the kernels read them with 16-byte copies) give
the aligned call's outputs bit for bit, and an H that is not a multiple
of 4 raises before anything is launched.  Needs an NVIDIA card and
``nvcc``; skips without them.  On the card (which has no JAX, so without
the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_rnn_card.py
"""

import pytest
import torch

from icassp2022_depression_tpu_torch.ops import rnn_cuda

pytestmark = pytest.mark.card

#: ``chip_smoke.py``'s KERNEL_TOL: every output within this share of its
#: reference's largest magnitude (float32 sums in another order)
KERNEL_TOL = 1e-5
GATES = {"gru": 3, "lstm": 4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the GRU / LSTM kernels are CUDA)")
    return "cuda"


def _inputs(cell, t, b, h, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = GATES[cell] * h
    xp = torch.randn((t, b, g), generator=gen)
    w = (torch.rand((h, g), generator=gen) * 2 - 1) / h ** 0.5
    bias = (torch.rand((1, g), generator=gen) * 2 - 1) / h ** 0.5
    return tuple(a.to(dev) for a in (xp, w, bias))


def _offset(a):
    """``a``'s values in a view one float past a 16-byte boundary."""
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = flat[1:].view(a.shape)
    view.copy_(a)
    assert view.data_ptr() % 16 != 0
    return view


def _fwd(cell, *args):
    out = getattr(rnn_cuda, f"{cell}_sequence")(*args)
    return out if isinstance(out, tuple) else (out,)


def _bwd(cell, xp, w, bias, outs, couts):
    return getattr(rnn_cuda, f"{cell}_sequence_bwd")(xp, w, bias, *outs,
                                                    *couts)


@pytest.mark.parametrize("cell,shape", [("gru", (3, 8, 256)),
                                        ("lstm", (3, 4, 128)),
                                        ("lstm", (16, 8, 512))])
def test_offset_views_give_the_aligned_results(cell, shape, dev):
    """Forward and backward on views of every input off a 16-byte boundary
    equal the aligned call bitwise, and the plain loops within
    ``KERNEL_TOL`` of their largest."""
    t, b, h = shape
    ins = _inputs(cell, t, b, h, dev)
    gen = torch.Generator().manual_seed(1)
    couts = tuple(torch.randn((t, b, h), generator=gen).to(dev)
                  for _ in range(1 if cell == "gru" else 2))
    outs = _fwd(cell, *ins)
    grads = _bwd(cell, *ins, outs, couts)
    off = tuple(_offset(a) for a in ins)
    outs_off = _fwd(cell, *off)
    grads_off = _bwd(cell, *off, tuple(_offset(o) for o in outs),
                     tuple(_offset(c) for c in couts))
    torch.cuda.synchronize()
    for got, want in zip(outs_off + grads_off, outs + grads):
        assert torch.equal(got, want)
    cpu = tuple(a.cpu() for a in ins)
    ref = _fwd(cell, *cpu)
    ref_grads = _bwd(cell, *cpu, ref, tuple(c.cpu() for c in couts))
    for got, want in zip(outs + grads, ref + ref_grads):
        want = want.reshape(got.shape)
        assert ((got.cpu() - want).abs().max()
                <= KERNEL_TOL * want.abs().max())


@pytest.mark.parametrize("cell,h", [("gru", 254), ("lstm", 126)])
def test_an_h_no_kernel_takes_raises_before_launching(cell, h, dev):
    """At an H that is not a multiple of 4 the wrappers and the autograd
    Function raise ``ValueError`` and launch nothing; ``plain=True`` (the
    ``"torch"`` backend) runs the plain loops there."""
    ins = _inputs(cell, 3, 4, h, dev)
    before = rnn_cuda.launch_counts()
    with pytest.raises(ValueError, match="no route"):
        _fwd(cell, *ins)
    outs = getattr(rnn_cuda, f"{cell}_sequence_torch")(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    with pytest.raises(ValueError, match="no route"):
        _bwd(cell, *ins, outs, tuple(torch.zeros_like(o) for o in outs))
    fn = rnn_cuda.GRUSequence if cell == "gru" else rnn_cuda.LSTMSequence
    with pytest.raises(ValueError, match="no route"):
        fn.apply(*ins)
    plain = fn.apply(*ins, True)
    torch.cuda.synchronize()
    assert rnn_cuda.launch_counts() == before
    plain = plain if isinstance(plain, tuple) else (plain,)
    for got, want in zip(plain, outs):
        assert torch.equal(got, want)
