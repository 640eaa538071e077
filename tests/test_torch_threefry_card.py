"""The threefry kernel (``csrc/threefry.cu``) against its plain version on
the card, bit for bit.  Needs an NVIDIA card and ``nvcc``; skips without
them.  On the card (which has no JAX, so without the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_threefry_card.py
"""

import pytest
import torch

from icassp2022_depression_tpu_torch.ops import netvlad, prng

pytestmark = pytest.mark.card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the threefry kernel is CUDA)")
    return "cuda"


def _keys(dev, rows):
    return prng.split_torch(prng.prng_key(23, dev), rows)


#: (draw on the kernel route, the same draw's plain version) on [R, 2] keys
CASES = {
    "fold_in int": (lambda k: prng.fold_in(k, 7),
                    lambda k: prng.fold_in_torch(k, 7)),
    "fold_in ordinals": (lambda k: prng.fold_in(k[0], torch.arange(
        96, device=k.device)), lambda k: prng.fold_in_torch(
        k[0], torch.arange(96, device=k.device))),
    "split 4": (lambda k: prng.split(k, 4), lambda k: prng.split_torch(k, 4)),
    "random_bits odd": (lambda k: prng.random_bits(k, (5, 7), rows=(2, 9)),
                        lambda k: prng.random_bits_torch(k, (5, 7),
                                                         rows=(2, 9))),
    "uniform not a power of two": (
        lambda k: prng.uniform(k, (4, 1030), -0.3, 0.3),
        lambda k: prng.uniform_torch(k, (4, 1030), -0.3, 0.3)),
    "normal": (lambda k: prng.normal(k, (1280, 256)),
               lambda k: prng.normal_torch(k, (1280, 256))),
    "bernoulli rows": (lambda k: prng.bernoulli(k, 0.5, (4, 256), (4, 8)),
                       lambda k: prng.bernoulli_torch(k, 0.5, (4, 256),
                                                      (4, 8))),
    "bernoulli ragged": (lambda k: prng.bernoulli(k, 0.7, (5, 3)),
                         lambda k: prng.bernoulli_torch(k, 0.7, (5, 3))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_route(case, dev):
    """Keys, bits, uniforms, normals and masks bit for bit, one launch a
    draw."""
    kernel, plain = CASES[case]
    keys = _keys(dev, 8)
    before = prng.LAUNCHES
    got = kernel(keys)
    torch.cuda.synchronize()
    assert prng.LAUNCHES == before + 1
    want = plain(keys)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_bucket_weights_match_plain_route(dev, monkeypatch):
    """One wav2vlad bucket's NetVLAD weights (fold_in, split, four
    normals: six launches) against the same call through the plain
    draws on the card."""
    ordinals = torch.arange(1000, 1008, device=dev)
    before = prng.LAUNCHES
    got = netvlad.batched_per_utterance_params(0, ordinals, 80, 16, 256)
    assert prng.LAUNCHES == before + 6
    for name in ("fold_in", "split", "normal"):
        monkeypatch.setattr(prng, name, getattr(prng, f"{name}_torch"))
    want = netvlad.batched_per_utterance_params(0, ordinals, 80, 16, 256)
    assert prng.LAUNCHES == before + 6
    for k in want:
        assert torch.equal(got[k], want[k])


def test_draws_capture_in_a_cuda_graph(dev):
    """A split and a dropout mask captured in a CUDA graph: each replay
    advances the key in place and draws what the eager route draws."""
    key = prng.prng_key(5, dev)
    eager_key, eager = key.clone(), []
    for _ in range(3):
        nxt, sub = prng.split2(eager_key)
        eager_key = nxt.clone()
        eager.append(prng.bernoulli(sub, 0.5, (8, 256)))
    prng.split2(key), prng.bernoulli(key, 0.5, (8, 256))   # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        nxt, sub = prng.split2(key)
        key.copy_(nxt)
        mask = prng.bernoulli(sub, 0.5, (8, 256))
    for want in eager:
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(mask, want)
