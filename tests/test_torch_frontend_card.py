"""wav2vlad's length buckets on the card at their small row tiles (1, 2
and 4 rows under 8 answers, a multiple of 8 from 8 up), against the CPU.
Needs an NVIDIA card and ``nvcc`` (the NetVLAD weights' threefry kernel);
skips without them.  On the card (which has no JAX, so without the
suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_frontend_card.py
"""

import numpy as np
import pytest
import torch

from icassp2022_depression_tpu_torch.config import FrontendConfig
from icassp2022_depression_tpu_torch.frontend import audio

pytestmark = pytest.mark.card

#: the serving benchmark's correctness limit on a speaker's features: the
#: widest gap over the reference's largest (``wav2vlad_rel``)
WAV2VLAD_REL = 3e-05
#: answer lengths in samples at 16 kHz, each range inside one bucket (the
#: tail of 1024 included): 2.1-4 s -> 65536, 8.8-12 s -> 262144
BUCKETS = {65536: (33600, 64000), 262144: (140000, 192000)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the threefry kernel is CUDA)")
    return "cuda"


def _answers(blen: int, n: int):
    lo, hi = BUCKETS[blen]
    rng = np.random.default_rng(blen + n)
    return [np.round(rng.standard_normal(int(m)) * 3000.0).astype(np.int16)
            for m in rng.integers(lo, hi + 1, n)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.cpu(), want.cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("blen", sorted(BUCKETS))
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_card_matches_cpu_and_reruns_bitwise(n, blen, dev):
    """``extract_batch`` over ``n`` answers of one bucket: the card's
    features within ``wav2vlad_rel``'s limit of the CPU's, and a rerun on
    the card bitwise the first."""
    waves = _answers(blen, n)
    ordinals = [5 * i + 2 for i in range(n)]
    cfg = FrontendConfig()
    got = audio.extract_batch(waves, [16000] * n, cfg, ordinals=ordinals,
                              device=dev)
    again = audio.extract_batch(waves, [16000] * n, cfg, ordinals=ordinals,
                                device=dev)
    want = audio.extract_batch(waves, [16000] * n, cfg, ordinals=ordinals,
                               device="cpu")
    assert got.device.type == "cuda" and tuple(got.shape) == (n, 256)
    assert torch.equal(got, again)
    assert _rel(got, want) < WAV2VLAD_REL, _rel(got, want)


@pytest.mark.parametrize("blen", sorted(BUCKETS))
def test_an_answer_alone_matches_it_among_seven_others(blen, dev):
    """One answer in a one-row tile and the same answer, same ordinal, in
    an eight-row tile with 7 others: the same features within float32
    rounding (1e-6 of the largest)."""
    waves = _answers(blen, 8)
    ordinals = [11 * i + 1 for i in range(8)]
    cfg = FrontendConfig()
    among = audio.extract_batch(waves, [16000] * 8, cfg, ordinals=ordinals,
                                device=dev)
    for i in (0, 5):
        alone = audio.extract_batch([waves[i]], [16000], cfg,
                                    ordinals=[ordinals[i]], device=dev)
        assert _rel(alone[0], among[i]) < 1e-6, (i, _rel(alone[0], among[i]))
