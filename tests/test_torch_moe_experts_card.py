"""The grouped-expert kernel (``csrc/moe_experts.cu``) on the card: against
its plain version, bitwise on reruns, and the MoE LM's forward free of
host synchronisation.  Needs an NVIDIA card and ``nvcc``; skips without
them.  On the card (which has no JAX, so without the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_moe_experts_card.py
"""

import math

import numpy as np
import pytest
import torch

from icassp2022_depression_tpu_torch.config import MoeLmConfig
from icassp2022_depression_tpu_torch.models import moe_lm
from icassp2022_depression_tpu_torch.ops import moe

pytestmark = pytest.mark.card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the grouped-expert kernel is "
                    "CUDA)")
    return "cuda"


def _inputs(dev, rows, experts, hidden, inter, seed=0):
    """Slots in expert order with uneven counts (a Zipf law over the
    experts, the last expert empty), weights at nn.Linear's scale."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = 1.0 / np.arange(1, experts + 1)
    p[-1] = 0.0
    counts = np.random.default_rng(seed).multinomial(rows, p / p.sum())
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32, device=dev)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (randn(rows, hidden),
            randn(experts, inter, hidden, scale=hidden ** -0.5),
            randn(experts, inter, hidden, scale=hidden ** -0.5),
            randn(experts, hidden, inter, scale=inter ** -0.5),
            torch.rand(rows, generator=gen, device=dev), offsets)


#: (rows, experts, hidden, inter): a small layer, and a cohort call's expert
#: layer at Moonlight-16B-A3B's widths (6 slots of about 6,800 tokens)
SHAPES = {"small": (700, 8, 256, 128),
          "moonlight cohort": (40800, 64, 2048, 1408)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_plain_route(shape, dev):
    args = _inputs(dev, *SHAPES[shape])
    before = moe.LAUNCHES
    got = moe.experts(*args)
    torch.cuda.synchronize()
    assert moe.LAUNCHES == before + 2
    want = moe.experts_torch(*args)
    # float32 sums over the depth in another order than cuBLAS's
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    empty = args[-1][-2:].tolist()
    assert empty[0] == empty[1]          # an expert with no rows


def test_kernel_reruns_bitwise(dev):
    args = _inputs(dev, *SHAPES["moonlight cohort"], seed=1)
    first = moe.experts(*args)
    assert all(torch.equal(first, moe.experts(*args)) for _ in range(3))


def test_lm_forward_makes_no_host_synchronisation(dev):
    cfg = MoeLmConfig(vocab_size=512, hidden_size=256, num_hidden_layers=3,
                      num_attention_heads=4, kv_lora_rank=64,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32, intermediate_size=512,
                      moe_intermediate_size=128, n_routed_experts=8,
                      num_experts_per_tok=2, n_shared_experts=2,
                      bos_id=500, unk_id=501)
    gen = torch.Generator(device=dev).manual_seed(2)
    weights = {name: torch.randn(shape, generator=gen, device=dev)
               / math.sqrt(shape[-1])
               for name, shape in moe_lm.param_shapes(cfg).items()}
    chars = [chr(0x4E00 + i) for i in range(400)]
    embed = moe_lm.MoeLmEmbedder(
        {"weights": weights, "lexicon": {c: i for i, c in enumerate(chars)}},
        cfg, dev)
    sentences = [list(chars[i:i + n]) for i, n in enumerate([3, 40, 17, 1])]
    embed(sentences)                     # first use: build, handles
    torch.cuda.synchronize()
    before = moe.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = embed(sentences)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert moe.LAUNCHES == before + 2 * (cfg.num_hidden_layers - 1)
    assert out.shape == (4, cfg.hidden_size)
    assert torch.isfinite(out).all()
