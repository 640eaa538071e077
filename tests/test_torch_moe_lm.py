"""The MoE LM text embedder (``models/moe_lm.py``, ``ops/moe.py``) against
the plain reference (``portbench/reference/moonlight.py``) on the CPU, at
a tiny size with seeded random weights: the latent attention block, the
router, an expert layer, the pooled features through ``make_embedder``, a
fusion ``Predictor`` end to end, and faults the comparison must catch."""

import dataclasses
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.frontend import text as text_fe
from icassp2022_depression_tpu_torch.models import moe_lm
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import moe, prng
from icassp2022_depression_tpu_torch.serving.predictors import Predictor
from portbench.reference import moonlight as ref

CFG = C.MoeLmConfig(
    vocab_size=256, hidden_size=64, num_hidden_layers=4,
    num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
    moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
    n_shared_experts=2, first_k_dense_replace=1, bos_id=250, unk_id=251)
REF_CFG = {**dataclasses.asdict(CFG), "norm_topk_prob": True}
CHARS = [chr(0x4E00 + i) for i in range(200)]
TEXTS = ["".join(CHARS[(7 * i + 3 * j) % 200] for j in range(n))
         for i, n in enumerate([5, 17, 1, 30, 9, 12])] + ["ab 你好 12"]
#: float32 on the CPU, products summed in another order than the
#: reference's: a few ulps of features near 1, far under any fault
REL = 2e-5


def _weights(seed=3):
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in moe_lm.param_shapes(CFG).items():
        if name.endswith("norm.weight") or name.endswith("layernorm.weight"):
            t = 1 + 0.2 * (torch.rand(shape, generator=gen) - 0.5)
        elif name.endswith("e_score_correction_bias"):
            t = 0.1 * (torch.rand(shape, generator=gen) - 0.5)
        elif name == "embed_tokens.weight":
            t = torch.randn(shape, generator=gen)
        else:
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[-1])
        out[name] = t
    return out


@pytest.fixture(scope="module")
def params():
    return {"weights": _weights(),
            "lexicon": {c: i for i, c in enumerate(CHARS)}}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _hidden(seed=5, t=11):
    return torch.randn(t, CFG.hidden_size,
                       generator=torch.Generator().manual_seed(seed))


def test_published_widths_hold_15_62_billion_parameters():
    shapes = moe_lm.param_shapes(C.MoeLmConfig())
    assert sum(math.prod(s) for s in shapes.values()) == 15_624_565_888
    assert shapes["layers.26.mlp.experts.down_proj"] == (64, 2048, 1408)


def test_mla_block_matches_reference(params):
    w, x, p = params["weights"], _hidden(), "layers.2."
    batch = moe_lm._Batch([list(range(x.shape[0]))], "cpu")
    cos, sin = moe_lm.rope_tables(batch.pos, CFG)
    got = moe_lm.attention(x, w, p, CFG, cos, sin, batch)
    want = ref._attention(x, w, p, REF_CFG, cos, sin, "fp32")
    assert _rel(got, want) < REL


def test_router_bias_normalisation_and_scale(params):
    w, x = params["weights"], _hidden(t=40)
    gate = w["layers.1.mlp.gate.weight"]
    bias = torch.zeros(CFG.n_routed_experts)
    bias[5] = 10.0                      # selected for every token
    idx, weights = moe.route(x, gate, bias, 2, 2.446)
    assert (idx == 5).any(dim=1).all()
    torch.testing.assert_close(weights.sum(dim=1), torch.full((40,), 2.446))
    scores = torch.sigmoid(x @ gate.T)
    sel = scores.gather(1, idx)
    torch.testing.assert_close(weights, 2.446 * sel / sel.sum(1, True))


def test_dispatch_sorts_by_expert_with_offsets_on_the_device():
    idx = torch.tensor([[3, 0], [0, 2], [3, 1], [2, 0]])
    order, offsets = moe.dispatch(idx, 5)
    assert idx.reshape(-1)[order].tolist() == [0, 0, 0, 1, 2, 2, 3, 3]
    assert order.tolist() == [1, 2, 7, 5, 3, 6, 0, 4]     # stable
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [0, 3, 4, 6, 8, 8]


def test_expert_layer_matches_reference(params):
    w, x, p = params["weights"], _hidden(t=23), "layers.3."
    got = moe_lm.expert_block(x, w, p, CFG)
    want, _, margins = ref._experts(x, w, p, REF_CFG, "fp32")
    assert margins.min() > 1e-6
    assert _rel(got, want) < REL


def _program(params, texts, cfg=CFG):
    embed, dim = text_fe.make_embedder(params, cfg, device="cpu")
    assert dim == cfg.hidden_size
    return embed([text_fe.tokenize(t, "fallback") for t in texts])


def test_pooled_features_through_make_embedder(params):
    got = _program(params, TEXTS)
    want, routing = ref.embed(TEXTS, params["weights"], params["lexicon"],
                              REF_CFG)
    assert got.shape == (len(TEXTS), CFG.hidden_size)
    # no near tie: both sides choose the same experts everywhere
    assert min(m.min() for r in routing for _, m in r) > 1e-6
    assert _rel(got, want) < REL


def test_predictor_serves_fusion_with_the_lm_embedder(params):
    fcfg = C.replace(C.FUSE_CLF, text_embed_size=CFG.hidden_size,
                     audio_embed_size=16, audio_hidden_dims=8,
                     text_hidden_dims=4)
    front = C.FrontendConfig(n_fft=256, hop_length=64, n_mels=8,
                             netvlad_clusters=4, netvlad_output_dim=16)
    model = FusionNet(fcfg, prng.prng_key(11, "cpu"), device="cpu")
    predictor = Predictor(model, "fuse_clf", frontend_cfg=front,
                          device="cpu", elmo_params=params, elmo_cfg=CFG,
                          segmenter="fallback")
    assert predictor.embedder_id == "explicit-params"
    rng = np.random.default_rng(0)
    waves = [[rng.integers(-3000, 3000, 4000).astype(np.int16)
              for _ in range(3)] for _ in range(2)]
    texts = [TEXTS[:3], TEXTS[3:6]]
    out = predictor.predict_batch(waves, [[16000] * 3] * 2, texts)
    ref_text, _ = ref.embed(TEXTS[:6], params["weights"],
                            params["lexicon"], REF_CFG)
    stored = predictor.text_features(texts)
    assert _rel(stored.reshape(6, -1), ref_text) < REL
    want = predictor.predict_features(predictor.audio_features(
        waves, [[16000] * 3] * 2), ref_text.reshape(2, 3, -1))
    got = np.array([r["probs"] for r in out])
    assert np.max(np.abs(got - want)) < 1e-6


def _top_k_minus_one(monkeypatch):
    return dataclasses.replace(CFG, num_experts_per_tok=1)


def _no_shared_experts(monkeypatch):
    mlp = moe_lm.mlp
    shared = CFG.moe_intermediate_size * CFG.n_shared_experts
    monkeypatch.setattr(moe_lm, "mlp", lambda x, g, u, d:
                        mlp(x, g, u, d) * (g.shape[0] != shared))
    return CFG


def _rope_interleaved(monkeypatch):
    monkeypatch.setattr(moe_lm, "deinterleave", lambda x: x)
    return CFG


def _unnormalised(monkeypatch):
    def route(x, g, b, k, s):
        scores = torch.sigmoid(x @ g.T)
        idx = torch.topk(scores + b, k, dim=-1).indices
        return idx, scores.gather(1, idx) * s

    monkeypatch.setattr(moe, "route", route)
    return CFG


def _padding_routed(monkeypatch):
    """Every answer's padding rows go through the experts too (and are
    dropped after): the features hold, the routed rows do not."""
    block = moe_lm.expert_block

    def padded(x, w, p, cfg):
        extra = x.new_ones((17, x.shape[1]))
        return block(torch.cat([x, extra]), w, p, cfg)[:x.shape[0]]

    monkeypatch.setattr(moe_lm, "expert_block", padded)
    return CFG


FAULTS = {"top-k less one": _top_k_minus_one,
          "shared experts left out": _no_shared_experts,
          "rope without the de-interleave": _rope_interleaved,
          "routing weights unnormalised": _unnormalised,
          "padding rows routed": _padding_routed}


def _check(params, cfg):
    """The cell's comparison at this size: the features' widest relative
    gap, and the rows routed against the real tokens times k."""
    routed = []
    experts = moe.experts

    def counting(xs, *rest):
        routed.append(xs.shape[0])
        return experts(xs, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "experts", counting)
        got = _program(params, TEXTS, cfg)
    want, _ = ref.embed(TEXTS, params["weights"], params["lexicon"], REF_CFG)
    tokens = sum(len(ref.token_ids(t, params["lexicon"], REF_CFG))
                 for t in TEXTS)
    layers = CFG.num_hidden_layers - CFG.first_k_dense_replace
    rows_ok = routed == [tokens * CFG.num_experts_per_tok] * layers
    return _rel(got, want) < REL and rows_ok


def test_the_check_passes_the_program(params):
    assert _check(params, CFG)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_fail_the_check(fault, params, monkeypatch):
    cfg = FAULTS[fault](monkeypatch)
    assert not _check(params, cfg)


def test_elmo_paths_never_import_the_lm():
    code = ("import sys\n"
            "from icassp2022_depression_tpu_torch.serving import predictors\n"
            "from icassp2022_depression_tpu_torch.frontend import text\n"
            "assert not [m for m in sys.modules if 'moe' in m], "
            "[m for m in sys.modules if 'moe' in m]\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_lm_embedder_takes_explicit_params_only(params):
    with pytest.raises(ValueError, match="explicit params"):
        text_fe.make_embedder(None, CFG, device="cpu")
    weights = dict(params["weights"])
    del weights["norm.weight"]
    with pytest.raises(ValueError, match="lack 1 tensors"):
        text_fe.make_embedder({"weights": weights, "lexicon": {}}, CFG,
                              device="cpu")
