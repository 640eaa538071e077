"""The MoE LM cell's parts at a tiny size on the CPU: the driver through the
harness (program against the plain reference), the Zipf pool, the
compared numbers and their excusal of near ties, the counts and the
readers."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.counts import moe_lm as lm_counts
from portbench.harness import lm_weights, program, registry
from portbench.harness.cell import Cell, Context
from portbench.harness.trace import Trace
from portbench.tests import tiny

LM = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 3,
      "num_attention_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
      "moe_intermediate_size": 32, "n_routed_experts": 8,
      "num_experts_per_tok": 2, "n_shared_experts": 2,
      "first_k_dense_replace": 1, "routed_scaling_factor": 2.446,
      "norm_topk_prob": True, "rms_norm_eps": 1e-5, "kv_a_norm_eps": 1e-6,
      "rope_theta": 50000.0, "bos_id": 250, "unk_id": 251,
      "lexicon_chars": 40}
LIMITS = {"wav2vlad_rel": 1e-4, "lm_rel": 1e-4, "probs_abs": 1e-4,
          "lm_tie_share": 0.5}


def _cell(limits=LIMITS, seed=2**31 + 9, control=False):
    cfg = tiny.config("fuse_clf")
    cfg.update(LM)
    cfg["fusion"] = dict(cfg["fusion"], text_embed_size=LM["hidden_size"])
    mix = dict(tiny.mix("cohort"), driver="lm_closed_loop",
               family="lm_cohort", zipf_exponent=1.0)
    return Cell(name="tiny.fuse_clf_moonlight.lm_cohort", config=cfg,
                traffic=mix, workload={"chips": 1, "limits": limits,
                                       "tie_margin": 1e-7},
                seed=seed, seconds=0.3, trace=False, device="cpu",
                control=control, started=time.perf_counter())


def test_tiny_cell_runs_correct_against_the_reference():
    run = registry.driver("lm_closed_loop").run(_cell(control=True))
    assert run.correct, [(c.name, c.value) for c in run.compared]
    names = [c.name for c in run.compared]
    assert names == ["wav2vlad_rel", "lm_rel", "probs_abs", "lm_tie_share"]
    assert {c.name for c in run.control} == set(names)
    assert set(run.metrics) == {"speakers_per_s", "setup_s"}
    assert any("speakers in" in n for n in run.notes)


def test_lm_rel_catches_a_perturbed_feature_and_excuses_near_ties():
    loop = registry.driver("lm_closed_loop")
    margin = _cell().workload["tie_margin"]
    rng = np.random.default_rng(0)
    text = rng.normal(size=(4, 3, 64))
    experts = np.array([[0, 1], [1, 3], [2, 5]])       # 3 tokens, 1 layer
    routing = [[(experts, np.full(3, 1.0))] for _ in range(12)]
    chosen = [[experts.copy()] for _ in range(12)]
    want = (np.ones((4, 3, 16)), text, np.full((4, 2), 0.5), routing)
    got = ([np.ones((3, 16))] * 4, [t.copy() for t in text],
           np.full((4, 2), 0.5))
    got[1][2][1, 5] += 1e-3 * np.abs(text[2, 1]).max()
    out = loop.compared(got, want, chosen, margin)
    assert out["lm_rel"] > LIMITS["lm_rel"] and out["lm_tie_share"] == 0.0
    # answer 7 (speaker 2's second) took another expert at a token whose
    # reference margin is within the tie margin: it and its speaker's
    # probabilities are excused
    chosen[7][0][1] = [1, 4]
    routing[7][0][1][1] = margin / 2
    got[2][2] += 1.0
    out = loop.compared(got, want, chosen, margin)
    assert out["lm_rel"] == 0.0 and out["probs_abs"] == 0.0
    assert out["lm_tie_share"] == pytest.approx(1 / 12)
    # at a wider margin the same swap is not excused
    routing[7][0][1][1] = 10 * margin
    out = loop.compared(got, want, chosen, margin)
    assert out["lm_rel"] > LIMITS["lm_rel"] and out["probs_abs"] == 1.0
    assert out["lm_tie_share"] == 0.0


def test_zipf_pool_skews_characters_and_keeps_marks():
    loop = registry.driver("lm_closed_loop")
    chars = [chr(0x4E00 + i) for i in range(200)]
    mix = dict(tiny.mix("cohort"), pool=64, transcript_chars=[20, 120],
               zipf_exponent=1.0)
    pool = loop.ZipfPool(mix, 2**32 + 3, chars)
    text = "".join(t for ts in pool.texts for t in ts)
    counts = np.array([text.count(c) for c in chars])
    assert counts[0] == counts.max() and counts[0] > 5 * counts[100]
    lengths = sorted(len(t) for ts in pool.texts for t in ts)
    assert lengths[0] == 20 and lengths[-1] == 120
    first = pool.speaker(5)[1][0]
    assert pool.speaker(5 + 64)[1][0] != first        # marked
    assert pool.speaker(5 + 64)[1][0][2:] == first[2:]


def test_weights_redraw_per_tensor_and_lexicon_is_distinct():
    a = lm_weights.draw(registry.driver("lm_closed_loop")._shapes(LM), 7,
                        "cpu")
    b = lm_weights.draw_one(7, "layers.2.mlp.experts.down_proj",
                            (8, 64, 32), "cpu")
    assert (a["layers.2.mlp.experts.down_proj"] == b).all()
    assert float(a["layers.1.self_attn.q_proj.weight"].std()) \
        == pytest.approx(0.02, rel=0.1)
    lex = lm_weights.lexicon([chr(0x4E00 + i) for i in range(40)], 7, 250)
    assert len(set(lex.values())) == 40 and max(lex.values()) < 250


def test_counts_and_readers(monkeypatch):
    flops, experts_s = lm_counts.lm_call([10, 3], LM)
    assert flops > 0 and experts_s > 0
    mf, ms = lm_counts.moe_experts(13, LM)
    assert experts_s == pytest.approx(2 * ms)
    trace = Trace((0.0, 1.0), [("moe_experts_gate_up_kernel", (0.1, 0.3)),
                               ("moe_experts_down_kernel", (0.3, 0.4)),
                               ("other_kernel", (0.5, 0.6))],
                  [("lm/embed", (0.05, 0.65)), ("lm/moe", (0.1, 0.4)),
                   ("serve/cache_key", (0.0, 0.02)),
                   ("wav2vlad/bucket65536", (0.02, 0.06)),
                   ("prng/normal", (0.03, 0.04))])
    bucket = SimpleNamespace(
        name="wav2vlad/bucket65536", start_ns=2 * 10**7, end_ns=6 * 10**7,
        counts={"samples": 65536, "padded_samples": 3 * 65536})
    monkeypatch.setattr(program, "ring", lambda lo, hi: [bucket])
    ctx = Context("lm_cohort", {}, trace,
                  {"speakers": 4, "flops": 6.7e12,
                   "bound_s": {"moe_experts": 0.15}})
    readers = registry.metrics()
    got = {n: r.read(ctx) for n, r in readers.items()}
    assert got["moe_experts_roofline.lm_cohort"] == pytest.approx(50.0)
    assert got["mfu.lm_cohort"] == pytest.approx(10.0)
    assert got["lm_host_ms.lm_cohort"] == pytest.approx(150.0)
    assert got["kernels_per_speaker.lm_cohort"] == pytest.approx(0.75)
    assert got["device_idle.lm_cohort"] == pytest.approx(60.0)
    assert got["cache_key_ms.lm_cohort"] == pytest.approx(5.0)
    assert got["wav2vlad_ms.lm_cohort"] == pytest.approx(10.0)
    assert got["threefry_ms.lm_cohort"] == pytest.approx(2.5)
    assert got["wav2vlad_pad_share.lm_cohort"] == pytest.approx(75.0)
    assert got["mfu.cohort"] is None
    other = Context("cohort", {}, trace, ctx.work)
    assert all(readers[n].read(other) is None for n in got
               if n.endswith(".lm_cohort"))
