"""The plain references agree with the port's plain path at tiny sizes on
the CPU.  (This test imports both; the references import nothing of the
port.)"""

import numpy as np
import pytest
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.frontend import audio as audio_fe
from icassp2022_depression_tpu_torch.models import char_cnn, elmo
from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import prng
from portbench.harness import weights
from portbench.reference import elmo as ref_elmo
from portbench.reference import models as ref_models
from portbench.reference import threefry
from portbench.reference import wav2vlad as ref_w2v
from portbench.tests import tiny


@pytest.mark.parametrize("seed,ordinal", [(0, 0), (0, 2), (2**31 + 9, 7)])
def test_threefry_draws(seed, ordinal):
    """Keys and uniform bits equal; normals within an ulp or two (NumPy's
    and torch's log1p and sqrt may round differently)."""
    key = prng.fold_in(prng.prng_key(seed), ordinal)
    ref_key = threefry.fold_in(threefry.prng_key(seed), ordinal)
    assert key.tolist() == ref_key.astype(np.int64).tolist()
    k1, _ = prng.split(key, 2)
    r1, _ = threefry.split(ref_key, 2)
    assert k1.tolist() == r1.astype(np.int64).tolist()
    got = prng.normal(k1, (64, 5)).numpy()
    want = threefry.normal(r1, (64, 5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(prng.uniform(k1, (33,), -0.3, 0.7).numpy(),
                          threefry.uniform(r1, (33,), -0.3, 0.7))


def test_wav2vlad_matches_the_port():
    rng = np.random.default_rng(3)
    waves = [rng.integers(-3000, 3000, n, dtype=np.int16)
             for n in (1601, 2400, 4000)]
    fe = tiny.FRONTEND
    got = audio_fe.extract_batch(waves, [16000] * 3, C.FrontendConfig(**fe),
                                 ordinals=[0, 1, 2], device="cpu").numpy()
    want = ref_w2v.wav2vlad(waves, [0, 1, 2], fe, "cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * abs(want).max())


def _tiny_elmo():
    cfg = tiny.config("fuse_clf")
    cc, lm = cfg["char_cnn"], cfg["bilm"]
    chars = [chr(0x4E00 + i) for i in range(cc["n_chars"] - 6)]
    lex = ref_elmo.lexicons_from(chars, chars[:cfg["word_vocab"] - 4])
    gen = torch.Generator().manual_seed(5)
    flat = weights.draw(weights.elmo_specs(cc, lm, cc["n_chars"],
                                           len(lex["words"])), gen, "cpu")
    tree, layers = weights.elmo_trees(flat, cc, lm)
    pe = ep.PretrainedElmo(
        char_cnn.CharCnnConfig(
            n_chars=cc["n_chars"], char_dim=cc["char_dim"],
            filters=tuple(tuple(f) for f in cc["filters"]),
            n_highway=cc["n_highway"], output_dim=cc["output_dim"],
            word_vocab=len(lex["words"]), word_dim=cc["word_dim"],
            max_chars=cc["max_chars"]),
        elmo.ElmoLstmpConfig(vocab_size=1, input_dim=cc["output_dim"],
                             cell_size=lm["cell_size"],
                             proj_size=lm["proj_size"], layers=lm["layers"]),
        tree, {"layers": layers}, lex["chars"], lex["words"])
    return cfg, chars, lex, {"cc": tree, "layers": layers}, pe


def test_elmo_matches_the_port():
    cfg, chars, lex, w, pe = _tiny_elmo()
    rng = np.random.default_rng(1)
    texts = ["".join(rng.choice(chars, n)) for n in (3, 9, 1, 14)]
    texts.append("ab12 " + chars[0] + " x")     # a latin run, an OOV word
    got = pe.embed_sentences([ep_tokens(t) for t in texts]).numpy()
    want = ref_elmo.embed(texts, w, lex, {**cfg["char_cnn"], **cfg["bilm"]},
                          "cpu", block=2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * abs(want).max())


def ep_tokens(text):
    from icassp2022_depression_tpu_torch.frontend import text as text_fe

    return text_fe.tokenize(text, segmenter="fallback")


@pytest.mark.parametrize("task", ["audio_clf", "fuse_clf"])
def test_model_forwards_match_the_port(task):
    cfg = tiny.config(task)
    if task == "fuse_clf":
        model = FusionNet(C.FusionConfig(**cfg["fusion"]), None)
    else:
        model = AudioNet(C.RNNConfig(**cfg["model"]), None)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = weights.draw(weights.state_specs(shapes),
                      torch.Generator().manual_seed(2), "cpu")
    model.load_state_dict(sd)
    model.eval()
    g = torch.Generator().manual_seed(4)
    xa = torch.randn(5, 3, 16, generator=g)
    with torch.no_grad():
        if task == "fuse_clf":
            xt = torch.randn(5, 3, 16, generator=g)
            tf, af = model.pretrained_feature(xa, xt)
            got = model(torch.cat([tf, af], dim=-1))
            want = ref_models.fuse_clf(sd, xa, xt, cfg["fusion"])
        else:
            got = model(xa)
            want = ref_models.audio_clf(sd, xa, cfg["model"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
