"""The port's cross-corpus evaluation (``eval/cross_corpus.py``: EATD audio
models scored on DAIC-WOZ response features) against the JAX package's:
the windows bitwise, the soft-voted classification and the window-mean
regression on the same participants and weights (probabilities and
scores within 1e-5), a participant with no responses, and the batch of
every participant's windows padded to a power of two."""

import jax
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.eval import cross_corpus as jcc
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.eval import cross_corpus as tcc
from icassp2022_depression_tpu_torch.ops import rnn_cuda
from icassp2022_depression_tpu_torch.train import checkpoints as tcheckpoints

SMALL = dict(embedding_size=8, hidden_dims=8)
ATOL = 1e-5


def _participants(seed, n, counts=None):
    rng = np.random.default_rng(seed)
    counts = counts or [int(rng.integers(1, 12)) for _ in range(n)]
    return [rng.standard_normal((c, 1, SMALL["embedding_size"])).astype(
        np.float32) for c in counts]


def _models(preset, seed, backend="auto"):
    jcfg = jconfig.replace(getattr(jconfig, preset).model,
                           rnn_backend=backend, **SMALL)
    tcfg = tconfig.replace(getattr(tconfig, preset).model, **SMALL)
    params = jax.tree_util.tree_map(
        np.asarray, jaudio_net.init(jax.random.PRNGKey(seed), jcfg))
    return params, jcfg, tcfg


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 7])
def test_windows_of_3_bitwise(n):
    r = np.random.default_rng(n).standard_normal((n, 5)).astype(np.float32)
    want = jcc.windows_of_3(r)
    got = tcc.windows_of_3(r)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcc.windows_of_3(r[:, None, :]), got)
    if n:
        np.testing.assert_array_equal(got[-1][-1], r[-1])


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_evaluate_clf_matches_jax(backend):
    """Soft voting over each participant's windows, the participant with
    zero responses predicted 0; the JAX side through its scan and its
    Pallas GRU."""
    params, jcfg, tcfg = _models("AUDIO_CLF", 0, backend)
    feats = _participants(1, 0, [5, 0, 9, 1, 3, 12, 7])
    labels = [0, 1, 1, 0, 1, 0, 1]
    want = jcc.evaluate_clf(params, feats, labels, jcfg)
    got = tcc.evaluate_clf(params, feats, labels, tcfg, device="cpu")
    assert set(got) == set(want)
    assert got["predictions"] == want["predictions"]
    assert got["predictions"][1] == 0
    assert got["confusion_matrix"] == want["confusion_matrix"]
    for k in ("precision", "recall", "f1", "accuracy"):
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    # the windows' probabilities themselves
    counts, jprobs = jcc._all_window_outputs(jcc._apply_jit(jcfg), params,
                                             feats)
    model = tcheckpoints.load_model(params, "audio", tcfg, "cpu")
    tcounts, tprobs = tcc._all_window_outputs(model, feats)
    assert tcounts == counts and tprobs.shape == (sum(counts), 2)
    np.testing.assert_allclose(tprobs, jprobs, rtol=0, atol=ATOL)


def test_evaluate_reg_matches_jax():
    params, jcfg, tcfg = _models("AUDIO_REG", 2)
    feats = _participants(3, 6)
    feats.insert(2, np.zeros((0, 1, SMALL["embedding_size"]), np.float32))
    scores = [3.0, 15.0, 5.0, 20.0, 12.0, 1.0, 9.0]
    want = jcc.evaluate_reg(params, feats, scores, jcfg)
    model = tcheckpoints.load_model(params, "audio", tcfg, "cpu")
    got = tcc.evaluate_reg(model, feats, scores, tcfg, device="cpu")
    assert set(got) == set(want) == {"mae", "rmse", "mae_calibrated",
                                     "rmse_calibrated"}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=ATOL), k
    assert got["mae_calibrated"] <= got["mae"] + 1e-6


def test_no_windows_at_all():
    params, jcfg, tcfg = _models("AUDIO_CLF", 4)
    empty = [np.zeros((0, 1, SMALL["embedding_size"]), np.float32)] * 2
    got = tcc.evaluate_clf(params, empty, [0, 1], tcfg, device="cpu")
    assert got["predictions"] == [0, 0]
    assert got == jcc.evaluate_clf(params, empty, [0, 1], jcfg)


def test_one_batch_padded_to_a_power_of_two(monkeypatch):
    """AVEC2017's dev split's size: 35 participants of 40-120 responses go
    through the model as one batch of next_pow2(windows) rows (1024 here),
    the rows the GRU forward kernel's plan tiles in 32 tiles of 32 rows at
    H = 256."""
    feats = _participants(5, 0, [int(c) for c in np.random.default_rng(6)
                                 .integers(40, 121, 35)])
    total = sum(-(-len(f) // 3) for f in feats)
    assert 512 < total <= 1024
    params, _, tcfg = _models("AUDIO_CLF", 7)
    model = tcheckpoints.load_model(params, "audio", tcfg, "cpu")
    seen = []
    forward = type(model).forward
    monkeypatch.setattr(type(model), "forward",
                        lambda self, x, *a, **k: seen.append(x.shape)
                        or forward(self, x, *a, **k))
    counts, out = tcc._all_window_outputs(model, feats)
    assert seen == [torch.Size((1024, 3, SMALL["embedding_size"]))]
    assert sum(counts) == total and out.shape == (total, 2)
    plan = rnn_cuda.gru_fwd_plan(1024, 256)
    assert (plan["route"], plan["rows"], plan["row_tiles"]) == \
        ("step", 32, 32)
