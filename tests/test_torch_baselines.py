"""The port's sklearn baselines (``eval/traditional.py``, ``cli baselines``)
against the JAX package's: every model of both tracks on the same npz
features, the printed summaries equal (sklearn runs on the host in both,
on the same augmented folds)."""

import json

import numpy as np
import pytest

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu.data import folds as jfolds
from icassp2022_depression_tpu.eval import traditional as jtraditional
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch.eval import traditional as ttraditional

pytest.importorskip("sklearn")

#: EATD's size: 30 depressed and 132 other speakers, so every regression
#: fold's test split is full (10 + 44)
N_DEP, N_NON = 30, 132


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Audio (256-d) and text (32-d) npz features of 162 speakers whose
    features carry their label."""
    root = tmp_path_factory.mktemp("baselines")
    rng = np.random.default_rng(0)
    sds = np.concatenate([rng.uniform(53, 75, N_DEP),
                          rng.uniform(25, 52.9, N_NON)])[
        rng.permutation(N_DEP + N_NON)].astype(np.float32)
    clf = (sds >= 53).astype(np.int64)
    for sub, dim, suffix in (("AudioWhole", 256, "256"),
                             ("TextWhole", 32, "avg")):
        d = root / "Features" / sub
        d.mkdir(parents=True)
        x = (rng.standard_normal((len(sds), 3, 1, dim))
             + 0.4 * clf[:, None, None, None]).astype(np.float32)
        if sub == "TextWhole":
            x = x[:, :, 0]
        for track, y in (("clf", clf), ("reg", sds)):
            np.savez(d / f"whole_samples_{track}_{suffix}.npz", x)
            np.savez(d / f"whole_labels_{track}_{suffix}.npz", y)
    return root


@pytest.mark.parametrize("task,model", [
    ("audio_clf", "rf"), ("text_clf", "dt"), ("audio_clf", "svm"),
    ("text_clf", "lr"), ("audio_reg", "svr"), ("text_reg", "dt"),
    ("text_reg", "rf"), ("audio_reg", "ada")])
def test_cli_baselines_match_jax(root, task, model, capsys):
    argv = ["baselines", "--task", task, "--root", str(root), "--model",
            model, "--seed", "2"]
    assert (jcli.main(argv) or 0) == 0
    assert tcli.main(argv) == 0
    want, got = [json.loads(ln)
                 for ln in capsys.readouterr().out.strip().splitlines()]
    assert got == want
    keys = ({"precision", "recall", "f1", "accuracy"} if task.endswith("clf")
            else {"mae", "rmse"})
    assert set(got) == keys and all(np.isfinite(v) for v in got.values())


def test_library_per_fold_results_and_unknown_models():
    """The library calls' per-fold results equal the JAX package's (a
    small set with reg test splits cut to fit), and unknown model names
    raise."""
    rng = np.random.default_rng(1)
    y = (np.arange(30) % 3 == 0).astype(np.int64)
    x = (rng.standard_normal((30, 3, 8)) + y[:, None, None]).astype(
        np.float32)
    tf_idx = jfolds.generate_clf_folds(y, 3, seed=0)
    got = ttraditional.classify(x, y, tf_idx, model="lr")
    want = jtraditional.classify(x, y, tf_idx, model="lr")
    assert got == want and len(got[0]) == 3
    scores = (np.where(y == 1, 60.0, 40.0)
              + rng.normal(0, 3, len(y))).astype(np.float32)
    dep, non = jfolds.generate_reg_shuffles(scores, seed=0)
    kw = dict(model="dt", test_dep=2, test_non=4)
    assert ttraditional.regress(x, scores, dep, non, **kw) == \
        jtraditional.regress(x, scores, dep, non, **kw)
    with pytest.raises(ValueError, match="unknown classifier"):
        ttraditional.classify(x, y, tf_idx, model="knn")
    with pytest.raises(ValueError, match="unknown regressor"):
        ttraditional.regress(x, scores, dep, non, model="svm")
