"""The port's checking harness (``eval/checking.py``, ``cli check``) and
acceptance report (``cli parity``) against the JAX package's on the same
features and checkpoints: per-fold metrics equal (floats within 1e-6 on
the CLI lines), predictions within 1e-5, the same markdown tables.  Each
task's three fold checkpoints mix npz files written by the JAX package's
``checkpoints.save`` and by the port's."""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.data import augment as jaugment
from icassp2022_depression_tpu.data import folds as jfolds
from icassp2022_depression_tpu.eval import checking as jchecking
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu.train import checkpoints as jckpt
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.eval import checking as tchecking
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.train import checkpoints as tckpt

ATOL = 1e-5
TASKS = ["audio_clf", "text_clf", "fuse_clf", "audio_reg", "text_reg",
         "fuse_reg"]
CLF_KEYS = ("accuracy", "precision", "recall", "f1")
SMALL_FOLDS = dict(reg_test_dep=3, reg_test_non=8)


def _data(n, da, dt, seed):
    """Seeded features [n, 3, da] / [n, 3, dt], SDS scores and clf labels
    (about a third depressed), the classes a little apart."""
    rng = np.random.default_rng(seed)
    sds = rng.uniform(20, 80, n).round(0).astype(np.float32)
    clf = (sds >= 53).astype(np.int64)
    shift = np.where(clf == 1, 0.3, -0.3)[:, None, None]
    xa = (rng.standard_normal((n, 3, da)) + shift).astype(np.float32)
    xt = (rng.standard_normal((n, 3, dt)) + shift).astype(np.float32)
    return xa, xt, sds, clf


def _jax_model(task, full):
    """(JAX module, JAX config, port config, kind) of ``task``."""
    branch, track = task.split("_")
    if branch == "fuse":
        name = task.upper()
        jcfg, tcfg = getattr(jconfig, name), getattr(tconfig, name)
        if not full:
            small = dict(audio_embed_size=12, text_embed_size=20,
                         audio_hidden_dims=8, text_hidden_dims=8)
            jcfg = jconfig.replace(jcfg, **small)
            tcfg = tconfig.replace(tcfg, **small)
        return jfusion, jcfg, tcfg, "fusion"
    name = f"{branch.upper()}_{track.upper()}"
    jcfg = getattr(jconfig, name).model
    tcfg = getattr(tconfig, name).model
    if not full:
        d, h = (12, 16) if branch == "audio" else (20, 16)
        jcfg = jconfig.replace(jcfg, embedding_size=d, hidden_dims=h)
        tcfg = tconfig.replace(tcfg, embedding_size=d, hidden_dims=h)
    return (jaudio_net if branch == "audio" else jtext_net), jcfg, tcfg, \
        branch


def _ckpts(tmp_path, task, full, seed=0):
    """Three fold checkpoints of seeded JAX params: folds 1 and 3 written
    by the JAX package, fold 2 by the port (the same kind of params loaded
    into the port's model and saved from its state dict).  Returns (paths,
    JAX params per fold)."""
    module, jcfg, tcfg, kind = _jax_model(task, full)
    paths, params = [], []
    for fold in (1, 2, 3):
        p = module.init(jax.random.PRNGKey(100 * seed + fold), jcfg)
        if kind == "fusion":
            # a spread-out head, so that the folds' argmaxes differ
            p["fc_final"]["w"] = p["fc_final"]["w"] * 8.0
        path = tmp_path / f"{task}_{fold}"
        if fold == 2:
            model = tckpt.load_model(jax.tree_util.tree_map(np.asarray, p),
                                     kind, tcfg, "cpu")
            saved = tckpt.save(path, tporting.tree_from_reference(
                model.state_dict(), kind, tcfg))
        else:
            saved = jckpt.save(path, p)
        paths.append(saved)
        params.append(p)
    return paths, params


def _jax_apply(task, jcfg, params, xs):
    if task.startswith("fuse"):
        return np.asarray(jfusion.apply(params, jcfg, jnp.asarray(xs[0]),
                                        jnp.asarray(xs[1]), train=False)[0])
    module = jaudio_net if task.startswith("audio") else jtext_net
    return np.asarray(module.apply(params, jcfg, jnp.asarray(xs[0]),
                                   train=False))


def _assert_fold_equal(got, want):
    assert got["fold"] == want["fold"]
    if "f1" in want:
        for k in CLF_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["confusion_matrix"] == want["confusion_matrix"]
    else:
        for k in ("mae", "rmse"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("task", TASKS)
def test_check_functions_match_jax(task, tmp_path):
    """Each of the six ``check_*`` against the JAX package's at small
    widths: per-fold metrics equal, the mean, and each fold's predictions
    within 1e-5 of the JAX forward on the same test split."""
    xa, xt, sds, clf = _data(48, 12, 20, TASKS.index(task))
    _, jcfg, tcfg, kind = _jax_model(task, full=False)
    paths, params = _ckpts(tmp_path, task, full=False)
    branch, track = task.split("_")
    feats = {"audio": [xa], "text": [xt], "fuse": [xa, xt]}[branch]
    fn = f"check_{task}"
    if track == "clf":
        tf_idx = jfolds.generate_clf_folds(clf, 3, seed=0)
        want = getattr(jchecking, fn)(*feats, clf, tf_idx, paths, jcfg)
        got = getattr(tchecking, fn)(*feats, clf, tf_idx, paths, tcfg,
                                     device="cpu")
        dep, non = np.where(clf == 1)[0], np.where(clf == 0)[0]
        test_xs = [jaugment.augment_classification_fold(
            feats, clf, tr, dep, non)[1][0] for tr in tf_idx]
    else:
        dep, non = jfolds.generate_reg_shuffles(sds, seed=0)
        kw = dict(fold_cfg=jconfig.FoldConfig(**SMALL_FOLDS))
        want = getattr(jchecking, fn)(*feats, sds, dep, non, paths, jcfg,
                                      **kw)
        got = getattr(tchecking, fn)(
            *feats, sds, dep, non, paths, tcfg, device="cpu",
            fold_cfg=tconfig.FoldConfig(**SMALL_FOLDS))
        test_xs = []
        for fold in range(3):
            _, _, te_d, te_n = jfolds.reg_fold_split(dep, non, fold, 3, 8)
            te = np.concatenate([te_d, te_n])
            test_xs.append([f[te] for f in feats])
    (got_rows, got_mean), (want_rows, want_mean) = got, want
    assert len(got_rows) == 3
    for g, w, p, xs in zip(got_rows, want_rows, params, test_xs):
        _assert_fold_equal(g, w)
        np.testing.assert_allclose(g["predictions"],
                                   _jax_apply(task, jcfg, p, xs), rtol=0,
                                   atol=ATOL)
    assert set(got_mean) == set(want_mean)
    for k in want_mean:
        np.testing.assert_allclose(got_mean[k], want_mean[k], rtol=1e-6)


def test_check_takes_models_trees_and_pt_alike(tmp_path):
    """A fold's checkpoint as an in-memory model, a param tree, an npz or
    a reference ``.pt``: the same metrics and predictions."""
    xa, _, _, clf = _data(36, 12, 20, 9)
    _, _, tcfg, kind = _jax_model("audio_clf", full=False)
    paths, params = _ckpts(tmp_path, "audio_clf", full=False, seed=2)
    tf_idx = jfolds.generate_clf_folds(clf, 3, seed=1)
    trees = [jax.tree_util.tree_map(np.asarray, p) for p in params]
    model = tckpt.load_model(trees[0], kind, tcfg, "cpu")
    pt = tmp_path / "fold2.pt"
    tporting.export_reference_pt(trees[1], kind, tcfg, pt)
    base, _ = tchecking.check_audio_clf(xa, clf, tf_idx, paths, tcfg,
                                        device="cpu")
    mixed, _ = tchecking.check_audio_clf(xa, clf, tf_idx,
                                         [model, pt, trees[2]], tcfg,
                                         device="cpu")
    for a, b in zip(base, mixed):
        _assert_fold_equal(a, b)
        np.testing.assert_array_equal(a["predictions"], b["predictions"])


# -- the CLIs at the presets' widths ------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``Features/AudioWhole`` and ``Features/TextWhole`` npz of 162
    seeded speakers (EATD's count, so the regression folds are the
    recipe's 10 + 44)."""
    root = tmp_path_factory.mktemp("features")
    xa, xt, sds, clf = _data(162, 256, 1024, 11)
    audio, text = root / "Features" / "AudioWhole", root / "Features" / \
        "TextWhole"
    audio.mkdir(parents=True)
    text.mkdir(parents=True)
    for track, y in (("clf", clf), ("reg", sds)):
        np.savez(audio / f"whole_samples_{track}_256.npz", xa[:, :, None])
        np.savez(audio / f"whole_labels_{track}_256.npz", y)
        np.savez(text / f"whole_samples_{track}_avg.npz", xt)
        np.savez(text / f"whole_labels_{track}_avg.npz", y)
    return root


def _json_lines(out):
    return [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]


def _assert_close_json(got, want, where):
    """Equal JSON values, floats within 1e-6 (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_close_json(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_json(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert (math.isnan(got) and math.isnan(want)) or \
            abs(got - want) <= 1e-6, (where, got, want)
    else:
        assert got == want, where


@pytest.mark.parametrize("task", TASKS)
def test_cli_check_matches_jax(task, root, tmp_path, capsys):
    """``cli check`` of both packages on the npz features and the same
    three checkpoints: the same JSON lines (floats within 1e-6)."""
    paths, _ = _ckpts(tmp_path, task, full=True, seed=1)
    argv = ["check", "--task", task, "--root", str(root), "--ckpts",
            *map(str, paths)]
    assert jcli.main(argv) == 0
    want = _json_lines(capsys.readouterr().out)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert len(got) == 4 and "mean" in got[-1]
    _assert_close_json(got, want, task)


def _model_tree(tmp_path):
    """A reference ``Model/`` tree of all six tasks: clf names carry the
    fold, reg folds are directories, two saves of one fold (the better
    wins), ``.pt`` and npz mixed."""
    model = tmp_path / "Model"
    (tmp_path / "src").mkdir()
    names = {"audio_clf": ("ClassificationWhole/Audio",
                           "BiLSTM_gru_vlad256_256_0.6{f}_{f}"),
             "text_clf": ("ClassificationWhole/Text", "BiLSTM_128_0.6{f}_{f}"),
             "fuse_clf": ("ClassificationWhole/Fuse", "fuse_0.6{f}_{f}"),
             "audio_reg": ("Regression/Audio{f}", "gru_vlad256_256_7.{f}0"),
             "text_reg": ("Regression/Text{f}", "BiLSTM_128_7.{f}1"),
             "fuse_reg": ("Regression/Fuse{f}", "fuse_7.{f}2")}
    for i, task in enumerate(TASKS):
        paths, params = _ckpts(tmp_path / "src", task, full=True,
                               seed=3 + i)
        sub, stem = names[task]
        _, _, tcfg, kind = _jax_model(task, full=True)
        for f, (path, p) in enumerate(zip(paths, params), start=1):
            d = model / sub.format(f=f)
            d.mkdir(parents=True, exist_ok=True)
            target = str(d / stem.format(f=f))
            if f == 2:   # a reference-layout .pt, written by the port
                tporting.export_reference_pt(
                    jax.tree_util.tree_map(np.asarray, p), kind, tcfg,
                    target + ".pt")
            else:
                Path(target + ".npz").write_bytes(path.read_bytes())
        # a worse save of fold 1, which discovery passes over
        worse = stem.format(f=1).replace("0.61", "0.41").replace(
            "7.10", "9.10").replace("7.11", "9.11").replace("7.12", "9.12")
        (model / sub.format(f=1) / f"{worse}.npz").write_bytes(
            paths[2].read_bytes())
    return model


def test_cli_parity_ckpt_dir_matches_jax(root, tmp_path, capsys):
    """``parity --ckpt-dir`` over a mixed ``.pt`` / npz tree: the same
    discovery line, report (floats within 1e-6), markdown table and
    verdict, and the same exit code."""
    model = _model_tree(tmp_path)
    argv = ["parity", "--root", str(root), "--ckpt-dir", str(model)]
    jrc = jcli.main(argv)
    jout = capsys.readouterr()
    trc = tcli.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr()
    assert trc == jrc
    assert tout.err.strip().splitlines()[-1] == \
        jout.err.strip().splitlines()[-1]
    assert "fuse_reg (fuse_7.12.npz, fuse_7.22.pt, fuse_7.32.npz)" in \
        tout.err
    tlines, jlines = tout.out.strip().splitlines(), \
        jout.out.strip().splitlines()
    _assert_close_json(json.loads(tlines[0]), json.loads(jlines[0]),
                       "report")
    assert set(json.loads(tlines[0])) == {"audio_f1", "text_f1", "fuse_f1",
                                          "audio_mae", "text_mae",
                                          "fuse_mae"}
    assert tlines[1:] == jlines[1:]


@pytest.mark.parametrize("report", [
    {"audio_f1": [0.65, 0.66, 0.61], "fuse_mae": [8.0, 8.1, 7.9]},
    {"audio_f1": [0.2, 0.3, 0.25], "text_mae": [7.9, 8.2, 8.0]},
    {"unrelated": [1.0]}], ids=["pass", "fail", "no_band_metric"])
def test_cli_parity_from_report_matches_jax(report, tmp_path, capsys):
    path = tmp_path / "report.json"
    path.write_text(json.dumps(report))
    argv = ["parity", "--from-report", str(path)]
    outs = []
    for cli in (jcli, tcli):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = str(e)
        outs.append((rc, capsys.readouterr().out))
    assert outs[1] == outs[0]
    if "unrelated" not in report:
        assert outs[1][1].strip().splitlines()[-1] == \
            ("PARITY: PASS" if report.get("fuse_mae") else "PARITY: FAIL")


def test_parity_vmap_folds_raises_naming_its_item(tmp_path):
    """``--vmap-folds`` is ported: it passes to the trainers, so a root
    without features stops at the JAX CLI's feature check, not at the
    flag."""
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit, match="audio features not found"):
            cli.main(["parity", "--root", str(tmp_path), "--vmap-folds",
                      *(["--device", "cpu"] if cli is tcli else [])])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    teatd.make_synthetic_corpus(root, n_data=6, n_validation=3,
                                seconds=0.6, seed=2)
    return root


@pytest.mark.parametrize("task", ["audio_clf", "fuse_clf"])
def test_cli_check_corpus_matches_jax(task, corpus, tmp_path, capsys):
    """``check --corpus``: both packages extract the features anew (the
    audio through wav2vlad, the text through the seeded stand-in encoder)
    and print the same lines."""
    paths, _ = _ckpts(tmp_path, task, full=True, seed=4)
    argv = ["check", "--task", task, "--root", str(tmp_path), "--ckpts",
            *map(str, paths), "--corpus", str(corpus), "--elmo-weights", "",
            "--segmenter", "fallback"]
    assert jcli.main(argv) == 0
    want = _json_lines(capsys.readouterr().out)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert len(got) == 4
    _assert_close_json(got, want, task)


def test_check_without_a_card_raises(root, tmp_path, monkeypatch):
    paths, _ = _ckpts(tmp_path, "audio_clf", full=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["check", "--task", "audio_clf", "--root", str(root),
                   "--ckpts", *map(str, paths)])
    xa, _, _, clf = _data(36, 12, 20, 9)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tchecking.check_audio_clf(
            xa, clf, jfolds.generate_clf_folds(clf, 3, seed=1), paths,
            _jax_model("audio_clf", full=False)[2])
