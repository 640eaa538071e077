"""The port's text and fusion trainers against the JAX trainers on the same
numpy inputs and initial weights (carried across by the porting bridge),
and ``cli train --task text_*`` / ``cli pipeline`` end to end on tiny
synthetic npz feature roots in the JAX package's layout.

As in ``tests/test_torch_train.py``: dropout 0 (the two packages draw
their masks from different generators), float32 trajectories within
``TRAJ_TOL`` = 1e-5."""

import json

import jax
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.data import eatd as jeatd
from icassp2022_depression_tpu.data import folds as jfolds
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu.train import checkpoints as jckpt
from icassp2022_depression_tpu.train import trainers as jtrainers
from icassp2022_depression_tpu_torch import cli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.train import checkpoints as tckpt
from icassp2022_depression_tpu_torch.train import trainers as ttrainers

TRAJ_TOL = 1e-5     # float32 trajectories, reductions in another order
DA, DT, H = 24, 32, 16
CLF_GATE = dict(f1_floor=-1.0, train_acc_frac=0.0)
REG_GATE = dict(mae_ceiling=1e9, train_mae_ceiling=1e9)
REG_FOLDS = dict(reg_test_dep=3, reg_test_non=6, reg_augment_first_n=4)
META = {"text_embedder": "test-embedder", "text_segmenter": "fallback"}


def _data(seed, n=30):
    """SDS targets and their labels, and audio/text features that carry
    the label."""
    rng = np.random.default_rng(seed)
    sds = rng.integers(25, 75, n).astype(np.float32)
    _, clf = jeatd.eatd_targets(sds)
    xa = (rng.standard_normal((n, 3, DA)) + 0.5 * clf[:, None, None])
    xt = (rng.standard_normal((n, 3, DT)) - 0.5 * clf[:, None, None])
    return sds, clf, xa.astype(np.float32), xt.astype(np.float32)


def _branch_cfgs(preset, epochs, gate, dim):
    """The preset at a small width, dropout 0, few epochs, the recipe's
    learning rate (see ``test_torch_train._trainer_cfgs``)."""
    jt, tt = getattr(jconfig, preset), getattr(tconfig, preset)
    model = dict(embedding_size=dim, hidden_dims=H, dropout=0.0)
    return tuple(
        mod.replace(t, epochs=epochs, model=mod.replace(t.model, **model),
                    gate=mod.replace(t.gate, **gate))
        for mod, t in ((jconfig, jt), (tconfig, tt)))


def _fusion_cfgs(track, epochs, gate):
    fuse, trainer = {"clf": ("FUSE_CLF", "FUSE_CLF_TRAINER"),
                     "reg": ("FUSE_REG", "FUSE_REG_TRAINER")}[track]
    kw = dict(audio_embed_size=DA, text_embed_size=DT, audio_hidden_dims=H,
              text_hidden_dims=H, dropout=0.0)
    out = []
    for mod in (jconfig, tconfig):
        t = getattr(mod, trainer)
        out.append((mod.replace(getattr(mod, fuse), **kw),
                    mod.replace(t, epochs=epochs,
                                gate=mod.replace(t.gate, **gate))))
    return out


def _assert_results(got, want, to_sd):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["fold"] == w["fold"]
        assert set(w["logs"]) <= set(g["logs"])
        for k, v in w["logs"].items():
            np.testing.assert_allclose(g["logs"][k], np.asarray(v), rtol=0,
                                       atol=TRAJ_TOL, err_msg=k)
        for k, v in w["best"].items():
            if k != "params":
                np.testing.assert_allclose(g["best"][k], v, rtol=0,
                                           atol=TRAJ_TOL, err_msg=k)
        want_sd = to_sd(jax.device_get(w["best"]["params"]))
        assert set(want_sd) == set(g["best"]["params"])
        for k, v in want_sd.items():
            np.testing.assert_allclose(g["best"]["params"][k].numpy(),
                                       v.numpy(), rtol=0, atol=TRAJ_TOL,
                                       err_msg=k)


def _meta(path):
    return tckpt.load_meta(path)


# -- the text branch trainers -------------------------------------------------


def test_train_text_clf_matches_jax_trainer(tmp_path):
    sds, clf, _, xt = _data(1)
    train_idx = jfolds.generate_clf_folds(clf, 3, seed=1)
    jcfg, tcfg = _branch_cfgs("TEXT_CLF", 4, CLF_GATE, DT)
    jparams = [jtext_net.init(jax.random.PRNGKey(20 + f), jcfg.model)
               for f in range(3)]
    to_sd = lambda p: tporting.text_net_state_dict_from_jax(  # noqa: E731
        p, tcfg.model)
    jdatas = jtrainers._clf_fold_datas([xt], clf, train_idx, jcfg.batch_size)
    want = jtrainers._run_folds(jtext_net, jcfg, jdatas, 0,
                                init_params_per_fold=jparams)
    got = ttrainers.train_text_clf(
        xt, clf, train_idx, tcfg=tcfg, out_dir=tmp_path,
        init_params_per_fold=[to_sd(p) for p in jparams], meta_extras=META,
        device="cpu")
    _assert_results(got, want, to_sd)
    assert all(g["best"]["epoch"] >= 0 for g in got)
    for r in got:
        name = tckpt.text_clf_name(H, r["best"]["f1"], r["fold"])
        meta = _meta(tmp_path / f"{name}.npz")
        assert meta["task"] == "text_clf" and meta["fold"] == r["fold"]
        assert meta["text_embedder"] == "test-embedder"
        assert meta["text_segmenter"] == "fallback"
        idx = np.load(tmp_path / "train_idxs_{:.2f}_{}.npy".format(
            r["best"]["f1"], r["fold"]))
        assert list(idx) == meta["train_idx"]
        back = jckpt.load(tmp_path / f"{name}.npz", like=jparams[0])
        for k, v in to_sd(back).items():
            assert torch.equal(v, r["best"]["params"][k])


def test_train_text_reg_matches_jax_trainer(tmp_path):
    sds, _, _, xt = _data(2)
    dep, non = jfolds.generate_reg_shuffles(sds, seed=2)
    sds = sds / 50.0            # losses near 1, where 1e-5 is resolvable
    jcfg, tcfg = _branch_cfgs("TEXT_REG", 4, REG_GATE, DT)
    jparams = [jtext_net.init(jax.random.PRNGKey(30 + f), jcfg.model)
               for f in range(3)]
    to_sd = lambda p: tporting.text_net_state_dict_from_jax(  # noqa: E731
        p, tcfg.model)
    jdatas = jtrainers._reg_fold_datas([xt], sds, dep, non, jcfg.batch_size,
                                       jconfig.FoldConfig(**REG_FOLDS))
    want = jtrainers._run_folds(jtext_net, jcfg, jdatas, 0,
                                init_params_per_fold=jparams)
    got = ttrainers.train_text_reg(
        xt, sds, dep, non, tcfg=tcfg, out_dir=tmp_path,
        fold_cfg=tconfig.FoldConfig(**REG_FOLDS),
        init_params_per_fold=[to_sd(p) for p in jparams], meta_extras=META,
        device="cpu")
    _assert_results(got, want, to_sd)
    for r in got:
        name = tckpt.text_reg_name(H, r["best"]["mae"])
        meta = _meta(tmp_path / f"Text{r['fold']}" / f"{name}.npz")
        assert meta["task"] == "text_reg"
        assert meta["dep_idxs"] == [int(i) for i in dep]
        assert meta["text_embedder"] == "test-embedder"


# -- the fusion trainers ------------------------------------------------------


def _branches(seed, track):
    """Random JAX branch params per fold and their port state dicts."""
    audio, text = {"clf": ("AUDIO_CLF", "TEXT_CLF"),
                   "reg": ("AUDIO_REG", "TEXT_REG")}[track]
    ja, ta = _branch_cfgs(audio, 2, {}, DA)
    jt, tt = _branch_cfgs(text, 2, {}, DT)
    jb, tb = [], []
    for f in range(3):
        tp = jtext_net.init(jax.random.PRNGKey(seed + 2 * f), jt.model)
        ap = jaudio_net.init(jax.random.PRNGKey(seed + 2 * f + 1), ja.model)
        jb.append((tp, ap))
        tb.append((tporting.text_net_state_dict_from_jax(tp, tt.model),
                   tporting.audio_net_state_dict_from_jax(ap, ta.model)))
    return jb, tb


def test_train_fuse_clf_matches_jax_trainer_and_carries_folds(tmp_path):
    """Fold k+1 continues fold k's fc_final and Adam moments, as the JAX
    trainer's carry: all three folds' trajectories agree, and fold 2 run
    on its own (fresh model and optimizer) does not."""
    sds, clf, xa, xt = _data(3)
    train_idx = jfolds.generate_clf_folds(clf, 3, seed=3)
    (jf, jt), (tf, tt) = _fusion_cfgs("clf", 4, CLF_GATE)
    jb, tb = _branches(40, "clf")
    want = jtrainers.train_fuse_clf(xa, xt, clf, train_idx, jb, fcfg=jf,
                                    tcfg=jt, seed=0)
    init = tporting.fusion_state_dict_from_jax(
        jfusion.init(jax.random.PRNGKey(0), jf), tf)
    to_sd = lambda p: tporting.fusion_state_dict_from_jax(  # noqa: E731
        p, tf)
    got = ttrainers.train_fuse_clf(xa, xt, clf, train_idx, tb, fcfg=tf,
                                   tcfg=tt, out_dir=tmp_path,
                                   init_params_per_fold=[init],
                                   meta_extras=META, device="cpu")
    _assert_results(got, want, to_sd)
    alone = ttrainers.train_fuse_clf(xa, xt, clf, train_idx[1:2], tb[1:2],
                                     fcfg=tf, tcfg=tt,
                                     init_params_per_fold=[init],
                                     device="cpu")
    assert np.abs(alone[0]["step_losses"]
                  - got[1]["step_losses"]).max() > 100 * TRAJ_TOL
    for r in got:
        name = tckpt.fuse_clf_name(r["best"]["f1"], r["fold"])
        meta = _meta(tmp_path / f"{name}.npz")
        assert meta["task"] == "fuse_clf"
        assert meta["text_embedder"] == "test-embedder"
        assert (tmp_path / "train_idxs_{:.2f}_{}.npy".format(
            r["best"]["f1"], r["fold"])).is_file()
        back = jckpt.load(tmp_path / f"{name}.npz",
                          like=jfusion.init(jax.random.PRNGKey(0), jf))
        for k, v in to_sd(back).items():
            assert torch.equal(v, r["best"]["params"][k])


def test_train_fuse_reg_matches_jax_trainer(tmp_path):
    sds, _, xa, xt = _data(4)
    dep, non = jfolds.generate_reg_shuffles(sds, seed=4)
    sds = sds / 50.0
    (jf, jt), (tf, tt) = _fusion_cfgs("reg", 4, REG_GATE)
    jb, tb = _branches(50, "reg")
    want = jtrainers.train_fuse_reg(xa, xt, sds, dep, non, jb, fcfg=jf,
                                    tcfg=jt, seed=0,
                                    fold_cfg=jconfig.FoldConfig(**REG_FOLDS))
    init = [tporting.fusion_state_dict_from_jax(
        jfusion.init(jax.random.fold_in(jax.random.PRNGKey(0), f), jf), tf)
        for f in range(1, 4)]
    got = ttrainers.train_fuse_reg(xa, xt, sds, dep, non, tb, fcfg=tf,
                                   tcfg=tt, out_dir=tmp_path,
                                   fold_cfg=tconfig.FoldConfig(**REG_FOLDS),
                                   init_params_per_fold=init,
                                   meta_extras=META, device="cpu")
    _assert_results(got, want,
                    lambda p: tporting.fusion_state_dict_from_jax(p, tf))
    for r in got:
        name = tckpt.fuse_reg_name(r["best"]["mae"])
        meta = _meta(tmp_path / f"Fuse{r['fold']}" / f"{name}.npz")
        assert meta["task"] == "fuse_reg" and meta["fold"] == r["fold"]
        assert meta["non_idxs"] == [int(i) for i in non]


# -- the CLI ------------------------------------------------------------------


def _npz_root(root, n=24, seed=5):
    """Features/{AudioWhole,TextWhole} in the JAX package's npz layout,
    with an extract-text provenance file."""
    rng = np.random.default_rng(seed)
    sds = rng.integers(25, 75, n).astype(np.float32)
    sds_t, clf = jeatd.eatd_targets(sds)
    audio = root / "Features" / "AudioWhole"
    text = root / "Features" / "TextWhole"
    audio.mkdir(parents=True)
    text.mkdir(parents=True)
    xa = rng.standard_normal((n, 3, 1, 256)) + 0.3 * clf[:, None, None, None]
    xt = rng.standard_normal((n, 3, 1024)) - 0.3 * clf[:, None, None]
    for track, y in (("clf", clf), ("reg", sds_t)):
        np.savez(audio / f"whole_samples_{track}_256.npz", xa.astype(
            np.float32))
        np.savez(audio / f"whole_labels_{track}_256.npz", y)
        np.savez(text / f"whole_samples_{track}_avg.npz", xt.astype(
            np.float32))
        np.savez(text / f"whole_labels_{track}_avg.npz", y)
    (text / "extraction_meta.json").write_text(json.dumps(
        {"embedder": "test-embedder", "segmenter": "fallback"}))


def _small_presets(monkeypatch, epochs=3, hidden=8, gates=True):
    for name in ("AUDIO_CLF", "TEXT_CLF", "FUSE_CLF_TRAINER", "AUDIO_REG",
                 "TEXT_REG", "FUSE_REG_TRAINER"):
        t = getattr(tconfig, name)
        gate = (CLF_GATE if t.track == "classification" else REG_GATE) \
            if gates else {}
        model = (t.model if name.startswith("FUSE")
                 else tconfig.replace(t.model, hidden_dims=hidden))
        monkeypatch.setattr(tconfig, name, tconfig.replace(
            t, epochs=epochs, model=model,
            gate=tconfig.replace(t.gate, **gate)))
    for name in ("FUSE_CLF", "FUSE_REG"):
        monkeypatch.setattr(tconfig, name, tconfig.replace(
            getattr(tconfig, name), audio_hidden_dims=hidden,
            text_hidden_dims=hidden))


def _records(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_cli_pipeline_clf_writes_every_artifact(tmp_path, monkeypatch,
                                                capsys):
    root = tmp_path / "root"
    _npz_root(root)
    _small_presets(monkeypatch)
    assert cli.main(["pipeline", "--track", "clf", "--root", str(root),
                     "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"audio_f1", "text_f1", "fuse_f1"}
    assert all(len(v) == 3 and all(np.isfinite(v)) for v in summary.values())
    records = _records(root / "Model" / "pipeline_clf_metrics.jsonl")
    for task in ("audio_clf", "text_clf", "fuse_clf"):
        epochs = [r for r in records
                  if r["event"] == "epoch" and r["trainer"] == task]
        bests = [r for r in records
                 if r["event"] == "fold_best" and r["trainer"] == task]
        assert len(epochs) == 3 * 2 and len(bests) == 3, task
        assert [round(b["f1"], 4) for b in bests] == \
            summary[task.replace("_clf", "_f1")]
    out = root / "Model" / "ClassificationWhole"
    files = {"Audio": set(), "Text": set(), "Fuse": set()}
    for r in records:
        if r["event"] != "fold_best":
            continue
        assert r["epoch"] >= 0
        sub, name = {
            "audio_clf": ("Audio", tckpt.audio_clf_name(256, 8, r["f1"],
                                                        r["fold"])),
            "text_clf": ("Text", tckpt.text_clf_name(8, r["f1"],
                                                     r["fold"])),
            "fuse_clf": ("Fuse", tckpt.fuse_clf_name(r["f1"], r["fold"])),
        }[r["trainer"]]
        files[sub] |= {f"{name}.npz", f"{name}.json",
                       "train_idxs_{:.2f}_{}.npy".format(r["f1"], r["fold"])}
        meta = _meta(out / sub / f"{name}.npz")
        assert meta["fold"] == r["fold"] and meta["task"] == r["trainer"]
        if sub != "Audio":
            assert meta["text_embedder"] == "test-embedder"
            assert meta["text_segmenter"] == "fallback"
    for sub, names in files.items():
        assert {p.name for p in (out / sub).iterdir()} == names, sub
    # the fusion checkpoints load in the JAX package, in its layout
    jf = jconfig.replace(jconfig.FUSE_CLF, audio_hidden_dims=8,
                         text_hidden_dims=8)
    template = jfusion.init(jax.random.PRNGKey(0), jf)
    for npz in (out / "Fuse").glob("*.npz"):
        jckpt.load(npz, like=template)


def test_cli_pipeline_reg_and_ungated_warning(tmp_path, monkeypatch, capsys):
    """The reg track end to end (folds cut to the tiny root), and the
    warning when a branch gate never fired."""
    root = tmp_path / "root"
    _npz_root(root, n=30)
    _small_presets(monkeypatch, epochs=2, gates=False)
    fold_cfg = tconfig.FoldConfig(**REG_FOLDS)
    for name in ("train_audio_reg", "train_text_reg", "train_fuse_reg"):
        fn = getattr(ttrainers, name)
        monkeypatch.setattr(ttrainers, name,
                            lambda *a, _fn=fn, **k: _fn(*a, **k,
                                                        fold_cfg=fold_cfg))
    assert cli.main(["pipeline", "--track", "reg", "--root", str(root),
                     "--device", "cpu", "--lr", "3e-4"]) == 0
    out, err = capsys.readouterr()
    summary = json.loads(out.strip().splitlines()[-1])
    assert set(summary) == {"audio_mae", "text_mae", "fuse_mae"}
    assert "WARNING: audio_reg gate never fired" in err
    records = _records(root / "Model" / "pipeline_reg_metrics.jsonl")
    assert {r["trainer"] for r in records} == {"audio_reg", "text_reg",
                                               "fuse_reg"}


def test_cli_train_text_reads_npz_features(tmp_path, monkeypatch, capsys):
    root = tmp_path / "root"
    _npz_root(root)
    _small_presets(monkeypatch)
    assert cli.main(["train", "--task", "text_clf", "--root", str(root),
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["fold 1", "fold 2",
                                                  "fold 3"]
    records = _records(root / "Model" / "text_clf_metrics.jsonl")
    assert len([r for r in records if r["event"] == "epoch"]) == 3 * 2
    out = root / "Model" / "ClassificationWhole" / "Text"
    assert len(list(out.glob("BiLSTM_8_*.npz"))) == 3


@pytest.mark.parametrize("argv,match", [
    # the text-frontend options are ported: they pass to the next check
    (["--corpus", "x", "--device", "cpu"], "no speakers found"),
    (["--segmenter", "jieba", "--device", "cpu"], "audio features not found"),
    (["--elmo-weights", "w.npz", "--device", "cpu"],
     "audio features not found"),
    # --vmap-folds is ported: it passes to the feature check
    (["--vmap-folds", "--device", "cpu"], "audio features not found"),
    # --fold-parallel is ported: its 3 CPU ranks pass to the feature check
    (["--fold-parallel", "--device", "cpu"], "audio features not found"),
])
def test_cli_pipeline_unported_options_name_their_slice(argv, match,
                                                        tmp_path):
    with pytest.raises(SystemExit, match=match):
        cli.main(["pipeline", "--track", "clf", "--root", str(tmp_path),
                  *argv])


def test_cli_pipeline_needs_both_feature_dirs(tmp_path):
    (tmp_path / "Features" / "AudioWhole").mkdir(parents=True)
    with pytest.raises(SystemExit, match="text features not found"):
        cli.main(["pipeline", "--track", "clf", "--root", str(tmp_path),
                  "--device", "cpu"])
