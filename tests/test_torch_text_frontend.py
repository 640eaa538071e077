"""The port's text frontend and the text / fusion serving paths against the
JAX package: segmentation, the embedder's resolution and provenance ids,
``cli extract-text`` (npz files within 1e-5, ``extraction_meta.json``
byte-identical), ``Predictor`` and ``cli predict`` for ``text_clf`` and
``fuse_clf`` on one checkpoint and the same transcripts (probabilities
within 1e-5, labels equal), and the port's ``train --corpus`` /
``pipeline --corpus`` on a tiny corpus end to end.  Also: no entry point
falls back to the CPU without being asked.

The converted bundle is written by the JAX package's ``save_npz`` at the
zhs widths that the models see (512-d token streams, 1024-d sentence
vectors) and a small cell (C = 16), so the full-width text and fusion
models run on it.  Segmentation is pinned to ``fallback`` where the
result is compared, as on the card, which has no jieba."""

import json

import jax
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.frontend import text as jtext
from icassp2022_depression_tpu.models import char_cnn as jchar_cnn
from icassp2022_depression_tpu.models import elmo as jelmo
from icassp2022_depression_tpu.models import elmo_pretrained as jpre
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu.serving.predictors import Predictor as JPredictor
from icassp2022_depression_tpu.train import checkpoints as jckpt
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.frontend import text as ttext
from icassp2022_depression_tpu_torch.models import elmo as telmo
from icassp2022_depression_tpu_torch.serving import predictors as tpred

ATOL = 1e-5
TEXTS = ["我 最近 很 难过 睡不着", "I feel ok 今天 还 可以", "  有点累  ",
         "谢谢你们"]
SMALL_FE = dict(n_fft=256, hop_length=64, n_mels=16, netvlad_clusters=4,
                netvlad_output_dim=32)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A JAX-written bundle: char-CNN and biLM at the zhs stream widths
    (P = 512) with a 16-cell biLM, seeded, clips engaged."""
    chars = sorted(set("".join(TEXTS) + "我最近很难过睡不着感觉还不错开心"
                       "你好可以有点累谢们今天"))
    lex = {tok: i for i, tok in enumerate(
        ["<pad>", "<oov>", "<bos>", "<eos>", "<bow>", "<eow>"] + chars)}
    ccfg = jchar_cnn.CharCnnConfig(n_chars=len(lex), char_dim=8,
                                   filters=((1, 8), (2, 8), (3, 16)),
                                   n_highway=1, output_dim=512, max_chars=10)
    lcfg = jelmo.ElmoLstmpConfig(vocab_size=1, input_dim=512, cell_size=16,
                                 proj_size=512, layers=2)
    enc = jelmo.init_lstmp_encoder(jax.random.PRNGKey(1), lcfg)
    enc = {"layers": jax.tree_util.tree_map(lambda a: a * 2.0,
                                            enc["layers"])}
    pe = jpre.PretrainedElmo(ccfg, lcfg,
                             jchar_cnn.init(jax.random.PRNGKey(0), ccfg),
                             enc, lex, None)
    path = tmp_path_factory.mktemp("bundle") / "elmo_small.npz"
    jpre.save_npz(path, pe)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    teatd.make_synthetic_corpus(root, n_data=6, n_validation=3,
                                seconds=0.6, seed=2)
    return root


@pytest.mark.parametrize("segmenter", ["fallback", "auto", "jieba"])
def test_tokenize_matches_jax(segmenter):
    for text in TEXTS:
        assert ttext.tokenize(text, segmenter) == \
            jtext.tokenize(text, segmenter=segmenter)
    with pytest.raises(ValueError, match="unknown segmenter"):
        ttext.get_segmenter("nosuch")


def test_make_embedder_ids_and_vectors_match_jax(bundle):
    """The resolution order and the provenance ids, and each resolved
    embedder's vectors: a bundle, the stand-in and the LSTMP stand-in
    drawn from a seed, explicit parameters."""
    sents = [ttext.tokenize(t, "fallback") for t in TEXTS]
    small = dict(vocab_size=64, embed_dim=8, hidden=8, output_dim=16)
    lstmp = dict(vocab_size=64, input_dim=8, cell_size=16, proj_size=8)
    cases = [
        (dict(elmo_weights=str(bundle)), dict(elmo_weights=str(bundle))),
        (dict(elmo_weights=None, seed=3, cfg=telmo.ElmoConfig(**small)),
         dict(elmo_weights=None, seed=3, cfg=jelmo.ElmoConfig(**small))),
        (dict(elmo_weights="", seed=4, cfg=telmo.ElmoLstmpConfig(**lstmp)),
         dict(elmo_weights="", seed=4, cfg=jelmo.ElmoLstmpConfig(**lstmp))),
    ]
    for tkw, jkw in cases:
        tfn, tdim, tid = ttext.make_embedder(with_id=True, device="cpu",
                                             **tkw)
        jfn, jdim, jid = jtext.make_embedder(with_id=True, **jkw)
        assert (tid, tdim) == (jid, jdim)
        np.testing.assert_allclose(tfn(sents).numpy(), np.asarray(jfn(sents)),
                                   rtol=0, atol=ATOL, err_msg=tid)
    params = jelmo.init(jax.random.PRNGKey(2), jelmo.ElmoConfig(**small))
    from icassp2022_depression_tpu_torch.models import porting

    jfn, _ = jtext.make_embedder(params, jelmo.ElmoConfig(**small))
    tfn, _, tid = ttext.make_embedder(porting.elmo_tree_from_jax(params),
                                      telmo.ElmoConfig(**small), with_id=True,
                                      device="cpu")
    assert tid == "explicit-params"
    np.testing.assert_allclose(tfn(sents).numpy(), np.asarray(jfn(sents)),
                               rtol=0, atol=ATOL)


def test_auto_weights_find_the_cached_bundle_as_jax_does(bundle, tmp_path,
                                                        monkeypatch):
    """``elmo_weights="auto"`` with ``ICASSP_ELMO_WEIGHTS`` unset and the
    bundle cached at ``~/.cache/icassp2022_tpu/elmo_zhs.npz`` (written by
    the port's ``save_npz``): both packages resolve it, with the same id
    and the same vectors."""
    from icassp2022_depression_tpu_torch.models import elmo_pretrained as tpre

    cached = tmp_path / ".cache" / "icassp2022_tpu" / "elmo_zhs.npz"
    cached.parent.mkdir(parents=True)
    tpre.save_npz(cached, tpre.load_npz(bundle, "cpu"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("ICASSP_ELMO_WEIGHTS", raising=False)
    assert tpre.default_weights_path() == jpre.default_weights_path() \
        == cached
    sents = [ttext.tokenize(t, "fallback") for t in TEXTS]
    tfn, tdim, tid = ttext.make_embedder(with_id=True, device="cpu")
    jfn, jdim, jid = jtext.make_embedder(with_id=True)
    assert (tid, tdim) == (jid, jdim)
    assert tid == f"elmo_bundle:elmo_zhs.npz:{cached.stat().st_size}"
    np.testing.assert_allclose(tfn(sents).numpy(), np.asarray(jfn(sents)),
                               rtol=0, atol=ATOL)


def _extract_both(corpus, tmp_path, capsys, extra):
    jout, tout = tmp_path / "jax", tmp_path / "port"
    argv = ["extract-text", "--root", str(corpus), "--segmenter",
            "fallback"] + extra
    assert jcli.main(argv + ["--out", str(jout)]) in (0, None)
    assert tcli.main(argv + ["--out", str(tout), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"text features (9, 3, 1024) -> {tout}"
    return jout, tout


@pytest.mark.parametrize("embedder", ["bundle", "standin"])
def test_cli_extract_text_matches_jax_cli(embedder, bundle, corpus, tmp_path,
                                          capsys):
    """The four npz files within 1e-5 (labels equal) and the provenance
    sidecar byte-identical: with ``--elmo-weights <bundle>`` and with the
    seeded stand-in (``--elmo-weights ''``)."""
    extra = (["--elmo-weights", str(bundle)] if embedder == "bundle"
             else ["--elmo-weights", "", "--seed", "5"])
    jout, tout = _extract_both(corpus, tmp_path, capsys, extra)
    for track in ("clf", "reg"):
        for kind in ("samples", "labels"):
            name = f"whole_{kind}_{track}_avg.npz"
            got = np.load(tout / name)["arr_0"]
            want = np.load(jout / name)["arr_0"]
            assert got.shape == want.shape and got.dtype == want.dtype, name
            if kind == "samples":
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tout / "extraction_meta.json").read_bytes() == \
        (jout / "extraction_meta.json").read_bytes()


def _text_fusion_ckpt(tmp_path, task, full: bool):
    """A seeded JAX checkpoint of ``task`` (full preset widths, or small
    ones) and the two packages' model configs."""
    if task.startswith("text"):
        jcfg, tcfg = jconfig.TEXT_CLF.model, tconfig.TEXT_CLF.model
        if not full:
            jcfg = jconfig.replace(jcfg, hidden_dims=8)
            tcfg = tconfig.replace(tcfg, hidden_dims=8)
        params = jtext_net.init(jax.random.PRNGKey(6), jcfg)
    else:
        jcfg, tcfg = jconfig.FUSE_CLF, tconfig.FUSE_CLF
        if not full:
            kw = dict(audio_embed_size=32, audio_hidden_dims=8,
                      text_hidden_dims=8)
            jcfg, tcfg = jconfig.replace(jcfg, **kw), tconfig.replace(tcfg,
                                                                      **kw)
        params = jfusion.init(jax.random.PRNGKey(6), jcfg)
    ckpt = jckpt.save(tmp_path / task, params,
                      {"task": task, "text_segmenter": "fallback"})
    return ckpt, jcfg, tcfg


def _waves(seed, n):
    rng = np.random.default_rng(seed)
    return ([[np.round(rng.standard_normal(int(rng.integers(2000, 6000)))
                       * 3000.0) for _ in range(3)] for _ in range(n)],
            [[16000] * 3] * n)


@pytest.mark.parametrize("task", ["text_clf", "fuse_clf"])
def test_predictor_matches_jax(task, bundle, tmp_path):
    """The same checkpoint and transcripts through both ``Predictor``s
    (the bundle's embedder, the segmenter adopted from the sidecar)."""
    ckpt, jcfg, tcfg = _text_fusion_ckpt(tmp_path, task, full=False)
    jkw, tkw = dict(elmo_weights=str(bundle)), dict(elmo_weights=str(bundle))
    if task == "fuse_clf":
        jkw["frontend_cfg"] = jconfig.FrontendConfig(**SMALL_FE)
        tkw["frontend_cfg"] = tconfig.FrontendConfig(**SMALL_FE)
    jp = JPredictor.from_checkpoint(ckpt, task, model_cfg=jcfg, **jkw)
    tp = tpred.Predictor.from_checkpoint(ckpt, task, model_cfg=tcfg,
                                         device="cpu", **tkw)
    assert tp.segmenter == jp.segmenter == "fallback"
    assert tp.embedder_id == jp.embedder_id
    texts = [TEXTS[:3], TEXTS[1:], [TEXTS[0], "", TEXTS[3]]]
    waves, srs = _waves(0, 3) if task == "fuse_clf" else (None, None)
    got = tp.predict_batch(waves, srs, texts)
    want = jp.predict_batch(waves, srs, texts)
    for g, w in zip(got, want):
        assert g["label"] == w["label"] and g["depressed"] == w["depressed"]
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tp.text_features(texts),
                               jp.text_features(texts), rtol=0, atol=ATOL)
    # the speakers come back from the feature cache, alone or in a batch
    hits = tp.feature_cache.hits
    alone = tp.predict_speaker(None if waves is None else waves[1],
                               None if srs is None else srs[1], texts[1])
    assert tp.feature_cache.hits > hits
    np.testing.assert_allclose(alone["probs"], got[1]["probs"], rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="3 transcripts"):
        tp.predict_batch(waves, srs, None)


def test_cli_predict_fuse_and_text_match_jax_cli(bundle, corpus, tmp_path,
                                                 capsys, monkeypatch):
    """Full-width ``fuse_clf`` and ``text_clf`` checkpoints: both CLIs'
    ``predict`` on one corpus speaker print the same fields and
    probabilities (the bundle through ``ICASSP_ELMO_WEIGHTS``)."""
    monkeypatch.setenv("ICASSP_ELMO_WEIGHTS", str(bundle))
    for task in ("fuse_clf", "text_clf"):
        ckpt, _, _ = _text_fusion_ckpt(tmp_path, task, full=True)
        argv = ["predict", "--task", task, "--ckpt", str(ckpt), "--root",
                str(corpus), "--speaker", "ValidationData/2",
                "--segmenter", "fallback"]
        assert jcli.main(argv) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert tcli.main(argv + ["--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(got) == set(want)
        assert (got["speaker"], got["true_sds"], got["label"],
                got["depressed"]) == (want["speaker"], want["true_sds"],
                                      want["label"], want["depressed"])
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                                   atol=ATOL)


def _small_presets(monkeypatch, epochs=2, hidden=8):
    gates = {"classification": dict(f1_floor=-1.0, train_acc_frac=0.0),
             "regression": dict(mae_ceiling=1e9, train_mae_ceiling=1e9)}
    for name in ("AUDIO_CLF", "TEXT_CLF", "FUSE_CLF_TRAINER"):
        t = getattr(tconfig, name)
        model = (t.model if name.startswith("FUSE")
                 else tconfig.replace(t.model, hidden_dims=hidden))
        monkeypatch.setattr(tconfig, name, tconfig.replace(
            t, epochs=epochs, model=model,
            gate=tconfig.replace(t.gate, **gates[t.track])))
    monkeypatch.setattr(tconfig, "FUSE_CLF", tconfig.replace(
        tconfig.FUSE_CLF, audio_hidden_dims=hidden, text_hidden_dims=hidden))


def test_cli_pipeline_and_train_from_corpus(bundle, corpus, tmp_path,
                                            monkeypatch, capsys):
    """``pipeline --track clf --corpus`` (both modalities extracted, no
    npz) and ``train --task text_clf --corpus`` run end to end; the text
    checkpoints record the bundle's embedder and the segmenter."""
    _small_presets(monkeypatch)
    root = tmp_path / "root"
    assert tcli.main(["pipeline", "--track", "clf", "--root", str(root),
                      "--corpus", str(corpus), "--elmo-weights", str(bundle),
                      "--segmenter", "fallback", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"audio_f1", "text_f1", "fuse_f1"}
    assert all(len(v) == 3 and all(np.isfinite(v)) for v in summary.values())
    assert not (root / "Features").exists()
    ident = f"elmo_bundle:{bundle.name}:{bundle.stat().st_size}"
    for sub in ("Text", "Fuse"):
        metas = [json.loads(p.read_text()) for p in
                 (root / "Model" / "ClassificationWhole" / sub).glob("*.json")]
        assert len(metas) == 3
        assert all(m["text_embedder"] == ident
                   and m["text_segmenter"] == "fallback" for m in metas)
    assert tcli.main(["train", "--task", "text_clf", "--root", str(root),
                      "--corpus", str(corpus), "--elmo-weights", str(bundle),
                      "--segmenter", "fallback", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["fold 1", "fold 2",
                                                  "fold 3"]
    with pytest.raises(SystemExit, match="no speakers found"):
        tcli.main(["train", "--task", "text_reg", "--root", str(root),
                   "--corpus", str(tmp_path / "empty"), "--elmo-weights",
                   str(bundle), "--device", "cpu"])


def test_entry_points_without_a_card_raise(monkeypatch, corpus, tmp_path):
    """No device given and no card: the CLI and ``Predictor`` raise,
    naming ``--device cpu``, instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tpred.default_device()
    ckpt, _, tcfg = _text_fusion_ckpt(tmp_path, "text_clf", full=False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tpred.Predictor.from_checkpoint(ckpt, "text_clf", model_cfg=tcfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["predict", "--task", "audio_clf", "--ckpt", str(ckpt),
                   "--root", str(corpus), "--speaker", "Data/1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttext.make_embedder(elmo_weights=None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttext.extract_eatd(corpus, elmo_weights=None, segmenter="fallback")
    for argv in (["extract-text", "--root", str(corpus)],
                 ["train", "--task", "text_clf", "--root", str(tmp_path),
                  "--corpus", str(corpus)],
                 ["pipeline", "--track", "reg", "--root", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(argv)


@pytest.mark.parametrize("flag,suffix", [(["--elmo-stateful"], ":stateful"),
                                         (["--elmo-tp", "2"], "")])
def test_cli_extract_text_unported_modes_name_their_items(flag, suffix,
                                                          bundle, corpus,
                                                          tmp_path):
    """Both modes are ported: ``--elmo-stateful`` (the stateful mode, held
    against JAX in test_torch_elmo_stateful.py) writes the features under
    the ``:stateful`` id; ``--elmo-tp 2`` (2 Gloo ranks on the CPU, rank 0
    writes; held against JAX in test_torch_elmo_tp.py) the serial
    features (1e-5) under the serial id, and names ``elmo_tp: 2``."""
    argv = ["extract-text", "--root", str(corpus), "--out", str(tmp_path),
            "--elmo-weights", str(bundle), "--segmenter", "fallback",
            "--device", "cpu", *flag]
    assert tcli.main(argv) == 0
    meta = json.loads((tmp_path / "extraction_meta.json").read_text())
    assert meta["embedder"] == \
        f"elmo_bundle:{bundle.name}:{bundle.stat().st_size}{suffix}"
    with np.load(tmp_path / "whole_samples_clf_avg.npz") as z:
        assert z["arr_0"].shape == (9, 3, 1024)
        got = z["arr_0"]
    if flag[0] == "--elmo-tp":
        assert meta["elmo_tp"] == 2
        want, _, _ = ttext.extract_eatd(corpus, elmo_weights=str(bundle),
                                        segmenter="fallback", device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
