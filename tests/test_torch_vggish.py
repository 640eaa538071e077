"""The port's VGGish embedder against the JAX package's: the host frontend
and the mel matrix bitwise, the seeded stand-in bitwise at full width, the
full-width conv stack (1e-5 of the largest magnitude), the postprocessor's
uint8 values exactly, a bundle written by the JAX package's
``checkpoints.save``, ``cli extract-audio --embedder vggish``, a
``train --audio-dim 128`` run and ``Predictor`` / ``cli predict
--audio-embedder vggish``, each through both packages on the same inputs.

The full-width weights (50.3 M floats in the first FC alone) are drawn
once per module on each side."""

import json

import jax
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.frontend import audio as jaudio
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import vggish as jvggish
from icassp2022_depression_tpu.serving.predictors import Predictor as JPredictor
from icassp2022_depression_tpu.train import checkpoints as jcheckpoints
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.frontend import audio as taudio
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models import vggish as tvggish
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.serving.predictors import Predictor
from icassp2022_depression_tpu_torch.train import checkpoints as tcheckpoints

#: float32 network outputs: within this fraction of the largest magnitude
REL = 1e-5
SEED = 3
NPZ = [f"whole_{kind}_{track}_128.npz" for kind in ("samples", "labels")
       for track in ("reg", "clf")]


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's draw) at SEED, full width."""
    return (_tree_np(jvggish.init(jax.random.PRNGKey(SEED))),
            tvggish.init(prng.prng_key(SEED)))


@pytest.fixture(scope="module")
def pca():
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    # scaled so that the stand-in's small embeddings spread over the bytes
    return (300.0 * q).astype(np.float32), \
        (rng.standard_normal(128) * 1e-3).astype(np.float32)


@pytest.fixture(scope="module")
def bundle(weights, pca, tmp_path_factory):
    """The seeded weights as ``scripts/convert_vggish.py`` writes a bundle:
    through the JAX package's ``checkpoints.save``, with a ``pca``
    subtree."""
    path = tmp_path_factory.mktemp("vggish") / "vggish_seeded"
    return jcheckpoints.save(path, dict(weights[0], pca={
        "matrix": pca[0], "means": pca[1]}))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    teatd.make_synthetic_corpus(root, n_data=3, n_validation=2,
                                seconds=(0.7, 2.2), seed=5)
    return root


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    tol = REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _waveform(kind: str, n: int = 36000):
    rng = np.random.default_rng(len(kind))
    pcm = np.round(rng.standard_normal(n) * 3000.0)
    return {"int16": pcm.astype(np.int16),
            "pcm_float": pcm.astype(np.float64),
            "normalised": (pcm / 32768.0).astype(np.float32),
            "short": pcm[:15000].astype(np.int16)}[kind]


@pytest.mark.parametrize("kind,sr", [("int16", 16000), ("pcm_float", 16000),
                                     ("normalised", 16000),
                                     ("int16", 22050), ("short", 16000)])
def test_waveform_to_examples_bitwise(kind, sr):
    """int16, integral-valued float PCM (scaled by 1/32768) and normalised
    float audio (passed through), a resampled rate, and a clip shorter
    than one example (no rows)."""
    x = _waveform(kind)
    want = jvggish.waveform_to_examples(x, sr)
    got = tvggish.waveform_to_examples(x, sr)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] == (0 if kind == "short" else
                            (1 if sr == 22050 else 2))
    assert tvggish._is_pcm_scaled(x) == (kind != "normalised")
    np.testing.assert_array_equal(tvggish._vggish_mel_matrix(),
                                  jvggish._vggish_mel_matrix())


def test_init_is_bitwise_the_jax_init(weights):
    want, got = weights
    for group, shapes in (("convs", tvggish._CONV_CHANNELS),
                          ("fcs", tvggish._FC_DIMS)):
        assert len(got[group]) == len(want[group]) == len(shapes)
        for g, w in zip(got[group], want[group]):
            for k in ("w", "b"):
                assert g[k].dtype == torch.float32
                np.testing.assert_array_equal(g[k].numpy(), w[k])
    assert got["fcs"][0]["w"].shape == (12288, 4096)


def test_conv_stack_matches_jax(weights):
    """The full-width network on 3 examples, on the port's NCHW layout
    with the NHWC flatten: within 1e-5 of the largest output."""
    x = np.random.default_rng(0).standard_normal((3, 96, 64)).astype(
        np.float32)
    want = np.asarray(jvggish.apply(weights[0], x))
    model = tvggish.from_params(weights[1], "cpu")
    assert not model.training
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, want)
    assert got.shape == (3, 128) and (got >= 0).all()
    # the JAX tree (numpy, '/'-joined keys) is the same state dict
    flat = {f"{g}/{i}/{k}": v for g in ("convs", "fcs")
            for i, d in enumerate(weights[0][g]) for k, v in d.items()}
    sd = tporting.vggish_state_dict_from_jax(flat)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    _close(tvggish.to_vggish_embedds(model, _waveform("int16"), 16000),
           jvggish.to_vggish_embedds(weights[0], _waveform("int16"), 16000))


def test_postprocessor_uint8_exact(pca, tmp_path):
    emb = np.random.default_rng(1).standard_normal((7, 128)).astype(
        np.float32) * 0.01
    want = jvggish.Postprocessor(*pca)(emb)
    got = tvggish.Postprocessor(*pca)(emb)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 20
    np.savez(tmp_path / "vggish_pca_params.npz", pca_eigen_vectors=pca[0],
             pca_means=pca[1])
    np.testing.assert_array_equal(
        tvggish.load_pca_params(tmp_path / "vggish_pca_params.npz")(emb),
        jvggish.load_pca_params(tmp_path / "vggish_pca_params.npz")(emb))


def test_load_npz_of_a_jax_bundle(weights, pca, bundle, tmp_path):
    """The bundle's network (on the device asked for) holds the JAX
    package's ``load_npz`` params, mapped; its PCA is the postprocessor."""
    model, post = tvggish.load_npz(bundle, "cpu")
    want, want_post = jvggish.load_npz(bundle)
    assert isinstance(model, tvggish.VGGish) and not model.training
    sd = tporting.vggish_state_dict_from_jax(_tree_np(want))
    got_sd = model.state_dict()
    assert set(got_sd) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got_sd[k], v), k
    np.testing.assert_array_equal(post.pca_matrix, want_post.pca_matrix)
    np.testing.assert_array_equal(post.pca_means, want_post.pca_means)
    # no pca subtree: no postprocessor; a wrong file: a clear error
    bare = jcheckpoints.save(tmp_path / "bare", weights[0])
    assert tvggish.load_npz(str(bare)[:-4], "cpu")[1] is None
    np.savez(tmp_path / "other.npz", x=np.zeros(3))
    with pytest.raises(ValueError, match="not a VGGish bundle"):
        tvggish.load_npz(tmp_path / "other.npz", "cpu")


def test_cli_extract_audio_vggish_matches_jax(corpus, bundle, pca, tmp_path,
                                              monkeypatch, capsys):
    """Both CLIs with the bundle auto-loaded (``ICASSP_VGGISH_WEIGHTS``):
    the four ``_128`` npz files, the printed line and the manifest; then
    ``--pca-params`` over the bundle's postprocessor."""
    monkeypatch.setenv("ICASSP_VGGISH_WEIGHTS", str(bundle))
    np.savez(tmp_path / "pca.npz", pca_eigen_vectors=pca[0][::-1].copy(),
             pca_means=pca[1])
    for extra in ([], ["--pca-params", str(tmp_path / "pca.npz")]):
        outs = {}
        for name, cli, dev in (("jax", jcli, []),
                               ("torch", tcli, ["--device", "cpu"])):
            outs[name] = tmp_path / f"{name}{len(extra)}"
            assert (cli.main(["extract-audio", "--root", str(corpus),
                              "--out", str(outs[name]), "--embedder",
                              "vggish"] + extra + dev) or 0) == 0
        cap = capsys.readouterr()
        lines = cap.out.strip().splitlines()
        assert lines[0].replace(str(outs["jax"]), "") == \
            lines[1].replace(str(outs["torch"]), "")
        assert "(5, 3, 1, 128)" in lines[1]
        assert cap.err.count("auto-loaded VGGish bundle") == 2
        assert sorted(p.name for p in outs["torch"].iterdir()) == \
            sorted(NPZ + ["manifest.json"])
        for f in NPZ:
            with np.load(outs["torch"] / f) as g, \
                    np.load(outs["jax"] / f) as w:
                assert g["arr_0"].dtype == w["arr_0"].dtype
                # postprocessed rows are means of uint8 steps: a float32
                # ulp at a rounding boundary moves one step
                np.testing.assert_allclose(g["arr_0"], w["arr_0"], rtol=0,
                                           atol=1.0, err_msg=f)
                assert np.mean(g["arr_0"] != w["arr_0"]) < 0.01, f
        manifest = json.loads((outs["torch"] / "manifest.json").read_text())
        assert manifest["embedder"] == "vggish"
        assert (outs["torch"] / "manifest.json").read_bytes() == \
            (outs["jax"] / "manifest.json").read_bytes()


def test_extract_eatd_vggish_stand_in_and_raw_embeddings(weights, corpus,
                                                         monkeypatch):
    """No bundle: the stand-in at ``seed`` (the module's draw stands in
    for both packages' ``init``); without a postprocessor the mean-pooled
    embeddings within 1e-5 of the largest; utterances shorter than one
    example are zero rows."""
    monkeypatch.setattr(jvggish, "init", lambda key: weights[0])
    monkeypatch.setattr(tvggish, "init", lambda key: weights[1])
    want = jaudio.extract_eatd_vggish(corpus, seed=SEED)
    got = taudio.extract_eatd_vggish(corpus, seed=SEED, device="cpu")
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    empty = np.abs(want[0]).sum(-1) == 0
    assert empty.any() and not empty.all()
    assert (got[0][empty] == 0).all()


@pytest.mark.parametrize("vmap", [False, True])
def test_cli_train_audio_dim_128_matches_jax(tmp_path, monkeypatch, capsys,
                                             vmap):
    """``train --task audio_clf --audio-dim 128`` on ``_128`` npz features,
    serial and ``--vmap-folds``, 2 epochs trained a fold (the recipe's
    ``epochs=3``): both CLIs' per-epoch records within 1e-5
    and the gated checkpoints' input layer 128 wide."""
    root = tmp_path / "root"
    feats_dir = root / "Features" / "AudioWhole"
    feats_dir.mkdir(parents=True)
    rng = np.random.default_rng(6)
    sds = np.concatenate([rng.uniform(55, 70, 9), rng.uniform(30, 50, 21)])
    clf = (sds >= 53).astype(np.int64)
    x = (rng.standard_normal((30, 3, 1, 128))
         + 0.5 * clf[:, None, None, None]).astype(np.float32)
    for track, y in (("clf", clf), ("reg", sds)):
        np.savez(feats_dir / f"whole_samples_{track}_128.npz", x)
        np.savez(feats_dir / f"whole_labels_{track}_128.npz", y)
    for C in (jconfig, tconfig):
        base = C.AUDIO_CLF
        monkeypatch.setattr(C, "AUDIO_CLF", C.replace(
            base, epochs=3, model=C.replace(base.model, hidden_dims=8),
            gate=C.replace(base.gate, f1_floor=-1.0, train_acc_frac=0.0)))
    records = {}
    for name, cli, dev in (("jax", jcli, []),
                           ("torch", tcli, ["--device", "cpu"])):
        model_dir = tmp_path / name
        argv = ["train", "--task", "audio_clf", "--root", str(root),
                "--audio-dim", "128", "--model-dir", str(model_dir)]
        assert (cli.main(argv + dev + (["--vmap-folds"] if vmap else []))
                or 0) == 0
        records[name] = [json.loads(ln) for ln in (
            model_dir / "audio_clf_metrics.jsonl").read_text().splitlines()]
    capsys.readouterr()
    assert len(records["torch"]) == len(records["jax"]) == 3 * 2 + 3
    for g, w in zip(records["torch"], records["jax"]):
        assert g["event"] == w["event"] and g["fold"] == w["fold"]
        for k, v in w.items():
            if isinstance(v, float) and k != "time":
                np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-5,
                                           err_msg=k)
    out = tmp_path / "torch" / "ClassificationWhole" / "Audio"
    ckpt = sorted(out.glob("*.npz"))[0]
    with np.load(ckpt) as z:
        assert z["rnn/0/fwd/w_ih"].shape == (24, 128)
        assert z["ln/w"].shape == (128,)


def _speakers(seed, n):
    rng = np.random.default_rng(seed)
    waves = [[np.round(rng.standard_normal(int(rng.integers(12000, 36000)))
                       * 3000.0).astype(np.int16) for _ in range(3)]
             for _ in range(n)]
    return waves, [[16000] * 3] * n


def test_predictor_vggish_matches_jax(weights, pca, tmp_path):
    """``Predictor(audio_embedder="vggish")`` of both packages on the same
    weights, two speakers: features (postprocessed) and probabilities."""
    jcfg = jconfig.replace(jconfig.AUDIO_CLF.model, embedding_size=128,
                           rnn_backend="pallas")
    tcfg = tconfig.replace(tconfig.AUDIO_CLF.model, embedding_size=128)
    params = _tree_np(jaudio_net.init(jax.random.PRNGKey(8), jcfg))
    post = (jvggish.Postprocessor(*pca), tvggish.Postprocessor(*pca))
    jp = JPredictor(params, "audio_clf", audio_embedder="vggish",
                    vggish_params=weights[0], vggish_postprocessor=post[0],
                    model_cfg=jcfg)
    tp = Predictor(tcheckpoints.load_model(params, "audio", tcfg, "cpu"),
                   "audio_clf", audio_embedder="vggish",
                   vggish_params=weights[1], vggish_postprocessor=post[1],
                   device="cpu")
    waves, srs = _speakers(2, 2)
    want = jp.predict_batch(waves, srs)
    got = tp.predict_batch(waves, srs)
    assert tp.feature_cache.misses == 2
    feats = tp.audio_features(waves, srs)
    assert tp.feature_cache.hits == 2 and feats.shape == (2, 3, 128)
    np.testing.assert_allclose(feats, jp.audio_features(waves, srs),
                               rtol=0, atol=1.0)
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=1e-5)
    assert tp.predict_batch([], []) == []
    assert tp._stack_rows([]).shape == (0, 3, 128)


def test_cli_predict_audio_embedder_vggish_matches_jax(corpus, bundle,
                                                       tmp_path, monkeypatch,
                                                       capsys):
    """``cli predict --audio-embedder vggish`` of both CLIs on a 128-d
    checkpoint, the bundle auto-loaded; ``--audio-embedder vggish`` on a
    text task raises the JAX CLI's message in both."""
    monkeypatch.setenv("ICASSP_VGGISH_WEIGHTS", str(bundle))
    jcfg = jconfig.replace(jconfig.AUDIO_REG.model, embedding_size=128)
    ckpt = jcheckpoints.save(
        tmp_path / "reg128",
        _tree_np(jaudio_net.init(jax.random.PRNGKey(9), jcfg)),
        {"task": "audio_reg"})
    argv = ["predict", "--task", "audio_reg", "--root", str(corpus),
            "--ckpt", str(ckpt), "--speaker", "ValidationData/1",
            "--audio-embedder", "vggish"]
    assert (jcli.main(argv) or 0) == 0
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    want, got = json.loads(lines[0]), json.loads(lines[1])
    assert set(got) == set(want) == {"sds_score", "speaker", "true_sds"}
    assert got["speaker"] == want["speaker"]
    np.testing.assert_allclose(got["sds_score"], want["sds_score"], rtol=0,
                               atol=1e-4)
    bad = ["predict", "--task", "text_clf", "--root", str(corpus), "--ckpt",
           str(ckpt), "--speaker", "Data/1", "--audio-embedder", "vggish"]
    for cli, dev in ((jcli, []), (tcli, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="audio_\\* tasks only"):
            cli.main(bad + dev)
