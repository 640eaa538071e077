"""The port's serving slice against the JAX package: the same npz and the
same waveforms through both ``Predictor``s, and both CLIs' ``predict`` on
one synthetic corpus.  Also: the port imports no JAX."""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.serving.predictors import Predictor as JPredictor
from icassp2022_depression_tpu.train import checkpoints as jcheckpoints
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.serving import predictors as tpredictors
from icassp2022_depression_tpu_torch.serving.predictors import Predictor

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "icassp2022_depression_tpu_torch"
ATOL = 1e-5
SMALL_FE = dict(n_fft=256, hop_length=64, n_mels=16, netvlad_clusters=4,
                netvlad_output_dim=32)
SMALL_NET = dict(embedding_size=32, hidden_dims=16)


def _waves(seed, n_speakers):
    rng = np.random.default_rng(seed)
    waves = [[np.round(rng.standard_normal(int(rng.integers(2000, 9000)))
                       * 3000.0) for _ in range(3)]
             for _ in range(n_speakers)]
    return waves, [[16000] * 3] * n_speakers


def _pair(tmp_path, task):
    """(JAX predictor on the Pallas GRU, port predictor) on one npz."""
    preset = "AUDIO_CLF" if task == "audio_clf" else "AUDIO_REG"
    jcfg = jconfig.replace(getattr(jconfig, preset).model,
                           rnn_backend="pallas", **SMALL_NET)
    tcfg = tconfig.replace(getattr(tconfig, preset).model, **SMALL_NET)
    params = jaudio_net.init(jax.random.PRNGKey(7), jcfg)
    ckpt = jcheckpoints.save(tmp_path / task, params, {"task": task})
    jp = JPredictor.from_checkpoint(
        ckpt, task, model_cfg=jcfg,
        frontend_cfg=jconfig.FrontendConfig(**SMALL_FE))
    tp = Predictor.from_checkpoint(
        ckpt, task, model_cfg=tcfg,
        frontend_cfg=tconfig.FrontendConfig(**SMALL_FE), device="cpu")
    assert tp.meta == {"task": task}
    return jp, tp


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if "probs" in w:
            assert g["label"] == w["label"]
            assert g["depressed"] == w["depressed"]
            np.testing.assert_allclose(g["probs"], w["probs"], rtol=0,
                                       atol=ATOL)
        else:
            np.testing.assert_allclose(g["sds_score"], w["sds_score"],
                                       rtol=0, atol=ATOL)


@pytest.mark.parametrize("task", ["audio_clf", "audio_reg"])
def test_predictor_matches_jax(tmp_path, task):
    jp, tp = _pair(tmp_path, task)
    waves, srs = _waves(0, 3)
    _assert_same(tp.predict_batch(waves, srs), jp.predict_batch(waves, srs))
    bases = [0, 3, 27]
    _assert_same(tp.predict_batch(waves, srs, ordinal_bases=bases),
                 jp.predict_batch(waves, srs, ordinal_bases=bases))
    np.testing.assert_allclose(tp.audio_features(waves, srs, bases),
                               jp.audio_features(waves, srs, bases),
                               rtol=0, atol=ATOL)


def test_predictor_cache_batching_and_empty_request(tmp_path):
    _, tp = _pair(tmp_path, "audio_clf")
    waves, srs = _waves(1, 3)
    batch = tp.predict_batch(waves, srs)
    assert tp.feature_cache.misses == 3 and tp.feature_cache.hits == 0
    # a speaker alone gets what it got inside the batch, from the cache
    alone = tp.predict_speaker(waves[1], srs[1])
    assert tp.feature_cache.hits == 1
    _assert_same([alone], [batch[1]])
    assert tp.predict_batch([], []) == []
    tp.warmup(batch_sizes=(1, 2), utt_seconds=0.3)
    out = tp.predict_features(np.zeros((3, 3, 32), np.float32))
    assert out.shape == (3, 2)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=0, atol=1e-6)


def test_predictor_names_missing_slices(tmp_path):
    # the text and fusion tasks are served since the text-frontend slice
    assert tpredictors.model_config("text_clf") == tconfig.TEXT_CLF.model
    assert tpredictors.model_config("fuse_reg") == tconfig.FUSE_REG
    with pytest.raises(ValueError, match="task must be one of"):
        tpredictors.model_config("video_clf")
    _, tp = _pair(tmp_path, "audio_clf")
    # the VGGish embedder is served since the VGGish slice: its network is
    # resolved at the first request (test_torch_vggish.py); an embedder
    # neither package has is refused
    vp = Predictor(tp.model, "audio_clf", audio_embedder="vggish",
                   device="cpu")
    assert vp.audio_embedder == "vggish" and vp._vggish is None
    assert tuple(vp._stack_rows([]).shape) == (0, 3, 128)
    with pytest.raises(ValueError, match="audio_embedder"):
        Predictor(tp.model, "audio_clf", audio_embedder="wav2vec",
                  device="cpu")
    # reference .pt checkpoints are served since the checking slice
    tporting.export_reference_pt(tp.model, "audio", tp.model.cfg,
                                 tmp_path / "ref.pt")
    x = np.random.default_rng(1).standard_normal(
        (2, 3, tp.model.cfg.embedding_size)).astype(np.float32)
    served = Predictor.from_checkpoint(tmp_path / "ref.pt", "audio_clf",
                                       model_cfg=tp.model.cfg, device="cpu")
    np.testing.assert_array_equal(served.predict_features(audio_feats=x),
                                  tp.predict_features(audio_feats=x))


def test_cli_predict_matches_jax_cli(tmp_path, capsys):
    """Full-width audio_clf: both CLIs on one synthetic corpus print the
    same fields and probabilities (the JAX CLI with its CPU default, the
    scan recurrence)."""
    root = tmp_path / "corpus"
    assert tcli.main(["synth-corpus", "--root", str(root), "--n-data", "3",
                      "--n-validation", "2", "--seconds", "0.6"]) == 0
    capsys.readouterr()
    params = jaudio_net.init(jax.random.PRNGKey(9), jconfig.AUDIO_CLF.model)
    ckpt = jcheckpoints.save(tmp_path / "clf", params)
    argv = ["predict", "--task", "audio_clf", "--ckpt", str(ckpt),
            "--root", str(root), "--speaker", "ValidationData/2"]
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
    assert teatd.corpus_position(root, "ValidationData", 2) == 4
    with pytest.raises(SystemExit, match="not found"):
        tcli.main(["predict", "--task", "audio_clf", "--ckpt", str(ckpt),
                   "--root", str(root), "--speaker", "Data/9"])


def test_port_imports_without_jax():
    """Every module of the port and the scripts that drive it on the card
    (``chip_smoke.py``, ``serve_ab.py``, ``lstmp_variants.py``,
    ``rnn_bwd_tiles.py``) import in a
    fresh interpreter without pulling in jax or the JAX package (whose
    __init__ imports jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import icassp2022_depression_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, lstmp_variants, rnn_bwd_tiles, serve_ab\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'icassp2022_depression_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import\s+(jax|icassp2022_depression_tpu)\b"
        r"|from\s+(jax|icassp2022_depression_tpu)(\.|\s))", re.M)
    sources = sorted(PKG.rglob("*.py")) + [
        REPO / f for f in ("chip_smoke.py", "serve_ab.py", "lstmp_variants.py",
                           "rnn_bwd_tiles.py")]
    assert len(sources) > 15
    for src in sources:
        assert not pattern.search(src.read_text()), src
