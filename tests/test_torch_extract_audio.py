"""The port's audio feature writer (``frontend/audio.py::extract_eatd``,
``cli extract-audio``) against the JAX package's on the same corpus: npz
files within 1e-5, ``manifest.json`` byte-identical, and the incremental
per-speaker cache of either package reused by the other."""

import json

import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.frontend import audio as jaudio
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.frontend import audio as taudio
from icassp2022_depression_tpu_torch.models import vggish as tvggish

ATOL = 1e-5
SMALL = dict(n_fft=256, hop_length=64, n_mels=16, netvlad_clusters=4,
             netvlad_output_dim=32)
NPZ = [f"whole_{kind}_{track}_256.npz" for kind in ("samples", "labels")
       for track in ("reg", "clf")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    teatd.make_synthetic_corpus(root, n_data=4, n_validation=2,
                                seconds=(0.2, 0.5), seed=3)
    return root


def _npz(path):
    with np.load(path) as data:
        return data["arr_0"]


def test_cli_extract_audio_matches_jax(corpus, tmp_path, capsys):
    """Both CLIs on one corpus: the four npz files (features within 1e-5,
    labels equal), the same printed line and byte-identical manifests."""
    outs = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        outs[name] = tmp_path / name
        assert (cli.main(["extract-audio", "--root", str(corpus), "--out",
                          str(outs[name])] + extra) or 0) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].replace(str(outs["jax"]), "") == \
        lines[1].replace(str(outs["torch"]), "")
    assert "(6 speakers," in lines[1]
    for f in NPZ:
        got, want = _npz(outs["torch"] / f), _npz(outs["jax"] / f)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f)
    assert _npz(outs["torch"] / NPZ[0]).shape == (6, 3, 1, 256)
    assert (outs["torch"] / "manifest.json").read_bytes() == \
        (outs["jax"] / "manifest.json").read_bytes()
    assert not (outs["torch"] / "speaker_cache.npz").exists()


def test_extract_eatd_equals_the_fused_pass(corpus):
    """Without a cache, every speaker goes through the fused pass's
    ordinals, so the writer's features are the fused pass's, bitwise."""
    cfg = tconfig.FrontendConfig(**SMALL)
    feats, sds, clf, manifest = taudio.extract_eatd(corpus, cfg,
                                                    device="cpu")
    fused, fsds, fclf = taudio.extract_eatd_device(corpus, cfg,
                                                   device="cpu")
    np.testing.assert_array_equal(feats[:, :, 0], fused.numpy())
    np.testing.assert_array_equal(sds, fsds)
    np.testing.assert_array_equal(clf, fclf)
    assert [m["status"] for m in manifest] == ["ok"] * 6


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_written_by_one_package_is_reused_by_the_other(corpus,
                                                             tmp_path,
                                                             writer):
    """An incremental pass of one package writes ``speaker_cache.npz``; the
    other package's incremental rerun takes every speaker from it (all
    ``cached``, the same features and manifest)."""
    jcfg = jconfig.FrontendConfig(**SMALL)
    tcfg = tconfig.FrontendConfig(**SMALL)

    def run(package):
        if package == "jax":
            return jaudio.extract_eatd(corpus, jcfg, out_dir=tmp_path,
                                       incremental=True)
        return taudio.extract_eatd(corpus, tcfg, out_dir=tmp_path,
                                   incremental=True, device="cpu")

    first = run(writer)
    manifest1 = (tmp_path / "manifest.json").read_bytes()
    reader = "torch" if writer == "jax" else "jax"
    second = run(reader)
    assert [m["status"] for m in first[3]] == ["ok"] * 6
    assert [m["status"] for m in second[3]] == ["cached"] * 6
    np.testing.assert_array_equal(np.asarray(second[0]),
                                  np.asarray(first[0]))
    manifest2 = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest2["min_len_s"] == json.loads(manifest1)["min_len_s"]
    assert manifest2["max_len_s"] == json.loads(manifest1)["max_len_s"]


def test_partial_cache_extracts_only_the_missing_speakers(corpus, tmp_path):
    """A cache that lacks some speakers: only those are extracted (under
    their corpus ordinals, so they match a full pass within 1e-5), and the
    JAX package's rerun over the same partial cache marks the same
    speakers."""
    tcfg = tconfig.FrontendConfig(**SMALL)
    full, *_ = taudio.extract_eatd(corpus, tcfg, out_dir=tmp_path,
                                   incremental=True, device="cpu")
    cache = tmp_path / "speaker_cache.npz"
    with np.load(cache) as data:
        kept = {k: data[k] for k in data.files if not k.startswith(
            ("Data/2@", "ValidationData/"))}
    np.savez(cache, **kept)
    jtmp = tmp_path / "jax"
    jtmp.mkdir()
    np.savez(jtmp / "speaker_cache.npz", **kept)
    feats, _, _, manifest = taudio.extract_eatd(corpus, tcfg,
                                                out_dir=tmp_path,
                                                incremental=True,
                                                device="cpu")
    jfeats, _, _, jmanifest = jaudio.extract_eatd(
        corpus, jconfig.FrontendConfig(**SMALL), out_dir=jtmp,
        incremental=True)
    status = [m["status"] for m in manifest]
    assert status == ["ok" if m["split"] == "ValidationData"
                      or m["number"] == 2 else "cached" for m in manifest]
    assert status == [m["status"] for m in jmanifest]
    np.testing.assert_allclose(feats, full, rtol=0, atol=ATOL)
    np.testing.assert_allclose(feats, np.asarray(jfeats), rtol=0, atol=ATOL)


def test_manifest_keeps_the_durations_of_earlier_passes(corpus, tmp_path):
    """An all-cached rerun measures no duration: the manifest keeps the
    earlier pass's range, as the JAX writer's does."""
    tcfg = tconfig.FrontendConfig(**SMALL)
    taudio.extract_eatd(corpus, tcfg, out_dir=tmp_path, incremental=True,
                        device="cpu")
    before = json.loads((tmp_path / "manifest.json").read_text())
    taudio.extract_eatd(corpus, tcfg, out_dir=tmp_path, incremental=True,
                        device="cpu")
    after = json.loads((tmp_path / "manifest.json").read_text())
    assert 0.2 <= before["min_len_s"] <= before["max_len_s"] <= 0.5
    assert (after["min_len_s"], after["max_len_s"]) == \
        (before["min_len_s"], before["max_len_s"])


def test_cache_key_is_the_jax_packages(corpus, tmp_path):
    tcfg = tconfig.FrontendConfig(**SMALL)
    taudio.extract_eatd(corpus, tcfg, out_dir=tmp_path, incremental=True,
                        device="cpu")
    with np.load(tmp_path / "speaker_cache.npz") as data:
        keys = sorted(data.files)
    fp = taudio._cache_fingerprint(tcfg)
    assert keys == sorted(
        [f"Data/{n}@{n - 1}|{fp}" for n in range(1, 5)]
        + [f"ValidationData/{n}@{n + 3}|{fp}" for n in range(1, 3)])


def _vggish_tree(seed):
    """Full-width VGGish weights in the JAX layout, drawn with numpy (the
    seeded threefry draw is held against JAX in test_torch_vggish.py)."""
    rng = np.random.default_rng(seed)
    return {g: [{"w": rng.uniform(-0.05, 0.05, shape).astype(np.float32),
                 "b": np.zeros(shape[-1], np.float32)} for shape in shapes]
            for g, shapes in (
                ("convs", [(3, 3, i, o) for i, o in tvggish._CONV_CHANNELS]),
                ("fcs", tvggish._FC_DIMS))}


@pytest.mark.parametrize("argv", [["--embedder", "vggish"],
                                  ["--vggish-ckpt", "x.ckpt"]])
def test_vggish_options_raise_naming_their_item(argv, tmp_path, monkeypatch,
                                                capsys):
    """The VGGish options are ported: ``--embedder vggish`` runs the seeded
    stand-in (no bundle), ``--vggish-ckpt`` converts the checkpoint it
    names (the converter needs tensorflow, so it is replaced here); each
    writes the ``_128`` npz files and a manifest naming the embedder."""
    root = tmp_path / "corpus"
    teatd.make_synthetic_corpus(root, n_data=1, n_validation=1,
                                seconds=1.2, seed=2)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("ICASSP_VGGISH_WEIGHTS", raising=False)
    seen = []
    monkeypatch.setattr(tvggish, "init", lambda key: _vggish_tree(0))
    monkeypatch.setattr(tvggish, "from_tf_checkpoint",
                        lambda path: seen.append(path) or _vggish_tree(1))
    out = tmp_path / "out"
    assert tcli.main(["extract-audio", "--root", str(root), "--out",
                      str(out), "--device", "cpu"]
                     + (argv if argv[0] == "--embedder"
                        else ["--embedder", "vggish"] + argv)) == 0
    assert "(2, 3, 1, 128)" in capsys.readouterr().out
    assert seen == (["x.ckpt"] if "--vggish-ckpt" in argv else [])
    assert json.loads((out / "manifest.json").read_text())["embedder"] == \
        "vggish"
    feats = _npz(out / "whole_samples_clf_128.npz")
    assert feats.shape == (2, 3, 1, 128) and np.abs(feats).sum(-1).all()


def test_extract_audio_without_a_card_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["extract-audio", "--root", str(corpus), "--out",
                   str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        taudio.extract_eatd(corpus, tconfig.FrontendConfig(**SMALL))
