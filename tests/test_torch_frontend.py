"""The port's log-mel, NetVLAD and bucketed wav2vlad frontend against the
JAX package on the same waveforms, at small widths."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.data import eatd as jeatd
from icassp2022_depression_tpu.frontend import audio as jaudio
from icassp2022_depression_tpu.ops import mel as jmel
from icassp2022_depression_tpu.ops import netvlad as jnetvlad
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.frontend import audio as taudio
from icassp2022_depression_tpu_torch.ops import mel as tmel
from icassp2022_depression_tpu_torch.ops import netvlad as tnetvlad
from icassp2022_depression_tpu_torch.utils import profiling

SMALL = dict(n_fft=256, hop_length=64, n_mels=16, netvlad_clusters=4,
             netvlad_output_dim=32)


def _pcm(rng, n):
    return np.round(rng.standard_normal(n) * 3000.0)


def test_mel_filterbank_equal():
    np.testing.assert_array_equal(tmel.mel_filterbank(16000, 256, 16),
                                  jmel.mel_filterbank(16000, 256, 16))
    np.testing.assert_array_equal(tmel.mel_filterbank(16000, 2048, 80),
                                  jmel.mel_filterbank(16000, 2048, 80))


# 4000 and 6400 are hop multiples, 4001 and 5123 are not
@pytest.mark.parametrize("length", [4000, 4001, 5123, 6400])
def test_log_mel_close(length):
    y = _pcm(np.random.default_rng(length), length).astype(np.float32)
    want = np.asarray(jmel.log_mel(jnp.asarray(y), 16000, 256, 64, 16))
    got = tmel.log_mel(torch.from_numpy(y), 16000, 256, 64, 16).numpy()
    assert got.shape == want.shape == (1 + length // 64, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_log_mel_batched_rows_match_single():
    y = _pcm(np.random.default_rng(0), 2 * 3000).astype(np.float32)
    y = y.reshape(2, 3000)
    rows = tmel.log_mel(torch.from_numpy(y), 16000, 256, 64, 16)
    for i in range(2):
        np.testing.assert_allclose(
            rows[i].numpy(),
            tmel.log_mel(torch.from_numpy(y[i]), 16000, 256, 64, 16).numpy(),
            rtol=0, atol=1e-5)


def test_frame_mask_equal():
    lengths = np.array([0, 63, 64, 1000, 4097])
    want = np.asarray(jmel.frame_mask(jnp.asarray(lengths), 70, 64))
    got = tmel.frame_mask(torch.from_numpy(lengths), 70, 64).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_netvlad_close(masked):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 40, 16)).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([40, 17, 3])[:, None]
    p = jnetvlad.batched_per_utterance_params(0, jnp.arange(3), 16, 4, 32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    if masked:
        want = jax.vmap(jnetvlad.netvlad)(p, jnp.asarray(x),
                                          jnp.asarray(mask))
        got = tnetvlad.netvlad(tp, torch.from_numpy(x),
                               torch.from_numpy(mask))
    else:
        want = jax.vmap(jnetvlad.netvlad, in_axes=(0, 0))(p, jnp.asarray(x))
        got = tnetvlad.netvlad(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_netvlad_unbatched_close():
    x = np.random.default_rng(2).standard_normal((25, 16)).astype(np.float32)
    want = jnetvlad.netvlad(jnetvlad.per_utterance_params(1, 9, 16, 4, 32),
                            jnp.asarray(x))
    got = tnetvlad.netvlad(tnetvlad.per_utterance_params(1, 9, 16, 4, 32),
                           torch.from_numpy(x))
    assert tuple(got.shape) == (32,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_extract_batch_close():
    """Several length buckets, a length that is no hop multiple (the
    reflected tail at the true end), a signal shorter than the tail
    (multi-bounce reflection), one sample, an empty answer (silence
    fallback), int16 and float64 inputs, explicit ordinals."""
    rng = np.random.default_rng(3)
    waves = [_pcm(rng, 5123), _pcm(rng, 20000).astype(np.int16),
             _pcm(rng, 90), np.array([17.0]), np.zeros(0),
             _pcm(rng, 16300), rng.standard_normal(3001) * 0.5]
    srs = [16000] * len(waves)
    ordinals = [0, 1, 2, 30, 31, 32, 99]
    want = jaudio.extract_batch(waves, srs, jconfig.FrontendConfig(**SMALL),
                                ordinals=ordinals)
    got = taudio.extract_batch(waves, srs, tconfig.FrontendConfig(**SMALL),
                               ordinals=ordinals, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (7, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_extract_batch_start_ordinal_and_order():
    rng = np.random.default_rng(4)
    waves = [_pcm(rng, n) for n in (3000, 40000, 3100)]
    cfg = tconfig.FrontendConfig(**SMALL)
    want = jaudio.extract_batch(waves, [16000] * 3,
                                jconfig.FrontendConfig(**SMALL),
                                start_ordinal=6)
    got = taudio.extract_batch(waves, [16000] * 3, cfg, start_ordinal=6,
                               device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # one utterance alone gets the same features as inside the batch
    alone = taudio.extract_batch(waves[1:2], [16000], cfg, ordinals=[7],
                                 device="cpu")
    np.testing.assert_allclose(alone[0].numpy(), got[1].numpy(), rtol=0,
                               atol=1e-6)


#: a length bucket's answers -> the rows it computes (its row tile)
ROW_TILES = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 7: 8, 8: 8, 9: 16, 17: 24}


def _one_bucket(n: int):
    """``n`` answers of 4000-16000 samples: with SMALL's tail of 128 all
    fall into the 16384-sample bucket."""
    rng = np.random.default_rng(100 + n)
    return [_pcm(rng, int(m)) for m in rng.integers(4000, 16001, n)]


@pytest.mark.parametrize("n", sorted(ROW_TILES))
def test_bucket_rows_match_one_answer_calls(n, monkeypatch):
    """A bucket of ``n`` answers computes its row tile's rows, and each
    real row's features are those of the answer alone (a one-row tile)
    under the same ordinal: the NetVLAD weights drawn for it bitwise, the
    features within float32 rounding."""
    drawn = []
    draw = tnetvlad.batched_per_utterance_params

    def recording(seed, ordinals, *args, **kw):
        drawn.append((ordinals.clone(), draw(seed, ordinals, *args, **kw)))
        return drawn[-1][1]

    monkeypatch.setattr(tnetvlad, "batched_per_utterance_params", recording)
    cfg = tconfig.FrontendConfig(**SMALL)
    waves = _one_bucket(n)
    ordinals = [7 * i + 3 for i in range(n)]
    got = taudio.extract_batch(waves, [16000] * n, cfg, ordinals=ordinals,
                               device="cpu")
    (rows, params), = drawn
    assert rows.tolist()[:n] == ordinals and len(rows) == ROW_TILES[n]
    scale = float(got.abs().max())
    for i, (w, o) in enumerate(zip(waves, ordinals)):
        alone = taudio.extract_batch([w], [16000], cfg, ordinals=[o],
                                     device="cpu")
        one_rows, one_params = drawn[-1]
        assert one_rows.tolist() == [o]
        for k, v in params.items():
            assert torch.equal(v[i], one_params[k][0]), k
        np.testing.assert_allclose(got[i].numpy(), alone[0].numpy(),
                                   rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("n", sorted(ROW_TILES))
def test_bucket_record_pads_to_the_row_tile(n):
    """The ``wav2vlad/bucket*`` record counts the bucket's real samples
    and, as ``padded_samples``, the rest of its row tile times its
    length."""
    waves = _one_bucket(n)
    t0 = time.time_ns()
    taudio.extract_batch(waves, [16000] * n, tconfig.FrontendConfig(**SMALL),
                         device="cpu")
    bucket, = [r for r in profiling.records(start_ns=t0)
               if r.name.startswith("wav2vlad/bucket")]
    samples = sum(len(w) for w in waves)
    assert bucket.name == "wav2vlad/bucket16384"
    assert bucket.counts == {
        "samples": samples,
        "padded_samples": ROW_TILES[n] * 16384 - samples}


def test_synthetic_corpus_and_reader_equal(tmp_path):
    jeatd.make_synthetic_corpus(tmp_path / "j", 2, 1, seconds=(0.2, 0.4),
                                seed=5)
    teatd.make_synthetic_corpus(tmp_path / "t", 2, 1, seconds=(0.2, 0.4),
                                seed=5)
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "t")
                           for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes()
    sj = jeatd.load_speaker(tmp_path / "j", "ValidationData", 1)
    st = teatd.load_speaker(tmp_path / "t", "ValidationData", 1)
    assert (st.sds, st.texts, st.sample_rates) == \
        (sj.sds, sj.texts, sj.sample_rates)
    for a, b in zip(st.waveforms, sj.waveforms):
        np.testing.assert_array_equal(a, b)
    assert teatd.corpus_position(tmp_path / "t", "ValidationData", 1) == 2


def test_extract_eatd_device_and_load_features_match_jax(tmp_path):
    """The fused corpus pass that feeds ``train --corpus`` (full default
    frontend), and the npz reader of the JAX package's extract-audio
    artifacts."""
    teatd.make_synthetic_corpus(tmp_path, 2, 1, seconds=(0.2, 0.4), seed=6)
    feats, sds, clf = taudio.extract_eatd_device(tmp_path, device="cpu")
    jfeats, jsds, jclf = jaudio.extract_eatd_device(tmp_path)
    assert tuple(feats.shape) == (3, 3, 256) and feats.device.type == "cpu"
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(sds, jsds)
    np.testing.assert_array_equal(clf, jclf)
    out = tmp_path / "Features"
    out.mkdir()
    np.savez(out / "whole_samples_clf_256.npz",
             np.asarray(jfeats)[:, :, None, :])
    np.savez(out / "whole_labels_clf_256.npz", jclf)
    for a, b in zip(taudio.load_features(out, "clf"),
                    jaudio.load_features(out, "clf")):
        np.testing.assert_array_equal(a, b)


def _no_device_calls(tmp_path):
    """Each entry point that takes ``device`` and puts host data somewhere,
    called without one: the audio frontend's two and the six trainers."""
    from icassp2022_depression_tpu_torch.train import trainers

    x = np.zeros((6, 3, 8), np.float32)
    y = np.array([0, 1] * 3)
    idx = [np.arange(4)]
    return {
        "extract_batch": lambda: taudio.extract_batch(
            [np.ones(400)], [16000], tconfig.FrontendConfig(**SMALL)),
        "extract_eatd_device": lambda: taudio.extract_eatd_device(tmp_path),
        "train_audio_clf": lambda: trainers.train_audio_clf(x, y, idx),
        "train_text_clf": lambda: trainers.train_text_clf(x, y, idx),
        "train_audio_reg": lambda: trainers.train_audio_reg(x, y, y, y),
        "train_text_reg": lambda: trainers.train_text_reg(x, y, y, y),
        "train_fuse_clf": lambda: trainers.train_fuse_clf(x, x, y, idx, []),
        "train_fuse_reg": lambda: trainers.train_fuse_reg(x, x, y, y, y, []),
    }


@pytest.mark.parametrize("entry", ["extract_batch", "extract_eatd_device",
                                   "train_audio_clf", "train_text_clf",
                                   "train_audio_reg", "train_text_reg",
                                   "train_fuse_clf", "train_fuse_reg"])
def test_entry_points_without_a_device_raise_without_a_card(entry, tmp_path,
                                                           monkeypatch):
    """No ``device`` and no card: the entry point raises, naming ``--device
    cpu``, instead of running on the CPU unasked.  Whether there is a card
    is decided here, at run time: the test takes it away."""
    teatd.make_synthetic_corpus(tmp_path, 1, 1, seconds=0.2, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _no_device_calls(tmp_path)[entry]()


def test_trainers_keep_a_tensor_where_it_lies():
    """A tensor's own device wins when the trainers are given none."""
    from icassp2022_depression_tpu_torch.train import trainers

    x = torch.zeros((2, 3, 4), dtype=torch.float64)
    got = trainers._features(x, None)
    assert got.device.type == "cpu" and got.dtype == torch.float32
