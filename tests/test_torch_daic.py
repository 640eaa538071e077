"""The port's DAIC-WOZ slice against the JAX package on the same inputs:
transcript segmentation, the split passes (host, device-resident and
multimodal) and their npz files, masked pooling, ``train_daic`` with
dropout on from the seed alone, ``check_daic``, ``DaicPredictor`` on
checkpoints written by either package, and the five CLI subcommands.

Sessions are DAIC-shaped and made from seeds (the corpus is not in the
repository).  Everything runs on the CPU, where the recurrences are the
plain loops; ``chip_smoke.py`` holds the kernels to them on the card."""

import json

import jax
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.data import eatd as jeatd
from icassp2022_depression_tpu.frontend import daic as jdaic_fe
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import elmo as jelmo
from icassp2022_depression_tpu.serving.predictors import (
    DaicPredictor as JDaicPredictor,
)
from icassp2022_depression_tpu.train import checkpoints as jcheckpoints
from icassp2022_depression_tpu.train import daic as jdaic
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.frontend import daic as tdaic_fe
from icassp2022_depression_tpu_torch.models import elmo as telmo
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.ops import prng as tprng
from icassp2022_depression_tpu_torch.serving.predictors import DaicPredictor
from icassp2022_depression_tpu_torch.train import checkpoints as tcheckpoints
from icassp2022_depression_tpu_torch.train import daic as tdaic

ATOL = 1e-5
SMALL_FE = dict(n_fft=256, hop_length=64, n_mels=16, netvlad_clusters=4,
                netvlad_output_dim=32)
ECFG = dict(vocab_size=64, embed_dim=8, hidden=4, layers=1, output_dim=8)
D, H = 16, 16
SR = 16000
QUESTIONS = ("how are you doing today",
             "what are you like when you don't sleep well",
             "when was the last time you felt really happy")


def _session_rows(rng, n_questions):
    """A transcript: Ellie asks a bank question before each answer; some
    answers are scrubbed or missing (an empty segment), one Ellie row has
    trailing whitespace, and a line off the bank is ignored."""
    rows, t = [], 0.0

    def add(speaker, value, dur):
        nonlocal t
        rows.append(f"{t:.2f}\t{t + dur:.2f}\t{speaker}\t{value}")
        t += dur + 0.1

    for q in range(n_questions):
        add("Ellie " if q == 1 else "Ellie", QUESTIONS[q % len(QUESTIONS)],
            0.3)
        kind = rng.integers(0, 6)
        if kind == 0:
            continue                          # empty segment: skipped
        if kind == 1:
            add("Participant", "scrubbed_entry", 0.4)
        add("Participant", f"answer {q} part one", float(rng.uniform(.2, .6)))
        if kind == 2:
            add("Ellie", "mhm", 0.2)          # not in the bank
            add("Participant", "and more", 0.3)
    add("Ellie", "i think i have asked everything i need to", 0.3)
    return rows, t


def _make_corpus(tmp_path, pids=(300, 301, 302, 303), seed=0,
                 questions=(3, 6)):
    """DAIC-shaped sessions (<id>_P/<id>_{AUDIO.wav,TRANSCRIPT.csv}), a
    question bank, and two AVEC2017-style split CSVs."""
    rng = np.random.default_rng(seed)
    for pid in pids:
        rows, seconds = _session_rows(
            rng, int(rng.integers(questions[0], questions[1] + 1)))
        d = tmp_path / f"{pid}_P"
        d.mkdir(parents=True)
        jeatd.write_wav(d / f"{pid}_AUDIO.wav",
                        rng.standard_normal(int(SR * (seconds + 1))) * 3000,
                        SR)
        (d / f"{pid}_TRANSCRIPT.csv").write_text(
            "\n".join(["start_time\tstop_time\tspeaker\tvalue"] + rows)
            + "\n")
    queries = tmp_path / "queries.txt"
    queries.write_text("\n".join(QUESTIONS) + "\n")
    half = len(pids) // 2
    csvs = []
    for name, part in (("train", pids[:half]), ("test", pids[half:])):
        p = tmp_path / f"{name}_split.csv"
        p.write_text("Participant_ID,PHQ8_Binary,PHQ8_Score\n" + "".join(
            f"{pid},{i % 2},{3 + 7 * (i % 2) + i}\n"
            for i, pid in enumerate(part)))
        csvs.append(p)
    return queries, csvs[0], csvs[1]


def _fe():
    return (jconfig.FrontendConfig(**SMALL_FE),
            tconfig.FrontendConfig(**SMALL_FE))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_segmentation_and_split_csv_equal_jax(tmp_path):
    queries, train_csv, _ = _make_corpus(tmp_path)
    assert tdaic_fe.load_queries() == jdaic_fe.load_queries()
    assert (tdaic_fe.BUNDLED_QUERIES.read_bytes()
            == jdaic_fe.BUNDLED_QUERIES.read_bytes())
    qs = tdaic_fe.load_queries(queries)
    assert qs == jdaic_fe.load_queries(queries)
    assert tdaic_fe.is_topic_question(QUESTIONS[0] + "\n", qs)
    assert tdaic_fe.read_split_csv(train_csv) == \
        jdaic_fe.read_split_csv(train_csv)
    for pid in (300, 301, 302, 303):
        path = tmp_path / f"{pid}_P" / f"{pid}_TRANSCRIPT.csv"
        rows = tdaic_fe.read_transcript(path)
        assert rows == jdaic_fe.read_transcript(path)
        got = tdaic_fe.participant_signals(tmp_path, pid, qs, True)
        want = jdaic_fe.participant_signals(tmp_path, pid, qs, True)
        assert got[1] == want[1] and got[2] == want[2]
        assert len(got[0]) == len(want[0]) > 0
        for g, w in zip(got[0], want[0]):
            assert g.dtype == w.dtype == np.float64
            np.testing.assert_array_equal(g, w)
    # the empty and scrubbed segments are skipped, as the reference does
    rows = [{"start_time": 0.0, "stop_time": 0.1, "speaker": "Ellie",
             "value": QUESTIONS[0]},
            {"start_time": 0.2, "stop_time": 0.3, "speaker": "Ellie",
             "value": QUESTIONS[1]},
            {"start_time": 0.4, "stop_time": 0.5, "speaker": "Participant",
             "value": "scrubbed_entry"}]
    wave = np.arange(SR, dtype=np.float64)
    assert tdaic_fe.segment_responses(rows, wave, SR, qs) == []


@pytest.mark.parametrize("path", ["host", "device", "multimodal"])
def test_split_passes_match_jax(path, tmp_path):
    queries, train_csv, _ = _make_corpus(tmp_path)
    both = tmp_path / "both.csv"
    both.write_text(train_csv.read_text() + "302,1,20\n303,0,2\n")
    jfe, tfe = _fe()
    jout, tout = tmp_path / "J", tmp_path / "T"
    if path == "host":
        want, jcl, jrl = jdaic_fe.extract_split(tmp_path, both, queries, jfe,
                                                jout, "dev")
        got, tcl, trl = tdaic_fe.extract_split(tmp_path, both, queries, tfe,
                                               tout, "dev", device="cpu")
        assert (tcl, trl) == (jcl, jrl)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            _close(g, w)
        # the npz files read back through the other package's reader
        for track in ("clf", "reg"):
            ta, ty = jdaic_fe.load_features(tout, "dev", track)
            wa, wy = tdaic_fe.load_features(jout, "dev", track)
            np.testing.assert_array_equal(ty, wy)
            assert ty.dtype == wy.dtype
            for g, w in zip(ta, wa):
                _close(g, w)
        # and the fused split pass is the per-participant pass at the
        # running ordinal
        ordinal = 0
        for pid, g in zip((300, 301, 302, 303), got):
            ref = tdaic_fe.extract_participant(
                tmp_path, pid, tdaic_fe.load_queries(queries), tfe,
                ordinal, device="cpu")
            ordinal += len(ref)
            np.testing.assert_array_equal(g, ref)
    elif path == "device":
        want, jcl, _ = jdaic_fe.extract_split_device(tmp_path, both,
                                                     queries, jfe)
        got, tcl, _ = tdaic_fe.extract_split_device(tmp_path, both, queries,
                                                    tfe, device="cpu")
        assert isinstance(got.flat, torch.Tensor) and tcl == jcl
        assert got.counts == list(want.counts)
        _close(got.flat, want.flat)
        # the device gather is the host padding, bit for bit
        host = tdaic_fe.extract_split(tmp_path, both, queries, tfe,
                                      device="cpu")[0]
        x, m = tdaic.pad_flat_responses_device(got, 9)
        hx, hm = tdaic_fe.pad_responses(host, 9)
        np.testing.assert_array_equal(x.numpy(), hx)
        np.testing.assert_array_equal(m, hm)
        jx, jm = jdaic.pad_flat_responses_device(want, 9)
        _close(x, jx)
        np.testing.assert_array_equal(m, jm)
    else:
        kw = dict(elmo_weights=None, seed=5, segmenter="fallback",
                  split_name="train")
        wa, wt, jcl, jrl = jdaic_fe.extract_split_multimodal(
            tmp_path, both, queries, jfe,
            elmo_cfg=jelmo.ElmoConfig(**ECFG), out_prefix=jout, **kw)
        ga, gt, tcl, trl = tdaic_fe.extract_split_multimodal(
            tmp_path, both, queries, tfe,
            elmo_cfg=telmo.ElmoConfig(**ECFG), out_prefix=tout,
            device="cpu", **kw)
        assert (tcl, trl) == (jcl, jrl)
        for g, w in zip(ga + gt, wa + wt):
            assert g.shape == w.shape
            _close(g, w)
        assert ((tout / "extraction_meta.json").read_bytes()
                == (jout / "extraction_meta.json").read_bytes())
        _, tt, _ = jdaic_fe.load_features(tout, "train", "clf", True)
        for g, w in zip(tt, wt):
            _close(g, w)
        # concat: the trainer's multimodal blocks, and the mismatch error
        mm = tdaic.concat_multimodal(ga, gt)
        for g, w in zip(mm, jdaic.concat_multimodal(wa, wt)):
            _close(g, w)
        with pytest.raises(ValueError, match="different segmentations"):
            tdaic.concat_multimodal(ga[:1], [gt[0][:-1]])


def test_participant_text_matches_jax(tmp_path):
    queries, _, _ = _make_corpus(tmp_path)
    bank = jdaic_fe.load_queries(queries)
    jcfg, tcfg = jelmo.ElmoConfig(**ECFG), telmo.ElmoConfig(**ECFG)
    jparams = jelmo.init(jax.random.PRNGKey(5), jcfg)
    tparams = telmo.init(tprng.prng_key(5), tcfg)
    for pid in (300, 301):
        want = jdaic_fe.extract_participant_text(tmp_path, pid, bank,
                                                 jparams, jcfg)
        got = tdaic_fe.extract_participant_text(tmp_path, pid, bank,
                                                tparams, tcfg)
        assert got.shape == np.asarray(want).shape and len(got) > 0
        _close(got, want)


@pytest.mark.parametrize("pooling", ["mean", "sum"])
def test_masked_pooling_matches_jax(pooling):
    rng = np.random.default_rng(1)
    jcfg = jconfig.replace(jdaic.DAIC_CLF.model, embedding_size=8,
                           hidden_dims=8, pooling=pooling)
    tcfg = tconfig.replace(tdaic.DAIC_CLF.model, embedding_size=8,
                           hidden_dims=8, pooling=pooling)
    params = jaudio_net.init(jax.random.PRNGKey(0), jcfg)
    model = AudioNet(tcfg)
    model.load_state_dict(tporting.audio_net_state_dict_from_jax(params,
                                                                 tcfg))
    model.eval()
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    mask = np.array([[1] * 7, [1] * 3 + [0] * 4, [0] * 7], np.float32)
    want = jaudio_net.apply(params, jcfg, x, time_mask=mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x), time_mask=torch.from_numpy(mask))
        _close(got, want)
        # the padded tail changes nothing
        x2 = x.copy()
        x2[1, 3:] = 99.0
        short = model(torch.from_numpy(x[1:2, :3]))
        _close(model(torch.from_numpy(x2), time_mask=torch.from_numpy(mask))
               [1:2], short)


def _ragged(n, rng, d=D):
    feats, labels = [], []
    for _ in range(n):
        dep = rng.random() < 0.4
        r = int(rng.integers(2, 7))
        feats.append(((0.8 if dep else -0.8)
                      + rng.standard_normal((r, 1, d))).astype(np.float32))
        labels.append(int(dep))
    return feats, labels


def _trainer_cfgs(track, epochs=5, **over):
    out = []
    for mod, cfgs in ((jconfig, jdaic), (tconfig, tdaic)):
        base = cfgs.DAIC_CLF if track == "clf" else cfgs.DAIC_REG
        out.append(mod.replace(
            base, epochs=epochs, batch_size=8,
            model=mod.replace(base.model, embedding_size=D, hidden_dims=H),
            optimizer=mod.replace(base.optimizer, learning_rate=3e-2),
            **over))
    return out


@pytest.mark.parametrize("track", ["clf", "reg"])
def test_train_daic_with_dropout_matches_jax(track, tmp_path):
    """The seed alone: JAX's init from PRNGKey(seed), dropout from
    fold_in(PRNGKey(seed), 1); every epoch's metrics agree, the same
    epoch is picked, and check_daic reproduces the best of both
    checkpoints in both packages."""
    rng = np.random.default_rng(5 if track == "clf" else 6)
    tr_f, tr_y = _ragged(20, rng)
    te_f, te_y = _ragged(8, rng)
    if track == "reg":
        tr_y = [5.0 + 10 * y + i % 3 for i, y in enumerate(tr_y)]
        te_y = [5.0 + 10 * y + i % 3 for i, y in enumerate(te_y)]
    jcfg, tcfg = _trainer_cfgs(track)
    want = jdaic.train_daic(tr_f, tr_y, te_f, te_y, jcfg, seed=3,
                            out_dir=tmp_path / "J")
    got = tdaic.train_daic(tr_f, tr_y, te_f, te_y, tcfg, seed=3,
                           out_dir=tmp_path / "T", device="cpu")
    for k, v in want["logs"].items():
        # float32 sums over a few steps: 1e-5 of the largest magnitude
        # (the L1 loss on PHQ8 scores is ~20)
        v = np.asarray(v)
        _close(got["logs"][k], v, ATOL * max(1.0, np.abs(v).max()))
    assert got["best"]["epoch"] == want["best"]["epoch"] >= 0
    metric = "f1" if track == "clf" else "mae"
    _close(got["best"][metric], want["best"][metric],
           ATOL * max(1.0, abs(want["best"][metric])))
    assert np.isfinite(got["step_losses"]).all()
    (jpath,), (tpath,) = (sorted((tmp_path / s).glob(f"daic_{track}_*.npz"))
                          for s in ("J", "T"))
    assert jpath.name == tpath.name
    meta = tcheckpoints.load_meta(tpath)
    assert meta["embedding_size"] == D and meta["epoch"] == \
        want["best"]["epoch"]
    # each package's check reproduces its own trainer's best, and both
    # agree on either checkpoint (F1 within 1e-6; MAE within 1e-5 of the
    # largest PHQ8 score)
    tol = 1e-6 if track == "clf" else ATOL * max(te_y)
    for path, best in ((jpath, want["best"]), (tpath, got["best"])):
        out = tdaic.check_daic(te_f, te_y, path, tcfg, device="cpu")
        jout = jdaic.check_daic(te_f, te_y, str(path)[:-4], jcfg)
        _close(out[metric], best[metric], tol)
        _close(out[metric], jout[metric], tol)
    # the features on the device path (a FlatResponses) train the same
    flat = tdaic_fe.FlatResponses(
        torch.from_numpy(np.concatenate([f[:, 0] for f in tr_f])),
        [len(f) for f in tr_f])
    dev = tdaic.train_daic(flat, tr_y, te_f, te_y, tcfg, seed=3)
    np.testing.assert_array_equal(dev["logs"]["loss"], got["logs"]["loss"])


def _jax_ckpt(tmp_path, name, seed, emb=256, hidden=16, meta=None):
    jcfg = jconfig.replace(jdaic.DAIC_CLF.model, embedding_size=emb,
                           hidden_dims=hidden)
    tcfg = tconfig.replace(tdaic.DAIC_CLF.model, embedding_size=emb,
                           hidden_dims=hidden)
    params = jaudio_net.init(jax.random.PRNGKey(seed), jcfg)
    path = jcheckpoints.save(tmp_path / name, params, meta)
    return str(path)[:-4], jcfg, tcfg


def _signals(rng, counts):
    return [[np.round(rng.standard_normal(int(rng.integers(3000, 9000)))
                      * 2000).astype(np.int16) for _ in range(c)]
            for c in counts]


def _same(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, (bool, int)):
                assert g[k] == v, k
            else:   # probabilities, or PHQ8 scores (0-24): 1e-5 of it
                _close(g[k], v, atol * max(1.0, np.abs(v).max()))


def test_daic_predictor_matches_jax_both_ways(tmp_path, capsys):
    """A JAX-written checkpoint in the port and a port-written one in the
    JAX package (npz and, for the port, reference .pt): every entry point
    agrees; ordinals, the cache, the padding masks and the errors."""
    queries, _, _ = _make_corpus(tmp_path)
    jfe, tfe = _fe()
    ckpt, jcfg, tcfg = _jax_ckpt(tmp_path, "daic_clf_0.80", 2,
                                 emb=32, meta={"embedding_size": 32})
    jp = JDaicPredictor.from_checkpoint(ckpt, "daic_clf",
                                        tcfg=jconfig.replace(
                                            jdaic.DAIC_CLF, model=jcfg),
                                        frontend_cfg=jfe)
    tp = DaicPredictor.from_checkpoint(ckpt, "daic_clf",
                                       tcfg=tconfig.replace(
                                           tdaic.DAIC_CLF, model=tcfg),
                                       frontend_cfg=tfe, device="cpu")
    assert not tp.multimodal and tp.meta == {"embedding_size": 32}
    rng = np.random.default_rng(7)
    sigs = _signals(rng, (3, 1, 5))
    srs = [SR] * 3
    # ragged batch: 3 participants -> 4 rows (one all-ones padded row)
    _same(tp.predict_signals(sigs, srs), jp.predict_signals(sigs, srs))
    _same(tp.predict_signals(sigs, srs, [0, 3, 9]),
          jp.predict_signals(sigs, srs, [0, 3, 9]))
    blocks = tp.response_features(sigs, srs, [4, 0, 2])
    for g, w in zip(blocks, jp.response_features(sigs, srs, [4, 0, 2])):
        _close(g, w)
    _same(tp.predict_features(blocks), jp.predict_features(blocks))
    for pid, start in ((300, 0), (302, 7)):
        _same([tp.predict_participant(tmp_path, pid, queries, start)],
              [jp.predict_participant(tmp_path, pid, queries, start)])
    # the response cache: a repeat participant hits it wherever it sits
    hits = tp.feature_cache.hits
    again = tp.predict_signals([sigs[1], sigs[0]], [SR, SR])
    assert tp.feature_cache.hits == hits + 4
    _same(again, tp.predict_signals(sigs, srs)[1::-1], 1e-6)
    assert tp.predict_signals([], []) == [] and tp.predict_features([]) == []
    for call in (lambda: tp.predict_signals([sigs[0], []], [SR, SR]),
                 lambda: tp.predict_features(
                     [np.zeros((0, 1, 32), np.float32)])):
        with pytest.raises(ValueError, match="zero segmented responses"):
            call()
    with pytest.raises(ValueError, match="task must be one of"):
        DaicPredictor(tp.model, "audio_clf", device="cpu")
    # the port's checkpoint (trained weights) in the JAX package, and as a
    # reference .pt in the port
    small = dict(embedding_size=32, hidden_dims=16)
    treg_cfg = tconfig.replace(tdaic.DAIC_REG, model=tconfig.replace(
        tdaic.DAIC_REG.model, **small))
    model = AudioNet(treg_cfg.model, tprng.prng_key(4))
    tree = tporting.audio_net_tree_from_state_dict(model.state_dict(),
                                                   treg_cfg.model)
    tpath = tcheckpoints.save(tmp_path / "port" / "daic_reg_3.10", tree)
    tporting.export_reference_pt(model, "audio", treg_cfg.model,
                                 tmp_path / "ref.pt")
    jreg = JDaicPredictor.from_checkpoint(
        str(tpath)[:-4], "daic_reg", tcfg=jconfig.replace(
            jdaic.DAIC_REG, model=jconfig.replace(jdaic.DAIC_REG.model,
                                                  **small)),
        frontend_cfg=jfe)
    for path in (tpath, tmp_path / "ref.pt"):
        treg = DaicPredictor.from_checkpoint(path, "daic_reg",
                                             tcfg=treg_cfg,
                                             frontend_cfg=tfe, device="cpu")
        out = treg.predict_signals(sigs, srs)
        assert all("phq8_score" in r for r in out)
        _same(out, jreg.predict_signals(sigs, srs))


def test_daic_predictor_multimodal_and_provenance(tmp_path, capsys):
    """Multimodal serving from the sidecar's embedding_size (and from the
    weights without one), the adoption of text_segmenter / text_seed, the
    embedder-mismatch warning, and the signals + texts path."""
    queries, _, _ = _make_corpus(tmp_path)
    meta = {"embedding_size": 264, "text_embedder": "prng:seed=5",
            "text_segmenter": "fallback", "text_seed": 5}
    ckpt, jcfg, tcfg = _jax_ckpt(tmp_path, "daic_clf_0.90", 0, emb=264,
                                 meta=meta)
    kw = dict(elmo_weights=None)
    jp = JDaicPredictor.from_checkpoint(ckpt, "daic_clf",
                                        elmo_cfg=jelmo.ElmoConfig(**ECFG),
                                        **kw)
    tp = DaicPredictor.from_checkpoint(ckpt, "daic_clf",
                                       elmo_cfg=telmo.ElmoConfig(**ECFG),
                                       device="cpu", **kw)
    err = capsys.readouterr().err
    assert tp.multimodal and tp.tcfg.model.embedding_size == 264
    assert (tp.segmenter, tp.embedder_id) == ("fallback", "prng:seed=5")
    assert "adopting segmenter 'fallback'" in err and "WARNING" not in err
    _same([tp.predict_participant(tmp_path, 301, queries, 2)],
          [jp.predict_participant(tmp_path, 301, queries, 2)])
    rng = np.random.default_rng(3)
    sigs = _signals(rng, (2, 3))
    texts = [["pretty good", "not great"], ["yes", "no", "maybe so"]]
    _same(tp.predict_signals(sigs, [SR, SR], None, texts),
          jp.predict_signals(sigs, [SR, SR], None, texts))
    with pytest.raises(ValueError, match="transcripts are required"):
        tp.predict_signals(sigs, [SR, SR])
    with pytest.raises(ValueError, match="align 1:1"):
        tp.predict_signals(sigs, [SR, SR], None, [["a"], ["b"]])
    # an explicit seed other than the training features' warns
    mismatch = DaicPredictor.from_checkpoint(
        ckpt, "daic_clf", elmo_cfg=telmo.ElmoConfig(**ECFG), seed=0,
        device="cpu", **kw)
    assert mismatch.embedder_id == "prng:seed=0"
    assert "predictions will be meaningless" in capsys.readouterr().err
    # the default (1024-d) stand-in does not make 264: a clear error
    with pytest.raises(ValueError, match="embedding_size"):
        DaicPredictor.from_checkpoint(ckpt, "daic_clf", device="cpu", **kw)
    # no sidecar: the width comes from the first GRU layer's weights
    bare, _, _ = _jax_ckpt(tmp_path, "daic_clf_0.70", 1, emb=264)
    old = DaicPredictor.from_checkpoint(bare, "daic_clf",
                                        elmo_cfg=telmo.ElmoConfig(**ECFG),
                                        device="cpu", **kw)
    assert old.multimodal and old.tcfg.model.embedding_size == 264
    assert "serving it as a --multimodal model" in capsys.readouterr().err


def _small_presets(monkeypatch, epochs=6):
    """Both packages' DAIC presets at a few epochs, gates open, a high
    learning rate (the CLIs read them at call time)."""
    for mod, cfgs in ((jconfig, jdaic), (tconfig, tdaic)):
        for name in ("DAIC_CLF", "DAIC_REG"):
            base = getattr(cfgs, name)
            gate = (mod.GateConfig(f1_floor=-1.0, train_acc_frac=0.0)
                    if name == "DAIC_CLF" else base.gate)
            monkeypatch.setattr(cfgs, name, mod.replace(
                base, epochs=epochs, batch_size=2, gate=gate,
                model=mod.replace(base.model, hidden_dims=16),
                optimizer=mod.replace(base.optimizer, learning_rate=3e-2)))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("track", ["clf", "reg"])
def test_cli_daic_commands_match_jax_cli(track, tmp_path, capsys,
                                         monkeypatch):
    """extract-daic -> train-daic -> check-daic -> predict-daic, and the
    fused train-daic / check-daic --daic-dir, in both CLIs."""
    _small_presets(monkeypatch)
    queries, train_csv, test_csv = _make_corpus(tmp_path)
    data = ["--daic-dir", str(tmp_path), "--queries", str(queries)]
    out = {}
    for name, main, extra in (("J", jcli.main, []),
                              ("T", tcli.main, ["--device", "cpu"])):
        feats = tmp_path / name / "Features"
        for split, csv in (("train", train_csv), ("test", test_csv)):
            assert main(["extract-daic", *data, "--split-csv", str(csv),
                         "--out", str(feats), "--split-name", split]
                        + extra) == 0
        capsys.readouterr()
        model_dir = tmp_path / name / "Model"
        assert main(["train-daic", "--track", track, "--features",
                     str(feats), "--model-dir", str(model_dir)]
                    + extra) == 0
        trained = _last_json(capsys)
        (ckpt,) = sorted(model_dir.glob(f"daic_{track}_*.npz"))
        assert main(["check-daic", "--track", track, "--features",
                     str(feats), "--ckpt", str(ckpt)[:-4]] + extra) == 0
        checked = _last_json(capsys)
        assert main(["train-daic", "--track", track, *data,
                     "--train-csv", str(train_csv), "--eval-csv",
                     str(test_csv), "--model-dir",
                     str(tmp_path / name / "Fused")] + extra) == 0
        fused = _last_json(capsys)
        assert main(["check-daic", "--track", track, *data, "--eval-csv",
                     str(test_csv), "--ckpt", str(ckpt)[:-4]] + extra) == 0
        rechecked = _last_json(capsys)
        assert main(["predict-daic", "--task", f"daic_{track}", *data,
                     "--ckpt", str(ckpt)[:-4], "--participant", "302",
                     "--start-ordinal", "4"] + extra) == 0
        out[name] = (trained, checked, fused, rechecked,
                     _last_json(capsys), feats)
    metric = "f1" if track == "clf" else "mae"
    for i in range(4):
        j, t = out["J"][i], out["T"][i]
        assert set(t) == set(j)
        _close(t[metric], j[metric], 1e-4)   # printed at 4 decimals
    assert out["T"][0]["epoch"] == out["J"][0]["epoch"]
    assert out["T"][2] == out["T"][0]          # fused == two-step
    _close(out["T"][1][metric], out["T"][0][metric], 1e-4)
    _same([{k: v for k, v in out["T"][4].items() if k != "participant"}],
          [{k: v for k, v in out["J"][4].items() if k != "participant"}])
    assert out["T"][4]["participant"] == 302
    for split in ("train", "test"):
        for g, w in zip(*(tdaic_fe.load_features(out[n][5], split, track)[0]
                          for n in ("T", "J"))):
            _close(g, w)


def test_cli_daic_errors_and_device(tmp_path, monkeypatch):
    queries, train_csv, test_csv = _make_corpus(tmp_path, pids=(300, 301))
    feats = tmp_path / "F"
    base = ["--daic-dir", str(tmp_path), "--queries", str(queries)]
    # --elmo-tp is ported (test_torch_elmo_tp.py): its 2 CPU ranks refuse
    # the plain BiLSTM stand-in, which has no tensor-parallel layout, as
    # the JAX package does
    with pytest.raises(Exception, match="no tensor-parallel layout"):
        tcli.main(["extract-daic", *base, "--split-csv", str(train_csv),
                   "--out", str(feats), "--multimodal", "--elmo-tp", "2",
                   "--elmo-weights", "", "--device", "cpu"])
    for argv, match in (
            (["train-daic", "--track", "clf"], "needs --features"),
            (["train-daic", "--track", "clf", *base], "--train-csv"),
            (["train-daic", "--track", "clf", *base, "--train-csv",
              str(train_csv), "--eval-csv", str(test_csv), "--multimodal"],
             "audio-only"),
            (["check-daic", "--track", "clf", "--ckpt", "x"],
             "needs --features"),
            (["check-daic", "--track", "clf", *base, "--ckpt", "x"],
             "--eval-csv")):
        with pytest.raises(SystemExit, match=match):
            tcli.main(argv + ["--device", "cpu"])
    # the card is the default: without one, every entry point raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["extract-daic", *base, "--split-csv", str(train_csv),
                  "--out", str(feats)],
                 ["train-daic", "--track", "clf", "--features", str(feats)],
                 ["check-daic", "--track", "clf", "--features", str(feats),
                  "--ckpt", "x"],
                 ["predict-daic", "--task", "daic_clf", *base, "--ckpt",
                  "x", "--participant", "300"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdaic_fe.extract_split(tmp_path, train_csv, queries)
