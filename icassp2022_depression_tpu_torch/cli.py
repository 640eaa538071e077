"""Command line of the port (counterpart of
:mod:`icassp2022_depression_tpu.cli`, the subcommands of the ported slices).

  python -m icassp2022_depression_tpu_torch.cli synth-corpus --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli extract-audio --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli extract-text --root ./corpus \\
      --elmo-weights elmo_zhs.npz
  python -m icassp2022_depression_tpu_torch.cli train --task audio_clf \\
      --root ./corpus --corpus ./corpus
  python -m icassp2022_depression_tpu_torch.cli train --task text_clf \\
      --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli pipeline --track clf \\
      --root ./corpus [--corpus ./corpus]
  python -m icassp2022_depression_tpu_torch.cli predict --task fuse_clf \\
      --ckpt ckpt.npz --root ./corpus --speaker Data/1
  python -m icassp2022_depression_tpu_torch.cli check --task audio_clf \\
      --root ./corpus --ckpts f1.npz f2.npz f3.pt [--corpus ./corpus]
  python -m icassp2022_depression_tpu_torch.cli export-pt --task audio_clf \\
      --ckpt ckpt.npz --out ref.pt
  python -m icassp2022_depression_tpu_torch.cli parity --root ./corpus \\
      [--ckpt-dir Model | --from-report report.json]

Every subcommand that computes runs on ``--device`` (default ``cuda``); on
a machine without a card it raises unless ``--device cpu`` is given.
``synth-corpus`` and ``export-pt`` run no model and take no device.

``train`` writes what the JAX CLI's ``train`` writes: the gated-best
checkpoints (npz + JSON sidecar, and ``train_idxs_{f1:.2f}_{fold}.npy`` for
classification) under ``<model-dir>/ClassificationWhole/{Audio,Text}`` or
``<model-dir>/Regression/{Audio,Text}{fold}``, the per-epoch metrics in
``<model-dir>/<task>_metrics.jsonl``, and one ``fold k: {...}`` line per
fold.  The tasks train from ``--corpus`` (wav2vlad audio or ELMo text
features extracted on the device, no npz) or from the npz features under
``<root>/Features/AudioWhole`` / ``<root>/Features/TextWhole``.
``extract-text`` writes the latter for text (the JAX package's
``extract-text`` layout and ``extraction_meta.json``).  ``pipeline`` runs
a track's three trainers (audio, text, then the fusion from each fold's
gated branches) on the npz features or, with ``--corpus``, on both
modalities extracted on the device, writes their checkpoints
(``.../Fuse`` and ``Regression/Fuse{fold}`` for the fusion) and
``<model-dir>/pipeline_<track>_metrics.jsonl``, and ends with a JSON line
of the per-fold gated metrics.  ``predict`` prints one JSON line with the
JAX CLI's fields: the result dict, ``speaker`` and ``true_sds``; the text
and fusion tasks embed the speaker's transcripts with the embedder that
``ICASSP_ELMO_WEIGHTS`` names, else ``~/.cache/icassp2022_tpu/elmo_zhs.npz``
when present (else the seeded stand-in).

``extract-audio`` writes ``<root>/Features/AudioWhole`` (the JAX package's
npz files and ``manifest.json``).  ``check`` recomputes each fold's
metrics from its checkpoint (npz of either package, or a reference
``.pt``) on the npz features or, with ``--corpus``, on features extracted
anew, and prints one JSON line per fold and one of their mean.
``export-pt`` writes a checkpoint as a reference-layout state-dict
``.pt``.  ``parity`` prints the ``BASELINE.md`` acceptance table of a
saved report (``--from-report``), of a reference ``Model/`` tree of
checkpoints (``--ckpt-dir``) or of both tracks trained anew.  The lines
printed are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from icassp2022_depression_tpu_torch.serving.predictors import (
    TASKS,
    Predictor,
    default_device,
    model_config,
    model_kind,
)


def cmd_synth_corpus(args):
    from icassp2022_depression_tpu_torch.data import eatd

    eatd.make_synthetic_corpus(Path(args.root), n_data=args.n_data,
                               n_validation=args.n_validation,
                               seconds=args.seconds, seed=args.seed)
    print(f"synthetic EATD-shaped corpus written to {args.root}")


def _device(args) -> torch.device:
    """``--device``; its default, ``cuda``, is the first card, and raises,
    naming ``--device cpu``, when there is none."""
    return default_device() if args.device == "cuda" \
        else torch.device(args.device)


def cmd_extract_audio(args):
    """EATD audio features -> ``<out>`` (default ``<root>/Features/
    AudioWhole``) in the JAX package's layout."""
    from icassp2022_depression_tpu_torch.frontend import audio as afe

    _reject((("--embedder vggish", args.embedder == "vggish", _VGGISH),
             ("--vggish-ckpt/--pca-params",
              bool(args.vggish_ckpt or args.pca_params), _VGGISH)))
    root = Path(args.root)
    out = Path(args.out) if args.out else root / "Features" / "AudioWhole"
    feats, _, clf, manifest = afe.extract_eatd(root, out_dir=out,
                                               device=_device(args))
    print(f"audio features {feats.shape} -> {out} "
          f"({len(manifest)} speakers, {int(clf.sum())} depressed)")
    return 0


def cmd_predict(args):
    """Serve a prediction for one corpus speaker from a checkpoint."""
    from icassp2022_depression_tpu_torch.data import eatd

    split, number = args.speaker.split("/")
    sp = eatd.load_speaker(Path(args.root), split, int(number))
    if sp is None:
        raise SystemExit(f"speaker {args.speaker} not found under {args.root}")
    kw = {"device": _device(args)}
    # default: from_checkpoint adopts the sidecar's segmenter
    if args.segmenter:
        kw["segmenter"] = args.segmenter
    if args.embed_seed is not None:
        kw["seed"] = args.embed_seed
    p = Predictor.from_checkpoint(args.ckpt, args.task, **kw)
    call = {}
    if not args.task.startswith("text"):
        # corpus-position ordinal base -> NetVLAD features identical to the
        # training-time extraction of this speaker
        call.update(waveforms=sp.waveforms, sample_rates=sp.sample_rates,
                    ordinal_base=3 * eatd.corpus_position(
                        Path(args.root), split, int(number)))
    if not args.task.startswith("audio"):
        call.update(texts=sp.texts)
    result = p.predict_speaker(**call)
    result["speaker"] = args.speaker
    result["true_sds"] = sp.sds
    print(json.dumps(result))
    return 0


def _reject_text_modes(args) -> None:
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    _reject((("--elmo-stateful", args.elmo_stateful, tfe.STATEFUL_ITEM),
             ("--elmo-tp", args.elmo_tp > 1, tfe.TP_ITEM)))


def cmd_extract_text(args):
    """EATD text features -> ``<out>`` (default ``<root>/Features/
    TextWhole``) in the JAX package's layout."""
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    _reject_text_modes(args)
    root = Path(args.root)
    out = Path(args.out) if args.out else root / "Features" / "TextWhole"
    feats, _, _ = tfe.extract_eatd(root, out_dir=out, seed=args.seed,
                                   elmo_weights=args.elmo_weights,
                                   segmenter=args.segmenter,
                                   device=_device(args))
    print(f"text features {feats.shape} -> {out}")
    return 0


_TRAINER_REST = "the rest of the JAX trainer (ROADMAP.md Queue 1, item 19)"
_MULTI_GPU = "the multi-GPU slice (ROADMAP.md Queue 1, item 18)"
_VGGISH = "the VGGish slice (ROADMAP.md Queue 1, item 17)"


def _reject(options) -> None:
    """The JAX CLI's options that arrive with later slices of the port
    (``ROADMAP.md`` Queue 1) raise instead of being ignored."""
    for flag, used, where in options:
        if used:
            raise SystemExit(f"{flag} is not ported yet: it arrives with "
                             f"{where}")


def _reject_unported(args) -> None:
    _reject((
        ("--resume-dir/--chunk-epochs",
         args.resume_dir is not None or args.chunk_epochs is not None,
         _TRAINER_REST),
        ("--vmap-folds", args.vmap_folds, _TRAINER_REST),
        ("--fold-parallel/--data-parallel",
         args.fold_parallel or args.data_parallel != 1, _MULTI_GPU),
        ("--audio-dim", args.audio_dim != 256, _VGGISH)))


def _train_folds(targets, seed: int, idx_files=None):
    from icassp2022_depression_tpu_torch.data import folds

    if idx_files:
        return [folds.load_index_file(p) for p in idx_files]
    return folds.generate_clf_folds(targets, 3, seed=seed)


def _features_dirs(root: Path):
    return (root / "Features" / "AudioWhole", root / "Features" / "TextWhole")


def _require_features(path: Path, kind: str) -> None:
    if not path.exists():
        raise SystemExit(f"{kind} features not found under {path}: point "
                         "--root at a directory with Features/AudioWhole "
                         "and Features/TextWhole"
                         + (" or pass --corpus" if kind == "audio" else ""))


def _text_meta(text_dir: Path):
    """The embedder's provenance recorded by ``extract-text`` -> checkpoint
    sidecar extras (a text or fusion model is only servable with the
    embedder whose features it was trained on), or None."""
    p = text_dir / "extraction_meta.json"
    if not p.exists():
        return None
    meta = json.loads(p.read_text())
    extras = {"text_embedder": meta.get("embedder")}
    if meta.get("segmenter"):
        extras["text_segmenter"] = meta["segmenter"]
    return extras


def _warn_stale_text_artifacts(text_dir: Path) -> None:
    """A ``--corpus`` run extracts the text anew; say so when
    ``extract-text`` artifacts (maybe of another embedder) lie unused."""
    if (text_dir / "whole_samples_clf_avg.npz").exists():
        print("--corpus: ignoring the existing extract-text artifacts in "
              f"{text_dir} - text features are re-extracted on the fly "
              "with THIS command's --seed/--segmenter/--elmo-weights "
              "(drop --corpus to train on the persisted npz instead)",
              file=sys.stderr)


def _corpus_text(args, text_dir: Path, device):
    """The corpus's text features on ``device`` and the checkpoint sidecar
    extras naming their embedder and segmenter."""
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    _warn_stale_text_artifacts(text_dir)
    x, sds, clf, meta = tfe.extract_eatd_device(
        Path(args.corpus), seed=args.seed, elmo_weights=args.elmo_weights,
        segmenter=args.segmenter, device=device)
    _require_speakers(sds, args.corpus)
    return x, sds, clf, {"text_embedder": meta["embedder"],
                         "text_segmenter": meta["segmenter"]}


def _require_speakers(sds, corpus) -> None:
    if len(sds) == 0:
        raise SystemExit(
            f"--corpus {corpus}: no speakers found; expected the EATD "
            "layout Data/<n>/ and/or ValidationData/<n>/ with "
            "{positive,neutral,negative}_out.wav and new_label.txt")


def cmd_train(args):
    """Train one branch task's 3 folds from a corpus (``--corpus``: wav2vlad
    or ELMo features extracted on the device) or from the npz features
    under ``<root>/Features/{AudioWhole,TextWhole}``."""
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.train import trainers
    from icassp2022_depression_tpu_torch.utils.logging import MetricsLogger

    _reject_unported(args)
    device = _device(args)
    root = Path(args.root)
    audio_dir, text_dir = _features_dirs(root)
    model_dir = Path(args.model_dir) if args.model_dir else root / "Model"
    logger = MetricsLogger(model_dir / f"{args.task}_metrics.jsonl",
                           echo=args.verbose)
    track = "clf" if args.task.endswith("clf") else "reg"
    # resolved at call time, so a changed preset is what trains
    tcfg = getattr(C, args.task.upper())
    text_kw = {}
    if args.task.startswith("text") and args.corpus:
        x, sds, clf_targets, text_kw["meta_extras"] = _corpus_text(
            args, text_dir, device)
        y = clf_targets if track == "clf" else sds
    elif args.task.startswith("text"):
        _require_features(text_dir, "text")
        x, y = tfe.load_features(text_dir, track)
        text_kw["meta_extras"] = _text_meta(text_dir)
    elif args.corpus:
        x, sds, clf_targets = afe.extract_eatd_device(Path(args.corpus),
                                                      device=device)
        _require_speakers(sds, args.corpus)
        y = clf_targets if track == "clf" else sds
    else:
        _require_features(audio_dir, "audio")
        x, y = afe.load_features(audio_dir, track)
    fn = {"audio_clf": trainers.train_audio_clf,
          "text_clf": trainers.train_text_clf,
          "audio_reg": trainers.train_audio_reg,
          "text_reg": trainers.train_text_reg}[args.task]
    if track == "clf":
        sub = "Audio" if args.task == "audio_clf" else "Text"
        results = fn(x, y, _train_folds(y, args.seed, args.idx_files),
                     tcfg=tcfg,
                     out_dir=model_dir / "ClassificationWhole" / sub,
                     seed=args.seed, device=device, **text_kw)
    else:
        dep, non = folds.generate_reg_shuffles(y, seed=args.seed)
        results = fn(x, y, dep, non, tcfg=tcfg,
                     out_dir=model_dir / "Regression", seed=args.seed,
                     device=device, **text_kw)
    for r in results:
        logger.log_fold(args.task, r["fold"], r["logs"], r["best"])
        best = {k: round(v, 4) for k, v in r["best"].items() if k != "params"}
        print(f"fold {r['fold']}: {best}")
    return 0


def _warn_ungated(named_results) -> None:
    """The reference fails loudly when a branch checkpoint is missing
    (torch.load of a path never written); here the fusion would silently
    start such a fold from the branch's initial random params, so say so."""
    for name, results in named_results.items():
        bad = [r["fold"] for r in results if r["best"]["epoch"] < 0]
        if bad:
            print(f"WARNING: {name} gate never fired for fold(s) {bad}; "
                  "fusion will start those folds from UNTRAINED branch "
                  "params (reference behaviour: missing checkpoint -> "
                  "hard failure)", file=sys.stderr)


def cmd_pipeline(args):
    """A whole track from the npz features, or with ``--corpus`` from both
    modalities extracted on the device: the audio and text branch trainers,
    then the fusion from each fold's gated branch params."""
    _pipeline_summary(args)
    return 0


def _pipeline_summary(args) -> dict:
    """The pipeline's body; returns the per-task fold metrics (also
    printed, rounded, as the last JSON line)."""
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.train import trainers
    from icassp2022_depression_tpu_torch.utils.logging import MetricsLogger

    _reject((
        ("--vmap-folds", args.vmap_folds, _TRAINER_REST),
        ("--fold-parallel", args.fold_parallel, _MULTI_GPU)))
    device = _device(args)
    root = Path(args.root)
    audio_dir, text_dir = _features_dirs(root)
    model_dir = Path(args.model_dir) if args.model_dir else root / "Model"
    if args.corpus:
        xa, sds, clf = afe.extract_eatd_device(Path(args.corpus),
                                                device=device)
        _require_speakers(sds, args.corpus)
        xt, _, _, text_meta = _corpus_text(args, text_dir, device)
        ya = yt = clf if args.track == "clf" else sds
    else:
        _require_features(audio_dir, "audio")
        _require_features(text_dir, "text")
        text_meta = _text_meta(text_dir)
        xa, ya = afe.load_features(audio_dir, args.track)
        xt, yt = tfe.load_features(text_dir, args.track)
    logger = MetricsLogger(model_dir / f"pipeline_{args.track}_metrics.jsonl")

    def _lr(tcfg):
        if not args.lr:
            return tcfg
        return C.replace(tcfg, optimizer=C.replace(tcfg.optimizer,
                                                   learning_rate=args.lr))

    kw = dict(seed=args.seed, device=device)
    if args.track == "clf":
        out = model_dir / "ClassificationWhole"
        tf_idx = _train_folds(ya, args.seed, args.idx_files)
        ra = trainers.train_audio_clf(xa, ya, tf_idx, _lr(C.AUDIO_CLF),
                                      out_dir=out / "Audio", **kw)
        rt = trainers.train_text_clf(xt, yt, tf_idx, _lr(C.TEXT_CLF),
                                     out_dir=out / "Text",
                                     meta_extras=text_meta, **kw)
        named = {"audio_clf": ra, "text_clf": rt}
        _warn_ungated(named)
        branch = [(t["best"]["params"], a["best"]["params"])
                  for t, a in zip(rt, ra)]
        named["fuse_clf"] = trainers.train_fuse_clf(
            xa, xt, ya, tf_idx, branch, C.FUSE_CLF, _lr(C.FUSE_CLF_TRAINER),
            out_dir=out / "Fuse", meta_extras=text_meta, **kw)
        metric = "f1"
    else:
        out = model_dir / "Regression"
        dep, non = folds.generate_reg_shuffles(ya, seed=args.seed)
        ra = trainers.train_audio_reg(xa, ya, dep, non, _lr(C.AUDIO_REG),
                                      out_dir=out, **kw)
        rt = trainers.train_text_reg(xt, yt, dep, non, _lr(C.TEXT_REG),
                                     out_dir=out, meta_extras=text_meta,
                                     **kw)
        named = {"audio_reg": ra, "text_reg": rt}
        _warn_ungated(named)
        branch = [(t["best"]["params"], a["best"]["params"])
                  for t, a in zip(rt, ra)]
        named["fuse_reg"] = trainers.train_fuse_reg(
            xa, xt, ya, dep, non, branch, C.FUSE_REG,
            _lr(C.FUSE_REG_TRAINER), out_dir=out, meta_extras=text_meta,
            **kw)
        metric = "mae"
    for name, results in named.items():
        for r in results:
            logger.log_fold(name, r["fold"], r["logs"], r["best"])
    summary = {f"{name.split('_')[0]}_{metric}":
               [float(r["best"][metric]) for r in results]
               for name, results in named.items()}
    print(json.dumps({k: [round(v, 4) for v in vs]
                      for k, vs in summary.items()}))
    return summary


def _corpus_audio(corpus: Path, device):
    """The corpus's wav2vlad features [N, 3, 256] on the host, SDS and clf
    targets (no npz written)."""
    from icassp2022_depression_tpu_torch.frontend import audio as afe

    feats, sds, clf, _ = afe.extract_eatd(corpus, device=device)
    _require_speakers(sds, corpus)
    return np.squeeze(feats, axis=2), sds, clf


def _corpus_text_host(args, corpus: Path, device):
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    return tfe.extract_eatd(corpus, seed=args.seed,
                            elmo_weights=args.elmo_weights,
                            segmenter=args.segmenter, device=device)


def cmd_check(args):
    """The reference's ``*ModelChecking.py``: recompute each fold's metrics
    from its checkpoint."""
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    device = _device(args)
    root = Path(args.root)
    audio_dir, text_dir = _features_dirs(root)
    ckpts = [Path(p) for p in args.ckpts]
    # "" (an unset shell variable) means no corpus, as absent does
    corpus = Path(args.corpus) if args.corpus else None
    if corpus is not None:
        # the features of train/pipeline --corpus checkpoints, extracted
        # anew (same math, ordinals and embedder resolution); every task
        # but text_clf needs the audio side, whose SDS are the reg targets
        if args.task != "text_clf":
            cfeat, csds, cclf = _corpus_audio(corpus, device)
        if args.task.startswith(("text", "fuse")):
            tfeat, tsds, tclf = _corpus_text_host(args, corpus, device)

    def _audio(track):
        if corpus is not None:
            return cfeat, (cclf if track == "clf" else csds)
        return afe.load_features(audio_dir, track)

    def _text(track):
        if corpus is not None:
            return tfeat, (tclf if track == "clf" else tsds)
        return tfe.load_features(text_dir, track)

    kw = {"device": device}
    if args.task == "audio_clf":
        x, y = _audio("clf")
        tf_idx = _train_folds(y, args.seed, args.idx_files)
        results, summary = checking.check_audio_clf(x, y, tf_idx, ckpts,
                                                    **kw)
    elif args.task == "text_clf":
        x, y = _text("clf")
        tf_idx = _train_folds(y, args.seed, args.idx_files)
        results, summary = checking.check_text_clf(x, y, tf_idx, ckpts,
                                                   **kw)
    elif args.task == "fuse_clf":
        xa, ya = _audio("clf")
        xt, _ = _text("clf")
        tf_idx = _train_folds(ya, args.seed, args.idx_files)
        results, summary = checking.check_fuse_clf(xa, xt, ya, tf_idx,
                                                   ckpts, **kw)
    else:
        xa, ya = _audio("reg")
        dep, non = folds.generate_reg_shuffles(ya, seed=args.seed)
        if args.task == "audio_reg":
            results, summary = checking.check_audio_reg(xa, ya, dep, non,
                                                        ckpts, **kw)
        elif args.task == "text_reg":
            xt, yt = _text("reg")
            results, summary = checking.check_text_reg(xt, yt, dep, non,
                                                       ckpts, **kw)
        else:
            xt, _ = _text("reg")
            results, summary = checking.check_fuse_reg(xa, xt, ya, dep, non,
                                                       ckpts, **kw)
    for r in results:
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("confusion_matrix", "predictions")}))
    print(json.dumps({"mean": summary}))
    return 0


def cmd_export_pt(args):
    """A checkpoint (npz of either package, or a reference ``.pt``) ->
    a reference-layout state-dict ``.pt`` that the reference module loads
    with ``load_state_dict(torch.load(out), strict=True)``."""
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.train import checkpoints

    kind, mcfg = model_kind(args.task), model_config(args.task)
    model = checkpoints.load_model(args.ckpt, kind, mcfg, "cpu")
    sd = porting.export_reference_pt(model, kind, mcfg, args.out)
    print(json.dumps({"exported": str(args.out), "task": args.task,
                      "kind": kind, "tensors": len(sd)}))
    return 0


#: the reference's real-corpus metric bands (``BASELINE.md``; two
#: checkpoint sets per branch task where the reference records both)
PARITY_BANDS = {
    "audio_f1": (0.60, 0.67), "text_f1": (0.62, 0.67),
    "fuse_f1": (0.62, 0.69),
    "audio_mae": (7.60, 8.38), "text_mae": (7.75, 8.46),
}


def check_parity_bands(report: dict):
    """Fold-metric report -> (rc, rows), each row ``(key, vals, mean,
    (lo, hi), in_band)``.  An F1 mean must lie within +-0.05 of its band,
    an MAE mean at most 0.5 above the band's top (lower is better).  rc is
    0 when every reported metric is in its band, else 1."""
    rc = 0
    rows = []
    for key, band in PARITY_BANDS.items():
        vals = report.get(key)
        if not vals:
            continue
        mean = sum(vals) / len(vals)
        lo, hi = band
        in_band = lo - 0.05 <= mean <= hi + 0.05 if "f1" in key else \
            mean <= hi + 0.5
        rows.append((key, vals, mean, band, in_band))
        if not in_band:
            rc = 1
    return rc, rows


#: ``BASELINE.md``'s rows: (report key, metric label, the reference's fold
#: values per published checkpoint set, source file:line in the
#: reference).  fuse_mae has no published folds, only the save floor, so
#: it is reported for information.
PARITY_TABLE_ROWS = (
    ("audio_f1", "Audio GRU clf F1, 3 folds",
     ((0.67, 0.67, 0.63), (0.63, 0.65, 0.60)),
     "Classification/fuse_net_whole.py:525; FuseModelChecking.py:11"),
    ("text_f1", "Text BiLSTM clf F1, 3 folds",
     ((0.64, 0.66, 0.62), (0.67, 0.66, 0.66)),
     "Classification/fuse_net_whole.py:524; FuseModelChecking.py:10"),
    ("fuse_f1", "Fusion clf F1, 3 folds", ((0.69, 0.68, 0.62),),
     "Classification/FuseModelChecking.py:12"),
    ("audio_mae", "Audio reg SDS MAE, 3 folds", ((7.60, 8.38, 8.25),),
     "Regression/fuse_net.py:34"),
    ("text_mae", "Text reg SDS MAE, 3 folds", ((7.75, 8.46, 8.01),),
     "Regression/fuse_net.py:33"),
    ("fuse_mae", "Fusion reg SDS MAE (save floor < 8.2)", None,
     "Regression/fuse_net.py:448"),
)


def _fmt_folds(vals) -> str:
    """``0.69 / 0.68 / 0.62 (mean ≈ 0.663)``, as ``BASELINE.md`` writes."""
    mean = sum(vals) / len(vals)
    return (" / ".join(f"{v:.2f}" for v in vals)
            + f" (mean ≈ {mean:.3f})")


def parity_report_markdown(report: dict, band_rows=None) -> str:
    """A fold-metric report as ``BASELINE.md``'s acceptance table: one row
    per published metric, this run's folds and mean beside the
    reference's, PASS / FLAG by :func:`check_parity_bands` (``info`` where
    there is no band, ``(not measured)`` where the report lacks the key).
    ``band_rows``: :func:`check_parity_bands`'s rows, when computed
    already."""
    if band_rows is None:
        _, band_rows = check_parity_bands(report)
    status_by_key = {key: in_band for key, *_r, in_band in band_rows}
    lines = [
        "| Metric | This build | Reference | Source (file:line) | Status |",
        "|---|---|---|---|---|",
    ]
    for key, label, ref_sets, source in PARITY_TABLE_ROWS:
        vals = report.get(key)
        ours = _fmt_folds(vals) if vals else "(not measured)"
        ref = ("; ".join(_fmt_folds(rs) for rs in ref_sets)
               if ref_sets else "save floor < 8.2, no published folds")
        if not vals:
            status = "—"
        elif key in status_by_key:
            status = "PASS" if status_by_key[key] else "FLAG"
        else:
            status = "info"
        lines.append(f"| {label} | {ours} | {ref} | {source} | {status} |")
    return "\n".join(lines)


#: the reference's ``Model/`` file names: clf names end in
#: ``_{metric:.2f}_{fold}`` (``audio_gru_whole.py:239``), reg names in
#: ``_{metric:.2f}`` with the fold in the directory
#: (``Regression/{Audio,Text,Fuse}{fold}/``, ``audio_bilstm_perm.py:208``)
_CLF_CKPT_RE = re.compile(r"^(?P<base>.+?)_(?P<metric>\d+(?:\.\d+)?)"
                          r"_(?P<fold>[123])$")
_REG_CKPT_RE = re.compile(r"^(?P<base>.+?)_(?P<metric>\d+(?:\.\d+)?)$")
_REG_DIR_RE = re.compile(r"^(?P<kind>Audio|Text|Fuse)(?P<fold>[123])$")


def _ckpt_modality(base: str) -> str:
    b = base.lower()
    if b.startswith("fuse"):
        return "fuse"
    # audio names carry the embedder: BiLSTM_gru_vlad256_256 /
    # gru_vlad256_256; a plain BiLSTM_{hidden} is the text branch
    return "audio" if ("vlad" in b or "gru" in b) else "text"


def _discover_reference_ckpts(ckpt_dir: Path) -> dict:
    """A reference ``Model/`` tree (its root, ``Model/`` itself or a flat
    directory of clf names) -> ``{task: [fold 1, 2, 3 paths]}``, ``.pt``
    and ``.npz`` alike.  Of several saves of a fold the best metric wins
    (max F1, min MAE: the file the reference's checking scripts name);
    only tasks with all three folds are returned, partial sets warn."""
    best: dict = {}   # (task, fold) -> (metric, path)

    def _offer(task, fold, metric, path):
        key = (task, fold)
        if key in best:
            old = best[key][0]
            if (metric <= old) if task.endswith("clf") else (metric >= old):
                return
        best[key] = (metric, path)

    for p in sorted(Path(ckpt_dir).rglob("*")):
        if p.suffix not in (".pt", ".npz") or not p.is_file():
            continue
        stem = p.stem
        mc = _CLF_CKPT_RE.match(stem)
        if mc:   # the fold in the file name: classification
            task = f"{_ckpt_modality(mc.group('base'))}_clf"
            _offer(task, int(mc.group("fold")), float(mc.group("metric")), p)
            continue
        regdir = _REG_DIR_RE.match(p.parent.name)
        mr = _REG_CKPT_RE.match(stem)
        if regdir and mr:   # the fold in the directory: regression
            task = f"{regdir.group('kind').lower()}_reg"
            _offer(task, int(regdir.group("fold")),
                   float(mr.group("metric")), p)
    found: dict = {}
    for task in TASKS:
        paths = [best.get((task, f)) for f in (1, 2, 3)]
        if all(p is not None for p in paths):
            found[task] = [p[1] for p in paths]
        elif any(p is not None for p in paths):
            have = [f for f in (1, 2, 3) if best.get((task, f))]
            print(f"parity: {task} has checkpoints only for folds {have} "
                  "— need all 3, skipping", file=sys.stderr)
    return found


def _report_from_ckpts(args) -> dict:
    """Score a discovered reference ``Model/`` tree with the checking
    harness (no training): the acceptance path of the reference's released
    ``.pt`` checkpoints (``FuseModelChecking.py:10-12`` names them)."""
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    found = _discover_reference_ckpts(Path(args.ckpt_dir))
    if not found:
        raise SystemExit(f"parity: no reference-layout checkpoints under "
                         f"{args.ckpt_dir} (expected "
                         "ClassificationWhole/{Audio,Text,Fuse}/"
                         "<name>_<metric>_<fold>.pt and/or "
                         "Regression/{Audio,Text,Fuse}<fold>/"
                         "<name>_<metric>.pt)")
    print("parity: checking " + ", ".join(
        f"{t} ({', '.join(p.name for p in ps)})"
        for t, ps in sorted(found.items())), file=sys.stderr)
    device = _device(args)
    corpus = Path(args.corpus) if args.corpus else None
    root = Path(args.root or corpus)
    audio_dir, text_dir = _features_dirs(root)
    cache: dict = {}

    def _audio(track):
        key = ("a", track)
        if key not in cache:
            if corpus:
                feat, sds, clf = _corpus_audio(corpus, device)
                cache[("a", "clf")] = (feat, clf)
                cache[("a", "reg")] = (feat, sds)
            else:
                cache[key] = afe.load_features(audio_dir, track)
        return cache[key]

    def _text(track):
        key = ("t", track)
        if key not in cache:
            if corpus:
                feat, sds, clf = _corpus_text_host(args, corpus, device)
                cache[("t", "clf")] = (feat, clf)
                cache[("t", "reg")] = (feat, sds)
            else:
                cache[key] = tfe.load_features(text_dir, track)
        return cache[key]

    kw = {"device": device}
    report: dict = {}
    clf_tasks = [t for t in found if t.endswith("clf")]
    if clf_tasks:
        y = (_audio if any(t.startswith(("audio", "fuse"))
                           for t in clf_tasks) else _text)("clf")[1]
        tf_idx = _train_folds(y, args.seed, args.idx_files)
        if "audio_clf" in found:
            x, ya = _audio("clf")
            res, _ = checking.check_audio_clf(x, ya, tf_idx,
                                              found["audio_clf"], **kw)
            report["audio_f1"] = [r["f1"] for r in res]
        if "text_clf" in found:
            x, yt = _text("clf")
            res, _ = checking.check_text_clf(x, yt, tf_idx,
                                             found["text_clf"], **kw)
            report["text_f1"] = [r["f1"] for r in res]
        if "fuse_clf" in found:
            xa, ya = _audio("clf")
            xt, _yt = _text("clf")
            res, _ = checking.check_fuse_clf(xa, xt, ya, tf_idx,
                                             found["fuse_clf"], **kw)
            report["fuse_f1"] = [r["f1"] for r in res]
    if any(t.endswith("reg") for t in found):
        xa, ya = _audio("reg")
        dep, non = folds.generate_reg_shuffles(ya, seed=args.seed)
        if "audio_reg" in found:
            res, _ = checking.check_audio_reg(xa, ya, dep, non,
                                              found["audio_reg"], **kw)
            report["audio_mae"] = [r["mae"] for r in res]
        if "text_reg" in found:
            xt, yt = _text("reg")
            res, _ = checking.check_text_reg(xt, yt, dep, non,
                                             found["text_reg"], **kw)
            report["text_mae"] = [r["mae"] for r in res]
        if "fuse_reg" in found:
            xt, _yt = _text("reg")
            res, _ = checking.check_fuse_reg(xa, xt, ya, dep, non,
                                             found["fuse_reg"], **kw)
            report["fuse_mae"] = [r["mae"] for r in res]
    return report


def cmd_parity(args):
    """The real-corpus parity report against ``BASELINE.md``'s bands, as
    its markdown acceptance table: of a saved report (``--from-report``,
    the first line this command prints), of a reference ``Model/`` tree
    of ``.pt`` or npz checkpoints (``--ckpt-dir``), or of both tracks
    trained anew with the reference configurations."""
    _reject((("--vmap-folds", args.vmap_folds, _TRAINER_REST),))
    # an acceptance run from a raw corpus keeps Model/ under the corpus
    root = args.root or args.corpus
    if args.from_report:
        report = json.loads(Path(args.from_report).read_text())
    elif args.ckpt_dir:
        if not root:
            raise SystemExit("parity --ckpt-dir: also pass --root (with "
                             "Features/ npz) and/or --corpus (re-extract) "
                             "so the checking harness has features")
        report = _report_from_ckpts(args)
    elif not root:
        raise SystemExit("parity: --root and/or --corpus (train + check) "
                         "or --from-report (re-check a saved report) is "
                         "required")
    else:
        report = {}
        for track in ("clf", "reg"):
            ns = argparse.Namespace(
                track=track, root=root, model_dir=args.model_dir,
                idx_files=args.idx_files, seed=args.seed, lr=None,
                vmap_folds=False, fold_parallel=False, corpus=args.corpus,
                segmenter=args.segmenter, elmo_weights=args.elmo_weights,
                device=args.device)
            report.update(_pipeline_summary(ns))
    if not any(report.get(k) for k in PARITY_BANDS):
        # a band check that looked at no metric must not print PASS
        raise SystemExit("parity: the report contains none of the band "
                         "metrics (" + ", ".join(PARITY_BANDS) + ") — "
                         "nothing to check")
    print(json.dumps(report))
    rc, rows = check_parity_bands(report)
    print(parity_report_markdown(report, rows))
    print("PARITY: " + ("PASS" if rc == 0 else "FAIL"))
    return rc


_DEVICE_HELP = ("torch device (default cuda; without a card this raises "
                "unless --device cpu is given)")


def build_parser():
    p = argparse.ArgumentParser(prog="icassp2022_depression_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("synth-corpus", help="write a synthetic EATD corpus")
    sp.add_argument("--root", required=True)
    sp.add_argument("--n-data", type=int, default=20)
    sp.add_argument("--n-validation", type=int, default=8)
    sp.add_argument("--seconds", type=float, default=2.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_synth_corpus)

    sp = sub.add_parser("extract-audio", help="EATD audio features "
                        "(wav2vlad)")
    sp.add_argument("--root", required=True)
    sp.add_argument("--out")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    # the JAX CLI's VGGish options arrive with item 17 (cmd_extract_audio)
    sp.add_argument("--embedder", choices=["netvlad", "vggish"],
                    default="netvlad")
    sp.add_argument("--vggish-ckpt")
    sp.add_argument("--pca-params")
    sp.set_defaults(fn=cmd_extract_audio)

    sp = sub.add_parser("extract-text", help="EATD text features")
    sp.add_argument("--root", required=True)
    sp.add_argument("--out")
    sp.add_argument("--seed", type=int, default=0,
                    help="seed of the stand-in encoder (no bundle)")
    sp.add_argument("--elmo-weights", default="auto",
                    help="converted ELMoForManyLangs bundle (npz); 'auto' "
                         "takes ICASSP_ELMO_WEIGHTS when set, else "
                         "~/.cache/icassp2022_tpu/elmo_zhs.npz when present, "
                         "else the seeded stand-in; '' the seeded stand-in")
    sp.add_argument("--segmenter", default="auto",
                    help="Chinese word segmenter: auto (jieba when "
                         "installed, else fallback), jieba, fallback, "
                         "pkuseg, thulac, hanlp")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    # the JAX CLI's options that later slices bring (see _reject_text_modes)
    sp.add_argument("--elmo-stateful", action="store_true")
    sp.add_argument("--elmo-tp", type=int, default=0)
    sp.set_defaults(fn=cmd_extract_text)

    sp = sub.add_parser("train", help="train one branch task's 3 folds")
    sp.add_argument("--task", required=True,
                    choices=["audio_clf", "text_clf", "audio_reg",
                             "text_reg"])
    sp.add_argument("--root", required=True)
    sp.add_argument("--model-dir")
    sp.add_argument("--idx-files", nargs="*")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--corpus",
                    help="extract the task's features (wav2vlad audio or "
                         "ELMo text) from this EATD corpus dir and train on "
                         "them where they lie (no npz)")
    sp.add_argument("--segmenter", default="auto",
                    help="with --corpus on text tasks: see extract-text")
    sp.add_argument("--elmo-weights", default="auto",
                    help="with --corpus on text tasks: see extract-text")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    # the JAX CLI's options that later slices bring (see _reject_unported)
    sp.add_argument("--audio-dim", type=int, default=256)
    sp.add_argument("--resume-dir")
    sp.add_argument("--chunk-epochs", type=int)
    sp.add_argument("--vmap-folds", action="store_true")
    sp.add_argument("--fold-parallel", action="store_true")
    sp.add_argument("--data-parallel", type=int, default=1)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("pipeline", help="a whole track incl. fusion")
    sp.add_argument("--track", required=True, choices=["clf", "reg"])
    sp.add_argument("--root", required=True)
    sp.add_argument("--model-dir")
    sp.add_argument("--idx-files", nargs="*")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--lr", type=float, default=None,
                    help="override every trainer's learning rate (default: "
                         "the reference values)")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    sp.add_argument("--corpus",
                    help="extract both modalities from this EATD corpus dir "
                         "on the device instead of reading npz features")
    sp.add_argument("--segmenter", default="auto",
                    help="with --corpus: see extract-text")
    sp.add_argument("--elmo-weights", default="auto",
                    help="with --corpus: see extract-text")
    # the JAX CLI's options that later slices bring (see cmd_pipeline)
    sp.add_argument("--vmap-folds", action="store_true")
    sp.add_argument("--fold-parallel", action="store_true")
    sp.set_defaults(fn=cmd_pipeline)

    sp = sub.add_parser("predict", help="serve one speaker from a checkpoint")
    sp.add_argument("--task", required=True, choices=list(TASKS))
    sp.add_argument("--root", required=True)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--speaker", required=True,
                    help="e.g. Data/5 or ValidationData/12")
    sp.add_argument("--segmenter", default=None,
                    help="override the text segmenter (default: adopt the "
                         "one recorded by the checkpoint's training "
                         "features)")
    sp.add_argument("--embed-seed", type=int, default=None,
                    help="seed of the stand-in text encoder (default 0)")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser("check", help="recompute fold metrics from "
                        "checkpoints")
    sp.add_argument("--task", required=True, choices=list(TASKS))
    sp.add_argument("--root", required=True)
    sp.add_argument("--ckpts", nargs="+", required=True,
                    help="one checkpoint per fold, in fold order (npz of "
                         "either package, or a reference .pt)")
    sp.add_argument("--idx-files", nargs="*")
    sp.add_argument("--corpus",
                    help="extract the needed features from this EATD "
                         "corpus dir anew instead of reading the npz "
                         "features (the checkpoints of train/pipeline "
                         "--corpus)")
    sp.add_argument("--segmenter", default="auto",
                    help="with --corpus on text/fusion tasks: see "
                         "extract-text")
    sp.add_argument("--elmo-weights", default="auto",
                    help="with --corpus on text/fusion tasks: see "
                         "extract-text")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    sp.set_defaults(fn=cmd_check)

    sp = sub.add_parser("export-pt", help="export a checkpoint as a "
                        "reference-layout torch state-dict .pt")
    sp.add_argument("--task", required=True, choices=list(TASKS))
    sp.add_argument("--ckpt", required=True,
                    help="an npz checkpoint (or a .pt to write anew as a "
                         "state-dict pickle)")
    sp.add_argument("--out", required=True, help="output .pt path")
    sp.set_defaults(fn=cmd_export_pt)

    sp = sub.add_parser("parity", help="real-corpus parity report against "
                        "BASELINE.md")
    sp.add_argument("--root")
    sp.add_argument("--model-dir")
    sp.add_argument("--idx-files", nargs="*",
                    help="the reference's persisted train_idxs_*.npy")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--corpus",
                    help="extract both modalities from this EATD corpus "
                         "dir on the device (no Features/ npz needed)")
    sp.add_argument("--segmenter", default="auto")
    sp.add_argument("--elmo-weights", default="auto")
    sp.add_argument("--from-report",
                    help="check the bands of a saved report JSON instead "
                         "of training")
    sp.add_argument("--ckpt-dir",
                    help="score a reference Model/ tree of .pt (or npz) "
                         "checkpoints instead of training")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    # the JAX CLI's option that item 19 brings (see cmd_parity)
    sp.add_argument("--vmap-folds", action="store_true")
    sp.set_defaults(fn=cmd_parity)
    return p


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
