"""Command line of the port (counterpart of
:mod:`icassp2022_depression_tpu.cli`, the subcommands of the ported slices).

  python -m icassp2022_depression_tpu_torch.cli synth-corpus --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli extract-audio --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli extract-audio --root ./corpus \\
      --embedder vggish [--vggish-ckpt CKPT] [--pca-params P.npz]
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
  python -m icassp2022_depression_tpu_torch.cli serve --task audio_clf \\
      --ckpt ckpt.npz [--batch-window-ms 5 --max-batch 32 --max-queue 128]
  python -m icassp2022_depression_tpu_torch.cli extract-daic \\
      --daic-dir ./daic --split-csv train_split.csv --out ./DaicFeatures
  python -m icassp2022_depression_tpu_torch.cli train-daic --track clf \\
      (--features ./DaicFeatures | --daic-dir ./daic --train-csv A \\
      --eval-csv B) --model-dir ./Model
  python -m icassp2022_depression_tpu_torch.cli check-daic --track clf \\
      --ckpt Model/daic_clf_0.67 (--features ./DaicFeatures | --daic-dir \\
      ./daic --eval-csv B)
  python -m icassp2022_depression_tpu_torch.cli predict-daic \\
      --task daic_clf --ckpt Model/daic_clf_0.67 --daic-dir ./daic \\
      --participant 300
  python -m icassp2022_depression_tpu_torch.cli baselines --task audio_clf \\
      --root ./corpus --model rf

Every subcommand that computes runs on ``--device`` (default ``cuda``); on
a machine without a card it raises unless ``--device cpu`` is given.
``train --fold-parallel [--data-parallel N]`` and ``pipeline
--fold-parallel`` run on 3 (3 x N) ranks, ``extract-text --elmo-tp N`` and
``extract-daic --multimodal --elmo-tp N`` on N (:func:`main`): one rank a
card over NCCL, Gloo ranks on the CPU with ``--device cpu``, or the ranks
of a ``torchrun`` launch; rank 0 writes the files and the output.
``synth-corpus`` and ``export-pt`` run no model and take no device;
``baselines`` runs sklearn on the host.

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
npz files and ``manifest.json``; ``--embedder vggish`` the ``_128`` files
of the VGGish embedder, whose checkpoints ``train --audio-dim 128`` trains
and ``predict`` / ``serve --audio-embedder vggish`` serve).
``extract-text --elmo-stateful`` carries the biLM state across speakers
as upstream's persistent embedder does.  ``baselines`` prints the fold
mean of a sklearn baseline on the npz features.  ``check`` recomputes each fold's
metrics from its checkpoint (npz of either package, or a reference
``.pt``) on the npz features or, with ``--corpus``, on features extracted
anew, and prints one JSON line per fold and one of their mean.
``export-pt`` writes a checkpoint as a reference-layout state-dict
``.pt``.  ``parity`` prints the ``BASELINE.md`` acceptance table of a
saved report (``--from-report``), of a reference ``Model/`` tree of
checkpoints (``--ckpt-dir``) or of both tracks trained anew.  The lines
printed are the JAX CLI's.

``serve`` runs the HTTP front (:mod:`.serving.transport`) around one
checkpoint of any EATD task or of a DAIC model (``--task daic_clf|
daic_reg``).  ``extract-daic`` writes a DAIC split's features in the
reference's layout (``--multimodal``: the per-response text too);
``train-daic`` trains on two such splits or, with ``--daic-dir``, on
features extracted on the device (no npz); ``check-daic`` recomputes a
DAIC checkpoint's eval-split metrics; ``predict-daic`` serves one raw
session.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from icassp2022_depression_tpu_torch.parallel import distributed
from icassp2022_depression_tpu_torch.serving.predictors import (
    TASKS,
    DaicPredictor,
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

    root = Path(args.root)
    out = Path(args.out) if args.out else root / "Features" / "AudioWhole"
    device = _device(args)
    if args.embedder == "vggish":
        from icassp2022_depression_tpu_torch.models import vggish

        params = post = None
        if args.vggish_ckpt:
            params = vggish.from_tf_checkpoint(args.vggish_ckpt)
        else:
            bundle = vggish.default_weights_path()
            if bundle is not None:   # a converted bundle loads itself
                params, post = vggish.load_npz(bundle, device)
                print(f"extract-audio: auto-loaded VGGish bundle {bundle}",
                      file=sys.stderr)
        if args.pca_params:          # the explicit flag wins over the bundle's
            post = vggish.load_pca_params(args.pca_params)
        feats, _, clf, manifest = afe.extract_eatd_vggish(
            root, params=params, postprocessor=post, out_dir=out,
            device=device)
    else:
        feats, _, clf, manifest = afe.extract_eatd(root, out_dir=out,
                                                   device=device)
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
    p = Predictor.from_checkpoint(args.ckpt, args.task, **kw,
                                  **_embedder_kw(args))
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


def cmd_extract_text(args):
    """EATD text features -> ``<out>`` (default ``<root>/Features/
    TextWhole``) in the JAX package's layout."""
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    root = Path(args.root)
    out = Path(args.out) if args.out else root / "Features" / "TextWhole"
    feats, _, _ = tfe.extract_eatd(root, out_dir=out, seed=args.seed,
                                   elmo_weights=args.elmo_weights,
                                   segmenter=args.segmenter,
                                   device=_device(args),
                                   elmo_stateful=args.elmo_stateful,
                                   elmo_tp=args.elmo_tp)
    print(f"text features {feats.shape} -> {out}")
    return 0


def _embedder_kw(args) -> dict:
    """predict / serve: ``--audio-embedder vggish`` (audio tasks only) as
    :class:`Predictor` kwargs, with the 128-d input layer and the weights
    and postprocessor that extraction used."""
    if args.audio_embedder != "vggish":
        return {}
    if not args.task.startswith("audio"):
        raise SystemExit(
            "--audio-embedder vggish is supported for audio_* tasks only "
            "(fusion/DAIC checkpoints train on wav2vlad features; serve "
            "those with the default embedder)")
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.models import vggish

    kw = {"audio_embedder": "vggish",
          "model_cfg": C.replace(model_config(args.task),
                                 embedding_size=vggish.EMBEDDING_SIZE)}
    if args.vggish_ckpt:
        kw["vggish_params"] = vggish.from_tf_checkpoint(args.vggish_ckpt)
    if args.pca_params:
        kw["vggish_postprocessor"] = vggish.load_pca_params(args.pca_params)
    return kw


def _fold_kw(args) -> dict:
    """The trainers' fold options of ``train``: chunked execution with a
    resume bundle (``--chunk-epochs`` counts only with ``--resume-dir``,
    as in the JAX CLI), ``--vmap-folds``, and ``--fold-parallel`` /
    ``--data-parallel`` (over the ranks :func:`main` launched)."""
    kw = {"vmap_folds": args.vmap_folds,
          "fold_parallel": args.fold_parallel,
          "data_parallel": args.data_parallel}
    if args.resume_dir:
        kw.update(resume_dir=Path(args.resume_dir),
                  chunk_epochs=args.chunk_epochs)
    return kw


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

    if args.data_parallel > 1 and not args.fold_parallel:
        raise SystemExit("--data-parallel requires --fold-parallel "
                         "(it shards each fold's batch over that fold's "
                         "device group)")
    audio_dim = args.audio_dim if args.task.startswith("audio") else 256
    if args.corpus and audio_dim != 256:
        raise SystemExit("--corpus always extracts 256-d wav2vlad "
                         "features; --audio-dim must stay 256")
    device = _device(args)
    root = Path(args.root)
    audio_dir, text_dir = _features_dirs(root)
    model_dir = Path(args.model_dir) if args.model_dir else root / "Model"
    logger = MetricsLogger(model_dir / f"{args.task}_metrics.jsonl",
                           echo=args.verbose)
    track = "clf" if args.task.endswith("clf") else "reg"
    # resolved at call time, so a changed preset is what trains
    tcfg = getattr(C, args.task.upper())
    if audio_dim != 256:
        # another embedder's features (extract-audio --embedder vggish:
        # 128-d): the model's input layer takes their width
        tcfg = C.replace(tcfg, model=C.replace(tcfg.model,
                                               embedding_size=audio_dim))
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
        x, y = afe.load_features(audio_dir, track, dim=audio_dim)
    fn = {"audio_clf": trainers.train_audio_clf,
          "text_clf": trainers.train_text_clf,
          "audio_reg": trainers.train_audio_reg,
          "text_reg": trainers.train_text_reg}[args.task]
    if track == "clf":
        sub = "Audio" if args.task == "audio_clf" else "Text"
        results = fn(x, y, _train_folds(y, args.seed, args.idx_files),
                     tcfg=tcfg,
                     out_dir=model_dir / "ClassificationWhole" / sub,
                     seed=args.seed, device=device, **text_kw,
                     **_fold_kw(args))
    else:
        dep, non = folds.generate_reg_shuffles(y, seed=args.seed)
        results = fn(x, y, dep, non, tcfg=tcfg,
                     out_dir=model_dir / "Regression", seed=args.seed,
                     device=device, **text_kw, **_fold_kw(args))
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
    # the branches (and the reg fusion) as one stacked program, over the
    # launched ranks with --fold-parallel; the clf fusion chains its
    # folds, so it stays serial (on every rank), as in the JAX CLI
    vmap = dict(vmap_folds=args.vmap_folds, fold_parallel=args.fold_parallel)
    if args.track == "clf":
        out = model_dir / "ClassificationWhole"
        tf_idx = _train_folds(ya, args.seed, args.idx_files)
        ra = trainers.train_audio_clf(xa, ya, tf_idx, _lr(C.AUDIO_CLF),
                                      out_dir=out / "Audio", **kw, **vmap)
        rt = trainers.train_text_clf(xt, yt, tf_idx, _lr(C.TEXT_CLF),
                                     out_dir=out / "Text",
                                     meta_extras=text_meta, **kw, **vmap)
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
                                      out_dir=out, **kw, **vmap)
        rt = trainers.train_text_reg(xt, yt, dep, non, _lr(C.TEXT_REG),
                                     out_dir=out, meta_extras=text_meta,
                                     **kw, **vmap)
        named = {"audio_reg": ra, "text_reg": rt}
        _warn_ungated(named)
        branch = [(t["best"]["params"], a["best"]["params"])
                  for t, a in zip(rt, ra)]
        named["fuse_reg"] = trainers.train_fuse_reg(
            xa, xt, ya, dep, non, branch, C.FUSE_REG,
            _lr(C.FUSE_REG_TRAINER), out_dir=out, meta_extras=text_meta,
            **kw, **vmap)
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
                vmap_folds=args.vmap_folds, fold_parallel=False,
                corpus=args.corpus,
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


def cmd_extract_daic(args):
    """A DAIC split's features in the reference's layout (``--multimodal``:
    also the per-response text modality and ``extraction_meta.json``)."""
    from icassp2022_depression_tpu_torch.frontend import daic

    queries = Path(args.queries) if args.queries else None
    device = _device(args)
    if args.multimodal:
        features, _, _, _ = daic.extract_split_multimodal(
            Path(args.daic_dir), Path(args.split_csv), queries,
            out_prefix=Path(args.out), split_name=args.split_name,
            seed=args.seed, elmo_weights=args.elmo_weights,
            segmenter=args.segmenter, device=device, elmo_tp=args.elmo_tp)
    else:
        features, _, _ = daic.extract_split(
            Path(args.daic_dir), Path(args.split_csv), queries,
            out_prefix=Path(args.out), split_name=args.split_name,
            device=device)
    counts = [f.shape[0] for f in features]
    print(f"{len(features)} participants, responses per participant: "
          f"min {min(counts, default=0)} max {max(counts, default=0)} "
          f"-> {args.out}"
          + (" (+ text modality)" if args.multimodal else ""))
    return 0


def _daic_tcfg(track: str, dim: int):
    """The track's preset (resolved at call time) at input width ``dim``."""
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.train import daic as daic_train

    base = daic_train.DAIC_CLF if track == "clf" else daic_train.DAIC_REG
    return C.replace(base, model=C.replace(base.model, embedding_size=dim))


def cmd_train_daic(args):
    """Train on the AVEC2017 splits: from ``extract-daic`` npz features,
    or with ``--daic-dir`` from features extracted on the device."""
    from icassp2022_depression_tpu_torch.frontend import daic as daic_fe
    from icassp2022_depression_tpu_torch.train import daic as daic_train

    device = _device(args)
    meta_extras = None
    if args.daic_dir:
        if args.multimodal:
            raise SystemExit("--daic-dir (fused extract->train) is "
                             "audio-only - the text modality needs the "
                             "ELMo pipeline's artifacts (extract-daic "
                             "--multimodal first, then --features)")
        if not (args.train_csv and args.eval_csv):
            raise SystemExit("--daic-dir requires --train-csv and "
                             "--eval-csv (AVEC2017 split files)")
        if args.features:
            raise SystemExit("--daic-dir and --features are mutually "
                             "exclusive (fused vs persisted-npz path)")
        queries = Path(args.queries) if args.queries else None
        x_tr, cl_tr, rl_tr = daic_fe.extract_split_device(
            Path(args.daic_dir), Path(args.train_csv), queries,
            device=device)
        x_te, cl_te, rl_te = daic_fe.extract_split_device(
            Path(args.daic_dir), Path(args.eval_csv), queries,
            device=device)
        for split, labels, csv in (("train", cl_tr, args.train_csv),
                                   ("eval", cl_te, args.eval_csv)):
            if len(labels) == 0:
                raise SystemExit(
                    f"--daic-dir {args.daic_dir}: no participants "
                    f"extracted for the {split} split ({csv}) - check "
                    "the CSV's Participant_ID column against the "
                    "<id>_P/ session dirs")
        y_tr, y_te = ((cl_tr, cl_te) if args.track == "clf"
                      else (rl_tr, rl_te))
        dim = int(x_tr.flat.shape[-1])
    else:
        if not args.features:
            raise SystemExit("train-daic needs --features (persisted npz "
                             "prefix) or --daic-dir (fused "
                             "extract->train)")
        prefix = Path(args.features)
        if args.multimodal:
            xa_tr, xt_tr, y_tr = daic_fe.load_features(
                prefix, "train", args.track, True)
            xa_te, xt_te, y_te = daic_fe.load_features(
                prefix, args.eval_split, args.track, True)
            x_tr = daic_train.concat_multimodal(xa_tr, xt_tr)
            x_te = daic_train.concat_multimodal(xa_te, xt_te)
            # the text provenance of extract-daic's sidecar -> checkpoint
            # sidecar (DaicPredictor adopts segmenter and seed)
            meta_p = prefix / "extraction_meta.json"
            if meta_p.exists():
                m = json.loads(meta_p.read_text())
                meta_extras = {"text_embedder": m.get("embedder"),
                               "text_segmenter": m.get("segmenter"),
                               "text_seed": m.get("seed")}
        else:
            x_tr, y_tr = daic_fe.load_features(prefix, "train", args.track)
            x_te, y_te = daic_fe.load_features(prefix, args.eval_split,
                                               args.track)
        dim = x_tr[0].shape[-1] if x_tr else 0
    result = daic_train.train_daic(
        x_tr, y_tr, x_te, y_te, _daic_tcfg(args.track, dim),
        out_dir=Path(args.model_dir) if args.model_dir else None,
        seed=args.seed, meta_extras=meta_extras, device=device)
    print(json.dumps({k: round(v, 4) for k, v in result["best"].items()
                      if k != "params"}))
    return 0


def cmd_check_daic(args):
    """A DAIC checkpoint's eval-split metrics, from npz features or, with
    ``--daic-dir``, from the split extracted anew (the checkpoints of
    ``train-daic --daic-dir``)."""
    from icassp2022_depression_tpu_torch.frontend import daic as daic_fe
    from icassp2022_depression_tpu_torch.train import daic as daic_train

    device = _device(args)
    if args.daic_dir:
        if args.multimodal:
            raise SystemExit("--daic-dir re-extraction is audio-only "
                             "(multimodal needs extract-daic --multimodal "
                             "artifacts via --features)")
        if not args.eval_csv:
            raise SystemExit("--daic-dir requires --eval-csv")
        if args.features:
            raise SystemExit("--daic-dir and --features are mutually "
                             "exclusive")
        if args.eval_split is not None:
            raise SystemExit("--eval-split names a persisted npz split "
                             "and has no effect with --daic-dir (the "
                             "--eval-csv file alone selects the split)")
        queries = Path(args.queries) if args.queries else None
        x, cl, rl = daic_fe.extract_split(Path(args.daic_dir),
                                          Path(args.eval_csv), queries,
                                          device=device)
        y = cl if args.track == "clf" else rl
    elif args.features:
        if args.queries:
            raise SystemExit("--queries only applies to --daic-dir "
                             "re-extraction (persisted npz features are "
                             "already segmented)")
        prefix = Path(args.features)
        eval_split = args.eval_split or "test"
        if args.multimodal:
            xa, xt, y = daic_fe.load_features(prefix, eval_split,
                                              args.track, True)
            x = daic_train.concat_multimodal(xa, xt)
        else:
            x, y = daic_fe.load_features(prefix, eval_split, args.track)
    else:
        raise SystemExit("check-daic needs --features (persisted npz "
                         "prefix) or --daic-dir + --eval-csv")
    dim = x[0].shape[-1] if x else 0
    out = daic_train.check_daic(x, y, args.ckpt,
                                _daic_tcfg(args.track, dim), device=device)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


def _daic_embedder_kw(args) -> dict:
    """serve / predict-daic: the multimodal text embedder's flags as
    :class:`DaicPredictor` kwargs; 'auto' / None values are left out so
    that ``from_checkpoint``'s sidecar adoption decides."""
    kw = {}
    if getattr(args, "multimodal", False):
        kw["multimodal"] = True
    if getattr(args, "elmo_weights", "auto") != "auto":
        kw["elmo_weights"] = args.elmo_weights or None
    if getattr(args, "segmenter", None):
        kw["segmenter"] = args.segmenter
    if getattr(args, "embed_seed", None) is not None:
        kw["seed"] = args.embed_seed
    return kw


def cmd_predict_daic(args):
    """A PHQ8 prediction for one raw DAIC session from a ``train-daic``
    checkpoint."""
    p = DaicPredictor.from_checkpoint(args.ckpt, args.task,
                                      device=_device(args),
                                      **_daic_embedder_kw(args))
    result = p.predict_participant(
        Path(args.daic_dir), args.participant,
        queries_path=Path(args.queries) if args.queries else None,
        start_ordinal=args.start_ordinal)
    result["participant"] = args.participant
    print(json.dumps(result))
    return 0


def cmd_serve(args):
    """The HTTP front around one checkpoint (runs until interrupted)."""
    from icassp2022_depression_tpu_torch.serving import transport

    embedder_kw = _embedder_kw(args)   # vggish raises off the audio tasks
    device = _device(args)
    if args.task.startswith("daic"):
        predictor = DaicPredictor.from_checkpoint(
            args.ckpt, args.task, device=device, **_daic_embedder_kw(args))
        if predictor.multimodal:
            print("serve: multimodal DAIC model - requests must carry "
                  "per-response 'texts' aligned with responses_b64",
                  file=sys.stderr)
        if args.warmup:
            print("note: --warmup is a no-op for DAIC serving (shapes "
                  "depend on per-session response counts)",
                  file=sys.stderr)
    else:
        kw = {"device": device, **embedder_kw}
        # default: from_checkpoint adopts the sidecar's segmenter
        if args.segmenter:
            kw["segmenter"] = args.segmenter
        if args.embed_seed is not None:
            kw["seed"] = args.embed_seed
        predictor = Predictor.from_checkpoint(args.ckpt, args.task, **kw)
        if args.warmup:
            with transport.predictor_scope(predictor):
                predictor.warmup()
    transport.serve_http(predictor, args.host, args.port,
                         batch_window_ms=args.batch_window_ms,
                         max_batch=args.max_batch, max_queue=args.max_queue,
                         auth_token=args.auth_token,
                         tls_cert=args.tls_cert, tls_key=args.tls_key)
    return 0


def cmd_baselines(args):
    """The sklearn baselines of one task on the npz features, on the host
    (the card's machine has no sklearn): one JSON line of the fold mean,
    rounded as the JAX CLI rounds it."""
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.eval import traditional
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    audio_dir, text_dir = _features_dirs(Path(args.root))
    track = "clf" if args.task.endswith("_clf") else "reg"
    x, y = (afe.load_features(audio_dir, track)
            if args.task.startswith("audio")
            else tfe.load_features(text_dir, track))
    if track == "clf":
        _, summary = traditional.classify(
            x, y, _train_folds(y, args.seed, args.idx_files),
            model=args.model, seed=args.seed)
    else:
        dep, non = folds.generate_reg_shuffles(y, seed=args.seed)
        _, summary = traditional.regress(x, y, dep, non, model=args.model,
                                         seed=args.seed)
    print(json.dumps({k: round(v, 4) for k, v in summary.items()}))
    return 0


_DEVICE_HELP = ("torch device (default cuda; without a card this raises "
                "unless --device cpu is given)")
_SERVE_EMBEDDER_HELP = ("serve checkpoints trained on extract-audio "
                        "--embedder vggish features (audio tasks)")


def _vggish_args(sp, embedder_flag: str, embedder_help: str) -> None:
    """The audio embedder's options (extract-audio, predict, serve)."""
    sp.add_argument(embedder_flag, choices=["netvlad", "vggish"],
                    default="netvlad", help=embedder_help)
    sp.add_argument("--vggish-ckpt",
                    help="released vggish_model.ckpt to convert and use "
                         "(default: the bundle ICASSP_VGGISH_WEIGHTS or "
                         "~/.cache/icassp2022_tpu/vggish.npz names, else "
                         "the seeded stand-in)")
    sp.add_argument("--pca-params",
                    help="released vggish_pca_params.npz postprocessor "
                         "(wins over a bundle's)")


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
                        "(wav2vlad or VGGish)")
    sp.add_argument("--root", required=True)
    sp.add_argument("--out")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    _vggish_args(sp, "--embedder",
                 "netvlad = the reference's committed wav2vlad path (256-d); "
                 "vggish = its declared alternative to_vggish_embedds "
                 "(128-d, _128 npz suffix)")
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
    sp.add_argument("--elmo-stateful", action="store_true",
                    help="emulate upstream ElmobiLm's cross-batch state (one "
                         "sents2elmo call per speaker, biLM states carried "
                         "across speakers; needs a converted bundle)")
    sp.add_argument("--elmo-tp", type=int, default=0,
                    help="run the LSTMP biLM tensor-parallel over N ranks "
                         "(one a card over NCCL; with --device cpu, Gloo "
                         "ranks on the CPU); results match serial up to "
                         "the all-reduce's summation order. 0/1 = serial")
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
    sp.add_argument("--resume-dir",
                    help="run each fold in epoch chunks and commit a resume "
                         "bundle to this dir after each; a rerun continues "
                         "from it (bundles of the JAX package are not read)")
    sp.add_argument("--chunk-epochs", type=int, default=25,
                    help="epochs per chunk with --resume-dir")
    sp.add_argument("--vmap-folds", action="store_true",
                    help="train the 3 folds as one program (a fold axis in "
                         "every tensor and kernel)")
    sp.add_argument("--audio-dim", type=int, default=256,
                    help="audio feature width of the npz features (128: "
                         "extract-audio --embedder vggish); the model's "
                         "input layer takes it")
    sp.add_argument("--fold-parallel", action="store_true",
                    help="train the 3 folds on 3 ranks, one a card over "
                         "NCCL (with --device cpu, Gloo ranks on the CPU); "
                         "implies --vmap-folds")
    sp.add_argument("--data-parallel", type=int, default=1,
                    help="with --fold-parallel: ranks per fold, each "
                         "with its rows of every batch (3 x N ranks)")
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
    sp.add_argument("--vmap-folds", action="store_true",
                    help="train each branch's 3 folds (and the reg "
                         "fusion's) as one program; the clf fusion chains "
                         "its folds and stays serial")
    sp.add_argument("--fold-parallel", action="store_true",
                    help="each branch's folds (and the reg fusion's) on 3 "
                         "ranks, as train --fold-parallel")
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
                    help="seed of the stand-in text encoder and VGGish "
                         "weights (default 0)")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    _vggish_args(sp, "--audio-embedder", _SERVE_EMBEDDER_HELP)
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
    sp.add_argument("--vmap-folds", action="store_true",
                    help="train both tracks as pipeline --vmap-folds does")
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("extract-daic", help="DAIC-WOZ features")
    sp.add_argument("--daic-dir", required=True)
    sp.add_argument("--split-csv", required=True)
    sp.add_argument("--queries", default=None,
                    help="question-bank file (default: the bundled DAIC "
                         "table, data/daic_queries.txt)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--split-name", default="train")
    sp.add_argument("--multimodal", action="store_true",
                    help="also extract the per-response text modality "
                         "(the reference drops it)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--elmo-weights", default="auto")
    sp.add_argument("--segmenter", default="auto",
                    help="text-modality segmenter (--multimodal only; see "
                         "extract-text --segmenter)")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    sp.add_argument("--elmo-tp", type=int, default=0,
                    help="tensor-parallel biLM for the text modality "
                         "(--multimodal only; see extract-text --elmo-tp)")
    sp.set_defaults(fn=cmd_extract_daic)

    sp = sub.add_parser("train-daic", help="DAIC-WOZ downstream training")
    sp.add_argument("--track", required=True, choices=["clf", "reg"])
    sp.add_argument("--daic-dir",
                    help="fused extract->train from a raw DAIC directory: "
                         "one extraction pass per split on the device "
                         "(requires --train-csv/--eval-csv; audio-only; no "
                         "npz written)")
    sp.add_argument("--train-csv",
                    help="AVEC2017 train split CSV (with --daic-dir)")
    sp.add_argument("--eval-csv",
                    help="AVEC2017 dev/test split CSV (with --daic-dir)")
    sp.add_argument("--queries", default=None,
                    help="question-bank file (with --daic-dir; default: the "
                         "bundled table)")
    sp.add_argument("--features", required=False,
                    help="directory written by extract-daic")
    sp.add_argument("--eval-split", default="test",
                    help="split name used for gating/eval (e.g. dev/test)")
    sp.add_argument("--model-dir")
    sp.add_argument("--multimodal", action="store_true")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    sp.set_defaults(fn=cmd_train_daic)

    sp = sub.add_parser("check-daic",
                        help="recompute DAIC eval-split metrics from a "
                             "train-daic checkpoint")
    sp.add_argument("--track", required=True, choices=["clf", "reg"])
    sp.add_argument("--features", required=False)
    sp.add_argument("--daic-dir",
                    help="re-extract the eval split from this raw DAIC dir "
                         "(with --eval-csv; the checkpoints of train-daic "
                         "--daic-dir)")
    sp.add_argument("--eval-csv", help="AVEC2017 split CSV (with --daic-dir)")
    sp.add_argument("--queries", default=None,
                    help="question-bank file (with --daic-dir; default: the "
                         "bundled table)")
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--eval-split", default=None,
                    help="persisted npz split name (with --features; "
                         "default 'test')")
    sp.add_argument("--multimodal", action="store_true")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    sp.set_defaults(fn=cmd_check_daic)

    sp = sub.add_parser("predict-daic",
                        help="serve one raw DAIC session from a train-daic "
                             "checkpoint")
    sp.add_argument("--task", required=True, choices=list(
        DaicPredictor.TASKS))
    sp.add_argument("--daic-dir", required=True)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--participant", type=int, required=True)
    sp.add_argument("--queries",
                    help="question bank (default: the bundled "
                         "data/daic_queries.txt)")
    sp.add_argument("--start-ordinal", type=int, default=0,
                    help="cumulative utterance ordinal of this participant "
                         "in its split (reproduces training-time NetVLAD "
                         "features)")
    sp.add_argument("--multimodal", action="store_true",
                    help="force multimodal serving (audio + per-response "
                         "text); checkpoints of train-daic are detected "
                         "from their recorded embedding_size")
    sp.add_argument("--elmo-weights", default="auto",
                    help="multimodal text embedder bundle (as extract-daic "
                         "--elmo-weights; '' = the seeded stand-in)")
    sp.add_argument("--segmenter", default=None,
                    help="multimodal text segmenter (as extract-daic "
                         "--segmenter)")
    sp.add_argument("--embed-seed", type=int, default=None,
                    help="stand-in text-embedder seed (default: the "
                         "checkpoint's recorded extraction seed)")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    sp.set_defaults(fn=cmd_predict_daic)

    sp = sub.add_parser("serve", help="HTTP serving front (stdlib)")
    sp.add_argument("--task", required=True,
                    choices=list(TASKS) + list(DaicPredictor.TASKS))
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--warmup", action="store_true",
                    help="run the standard serving shapes once at startup")
    sp.add_argument("--batch-window-ms", type=float, default=0.0,
                    help=">0: threaded server that micro-batches concurrent "
                         "requests into one device batch")
    sp.add_argument("--max-batch", type=int, default=32)
    sp.add_argument("--max-queue", type=int, default=128,
                    help="admission bound (pending speakers); overload sheds "
                         "with 503 + Retry-After instead of queueing "
                         "unboundedly")
    sp.add_argument("--auth-token", default=None,
                    help="require 'Authorization: Bearer <token>' on "
                         "prediction endpoints (healthz stays open)")
    sp.add_argument("--tls-cert", default=None,
                    help="PEM certificate chain: serve HTTPS")
    sp.add_argument("--tls-key", default=None,
                    help="PEM private key for --tls-cert")
    sp.add_argument("--segmenter", default=None,
                    help="override the text segmenter (default: adopt the "
                         "one recorded by the checkpoint's training "
                         "features)")
    sp.add_argument("--elmo-weights", default="auto",
                    help="text embedder bundle for multimodal DAIC serving "
                         "('' = the seeded stand-in; EATD tasks resolve as "
                         "predict does)")
    sp.add_argument("--embed-seed", type=int, default=None,
                    help="stand-in text-embedder seed (EATD tasks: default "
                         "0; DAIC: the checkpoint's recorded extraction "
                         "seed)")
    sp.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    _vggish_args(sp, "--audio-embedder", _SERVE_EMBEDDER_HELP)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("baselines", help="sklearn baselines (host only)")
    sp.add_argument("--task", required=True,
                    choices=["audio_clf", "text_clf", "audio_reg", "text_reg"])
    sp.add_argument("--root", required=True)
    sp.add_argument("--model", default="rf",
                    help="clf: rf, dt, svm, lr; reg: svr, dt, rf, ada")
    sp.add_argument("--idx-files", nargs="*")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_baselines)
    return p


def _ranks(args) -> int:
    """The ranks a command runs on: 3 folds (x ``--data-parallel``) for
    ``--fold-parallel``, N for ``--elmo-tp N``; else 1."""
    if getattr(args, "fold_parallel", False):
        return 3 * getattr(args, "data_parallel", 1)
    multimodal = getattr(args, "multimodal", True)
    tp = getattr(args, "elmo_tp", 0) if multimodal else 0
    return tp if tp > 1 else 1


def _need_devices(args, n: int, have: int) -> None:
    """The JAX CLI's messages when the host has too few devices."""
    if getattr(args, "fold_parallel", False):
        try:
            distributed.devices_needed(3, getattr(args, "data_parallel", 1),
                                       have)
        except AssertionError as e:
            raise SystemExit(str(e)) from None
    elif have < n:
        raise SystemExit(
            f"--elmo-tp {n} needs >= {n} devices but only {have} are "
            "available (on a single-card host use the serial encoder, or "
            "--device cpu for Gloo ranks on the CPU)")


def _rank_main(argv) -> tuple:
    """One launched rank of :func:`main`: the command itself, and the
    standard output of rank 0 kept for the launcher (the other ranks' is
    dropped, as is their standard error) -> (exit code, rank 0's output,
    the code of a ``SystemExit`` or None)."""
    import contextlib
    import io
    import os

    out = io.StringIO()
    main_rank = distributed.is_main()
    rc, code = 0, None
    with open(os.devnull, "w") as quiet, \
            contextlib.redirect_stdout(out if main_rank else quiet), \
            contextlib.redirect_stderr(sys.stderr if main_rank else quiet):
        try:
            rc = main(argv)
        except SystemExit as e:     # the command's own refusal, every rank's
            code = e.code
    return rc, out.getvalue(), code


def _launch(args, argv, n: int) -> int:
    """Run the command on ``n`` ranks: one a card, ``cuda:0 ..
    cuda:n-1``, over NCCL (never two ranks on one card), or with
    ``--device cpu`` n Gloo ranks on the CPU.  Rank 0's output is printed
    here, and its ``SystemExit`` raised here."""
    if args.device == "cpu":
        devices = ["cpu"] * n
    else:
        default_device()            # no card: the usual error
        _need_devices(args, n, torch.cuda.device_count())
        devices = [f"cuda:{i}" for i in range(n)]
    print(f"# launching {n} ranks on {', '.join(devices)}", file=sys.stderr,
          flush=True)
    rc, out, code = distributed.launch(_rank_main, n, devices,
                                       args=(argv,))[0]
    sys.stdout.write(out)
    sys.stdout.flush()
    if code is not None:
        raise SystemExit(code)
    return rc


def main(argv=None):
    """The command line.  A command that runs on several ranks
    (``--fold-parallel``, ``--elmo-tp N``) joins the group ``torchrun``
    launched it into, runs on the ranks of the group it is a rank of, or
    else launches its ranks (:func:`_launch`)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    n = _ranks(args)
    if n > 1 and not distributed.initialize(
            "gloo" if getattr(args, "device", "cuda") == "cpu" else None):
        return _launch(args, argv, n)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
