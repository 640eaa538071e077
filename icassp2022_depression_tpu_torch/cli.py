"""Command line of the port (counterpart of
:mod:`icassp2022_depression_tpu.cli`, the subcommands of the ported slices).

  python -m icassp2022_depression_tpu_torch.cli synth-corpus --root ./corpus
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

Every subcommand that computes runs on ``--device`` (default ``cuda``); on
a machine without a card it raises unless ``--device cpu`` is given.

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
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from icassp2022_depression_tpu_torch.serving.predictors import (
    TASKS,
    Predictor,
    default_device,
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
        ("--audio-dim", args.audio_dim != 256,
         "the VGGish slice (ROADMAP.md Queue 1, item 17)")))


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
    print(json.dumps({f"{name.split('_')[0]}_{metric}":
                      [round(float(r["best"][metric]), 4) for r in results]
                      for name, results in named.items()}))
    return 0


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
    return p


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
