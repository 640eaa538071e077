"""Command line of the port (counterpart of
:mod:`icassp2022_depression_tpu.cli`, the subcommands of the ported slices).

  python -m icassp2022_depression_tpu_torch.cli synth-corpus --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli train --task audio_clf \\
      --root ./corpus --corpus ./corpus --device cuda
  python -m icassp2022_depression_tpu_torch.cli train --task text_clf \\
      --root ./corpus --device cuda
  python -m icassp2022_depression_tpu_torch.cli pipeline --track clf \\
      --root ./corpus --device cuda
  python -m icassp2022_depression_tpu_torch.cli predict --task audio_clf \\
      --ckpt ckpt.npz --root ./corpus --speaker Data/1

``train`` writes what the JAX CLI's ``train`` writes: the gated-best
checkpoints (npz + JSON sidecar, and ``train_idxs_{f1:.2f}_{fold}.npy`` for
classification) under ``<model-dir>/ClassificationWhole/{Audio,Text}`` or
``<model-dir>/Regression/{Audio,Text}{fold}``, the per-epoch metrics in
``<model-dir>/<task>_metrics.jsonl``, and one ``fold k: {...}`` line per
fold.  The audio tasks train from ``--corpus`` (wav2vlad on the device) or
from ``<root>/Features/AudioWhole``; the text tasks from the npz features
under ``<root>/Features/TextWhole`` (the JAX package's ``extract-text``
layout).  ``pipeline`` runs a track's three trainers (audio, text, then the
fusion from each fold's gated branches) on those npz features, writes
their checkpoints (``.../Fuse`` and ``Regression/Fuse{fold}`` for the
fusion) and ``<model-dir>/pipeline_<track>_metrics.jsonl``, and ends with
a JSON line of the per-fold gated metrics.  ``predict`` prints one JSON
line with the JAX CLI's fields: the result dict, ``speaker`` and
``true_sds``.
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


def cmd_predict(args):
    """Serve a prediction for one corpus speaker from a checkpoint."""
    from icassp2022_depression_tpu_torch.data import eatd

    split, number = args.speaker.split("/")
    sp = eatd.load_speaker(Path(args.root), split, int(number))
    if sp is None:
        raise SystemExit(f"speaker {args.speaker} not found under {args.root}")
    p = Predictor.from_checkpoint(args.ckpt, args.task, device=args.device)
    # corpus-position ordinal base -> NetVLAD features identical to the
    # training-time extraction of this speaker
    result = p.predict_speaker(
        waveforms=sp.waveforms, sample_rates=sp.sample_rates,
        ordinal_base=3 * eatd.corpus_position(Path(args.root), split,
                                              int(number)))
    result["speaker"] = args.speaker
    result["true_sds"] = sp.sds
    print(json.dumps(result))
    return 0


#: the text frontend (segmenters, ELMo) that extracts text features from a
#: corpus on the fly
_TEXT_FRONTEND = "the text-frontend slice (ROADMAP.md Queue 1, item 13)"
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
        ("--corpus with a text task",
         bool(args.corpus) and args.task.startswith("text"), _TEXT_FRONTEND),
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


def _device(args) -> torch.device:
    return torch.device(args.device) if args.device else default_device()


def cmd_train(args):
    """Train one branch task's 3 folds: audio from a corpus (``--corpus``,
    the features stay on the device) or from the npz features under
    ``<root>/Features/AudioWhole``; text from ``<root>/Features/TextWhole``."""
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
    if args.task.startswith("text"):
        _require_features(text_dir, "text")
        x, y = tfe.load_features(text_dir, track)
        text_kw["meta_extras"] = _text_meta(text_dir)
    elif args.corpus:
        x, sds, clf_targets = afe.extract_eatd_device(Path(args.corpus),
                                                      device=device)
        if len(sds) == 0:
            raise SystemExit(
                f"--corpus {args.corpus}: no speakers found; expected the "
                "EATD layout Data/<n>/ and/or ValidationData/<n>/ with "
                "{positive,neutral,negative}_out.wav and new_label.txt")
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
    """A whole track from the npz features: the audio and text branch
    trainers, then the fusion from each fold's gated branch params."""
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.train import trainers
    from icassp2022_depression_tpu_torch.utils.logging import MetricsLogger

    _reject((
        ("--corpus/--elmo-weights/--segmenter",
         bool(args.corpus) or args.elmo_weights != "auto"
         or args.segmenter != "auto", _TEXT_FRONTEND),
        ("--vmap-folds", args.vmap_folds, _TRAINER_REST),
        ("--fold-parallel", args.fold_parallel, _MULTI_GPU)))
    device = _device(args)
    root = Path(args.root)
    audio_dir, text_dir = _features_dirs(root)
    model_dir = Path(args.model_dir) if args.model_dir else root / "Model"
    _require_features(audio_dir, "audio")
    _require_features(text_dir, "text")
    logger = MetricsLogger(model_dir / f"pipeline_{args.track}_metrics.jsonl")
    text_meta = _text_meta(text_dir)

    def _lr(tcfg):
        if not args.lr:
            return tcfg
        return C.replace(tcfg, optimizer=C.replace(tcfg.optimizer,
                                                   learning_rate=args.lr))

    xa, ya = afe.load_features(audio_dir, args.track)
    xt, yt = tfe.load_features(text_dir, args.track)
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
                    help="audio tasks: extract wav2vlad features from this "
                         "EATD corpus dir and train on them where they lie "
                         "(no npz)")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda if a card is "
                         "present, else cpu)")
    # the JAX CLI's options that later slices bring (see _reject_unported)
    sp.add_argument("--audio-dim", type=int, default=256)
    sp.add_argument("--resume-dir")
    sp.add_argument("--chunk-epochs", type=int)
    sp.add_argument("--vmap-folds", action="store_true")
    sp.add_argument("--fold-parallel", action="store_true")
    sp.add_argument("--data-parallel", type=int, default=1)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("pipeline", help="a whole track incl. fusion, "
                                         "from the npz features")
    sp.add_argument("--track", required=True, choices=["clf", "reg"])
    sp.add_argument("--root", required=True)
    sp.add_argument("--model-dir")
    sp.add_argument("--idx-files", nargs="*")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--lr", type=float, default=None,
                    help="override every trainer's learning rate (default: "
                         "the reference values)")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda if a card is "
                         "present, else cpu)")
    # the JAX CLI's options that later slices bring (see cmd_pipeline)
    sp.add_argument("--corpus")
    sp.add_argument("--segmenter", default="auto")
    sp.add_argument("--elmo-weights", default="auto")
    sp.add_argument("--vmap-folds", action="store_true")
    sp.add_argument("--fold-parallel", action="store_true")
    sp.set_defaults(fn=cmd_pipeline)

    sp = sub.add_parser("predict", help="serve one speaker from a checkpoint")
    sp.add_argument("--task", required=True, choices=list(TASKS))
    sp.add_argument("--root", required=True)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--speaker", required=True,
                    help="e.g. Data/5 or ValidationData/12")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda if a card is "
                         "present, else cpu)")
    sp.set_defaults(fn=cmd_predict)
    return p


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
