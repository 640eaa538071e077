"""Command line of the port (counterpart of
:mod:`icassp2022_depression_tpu.cli`, the subcommands of the ported slices).

  python -m icassp2022_depression_tpu_torch.cli synth-corpus --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli train --task audio_clf \\
      --root ./corpus --corpus ./corpus --device cuda
  python -m icassp2022_depression_tpu_torch.cli predict --task audio_clf \\
      --ckpt ckpt.npz --root ./corpus --speaker Data/1

``train`` writes what the JAX CLI's ``train`` writes: the gated-best
checkpoints (npz + JSON sidecar, and ``train_idxs_{f1:.2f}_{fold}.npy`` for
classification) under ``<model-dir>/ClassificationWhole/Audio`` or
``<model-dir>/Regression/Audio{fold}``, the per-epoch metrics in
``<model-dir>/<task>_metrics.jsonl``, and one ``fold k: {...}`` line per
fold.  ``predict`` prints one JSON line with the JAX CLI's fields: the
result dict, ``speaker`` and ``true_sds``.
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


def _reject_unported(args) -> None:
    """The JAX CLI's ``train`` options that arrive with later slices of the
    port (``ROADMAP.md`` Queue 1) raise instead of being ignored."""
    if args.task.startswith("text"):
        raise SystemExit(f"--task {args.task}: the text branch arrives with "
                         "the text slice of the port (ROADMAP.md Queue 1, "
                         "item 11)")
    for flag, used, where in (
            ("--resume-dir/--chunk-epochs",
             args.resume_dir is not None or args.chunk_epochs is not None,
             "the rest of the JAX trainer (ROADMAP.md Queue 1, item 19)"),
            ("--vmap-folds", args.vmap_folds,
             "the rest of the JAX trainer (ROADMAP.md Queue 1, item 19)"),
            ("--fold-parallel/--data-parallel",
             args.fold_parallel or args.data_parallel != 1,
             "the multi-GPU slice (ROADMAP.md Queue 1, item 18)"),
            ("--audio-dim", args.audio_dim != 256,
             "the VGGish slice (ROADMAP.md Queue 1, item 17)")):
        if used:
            raise SystemExit(f"{flag} is not ported yet: it arrives with "
                             f"{where}")


def _train_folds(targets, seed: int, idx_files=None):
    from icassp2022_depression_tpu_torch.data import folds

    if idx_files:
        return [folds.load_index_file(p) for p in idx_files]
    return folds.generate_clf_folds(targets, 3, seed=seed)


def cmd_train(args):
    """Train one audio task's 3 folds, from a corpus (``--corpus``, the
    features stay on the device) or from the npz features under
    ``<root>/Features/AudioWhole``."""
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.train import trainers
    from icassp2022_depression_tpu_torch.utils.logging import MetricsLogger

    _reject_unported(args)
    device = torch.device(args.device) if args.device else default_device()
    root = Path(args.root)
    model_dir = Path(args.model_dir) if args.model_dir else root / "Model"
    logger = MetricsLogger(model_dir / f"{args.task}_metrics.jsonl",
                           echo=args.verbose)
    clf = args.task == "audio_clf"
    # resolved at call time, so a changed preset is what trains
    tcfg = C.AUDIO_CLF if clf else C.AUDIO_REG
    if args.corpus:
        x, sds, clf_targets = afe.extract_eatd_device(Path(args.corpus),
                                                      device=device)
        if len(sds) == 0:
            raise SystemExit(
                f"--corpus {args.corpus}: no speakers found; expected the "
                "EATD layout Data/<n>/ and/or ValidationData/<n>/ with "
                "{positive,neutral,negative}_out.wav and new_label.txt")
        y = clf_targets if clf else sds
    else:
        audio_dir = root / "Features" / "AudioWhole"
        if not audio_dir.exists():
            raise SystemExit(f"audio features not found under {audio_dir}: "
                             "pass --corpus, or point --root at a directory "
                             "with Features/AudioWhole")
        x, y = afe.load_features(audio_dir, "clf" if clf else "reg")
    if clf:
        results = trainers.train_audio_clf(
            x, y, _train_folds(y, args.seed, args.idx_files), tcfg=tcfg,
            out_dir=model_dir / "ClassificationWhole" / "Audio",
            seed=args.seed, device=device)
    else:
        dep, non = folds.generate_reg_shuffles(y, seed=args.seed)
        results = trainers.train_audio_reg(
            x, y, dep, non, tcfg=tcfg, out_dir=model_dir / "Regression",
            seed=args.seed, device=device)
    for r in results:
        logger.log_fold(args.task, r["fold"], r["logs"], r["best"])
        best = {k: round(v, 4) for k, v in r["best"].items() if k != "params"}
        print(f"fold {r['fold']}: {best}")
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

    sp = sub.add_parser("train", help="train one audio task's 3 folds")
    sp.add_argument("--task", required=True,
                    choices=["audio_clf", "text_clf", "audio_reg",
                             "text_reg"])
    sp.add_argument("--root", required=True)
    sp.add_argument("--model-dir")
    sp.add_argument("--idx-files", nargs="*")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--corpus",
                    help="extract wav2vlad features from this EATD corpus "
                         "dir and train on them where they lie (no npz)")
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
