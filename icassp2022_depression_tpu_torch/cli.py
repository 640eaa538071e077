"""Command line of the port (counterpart of
:mod:`icassp2022_depression_tpu.cli`, the subcommands of the ported slice).

  python -m icassp2022_depression_tpu_torch.cli synth-corpus --root ./corpus
  python -m icassp2022_depression_tpu_torch.cli predict --task audio_clf \\
      --ckpt ckpt.npz --root ./corpus --speaker Data/1

``predict`` prints one JSON line with the JAX CLI's fields: the result
dict, ``speaker`` and ``true_sds``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from icassp2022_depression_tpu_torch.serving.predictors import TASKS, Predictor


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
