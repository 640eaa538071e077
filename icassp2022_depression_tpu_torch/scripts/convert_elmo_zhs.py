"""Convert a released ELMoForManyLangs model directory to the single-npz
weight bundle (port of the JAX repo's ``convert_elmo_zhs`` script).

The reference loads the zhs model through the upstream package
(``Classification/text_features_whole.py:16``); this converter needs only
torch, because the released directory is plain files:

    zhs.model/
      config.json                      (points at the architecture config)
      cnn_50_100_512_4096_sample.json  (architecture config)
      char.dic  word.dic               (tab-separated lexicons)
      token_embedder.pkl  encoder.pkl  (torch.save-d state dicts)

Usage:
    python -m icassp2022_depression_tpu_torch.scripts.convert_elmo_zhs \\
        /path/to/zhs.model -o ~/.cache/icassp2022_tpu/elmo_zhs.npz

``extract-text`` then loads the bundle from ``ICASSP_ELMO_WEIGHTS`` or
``~/.cache/icassp2022_tpu/elmo_zhs.npz`` (pass ``--elmo-weights`` to point
elsewhere).  Either package's ``load_npz`` reads the bundle.  Validate a
conversion with ``--check``: it embeds two fixture sentences on
``--device`` (default: the card; ``cpu`` to run there) and prints their
pooled-vector norms (compare against ``Embedder.sents2elmo`` means from
the source environment).  Converting alone runs on the host and needs no
card.
"""

import argparse
from pathlib import Path

from icassp2022_depression_tpu_torch.models import elmo_pretrained
from icassp2022_depression_tpu_torch.train.checkpoints import _flatten
from icassp2022_depression_tpu_torch.utils.device import resolve_device

#: the sentences ``--check`` embeds
CHECK_SENTENCES = [["今天", "天气", "很", "好"], ["我", "有点", "累"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model_dir", type=Path,
                    help="released ELMoForManyLangs model directory")
    ap.add_argument("-o", "--out", type=Path,
                    default=Path.home() / ".cache" / "icassp2022_tpu" /
                    "elmo_zhs.npz")
    ap.add_argument("--check", action="store_true",
                    help="embed two fixture sentences after converting")
    ap.add_argument("--device", default="cuda",
                    help="where --check embeds: cuda (default; the first "
                         "card, an error without one) or cpu")
    args = ap.parse_args(argv)

    pe = elmo_pretrained.convert_model_dir(args.model_dir)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    elmo_pretrained.save_npz(args.out, pe)
    n_params = sum(v.size for v in
                   _flatten((pe.cc_params, pe.enc_params)).values())
    print(f"wrote {args.out} ({n_params:,} params, "
          f"chars={len(pe.char_lexicon)}, "
          f"words={len(pe.word_lexicon) if pe.word_lexicon else 0})")

    if args.check:
        device = resolve_device(None if args.device == "cuda"
                                else args.device)
        roundtrip = elmo_pretrained.load_npz(args.out, device)
        emb = roundtrip.embed_sentences(CHECK_SENTENCES).cpu()
        for s, e in zip(CHECK_SENTENCES, emb):
            print("".join(s), "->", tuple(e.shape), "norm",
                  float((e.double() ** 2).sum() ** 0.5))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
