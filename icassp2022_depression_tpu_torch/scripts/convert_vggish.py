"""Convert the released VGGish TF-slim checkpoint (+ PCA params) to the npz
checkpoint format (port of the JAX repo's ``convert_vggish`` script).

The reference's ``to_vggish_embedds`` loads ``vggish_model.ckpt`` and
``vggish_pca_params.npz`` (``Classification/audio_features_whole.py:31-32``);
this one-time converter turns them into one npz bundle that either
package's ``models.vggish.load_npz`` reads (``ICASSP_VGGISH_WEIGHTS``).
Reading the checkpoint needs tensorflow, and nothing else here does:
convert on a host that has it and copy the bundle to the card's host.

Usage:
    python -m icassp2022_depression_tpu_torch.scripts.convert_vggish \\
        vggish_model.ckpt --pca vggish_pca_params.npz -o vggish_converted
"""

import argparse

from icassp2022_depression_tpu_torch.models import vggish
from icassp2022_depression_tpu_torch.train import checkpoints


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt", help="vggish_model.ckpt (TF-slim checkpoint)")
    ap.add_argument("--pca", help="vggish_pca_params.npz")
    ap.add_argument("-o", "--out", default="vggish_converted")
    args = ap.parse_args(argv)

    params = vggish.from_tf_checkpoint(args.ckpt)
    if args.pca:
        post = vggish.load_pca_params(args.pca)
        params = dict(params, pca={"matrix": post.pca_matrix,
                                   "means": post.pca_means.ravel()})
    out = checkpoints.save(args.out, params)
    n = sum(v.size for v in checkpoints._flatten(params).values())
    print(f"wrote {out} ({n:,} params)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
