"""EATD text features (port of :mod:`icassp2022_depression_tpu.frontend.text`,
the npz reader only).

The text trainers read the features the JAX package's ``extract-text``
writes: ``whole_samples_{track}_avg.npz`` ([N, 3, 1024], one averaged ELMo
vector per answer) and ``whole_labels_{track}_avg.npz``.  The
segmenters, the stand-in and pretrained ELMo embedders and the on-the-fly
corpus pass (``extract_eatd_device``) are not ported yet (``ROADMAP.md``
Queue 1, item 13).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_features(features_dir: Path, track: str = "clf"):
    """(features [N, 3, D], labels [N]) from the reference-layout npz pair."""
    features_dir = Path(features_dir)
    feats = np.load(features_dir / f"whole_samples_{track}_avg.npz")["arr_0"]
    labels = np.load(features_dir / f"whole_labels_{track}_avg.npz")["arr_0"]
    return feats, labels

