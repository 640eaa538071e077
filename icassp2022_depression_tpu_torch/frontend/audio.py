"""EATD audio frontend: batched wav2vlad (port of
:mod:`icassp2022_depression_tpu.frontend.audio`: the batched extraction,
the fused corpus pass that feeds training, and the npz feature reader).

Reference: ``wav2vlad`` (``Classification/audio_features_whole.py:57-72``)
= librosa log-mel -> a freshly initialised NetVLAD per utterance.

Utterances are grouped into padded power-of-two length buckets; each
bucket is one ``[B, blen]`` float32 upload and one batched pass of
log-mel, frame mask and per-utterance NetVLAD (weights keyed by the
utterance ordinal, :mod:`..ops.netvlad`) on the target device.  The rows
are zero-padded, but each carries the reflected tail of its own signal at
its TRUE end, as librosa's centred STFT does, so the last valid frames do
not read bucket padding.  The JAX package's flat int16 wire format (built
for a slow host link) is not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch.config import FoldConfig, FrontendConfig
from icassp2022_depression_tpu_torch.data import eatd
from icassp2022_depression_tpu_torch.ops import mel, netvlad
from icassp2022_depression_tpu_torch.utils import shapes
from icassp2022_depression_tpu_torch.utils.device import resolve_device


def _bucket_length(n: int, min_len: int = 16384) -> int:
    """Next power-of-two padded length (a handful of buckets overall)."""
    return shapes.next_pow2(n, minimum=min_len)


def _fill_row(row: np.ndarray, w: np.ndarray, tail: int) -> None:
    """Write ``w`` and up to ``tail`` samples of its reflection at its end
    (librosa's centred reflect pad) into the zeroed bucket row."""
    nw = len(w)
    row[:nw] = w
    t_room = min(tail, len(row) - nw)
    if t_room <= 0:
        return
    end = nw + t_room
    if nw > 1 and t_room < nw:
        # single-bounce reflect: w[-2], w[-3], ... (edge excluded)
        stop = nw - 2 - t_room
        row[nw:end] = w[nw - 2: (stop if stop >= 0 else None): -1]
    elif nw > 1:
        # multi-bounce reflection for very short signals
        row[nw:end] = np.pad(w, (0, t_room), mode="reflect")[nw:]
    else:
        row[nw:end] = w[0]   # edge pad for one sample


def bucket_pipeline(wavs: torch.Tensor, lengths: torch.Tensor,
                    ordinals: torch.Tensor, sr: int,
                    cfg: FrontendConfig) -> torch.Tensor:
    """One bucket: padded rows [B, blen], true lengths [B], ordinals [B]
    (all on one device) -> NetVLAD features [B, output_dim]."""
    lm = mel.log_mel(wavs, sr, cfg.n_fft, cfg.hop_length, cfg.n_mels,
                     cfg.log_floor, True)                     # [B, F, M]
    fmask = mel.frame_mask(lengths, lm.shape[1], cfg.hop_length)
    params = netvlad.batched_per_utterance_params(
        cfg.netvlad_seed, ordinals, cfg.n_mels, cfg.netvlad_clusters,
        cfg.netvlad_output_dim)
    return netvlad.netvlad(params, lm, fmask)


def extract_batch(waveforms: Sequence[np.ndarray], sample_rates: Sequence[int],
                  cfg: FrontendConfig = FrontendConfig(),
                  start_ordinal: int = 0,
                  ordinals: Optional[Sequence[int]] = None,
                  device=None) -> torch.Tensor:
    """wav2vlad over variable-length utterances -> [N, output_dim] float32
    on ``device`` (None: the first card, :func:`..utils.device.
    resolve_device`), in input order.

    NetVLAD weights are keyed per utterance ordinal: consecutive from
    ``start_ordinal``, or explicit via ``ordinals``.  Empty waveforms get
    the reference's silence fallback (``audio_features_whole.py:105-109``).
    """
    device = resolve_device(device)
    n = len(waveforms)
    waveforms = [np.asarray(w) if len(w)
                 else eatd.silence_fallback(sr, cfg.silence_amplitude,
                                            cfg.silence_seconds)
                 for w, sr in zip(waveforms, sample_rates)]
    if ordinals is None:
        ordinals = range(start_ordinal, start_ordinal + n)
    ordinals = list(ordinals)
    tail = cfg.n_fft // 2
    buckets: dict = {}
    for i, (w, sr) in enumerate(zip(waveforms, sample_rates)):
        # mel banks depend on sr; the bucket reserves room for the tail
        buckets.setdefault((_bucket_length(len(w) + tail), sr), []).append(i)

    out = torch.empty((n, cfg.netvlad_output_dim), dtype=torch.float32,
                      device=device)
    for (blen, sr), idxs in buckets.items():
        # batch rows rounded up to a multiple of 8: a few shapes per bucket
        brows = -(-len(idxs) // 8) * 8
        rows = np.zeros((brows, blen), np.float32)
        lengths = np.zeros((brows,), np.int64)
        row_ordinals = np.zeros((brows,), np.int64)
        for r, i in enumerate(idxs):
            _fill_row(rows[r], waveforms[i], tail)
            lengths[r] = len(waveforms[i])
            row_ordinals[r] = ordinals[i]
        feats = bucket_pipeline(torch.from_numpy(rows).to(device),
                                torch.from_numpy(lengths).to(device),
                                torch.from_numpy(row_ordinals).to(device),
                                sr, cfg)
        out[torch.as_tensor(idxs, device=device)] = feats[:len(idxs)]
    return out


def _corpus_utterances(root: Path, max_id: int):
    """Flatten the corpus into per-utterance lists in ``load_speakers``
    order (3 utterances per speaker).  Returns (waveforms, rates, sds,
    manifest)."""
    waveforms: List[np.ndarray] = []
    rates: List[int] = []
    sds: List[float] = []
    manifest = []
    for sp in eatd.load_speakers(root, max_id=max_id, read_text=False):
        sds.append(sp.sds)
        manifest.append({"split": sp.split, "number": sp.number,
                         "status": "ok"})
        for w, sr in zip(sp.waveforms, sp.sample_rates):
            waveforms.append(np.asarray(w))
            rates.append(sr)
    return waveforms, rates, sds, manifest


def extract_eatd_device(root: Path, cfg: FrontendConfig = FrontendConfig(),
                        max_id: int = eatd.MAX_SPEAKER_ID,
                        sds_threshold: float = FoldConfig.sds_threshold,
                        device=None):
    """The fused corpus pass that feeds training (``cli train --corpus``):
    one corpus read, and the [N, 3, output_dim] features stay on
    ``device`` (None: the first card) for the trainers, which gather their
    folds there.  Same math and ordinals as the JAX package's
    ``extract_eatd``; no npz artifacts.  Labels are host arrays.

    Returns (features [N, 3, output_dim] on ``device``, sds_targets [N]
    float32, clf_targets [N] int64).
    """
    device = resolve_device(device)
    waveforms, rates, sds, _ = _corpus_utterances(root, max_id)
    flat = extract_batch(waveforms, rates, cfg, device=device)
    feats = flat.reshape(len(sds), 3, cfg.netvlad_output_dim)
    sds_targets, clf_targets = eatd.eatd_targets(sds, sds_threshold)
    return feats, sds_targets, clf_targets


def load_features(features_dir: Path, track: str = "clf", dim: int = 256):
    """Load the reference-layout npz pair (written by the JAX package's
    ``extract-audio``) and squeeze the singleton axis the trainers expect
    (``audio_gru_whole.py:19``)."""
    features_dir = Path(features_dir)
    feats = np.load(features_dir / f"whole_samples_{track}_{dim}.npz")["arr_0"]
    labels = np.load(features_dir / f"whole_labels_{track}_{dim}.npz")["arr_0"]
    return np.squeeze(feats, axis=2), labels
