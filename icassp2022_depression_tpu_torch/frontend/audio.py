"""EATD audio frontend: batched wav2vlad and VGGish (port of
:mod:`icassp2022_depression_tpu.frontend.audio`: the batched extraction,
the fused corpus pass that feeds training, the npz feature writer with its
incremental per-speaker cache, the VGGish corpus pass
(:func:`extract_eatd_vggish`) and the npz feature reader).

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

import hashlib
import json
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
    folds there.  Same math and ordinals as :func:`extract_eatd`; no npz
    artifacts.  Labels are host arrays.

    Returns (features [N, 3, output_dim] on ``device``, sds_targets [N]
    float32, clf_targets [N] int64).
    """
    device = resolve_device(device)
    waveforms, rates, sds, _ = _corpus_utterances(root, max_id)
    flat = extract_batch(waveforms, rates, cfg, device=device)
    feats = flat.reshape(len(sds), 3, cfg.netvlad_output_dim)
    sds_targets, clf_targets = eatd.eatd_targets(sds, sds_threshold)
    return feats, sds_targets, clf_targets


def _cache_fingerprint(cfg: FrontendConfig) -> str:
    """md5 of every frontend field that changes the features (the JAX
    package's key, so either package reuses the other's cache)."""
    return hashlib.md5(json.dumps([
        cfg.netvlad_seed, cfg.n_mels, cfg.netvlad_clusters,
        cfg.netvlad_output_dim, cfg.n_fft, cfg.hop_length, cfg.log_floor,
        cfg.silence_amplitude, cfg.silence_seconds,
    ]).encode()).hexdigest()[:10]


def extract_eatd(root: Path, cfg: FrontendConfig = FrontendConfig(),
                 out_dir: Optional[Path] = None,
                 max_id: int = eatd.MAX_SPEAKER_ID,
                 sds_threshold: float = FoldConfig.sds_threshold,
                 incremental: bool = False, device=None):
    """The corpus audio pass with host results (``cli extract-audio``):
    [N, 3, 1, 256] features, SDS and clf targets and the per-speaker
    manifest.  With ``out_dir`` it writes the JAX package's four
    ``whole_{samples,labels}_{reg,clf}_256.npz`` and ``manifest.json``
    (each speaker's status, the shortest and longest answer in seconds).

    ``incremental`` (with ``out_dir``) reuses ``speaker_cache.npz`` from
    an earlier pass of either package: only the speakers it lacks are
    extracted, each under its training-time ordinals ``3 * position + k``,
    and the manifest's durations merge with the earlier manifest's.  A
    cache entry is keyed ``split/number@position|md5(config)[:10]``, so a
    changed config or a speaker moved in the corpus is extracted anew.
    The extraction runs on ``device`` (None: the first card);
    :func:`extract_eatd_device` is the pass that leaves the features
    there."""
    fp = _cache_fingerprint(cfg)

    def cache_key(sp, idx: int) -> str:
        return f"{sp.split}/{sp.number}@{idx}|{fp}"

    cache: dict = {}
    cache_path = (Path(out_dir) / "speaker_cache.npz"
                  if out_dir is not None else None)
    if incremental and cache_path is not None and cache_path.exists():
        with np.load(cache_path) as data:
            cache = {k: data[k] for k in data.files}

    waveforms: List[np.ndarray] = []
    rates: List[int] = []
    sds: List[float] = []
    manifest, speakers, todo = [], [], []
    min_len, max_len = float("inf"), 0.0
    for idx, sp in enumerate(eatd.load_speakers(root, max_id=max_id,
                                                read_text=False)):
        speakers.append(sp)
        sds.append(sp.sds)
        cached = incremental and cache_key(sp, idx) in cache
        manifest.append({"split": sp.split, "number": sp.number,
                         "status": "cached" if cached else "ok"})
        if cached:
            continue
        for w, sr, dur in zip(sp.waveforms, sp.sample_rates, sp.durations):
            waveforms.append(w)
            rates.append(sr)
            min_len = min(min_len, dur)
            max_len = max(max_len, dur)
        todo.append(idx)

    dim = cfg.netvlad_output_dim
    features = np.zeros((len(sds), 3, 1, dim), np.float32)
    if todo:
        flat = extract_batch(waveforms, rates, cfg,
                             ordinals=[3 * idx + k for idx in todo
                                       for k in range(3)],
                             device=device).cpu().numpy()
        features[todo] = flat.reshape(len(todo), 3, 1, dim)
    for idx, sp in enumerate(speakers):
        key = cache_key(sp, idx)
        if incremental and key in cache:
            features[idx] = cache[key]
    if incremental and cache_path is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache_path, **{cache_key(sp, idx): features[idx]
                                for idx, sp in enumerate(speakers)})
    sds_targets, clf_targets = eatd.eatd_targets(sds, sds_threshold)

    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for track, y in (("reg", sds_targets), ("clf", clf_targets)):
            np.savez(out_dir / f"whole_samples_{track}_{dim}.npz", features)
            np.savez(out_dir / f"whole_labels_{track}_{dim}.npz", y)
        # durations are measured only for the speakers extracted now; an
        # incremental rerun keeps the earlier manifest's corpus-wide range
        manifest_path = out_dir / "manifest.json"
        prev = {}
        if incremental and manifest_path.exists():
            try:
                prev = json.loads(manifest_path.read_text())
            except ValueError:
                prev = {}
        if prev.get("min_len_s") is not None:
            min_len = min(min_len, prev["min_len_s"])
        if prev.get("max_len_s") is not None:
            max_len = max(max_len, prev["max_len_s"])
        manifest_path.write_text(json.dumps(
            {"speakers": manifest,
             "min_len_s": min_len if np.isfinite(min_len) else None,
             "max_len_s": max_len if max_len > 0 else None}, indent=2))
    return features, sds_targets, clf_targets, manifest


#: examples per VGGish forward: one shape for every call, and the first
#: conv's map of a chunk (256 x 64 x 96 x 64 floats, 100.7 MB) bounded
VGGISH_CHUNK = 256


def vggish_embed_waveforms(model, waveforms: Sequence[np.ndarray],
                           sample_rates: Sequence[int],
                           postprocessor=None) -> np.ndarray:
    """Waveforms -> per-utterance mean-pooled VGGish embeddings [n_utt,
    128], numpy (the JAX package's ``vggish_embed_waveforms``).

    Corpus extraction and serving both embed through here.  Every
    utterance's 0.96 s examples (host numpy,
    :func:`..models.vggish.waveform_to_examples`) go through fixed
    ``VGGISH_CHUNK``-example chunks of ``model`` (a
    :class:`..models.vggish.VGGish`) on its device, the last chunk zero
    padded; the embeddings are read back once, postprocessed on the host
    when ``postprocessor`` is given, and averaged per utterance.  An
    utterance shorter than one example embeds as a zero row."""
    from icassp2022_depression_tpu_torch.models import vggish

    per_utt = [vggish.waveform_to_examples(np.asarray(w), sr)
               for w, sr in zip(waveforms, sample_rates)]
    counts = [e.shape[0] for e in per_utt]
    total = sum(counts)
    out = np.zeros((len(counts), vggish.EMBEDDING_SIZE), np.float32)
    if not total:
        return out
    flat = np.concatenate([e for e in per_utt if e.shape[0]])
    device = next(model.parameters()).device
    pieces = []
    with torch.inference_mode():
        for lo in range(0, total, VGGISH_CHUNK):
            part = np.zeros((VGGISH_CHUNK,) + flat.shape[1:], np.float32)
            rows = flat[lo:lo + VGGISH_CHUNK]
            part[:len(rows)] = rows
            pieces.append(model(torch.from_numpy(part).to(device)))
        emb = torch.cat(pieces)[:total].cpu().numpy()
    if postprocessor is not None:
        emb = postprocessor(emb).astype(np.float32)
    pos = 0
    for utt, c in enumerate(counts):
        if c:
            out[utt] = emb[pos:pos + c].mean(0)
            pos += c
    return out


def extract_eatd_vggish(root: Path, params=None, postprocessor=None,
                        out_dir: Optional[Path] = None,
                        max_id: int = eatd.MAX_SPEAKER_ID,
                        sds_threshold: float = FoldConfig.sds_threshold,
                        seed: int = 0, device=None):
    """The corpus audio pass through the reference's alternative embedder,
    VGGish (``to_vggish_embedds``, ``audio_features_whole.py:39-55``):
    each utterance's example embeddings mean-pooled to one 128-d vector,
    in the wav2vlad layout ``[N, 3, 1, 128]``.  ``params``: a
    :class:`..models.vggish.VGGish`, a JAX-layout param tree, or None for
    the seeded stand-in at ``seed``.  With ``out_dir`` it writes the JAX
    package's ``whole_{samples,labels}_{reg,clf}_128.npz`` and a
    ``manifest.json`` with ``"embedder": "vggish"``.  The network runs on
    ``device`` (None: the first card).

    Returns (features [N, 3, 1, 128], sds_targets, clf_targets, manifest).
    """
    from icassp2022_depression_tpu_torch.models import vggish

    model = vggish.resolve(params, seed, device)
    waveforms, rates, sds, manifest = _corpus_utterances(root, max_id)
    dim = vggish.EMBEDDING_SIZE
    features = vggish_embed_waveforms(model, waveforms, rates,
                                      postprocessor).reshape(len(sds), 3, 1,
                                                             dim)
    sds_targets, clf_targets = eatd.eatd_targets(sds, sds_threshold)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for track, y in (("reg", sds_targets), ("clf", clf_targets)):
            np.savez(out_dir / f"whole_samples_{track}_{dim}.npz", features)
            np.savez(out_dir / f"whole_labels_{track}_{dim}.npz", y)
        (out_dir / "manifest.json").write_text(json.dumps(
            {"speakers": manifest, "embedder": "vggish"}, indent=2))
    return features, sds_targets, clf_targets, manifest


def load_features(features_dir: Path, track: str = "clf", dim: int = 256):
    """Load the reference-layout npz pair (written by ``extract-audio`` of
    either package) and squeeze the singleton axis the trainers expect
    (``audio_gru_whole.py:19``)."""
    features_dir = Path(features_dir)
    feats = np.load(features_dir / f"whole_samples_{track}_{dim}.npz")["arr_0"]
    labels = np.load(features_dir / f"whole_labels_{track}_{dim}.npz")["arr_0"]
    return np.squeeze(feats, axis=2), labels
