"""DAIC-WOZ (English) frontend: transcript segmentation + batched wav2vlad
(port of :mod:`icassp2022_depression_tpu.frontend.daic`).

Reference (``DAICFeatureExtarction/feature_extraction.py``): for each
participant, walk ``{id}_TRANSCRIPT.csv``; a new response segment starts
when ``Ellie`` asks a line that exactly matches one of the canonical
questions in ``queries.txt`` (or contains "i think i have asked
everything"); ``Participant`` rows append ``wave_data[start:stop]`` to the
current signal (skipping ``scrubbed_entry``); each closed segment is
embedded with wav2vlad.  Labels are PHQ8_Binary / PHQ8_Score from the
AVEC2017 split CSVs (``:11-18``).

Segmentation stays on the host (CSV and string work, float64 signals as
the JAX package builds them); a whole split's responses go through ONE
:func:`..audio.extract_batch` call, numbered by cumulative utterance
ordinal across the split, as the reference's split pass numbers them.
The saved arrays are object arrays of per-participant ``[n_i, 1, 256]``
blocks, the reference's ragged layout, written as the JAX package writes
them, so either package reads the other's files.

The question bank (Ellie's utterance inventory, DAIC corpus metadata) is
bundled as this package's own ``data/daic_queries.txt``, a copy of the JAX
package's; :func:`load_queries` defaults to it.  Every function that
extracts runs on ``device`` (None: the first card, raising when there is
none).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from icassp2022_depression_tpu_torch.config import FrontendConfig
from icassp2022_depression_tpu_torch.data.eatd import read_wav
from icassp2022_depression_tpu_torch.frontend import audio as audio_fe
from icassp2022_depression_tpu_torch.parallel import distributed
from icassp2022_depression_tpu_torch.utils.device import resolve_device

#: the bundled DAIC question bank (the reference ships it as
#: ``DAICFeatureExtarction/queries.txt``)
BUNDLED_QUERIES = Path(__file__).resolve().parent.parent / "data" / \
    "daic_queries.txt"


def load_queries(path: Optional[Path] = None) -> List[str]:
    """Question bank lines; defaults to the bundled table."""
    return [line.rstrip("\n") for line in
            Path(path or BUNDLED_QUERIES).read_text().splitlines()]


def is_topic_question(sentence: str, queries: Sequence[str]) -> bool:
    """Exact match against the question bank (reference
    ``identify_topics``)."""
    sentence = sentence.strip("\n")
    return any(q.strip("\n") == sentence for q in queries)


def read_transcript(path: Path) -> List[dict]:
    """TRANSCRIPT.csv rows (tab-separated: start_time, stop_time, speaker,
    value), empty fields as 0.0 / "".  The speaker field is stripped of
    whitespace, the JAX package's documented deviation from the reference
    (a raw ``'Ellie '`` row matches neither speaker there)."""
    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            rows.append({
                "start_time": float(row["start_time"] or 0.0),
                "stop_time": float(row["stop_time"] or 0.0),
                "speaker": (row["speaker"] or "").strip(),
                "value": row["value"] or "",
            })
    return rows


def segment_responses(transcript: List[dict], wave_data: np.ndarray, sr: int,
                      queries: Sequence[str], with_text: bool = False):
    """A session -> per-question participant response signals (float64),
    by the reference's rules (``feature_extraction.py:45-60``): a matching
    Ellie question closes the current signal if it is nonempty;
    ``scrubbed_entry`` rows are skipped.  ``with_text`` also returns each
    response's concatenated participant transcript."""
    signals: List[np.ndarray] = []
    texts: List[str] = []
    signal = np.empty(0, np.float64)
    response = ""
    for t in transcript:
        if t["speaker"] == "Ellie" and (
                is_topic_question(t["value"], queries) or
                "i think i have asked everything" in t["value"]):
            if len(signal) == 0:
                response = ""
                continue
            signals.append(signal)
            texts.append(response.strip())
            signal = np.empty(0, np.float64)
            response = ""
        elif t["speaker"] == "Participant":
            if "scrubbed_entry" in t["value"]:
                continue
            start = int(t["start_time"] * sr)
            stop = int(t["stop_time"] * sr)
            signal = np.hstack((signal,
                                wave_data[start:stop].astype(np.float64)))
            response += " " + t["value"]
    if with_text:
        return signals, texts
    return signals


def _session(daic_dir: Path, number: int):
    base = Path(daic_dir) / f"{number}_P"
    transcript = read_transcript(base / f"{number}_TRANSCRIPT.csv")
    wave_data, sr = read_wav(base / f"{number}_AUDIO.wav")
    return transcript, wave_data, sr


def participant_signals(daic_dir: Path, number: int,
                        queries: Sequence[str], with_text: bool = False):
    """One participant's segmented response signals (host work only).
    Returns (signals, sample_rate), or (signals, texts, sample_rate) with
    ``with_text``."""
    transcript, wave_data, sr = _session(daic_dir, number)
    if with_text:
        signals, texts = segment_responses(transcript, wave_data, sr,
                                           queries, with_text=True)
        return signals, texts, sr
    return segment_responses(transcript, wave_data, sr, queries), sr


def extract_participant(daic_dir: Path, number: int, queries: Sequence[str],
                        cfg: FrontendConfig = FrontendConfig(),
                        start_ordinal: int = 0,
                        device=None) -> np.ndarray:
    """One participant -> [n_responses, 1, output_dim] features (host)."""
    signals, sr = participant_signals(daic_dir, number, queries)
    if not signals:
        return np.zeros((0, 1, cfg.netvlad_output_dim), np.float32)
    feats = audio_fe.extract_batch(signals, [sr] * len(signals), cfg,
                                   start_ordinal=start_ordinal,
                                   device=device)
    return feats.cpu().numpy()[:, None, :]


class FlatResponses(NamedTuple):
    """A whole split's response features as one flat row matrix on the
    device + the per-participant row counts (the fused DAIC
    extract->train path): participant ``i`` owns rows ``[sum(counts[:i]),
    sum(counts[:i+1]))``, in cumulative-ordinal order."""

    flat: torch.Tensor    # [total_responses, output_dim]
    counts: List[int]     # [n_participants]


def _split_signals(daic_dir: Path, ids: Sequence[int],
                   queries: Sequence[str], with_text: bool = False):
    """Every participant's responses of a split, flattened in split order:
    (signals, rates, texts or None, counts)."""
    signals: List[np.ndarray] = []
    srs: List[int] = []
    texts: List[str] = []
    counts: List[int] = []
    for pid in ids:
        if with_text:
            s, t, sr = participant_signals(daic_dir, pid, queries, True)
            texts.extend(t)
        else:
            s, sr = participant_signals(daic_dir, pid, queries)
        signals.extend(s)
        srs.extend([sr] * len(s))
        counts.append(len(s))
    return signals, srs, (texts if with_text else None), counts


def _split_flat_features(daic_dir: Path, ids: Sequence[int],
                         queries: Sequence[str], cfg: FrontendConfig,
                         device) -> Tuple[torch.Tensor, List[int]]:
    """All participants' responses through ONE ``extract_batch`` call on
    ``device``, ordinals cumulative across the split -> ([M, D] device
    tensor, counts).  Each row is the per-participant pass's (buckets
    depend on each utterance's own length, not on its batch peers)."""
    signals, srs, _, counts = _split_signals(daic_dir, ids, queries)
    if signals:
        flat = audio_fe.extract_batch(signals, srs, cfg, device=device)
    else:
        flat = torch.zeros((0, cfg.netvlad_output_dim), dtype=torch.float32,
                           device=device)
    return flat, counts


def read_split_csv(path: Path) -> Tuple[List[int], List[int], List[float]]:
    """AVEC2017 split CSV -> (participant ids, PHQ8_Binary, PHQ8_Score)."""
    ids, clabels, rlabels = [], [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            ids.append(int(row["Participant_ID"]))
            clabels.append(int(row["PHQ8_Binary"]))
            rlabels.append(float(row["PHQ8_Score"]))
    return ids, clabels, rlabels


def _ragged(flat: np.ndarray, counts: Sequence[int], block: bool = True):
    """Flat rows -> per-participant blocks ([n_i, 1, D], or [n_i, D])."""
    out, pos = [], 0
    for c in counts:
        rows = flat[pos:pos + c]
        out.append(rows[:, None, :] if block else rows)
        pos += c
    return out


def _save_ragged(path: Path, features) -> None:
    ragged = np.empty(len(features), dtype=object)
    for i, f in enumerate(features):
        ragged[i] = f
    np.savez(path, np.asarray(ragged, dtype=object))


def _save_split(out_prefix: Path, split_name: str, features, clabels,
                rlabels) -> Path:
    """The reference's four-file layout (``feature_extraction.py:83-100``)."""
    out_prefix = Path(out_prefix)
    out_prefix.mkdir(parents=True, exist_ok=True)
    _save_ragged(out_prefix / f"{split_name}_samples_clf.npz", features)
    _save_ragged(out_prefix / f"{split_name}_samples_reg.npz", features)
    np.savez(out_prefix / f"{split_name}_labels_clf.npz", np.asarray(clabels))
    np.savez(out_prefix / f"{split_name}_labels_reg.npz", np.asarray(rlabels))
    return out_prefix


def extract_split(daic_dir: Path, split_csv: Path,
                  queries_path: Optional[Path] = None,
                  cfg: FrontendConfig = FrontendConfig(),
                  out_prefix: Optional[Path] = None,
                  split_name: str = "train", device=None):
    """A split's pass -> (ragged per-participant features on the host,
    PHQ8_Binary, PHQ8_Score); with ``out_prefix``, saved in the
    reference's four-file layout."""
    queries = load_queries(queries_path)
    ids, clabels, rlabels = read_split_csv(split_csv)
    flat, counts = _split_flat_features(daic_dir, ids, queries, cfg,
                                        resolve_device(device))
    features = _ragged(flat.cpu().numpy(), counts)
    if out_prefix is not None:
        _save_split(out_prefix, split_name, features, clabels, rlabels)
    return features, clabels, rlabels


def extract_split_device(daic_dir: Path, split_csv: Path,
                         queries_path: Optional[Path] = None,
                         cfg: FrontendConfig = FrontendConfig(),
                         device=None):
    """The fused pipeline's split pass (``cli train-daic --daic-dir``): the
    features stay on ``device`` as a :class:`FlatResponses`, which
    :func:`..train.daic.train_daic` pads by a gather there.  Same math and
    ordinals as :func:`extract_split`; no npz.  Returns (FlatResponses,
    PHQ8_Binary, PHQ8_Score)."""
    queries = load_queries(queries_path)
    ids, clabels, rlabels = read_split_csv(split_csv)
    flat, counts = _split_flat_features(daic_dir, ids, queries, cfg,
                                        resolve_device(device))
    return FlatResponses(flat, counts), clabels, rlabels


def extract_split_multimodal(daic_dir: Path, split_csv: Path,
                             queries_path: Optional[Path] = None,
                             cfg: FrontendConfig = FrontendConfig(),
                             elmo_params=None, elmo_cfg=None, seed: int = 0,
                             elmo_weights: Optional[str] = "auto",
                             out_prefix: Optional[Path] = None,
                             split_name: str = "train",
                             segmenter: str = "auto", device=None,
                             elmo_tp: int = 0):
    """A split's pass over BOTH modalities (the DAIC text branch the
    reference drops): one session read per participant feeds the audio
    (one ``extract_batch`` for the split) and each response's transcript
    (one embedder call for the split; the embedder resolves as
    ``extract-text``'s, :func:`..text.make_embedder`, with ``elmo_tp``
    its tensor-parallel biLM over that many ranks).  With ``out_prefix``
    it also writes ``{split}_text_samples.npz`` (ragged [n_i, Dt] blocks)
    and ``extraction_meta.json``, as the JAX package does (rank 0 of a
    group writes).  Returns (audio blocks, text blocks, PHQ8_Binary,
    PHQ8_Score)."""
    from icassp2022_depression_tpu_torch.frontend import text as text_fe

    device = resolve_device(device)
    embed, tdim, embedder_id = text_fe.make_embedder(
        elmo_params, elmo_cfg, seed, elmo_weights, with_id=True,
        device=device, elmo_tp=elmo_tp)
    queries = load_queries(queries_path)
    ids, clabels, rlabels = read_split_csv(split_csv)
    signals, srs, texts, counts = _split_signals(daic_dir, ids, queries,
                                                 with_text=True)
    if signals:
        flat_audio = audio_fe.extract_batch(signals, srs, cfg,
                                            device=device).cpu().numpy()
        flat_text = embed([text_fe.tokenize(t, segmenter=segmenter)
                           for t in texts]).cpu().numpy()
    else:
        flat_audio = np.zeros((0, cfg.netvlad_output_dim), np.float32)
        flat_text = np.zeros((0, tdim), np.float32)
    audio_features = _ragged(flat_audio, counts)
    text_features = _ragged(flat_text, counts, block=False)
    if out_prefix is not None and distributed.is_main():
        out_prefix = _save_split(out_prefix, split_name, audio_features,
                                 clabels, rlabels)
        _save_ragged(out_prefix / f"{split_name}_text_samples.npz",
                     text_features)
        # the text provenance sidecar (extract-text's scheme): train-daic
        # copies it into checkpoint sidecars for serving
        (out_prefix / "extraction_meta.json").write_text(json.dumps(
            {"embedder": embedder_id, "segmenter": segmenter,
             "seed": seed, "elmo_tp": elmo_tp, "text_dim": int(tdim)}))
    return audio_features, text_features, clabels, rlabels


def load_features(prefix: Path, split_name: str = "train",
                  track: str = "clf", multimodal: bool = False):
    """Saved split features (either package's) as ragged lists ->
    (audio_features[, text_features], labels)."""
    prefix = Path(prefix)
    with np.load(prefix / f"{split_name}_samples_{track}.npz",
                 allow_pickle=True) as z:
        audio = list(z["arr_0"])
    labels = np.load(prefix / f"{split_name}_labels_{track}.npz")["arr_0"]
    if not multimodal:
        return audio, labels
    with np.load(prefix / f"{split_name}_text_samples.npz",
                 allow_pickle=True) as z:
        text = list(z["arr_0"])
    return audio, text, labels


def extract_participant_multimodal(daic_dir: Path, number: int,
                                   queries: Sequence[str], elmo_params,
                                   elmo_cfg,
                                   cfg: FrontendConfig = FrontendConfig(),
                                   start_ordinal: int = 0, embed_fn=None,
                                   segmenter: str = "auto", device=None):
    """One participant, one session read -> ([n, 1, Da] audio features,
    [n, Dt] text embeddings) on the host.  ``embed_fn`` (from
    :func:`..text.make_embedder`) overrides ``elmo_params`` /
    ``elmo_cfg``."""
    from icassp2022_depression_tpu_torch.frontend import text as text_fe

    device = resolve_device(device)
    if embed_fn is None:
        embed_fn, tdim = text_fe.make_embedder(elmo_params, elmo_cfg,
                                               elmo_weights=None,
                                               device=device)
    else:
        tdim = None
    transcript, wave_data, sr = _session(daic_dir, number)
    signals, texts = segment_responses(transcript, wave_data, sr, queries,
                                       with_text=True)
    if not signals:
        if tdim is None:
            tdim = embed_fn([["x"]]).shape[1]
        return (np.zeros((0, 1, cfg.netvlad_output_dim), np.float32),
                np.zeros((0, tdim), np.float32))
    audio = audio_fe.extract_batch(signals, [sr] * len(signals), cfg,
                                   start_ordinal=start_ordinal,
                                   device=device)
    text = embed_fn([text_fe.tokenize(t, segmenter=segmenter)
                     for t in texts])
    return audio.cpu().numpy()[:, None, :], text.cpu().numpy()


def extract_participant_text(daic_dir: Path, number: int,
                             queries: Sequence[str], elmo_params,
                             elmo_cfg) -> np.ndarray:
    """One participant's per-response transcripts -> [n, D] text
    embeddings on the host, through ``elmo_params`` (on their device)
    under ``elmo_cfg``.  Prefer :func:`extract_participant_multimodal`
    when the audio is needed too (one session read)."""
    from icassp2022_depression_tpu_torch.frontend import text as text_fe

    transcript, wave_data, sr = _session(daic_dir, number)
    _, texts = segment_responses(transcript, wave_data, sr, queries,
                                 with_text=True)
    if not texts:
        return np.zeros((0, elmo_cfg.output_dim), np.float32)
    sentences = [text_fe.tokenize(t) for t in texts]
    return text_fe.embed_sentences(elmo_params, sentences,
                                   elmo_cfg).cpu().numpy()


def pad_responses(features: List[np.ndarray],
                  max_responses: Optional[int] = None):
    """Ragged [n_i, 1, D] blocks -> dense [N, R, D] + mask [N, R] (1 on a
    participant's responses, 0 on the padding after them)."""
    if max_responses is None:
        max_responses = max((f.shape[0] for f in features), default=1)
    n = len(features)
    d = features[0].shape[-1] if features else 0
    out = np.zeros((n, max_responses, d), np.float32)
    mask = np.zeros((n, max_responses), np.float32)
    for i, f in enumerate(features):
        r = min(f.shape[0], max_responses)
        out[i, :r] = f[:r, 0, :]
        mask[i, :r] = 1.0
    return out, mask


def gather_responses(flat: torch.Tensor, counts: Sequence[int], rows: int,
                     max_responses: int) -> torch.Tensor:
    """Flat [M, D] response rows + per-participant counts -> [rows, R, D]
    on their device, by one index gather: participant i's first
    ``min(n_i, R)`` responses, then a zeros sentinel row in every other
    slot (the rows past ``len(counts)`` included).  Callers build their own
    masks."""
    idx = np.full((rows, max_responses), int(sum(counts)), np.int64)
    pos = 0
    for i, c in enumerate(counts):
        r = min(c, max_responses)
        idx[i, :r] = np.arange(pos, pos + r)
        pos += c
    table = torch.cat([flat, flat.new_zeros((1, flat.shape[-1]))])
    return table[torch.as_tensor(idx, device=flat.device)]
