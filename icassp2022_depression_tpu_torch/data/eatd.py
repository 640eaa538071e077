"""EATD-Corpus reader (port of :mod:`icassp2022_depression_tpu.data.eatd`).

NumPy only, so it is the JAX package's reader line for line:

* per speaker ``<split>/<n>/``, the three answers ``positive_out.wav``,
  ``neutral_out.wav``, ``negative_out.wav`` are read with the stdlib
  ``wave`` module as int16 PCM and cast to float64;
* an empty wav falls back to 5 s of ``1e-4`` "silence" at the file's
  sample rate (``audio_features_whole.py:105-110``);
* the SDS score is the first line of ``new_label.txt``;
* speakers are iterated 1..114 over ``Data/`` then ``ValidationData/``.

The native threaded wav reader of the JAX package is not ported:
:func:`load_speakers` reads the corpus through the stdlib path.
"""

from __future__ import annotations

import dataclasses
import wave as wave_mod
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

TOPICS = ("positive", "neutral", "negative")
#: reference iterates speaker ids 1..114 per split (``audio_features_whole.py:120``)
MAX_SPEAKER_ID = 114


@dataclasses.dataclass
class Speaker:
    split: str
    number: int
    #: three float64 waveforms in topic order (positive, neutral, negative)
    waveforms: List[np.ndarray]
    sample_rates: List[int]
    #: SDS score (raw target); binary label is ``sds >= 53``
    sds: float
    #: transcripts (topic order), None if text files absent
    texts: Optional[List[str]] = None

    @property
    def durations(self) -> List[float]:
        return [len(w) / sr for w, sr in zip(self.waveforms, self.sample_rates)]


def read_wav(path: Path) -> tuple[np.ndarray, int]:
    """int16 PCM -> float64 array + sample rate (reference's dtype path:
    ``np.frombuffer(..., dtype=np.short).astype(np.float)``)."""
    with wave_mod.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        data = np.frombuffer(f.readframes(n), dtype=np.short).astype(np.float64)
    return data, sr


def silence_fallback(sr: int, amplitude: float = 1e-4,
                     seconds: int = 5) -> np.ndarray:
    """The reference's empty-wav fallback (``audio_features_whole.py:105-110``)."""
    return np.full(sr * seconds, amplitude, dtype=np.float64)


def _read_label_and_texts(d: Path, read_text: bool):
    label_path = d / "new_label.txt"
    lines = label_path.read_text().splitlines()
    try:
        sds = float(lines[0])
    except (IndexError, ValueError):
        raise ValueError(
            f"{label_path}: first line must be a numeric SDS score, got "
            f"{lines[0]!r}" if lines else f"{label_path}: file is empty")
    texts = None
    if read_text:
        txts = []
        ok = True
        for topic in TOPICS:
            p = d / f"{topic}.txt"
            if not p.exists():
                ok = False
                break
            content = p.read_text()
            txts.append(content.splitlines()[0] if content else "")
        texts = txts if ok else None
    return sds, texts


def _apply_silence_fallback(waveforms, srs):
    return [w if w.shape[0] >= 1 else silence_fallback(sr)
            for w, sr in zip(waveforms, srs)]


def load_speaker(root: Path, split: str, number: int,
                 read_text: bool = True) -> Optional[Speaker]:
    d = Path(root) / split / str(number)
    if not (d / "positive_out.wav").exists():
        return None
    waveforms, srs = [], []
    for topic in TOPICS:
        w, sr = read_wav(d / f"{topic}_out.wav")
        waveforms.append(w)
        srs.append(sr)
    waveforms = _apply_silence_fallback(waveforms, srs)
    sds, texts = _read_label_and_texts(d, read_text)
    return Speaker(split, number, waveforms, srs, sds, texts)


def iter_speakers(root: Path, splits=("Data", "ValidationData"),
                  max_id: int = MAX_SPEAKER_ID,
                  read_text: bool = True) -> Iterator[Speaker]:
    """Reference iteration order: ids 1..114 in Data, then ValidationData."""
    for split in splits:
        for number in range(1, max_id + 1):
            sp = load_speaker(Path(root), split, number, read_text)
            if sp is not None:
                yield sp


def eatd_targets(sds, threshold: float = 53.0):
    """Label derivation shared by every EATD extraction entry point:
    SDS scores -> (sds_targets f32, clf_targets int64), depressed iff
    ``target >= 53`` (``audio_features_whole.py:113``)."""
    sds_targets = np.asarray(sds, np.float32)
    return sds_targets, (sds_targets >= threshold).astype(np.int64)


def binary_label(sds: float, threshold: float = 53.0) -> int:
    """Scalar form of :func:`eatd_targets`'s clf rule."""
    return int(eatd_targets([sds], threshold)[1][0])


def load_speakers(root: Path, splits=("Data", "ValidationData"),
                  max_id: int = MAX_SPEAKER_ID,
                  read_text: bool = False) -> List[Speaker]:
    """The whole corpus in :func:`iter_speakers` order."""
    return list(iter_speakers(root, splits, max_id, read_text))


def corpus_position(root: Path, split: str, number: int) -> int:
    """Index of ``split/number`` in :func:`iter_speakers` order, counted
    from the speaker directories alone (no wav is decoded).  Times 3 it is
    the speaker's NetVLAD ordinal base at training-time extraction."""
    idx = 0
    root = Path(root)
    for sp_split in ("Data", "ValidationData"):
        for n in range(1, MAX_SPEAKER_ID + 1):
            if sp_split == split and n == number:
                return idx
            if (root / sp_split / str(n)).is_dir():
                idx += 1
    raise ValueError(f"{split}/{number} is not an EATD speaker id")


# ---------------------------------------------------------------------------
# Synthetic corpus (for tests / demos without the restricted real corpus)
# ---------------------------------------------------------------------------


def write_wav(path: Path, data: np.ndarray, sr: int) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.clip(data, -32768, 32767).astype(np.int16).tobytes())


def make_synthetic_corpus(root: Path, n_data: int = 8, n_validation: int = 4,
                          sr: int = 16000, seconds=1.0,
                          dep_fraction: float = 0.3, seed: int = 0) -> None:
    """Writes an EATD-shaped corpus with synthetic audio/text.  Depressed
    speakers (SDS >= 53) get lower-pitch, lower-energy audio.  ``seconds``
    may be a (lo, hi) pair for per-utterance uniform durations."""
    rng = np.random.default_rng(seed)
    lo, hi = (seconds if isinstance(seconds, (tuple, list))
              else (seconds, seconds))
    for split, count in (("Data", n_data), ("ValidationData", n_validation)):
        for num in range(1, count + 1):
            dep = rng.random() < dep_fraction
            sds = float(rng.integers(55, 75) if dep else rng.integers(25, 50))
            d = Path(root) / split / str(num)
            for topic in TOPICS:
                n = int(sr * (lo if lo == hi else rng.uniform(lo, hi)))
                t = np.arange(n) / sr
                f0 = (90 if dep else 180) + rng.uniform(-10, 10)
                amp = (1200 if dep else 6000) * rng.uniform(0.8, 1.2)
                sig = amp * np.sin(2 * np.pi * f0 * t)
                sig += rng.normal(0, 300, n)
                write_wav(d / f"{topic}_out.wav", sig, sr)
                (d / f"{topic}.txt").write_text(
                    ("我 最近 很 难过 睡不着\n" if dep else "我 感觉 还 不错 很 开心\n"))
            (d / "new_label.txt").write_text(f"{sds}\n")
