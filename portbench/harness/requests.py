"""The general generator of speakers for the serving mixes.

A mix file gives the pool size and the ranges; a seed gives the pool.
Every seed draws the same speakers' sizes in another order: the answer
lengths and the transcript lengths lie on an even grid over their ranges,
and speaker ``i`` of the grid holds its ``i``-th shortest, middle and
longest third (one answer from each third), so a seed changes which
speaker comes when and in which order its answers come, not how many
length buckets a speaker's answers fill or how much work a pass over the
pool is.

Speaker ``s`` (0, 1, 2, ... over a run: warm-up first, then the window)
is pool entry ``s % pool`` with the mark ``s // pool`` written into it:
two samples of its first answer and two characters of its first
transcript.  So no two speakers of a run have the same content, and no
cache of any size can serve one from another.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _grid(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


class SpeakerPool:
    def __init__(self, mix: dict, seed: int, chars: Sequence[str] = (),
                 text: bool = True):
        self.size = int(mix["pool"])
        self.sr = int(mix["sample_rate"])
        self.chars = list(chars)
        rng = np.random.default_rng(seed)
        n = 3 * self.size
        lo, hi = mix["answer_seconds"]
        lengths = self._triples(
            np.round(_grid(lo, hi, n) * self.sr).astype(np.int64), rng)
        amp = int(mix["amplitude"])
        flat = rng.integers(-amp, amp + 1, int(lengths.sum()),
                            dtype=np.int16)
        cuts = np.cumsum(lengths)[:-1]
        waves = np.split(flat, cuts)
        self.waves = [waves[3 * i:3 * i + 3] for i in range(self.size)]
        self.texts: List[List[str]] = []
        if text:
            lo, hi = mix["transcript_chars"]
            counts = self._triples(np.round(_grid(lo, hi + 1, n) - 0.5)
                                   .astype(np.int64).clip(lo, hi), rng)
            ids = rng.integers(0, len(self.chars), int(counts.sum()))
            pieces = np.split(ids, np.cumsum(counts)[:-1])
            sentences = ["".join(self.chars[i] for i in p) for p in pieces]
            self.texts = [sentences[3 * i:3 * i + 3]
                          for i in range(self.size)]

    def _triples(self, grid: np.ndarray, rng) -> np.ndarray:
        """A sorted grid of ``3 * size`` values -> the pool's values in
        speaker-major order: speaker ``i`` of the grid takes values ``i``,
        ``i + size`` and ``i + 2 size``; the speakers and each speaker's
        three come in an order drawn from ``rng``."""
        triples = np.sort(grid).reshape(3, self.size).T
        triples = triples[rng.permutation(self.size)]
        return np.stack([row[rng.permutation(3)] for row in triples]) \
            .reshape(-1)

    def speaker(self, s: int):
        """(3 int16 waveforms, 3 transcripts or None) of speaker ``s``."""
        p, mark = s % self.size, s // self.size
        waves = [w.copy() for w in self.waves[p]]
        waves[0][0] = mark % 32768
        waves[0][1] = (mark // 32768) % 32768
        texts = None
        if self.texts:
            k = len(self.chars)
            first = self.texts[p][0]
            texts = [self.chars[mark % k] + self.chars[(mark // k) % k]
                     + first[2:]] + self.texts[p][1:]
        return waves, texts

    def size_of(self, s: int) -> int:
        """Samples and characters of speaker ``s`` (its work)."""
        p = s % self.size
        return (sum(len(w) for w in self.waves[p])
                + (sum(len(t) for t in self.texts[p]) if self.texts else 0))

    def call(self, first: int, count: int) -> dict:
        """``Predictor.predict_batch``'s arguments for speakers ``first ..
        first + count``."""
        speakers = [self.speaker(s) for s in range(first, first + count)]
        kw = {"waveforms_per_speaker": [w for w, _ in speakers],
              "sample_rates": [[self.sr] * 3 for _ in speakers]}
        if self.texts:
            kw["texts_per_speaker"] = [t for _, t in speakers]
        return kw
