"""The speaker generator: the same seed gives the same speakers, every seed
the same sizes, and no two speakers of a run the same content."""

import hashlib

import numpy as np

from portbench.harness import registry
from portbench.harness.requests import SpeakerPool

CHARS = [chr(0x4E00 + i) for i in range(6778)]


def _mix(name, pool=16):
    return dict(registry.traffic(name), pool=pool)


def _digest(waves, texts):
    h = hashlib.sha256()
    for w in waves:
        h.update(w.tobytes())
    for t in texts or []:
        h.update(t.encode())
    return h.hexdigest()


def test_same_seed_same_speakers():
    a = SpeakerPool(_mix("interactive"), 2**31 + 17, CHARS)
    b = SpeakerPool(_mix("interactive"), 2**31 + 17, CHARS)
    for s in (0, 5, 16, 100):
        wa, ta = a.speaker(s)
        wb, tb = b.speaker(s)
        assert ta == tb
        assert all(np.array_equal(x, y) for x, y in zip(wa, wb))


def test_every_seed_the_same_sizes():
    mix = _mix("cohort", pool=32)
    sizes = []
    for seed in (1, 2**31 + 3, 2**32 + 11):
        pool = SpeakerPool(mix, seed, CHARS)
        sizes.append((sorted(len(w) for ws in pool.waves for w in ws),
                      sorted(len(t) for ts in pool.texts for t in ts)))
    assert sizes[0] == sizes[1] == sizes[2]
    lo, hi = mix["answer_seconds"]
    lengths = np.asarray(sizes[0][0]) / mix["sample_rate"]
    assert lo <= lengths.min() and lengths.max() <= hi
    chars = np.asarray(sizes[0][1])
    lo, hi = mix["transcript_chars"]
    assert chars.min() == lo and chars.max() == hi


def test_no_two_speakers_share_content():
    pool = SpeakerPool(_mix("interactive", pool=8), 3, CHARS)
    seen = {_digest(*pool.speaker(s)) for s in range(400)}
    assert len(seen) == 400
    audio = SpeakerPool(_mix("interactive", pool=8), 3, text=False)
    seen = {_digest(*audio.speaker(s)) for s in range(400)}
    assert len(seen) == 400


def test_a_call_holds_distinct_speakers():
    pool = SpeakerPool(_mix("cohort", pool=64), 9, CHARS)
    kw = pool.call(32, 32)
    assert len(kw["waveforms_per_speaker"]) == 32
    digests = {_digest(w, t) for w, t in zip(kw["waveforms_per_speaker"],
                                             kw["texts_per_speaker"])}
    assert len(digests) == 32
    assert kw["sample_rates"][0] == [16000] * 3


def test_every_seed_the_same_speakers_in_another_order():
    """A speaker's three sizes are one of the same triples in every seed,
    so a seed does not change how many length buckets a request fills."""
    mix = _mix("interactive", pool=16)
    triples = []
    for seed in (5, 2**31 + 6):
        pool = SpeakerPool(mix, seed, CHARS)
        triples.append((sorted(tuple(sorted(len(w) for w in ws))
                               for ws in pool.waves),
                        sorted(tuple(sorted(len(t) for t in ts))
                               for ts in pool.texts)))
    assert triples[0] == triples[1]
    lengths = triples[0][0]
    assert all(a < b < c for a, b, c in lengths)
