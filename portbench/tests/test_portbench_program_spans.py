"""The readers of the port's own span records (``harness/program.py`` and
the seven metrics on it), on made-up traces and records: the window picks
the records on the shared clock, a track's fixed costs are read outside
the profiled slice, and every reader gives None in a cell of another
family or where the port keeps no records."""

import time
from types import SimpleNamespace

import pytest

from portbench.harness import program, registry
from portbench.harness.cell import Context
from portbench.harness.trace import Trace

NEW = ("threefry_ms.interactive", "threefry_ms.cohort",
       "cache_key_ms.interactive", "cache_key_ms.cohort",
       "wav2vlad_pad_share.interactive", "wav2vlad_pad_share.cohort",
       "track_fixed_s.train")
S = 10**9                     # ns a second
T0 = 1_790_000_000            # a wall clock in seconds


def _rec(name, start_s, end_s, rid, parent=None, root=None, **counts):
    return SimpleNamespace(name=name, start_ns=int((T0 + start_s) * S),
                           end_ns=int((T0 + end_s) * S), id=rid,
                           parent=parent, root=rid if root is None else root,
                           counts=counts)


def _ring(records):
    def ring(start_ns, end_ns):
        return [r for r in records
                if r.end_ns >= start_ns and r.start_ns <= end_ns]
    return ring


def _ctx(family, window=(10.0, 20.0), spans=(), task="fuse_clf", **work):
    trace = Trace(window=(T0 + window[0], T0 + window[1]), device_ops=[],
                  spans=[(n, (T0 + a, T0 + b)) for n, (a, b) in spans])
    return Context(family, {"task": task}, trace, work)


@pytest.fixture(scope="module")
def readers():
    found = registry.metrics()
    return {name: found[name] for name in NEW}


def test_threefry_and_cache_key_read_the_programs_regions(readers):
    spans = [("serve/call", (10.5, 12.0)),
             ("serve/cache_key", (10.6, 10.7)),
             ("portbench/cache_key", (10.61, 10.69)),
             ("wav2vlad/bucket65536", (10.8, 11.5)),
             ("prng/fold_in", (10.9, 11.0)),
             ("prng/normal", (11.0, 11.2)),
             ("prng/split", (11.1, 11.15)),        # overlaps: counted once
             ("serve/cache_key", (11.6, 11.8))]
    ctx = _ctx("interactive", spans=spans, requests=2, speakers=2)
    assert readers["threefry_ms.interactive"].read(ctx) == \
        pytest.approx(1e3 * 0.3 / 2)
    assert readers["cache_key_ms.interactive"].read(ctx) == \
        pytest.approx(1e3 * 0.3 / 2)
    cohort = _ctx("cohort", spans=spans, requests=1, speakers=4)
    assert readers["threefry_ms.cohort"].read(cohort) == \
        pytest.approx(1e3 * 0.3 / 4)
    assert readers["cache_key_ms.cohort"].read(cohort) == \
        pytest.approx(1e3 * 0.3 / 4)
    # the harness's own wrapper around each key is not the program's
    only_harness = _ctx("interactive", spans=[spans[2]], requests=2)
    assert readers["cache_key_ms.interactive"].read(only_harness) is None


def test_pad_share_reads_the_buckets_inside_the_window(monkeypatch):
    records = [
        _rec("wav2vlad/bucket65536", 11.0, 11.5, 1, samples=48000,
             padded_samples=8 * 65536 - 48000),
        _rec("wav2vlad/bucket131072", 12.0, 12.5, 2, samples=200000,
             padded_samples=8 * 131072 - 200000),
        # a warm-up call before the window and one across its end
        _rec("wav2vlad/bucket65536", 8.0, 8.5, 3, samples=1,
             padded_samples=8 * 65536 - 1),
        _rec("wav2vlad/bucket65536", 19.9, 20.1, 4, samples=1,
             padded_samples=8 * 65536 - 1),
        # a bucket record of a checkout without counts
        _rec("wav2vlad/bucket65536", 13.0, 13.1, 5),
    ]
    monkeypatch.setattr(program, "ring", _ring(records))
    processed = 8 * 65536 + 8 * 131072
    want = 100.0 * (processed - 248000) / processed
    assert program.pad_share_pct(_ctx("interactive"), "interactive") == \
        pytest.approx(want)
    assert program.pad_share_pct(_ctx("cohort"), "interactive") is None
    assert program.pad_share_pct(_ctx("interactive", window=(30, 40)),
                                 "interactive") is None


def _track_records():
    """Two tracks: the warm-up track (0..5 s) and the traced one (6..40
    s), whose fixed costs lie outside the window (20..22 s)."""
    return [
        _rec("audio_clf/plan", 0.1, 0.3, 2, parent=1, root=1),
        _rec("foldrun/capture", 0.5, 0.9, 3, parent=5, root=1),
        _rec("audio_clf/track", 0.0, 5.0, 1),
        _rec("audio_clf/plan", 6.0, 6.25, 11, parent=10, root=10),
        _rec("foldrun/warm_epoch", 6.5, 6.75, 13, parent=12, root=10),
        _rec("foldrun/capture", 6.75, 7.0, 14, parent=12, root=10),
        _rec("foldrun/replay", 7.0, 7.1, 15, parent=12, root=10),
        _rec("foldrun/replay", 20.0, 22.0, 16, parent=12, root=10),
        _rec("audio_clf/folds", 6.4, 38.0, 12, parent=10, root=10),
        # a region another thread opened meanwhile: another root
        _rec("foldrun/capture", 30.0, 31.0, 20),
        _rec("audio_clf/save", 38.0, 39.5, 17, parent=10, root=10),
        _rec("audio_clf/track", 6.0, 40.0, 10),
    ]


def test_track_fixed_costs_lie_outside_the_window(monkeypatch):
    monkeypatch.setattr(program, "ring", _ring(_track_records()))
    ctx = _ctx("train", window=(20.0, 22.0), task="audio_clf")
    assert program.track_fixed_s(ctx, "train") == \
        pytest.approx(0.25 + 0.25 + 0.25 + 1.5)
    assert program.track_fixed_s(ctx, "interactive") is None
    # a window that no track holds, and another task's tracks
    assert program.track_fixed_s(
        _ctx("train", window=(41.0, 42.0), task="audio_clf"),
        "train") is None
    assert program.track_fixed_s(
        _ctx("train", window=(20.0, 22.0), task="text_clf"),
        "train") is None


def test_the_readers_on_the_ports_own_ring(readers):
    """The port's records, read through its ring on the shared clock."""
    from icassp2022_depression_tpu_torch.utils import profiling

    lo = time.time_ns()
    with profiling.annotate("audio_clf/track"):
        with profiling.annotate("audio_clf/plan"):
            time.sleep(0.002)
        inner_lo = time.time_ns()
        with profiling.annotate("foldrun/replay"):
            time.sleep(0.002)
        inner_hi = time.time_ns()
        with profiling.annotate("audio_clf/save"):
            time.sleep(0.001)
    with profiling.annotate("wav2vlad/bucket65536", samples=65536,
                            padded_samples=7 * 65536):
        pass
    hi = time.time_ns()
    train = Context("train", {"task": "audio_clf"},
                    Trace((inner_lo * 1e-9, inner_hi * 1e-9)))
    got = readers["track_fixed_s.train"].read(train)
    assert 0.003 <= got < (hi - lo) * 1e-9
    serve = Context("interactive", {"task": "fuse_clf"},
                    Trace((lo * 1e-9, hi * 1e-9)), {"requests": 1})
    assert readers["wav2vlad_pad_share.interactive"].read(serve) == \
        pytest.approx(87.5)


@pytest.mark.parametrize("family", ["interactive", "cohort", "train"])
def test_none_elsewhere_and_without_records(readers, family, monkeypatch):
    """In a cell of another family, and on a checkout whose port keeps
    no records (the ring gives None) or whose trace has no such region,
    every reader gives None."""
    from icassp2022_depression_tpu_torch.utils import profiling
    real_ring = program.ring
    spans = [("prng/normal", (11.0, 11.2)),
             ("serve/cache_key", (11.6, 11.8))]
    monkeypatch.setattr(program, "ring", _ring(_track_records()))
    other = {"interactive": "train", "cohort": "interactive",
             "train": "cohort"}[family]
    ctx = _ctx(other, spans=spans, window=(20.0, 22.0), task="audio_clf",
               requests=1, speakers=1)
    for name, reader in readers.items():
        if name.endswith("." + family):
            assert reader.read(ctx) is None, name
    monkeypatch.delattr(profiling, "records")
    assert real_ring(0, 2**62) is None
    monkeypatch.setattr(program, "ring", lambda start_ns, end_ns: None)
    bare = _ctx(family, window=(20.0, 22.0), task="audio_clf", requests=1,
                speakers=1)
    for name, reader in readers.items():
        assert reader.read(bare) is None, name
        assert reader.read(None) is None, name
