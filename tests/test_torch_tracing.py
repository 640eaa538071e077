"""The port's span recorder (``utils/profiling.py``) and the regions the
serving and training paths record, on the CPU: one request's tree in
``Predictor``, one stacked track's, the records on ``torch.profiler``'s
clock, the profiler range entered only while a profiler runs, one parent
stack a thread, and the ring's bound."""

import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import char_cnn, elmo
from icassp2022_depression_tpu_torch.models import elmo_pretrained as tpre
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.serving.predictors import Predictor
from icassp2022_depression_tpu_torch.train import trainers
from icassp2022_depression_tpu_torch.utils import profiling

SMALL_FE = dict(n_fft=256, hop_length=64, n_mels=8, netvlad_clusters=4,
                netvlad_output_dim=16)
TEXTS = ["我 最近 很 难过", "今天 还 可以 谢谢", "有点累"]


def _since(t0: int) -> list:
    return profiling.records(start_ns=t0)


def _tree(recs, root) -> list:
    return [r for r in recs if r.root == root.id]


def _nested(tree) -> None:
    """Every record's parent is in the tree and holds it in time."""
    by_id = {r.id: r for r in tree}
    for r in tree:
        if r.parent is None:
            continue
        p = by_id[r.parent]
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (p, r)


@pytest.fixture(scope="module")
def fusion(tmp_path_factory):
    """A small ``fuse_clf`` predictor over a small ELMo bundle written by
    the port, its weights drawn from seeds."""
    chars = sorted(set("".join(TEXTS)))
    lex = {tok: i for i, tok in enumerate(
        ["<pad>", "<oov>", "<bos>", "<eos>", "<bow>", "<eow>"] + chars)}
    ccfg = char_cnn.CharCnnConfig(n_chars=len(lex), char_dim=4,
                                  filters=((1, 4), (2, 4)), n_highway=1,
                                  output_dim=8, max_chars=6)
    lcfg = elmo.ElmoLstmpConfig(vocab_size=1, input_dim=8, cell_size=16,
                                proj_size=8, layers=2)
    pe = tpre.PretrainedElmo(
        ccfg, lcfg, char_cnn.init(prng.prng_key(0), ccfg),
        elmo.init_lstmp_encoder(prng.prng_key(1), lcfg), lex, None)
    bundle = tmp_path_factory.mktemp("bundle") / "elmo_tiny.npz"
    tpre.save_npz(bundle, pe)
    fcfg = tconfig.FusionConfig(audio_embed_size=16, text_embed_size=16,
                                audio_hidden_dims=8, text_hidden_dims=4)
    return Predictor(FusionNet(fcfg, prng.prng_key(2)), "fuse_clf",
                     frontend_cfg=tconfig.FrontendConfig(**SMALL_FE),
                     device="cpu", elmo_weights=str(bundle),
                     segmenter="fallback")


def test_a_call_is_one_tree(fusion):
    """One ``predict_batch`` leaves one ``serve/call`` root whose
    descendants carry the serving, audio, threefry and text regions,
    linked to their parents and nested in time; the length buckets count
    the call's real samples and their padding, and no other region
    counts anything."""
    rng = np.random.default_rng(4)
    waves = [[np.round(rng.standard_normal(n) * 3000.0) for n in
              (3000, 9000, 20000)]]
    t0 = time.time_ns()
    out = fusion.predict_batch(waves, [[16000] * 3], [TEXTS])
    assert len(out) == 1
    recs = _since(t0)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["serve/call"]
    call = roots[0]
    tree = _tree(recs, call)
    assert len(tree) == len(recs)
    _nested(tree)
    names = collections.Counter(r.name for r in tree)
    assert names["serve/cache_key"] == 2
    for name in ("serve/audio", "serve/text", "text/segment",
                 "serve/forward", "serve/readback"):
        assert names[name] == 1, name
    assert names["elmo/build_batch"] == names["elmo/encode"] == 1
    buckets = [r for r in tree if r.name.startswith("wav2vlad/bucket")]
    assert len(buckets) == 2         # 3000 and 9000 share one bucket
    # each bucket draws its weights: fold_in, split, 4 normals, and no
    # draw inside another opens a region of its own
    assert names["prng/fold_in"] == names["prng/split"] == len(buckets)
    assert names["prng/normal"] == 4 * len(buckets)
    assert names["prng/uniform"] == names["prng/random_bits"] == 0
    by_id = {r.id: r for r in tree}
    for r in tree:
        if r.name.startswith("prng/"):
            assert by_id[r.parent].name.startswith("wav2vlad/bucket")
        if r.name.startswith("wav2vlad/bucket"):
            assert by_id[r.parent].name == "serve/audio"
    assert by_id[next(r.parent for r in tree
                      if r.name == "text/segment")].name == "serve/text"
    assert sum(b.counts["samples"] for b in buckets) == 32000
    # each bucket's row tile (2 rows for 3000 and 9000, 1 for 20000)
    # times its padded length, less its real samples
    tiles = {"wav2vlad/bucket16384": 2, "wav2vlad/bucket32768": 1}
    assert sorted(b.name for b in buckets) == sorted(tiles)
    for b in buckets:
        blen = int(b.name[len("wav2vlad/bucket"):])
        assert b.counts["padded_samples"] == \
            tiles[b.name] * blen - b.counts["samples"]
    assert [r.name for r in tree if r.counts and r not in buckets] == []
    # the cached speaker: the call's tree holds no extraction
    t1 = time.time_ns()
    fusion.predict_batch(waves, [[16000] * 3], [TEXTS])
    again = collections.Counter(r.name for r in _since(t1))
    assert again["serve/call"] == 1 and again["text/segment"] == 0
    assert not any(n.startswith(("wav2vlad/", "prng/", "elmo/"))
                   for n in again)


@pytest.mark.parametrize("out_dir", [False, True])
def test_a_stacked_track_is_one_tree(tmp_path, out_dir):
    """``train_audio_clf(vmap_folds=True)`` on the CPU's eager route:
    ``audio_clf/track`` holds ``audio_clf/plan`` and ``audio_clf/folds``,
    which holds the replays and the readback; the gated saves are
    ``audio_clf/save`` when there is an ``out_dir``.  The eager route
    captures nothing, and the epochs' draws open no region."""
    rng = np.random.default_rng(0)
    y = np.arange(12) % 2
    x = rng.standard_normal((12, 3, 256)).astype(np.float32)
    idx = [np.setdiff1d(np.arange(12), np.arange(f, 12, 3)) for f in range(3)]
    tcfg = tconfig.replace(tconfig.AUDIO_CLF, epochs=3)
    t0 = time.time_ns()
    trainers.train_audio_clf(x, y, idx, tcfg, device="cpu",
                             vmap_folds=True,
                             out_dir=tmp_path if out_dir else None)
    recs = _since(t0)
    track = [r for r in recs if r.name == "audio_clf/track"]
    assert len(track) == 1 and track[0].parent is None
    track = track[0]
    tree = _tree(recs, track)
    _nested(tree)
    by_id = {r.id: r for r in tree}

    def only(name):
        got = [r for r in tree if r.name == name]
        assert len(got) == 1, (name, got)
        return got[0]

    assert by_id[only("audio_clf/plan").parent] is track
    folds = only("audio_clf/folds")
    assert by_id[folds.parent] is track
    replay = only("foldrun/replay")
    assert by_id[replay.parent] is folds
    assert [r for r in tree if r.start_ns >= replay.start_ns
            and r.end_ns <= replay.end_ns and r is not replay] == []
    assert by_id[only("foldrun/readback").parent] is folds
    assert not [r for r in tree if r.name in ("foldrun/warm_epoch",
                                              "foldrun/capture")]
    saves = [r for r in tree if r.name == "audio_clf/save"]
    if out_dir:
        assert len(saves) == 1 and by_id[saves[0].parent] is track
    else:
        assert not saves


def test_no_draw_region_inside_an_epoch():
    """The serial trainer's eager epochs: each ``audio_clf/fold{i}``
    holds its fold's replays, and no threefry draw made inside an epoch
    (the dropout masks) opens a region, as none may inside what a graph
    captures; the folds' own key draws, outside the epochs, still do."""
    rng = np.random.default_rng(1)
    y = np.arange(12) % 2
    x = rng.standard_normal((12, 3, 256)).astype(np.float32)
    idx = [np.setdiff1d(np.arange(12), np.arange(f, 12, 3)) for f in range(3)]
    tcfg = tconfig.replace(tconfig.AUDIO_CLF, epochs=2)
    t0 = time.time_ns()
    trainers.train_audio_clf(x, y, idx, tcfg, device="cpu")
    recs = _since(t0)
    by_id = {r.id: r for r in recs}

    def ancestors(r):
        while r.parent is not None:
            r = by_id[r.parent]
            yield r.name

    replays = [r for r in recs if r.name == "foldrun/replay"]
    assert sorted(next(ancestors(r)) for r in replays) == \
        ["audio_clf/fold1", "audio_clf/fold2", "audio_clf/fold3"]
    draws = [r for r in recs if r.name.startswith("prng/")]
    assert draws
    assert not [r for r in draws
                if any(a.startswith("foldrun/") for a in ancestors(r))]


def test_a_record_brackets_the_profilers_event():
    """Under ``torch.profiler`` a region is also a profiler range, and
    its record, on ``time.time_ns()``, holds the profiler's event of it:
    records and traces share one clock."""
    a = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans = []
        for i in range(5):
            with profiling.annotate(f"tracing/probe{i}") as span:
                (a @ a).sum()
            spans.append(span)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("tracing/probe")}
    assert sorted(events) == [s.name for s in spans]
    for s in spans:
        e = events[s.name]
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns


def test_no_profiler_range_without_a_profiler(monkeypatch):
    """With no profiler running a region never enters
    ``record_function``; under one it does, once a region."""
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with profiling.annotate("tracing/off") as off:
        with profiling.annotate("tracing/off_inner"):
            pass
    assert entered == [] and off.end_ns is not None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("tracing/on"):
            pass
    assert entered == ["tracing/on"]


def test_threads_keep_their_own_parents():
    """Regions opened on many threads at once, switching often: each
    inner region's parent and root are its own thread's outer region,
    and the ring counts every record it took, kept or dropped."""
    threads, rounds = 16, 200
    barrier = threading.Barrier(threads)
    outers: dict = {}

    def work(k):
        barrier.wait(timeout=30)
        mine = outers.setdefault(k, set())
        for _ in range(rounds):
            with profiling.annotate(f"tracing/t{k}") as outer:
                mine.add(outer.id)
                with profiling.annotate(f"tracing/t{k}/inner") as inner:
                    pass
            assert inner.parent == outer.id and inner.root == outer.id

    small = collections.deque(maxlen=1000)
    interval = sys.getswitchinterval()
    pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    try:
        profiling.clear()
        # a small ring, so that records are dropped under contention too
        profiling._ring, big = small, profiling._ring
        sys.setswitchinterval(1e-6)
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        profiling._ring = big
    assert not any(t.is_alive() for t in pool)
    assert len(outers) == threads
    assert len(small) + profiling.dropped() == 2 * threads * rounds
    for r in small:
        k = int(r.name.split("/")[1][1:])
        if r.name.endswith("/inner"):
            assert r.parent in outers[k] and r.root == r.parent
        else:
            assert r.parent is None and r.root == r.id
    profiling.clear()


def test_the_ring_drops_its_oldest(monkeypatch):
    """Past its bound the ring lets its oldest records go and counts
    them; ``records`` picks those that overlap an interval."""
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=4))
    profiling.clear()
    spans = []
    for i in range(6):
        with profiling.annotate(f"tracing/r{i}") as span:
            time.sleep(0.001)
        spans.append(span)
    assert [r.name for r in profiling.records()] == \
        [f"tracing/r{i}" for i in range(2, 6)]
    assert profiling.dropped() == 2
    mid = profiling.records(spans[3].start_ns, spans[4].start_ns)
    assert [r.name for r in mid] == ["tracing/r3", "tracing/r4"]
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0
