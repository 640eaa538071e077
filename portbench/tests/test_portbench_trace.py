"""The trace reduction's arithmetic on a made-up timeline, and the
readers on it."""

import pytest

from portbench.harness import readers
from portbench.harness.cell import Context
from portbench.harness.trace import Trace, short_name


def _trace():
    # window 0..10 s; kernels overlap at 1..3; a copy at 6..7
    return Trace(window=(0.0, 10.0),
                 device_ops=[("void ns::lstmp_fwd_step_kernel<float>(a)",
                              (1.0, 2.5)),
                             ("lstmp_fwd_reduce_kernel(float*)", (2.0, 3.0)),
                             ("Memcpy HtoD (Pageable -> Device)", (6.0, 7.0))],
                 spans=[("wav2vlad/bucket65536", (0.0, 4.0)),
                        ("portbench/cache_key", (3.5, 5.0)),
                        ("wav2vlad/bucket131072", (4.5, 5.5))])


def test_busy_gaps_and_spans():
    t = _trace()
    assert t.window_s == 10.0
    assert t.busy_s() == pytest.approx(3.0)
    assert t.busy_s(lambda n: n.startswith("lstmp_fwd_")) == pytest.approx(2.0)
    assert t.gaps() == [(0.0, 1.0), (3.0, 6.0), (7.0, 10.0)]
    assert t.span_s("wav2vlad/bucket") == pytest.approx(5.0)
    assert len(t.kernels()) == 2


def test_breakdown_names_the_innermost_open_span():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["lstmp_fwd_step_kernel", 1.5]
    assert ["Memcpy HtoD", 1.0] in b["device_ops"]
    gaps = dict(b["idle_gaps"])
    assert gaps["wav2vlad/bucket65536"] == pytest.approx(1.0)   # 0..1
    # mid 4.5: inside the key (3.5..5) and the shorter bucket (4.5..5.5)
    assert gaps["wav2vlad/bucket131072"] == pytest.approx(3.0)
    assert gaps["host outside spans"] == pytest.approx(3.0)     # 7..10


def test_short_names():
    assert short_name("void (anonymous namespace)::gates_kernel<true>(x)") \
        == "gates_kernel"
    assert short_name("gru_fwd_step_kernel(float const*)") == \
        "gru_fwd_step_kernel"


def test_readers_on_a_context():
    ctx = Context("interactive", {}, _trace(),
                  {"requests": 4, "speakers": 4, "flops": 67e12,
                   "bound_s": {"lstmp_fwd": 0.5}})
    assert readers.idle_pct(ctx, "interactive") == pytest.approx(70.0)
    assert readers.idle_pct(ctx, "cohort") is None
    assert readers.kernels_per(ctx, "interactive", "requests") == 0.5
    assert readers.mfu_pct(ctx, "interactive") == pytest.approx(10.0)
    assert readers.roofline_pct(ctx, "interactive", "lstmp_fwd",
                                ("lstmp_fwd_",)) == pytest.approx(25.0)
    assert readers.span_ms_per(ctx, "interactive", "wav2vlad/bucket",
                               "requests") == pytest.approx(1250.0)
    assert readers.roofline_pct(ctx, "interactive", "gru", ("gru_",)) \
        is None
