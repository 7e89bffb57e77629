"""Window accounting, percentiles and the trace's busy union on
synthetic timestamps."""

import pytest

from bench.accounting import Rec, itls, percentile, tokens_in, ttfts
from bench.trace import Trace, breakdown, short_name


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 90) == 90
    assert percentile(xs, 95) == 95
    assert percentile(xs, 100) == 100
    assert percentile([5.0], 90) == 5.0
    assert percentile([], 90) is None
    assert percentile([3, 1, 2], 50) == 2


def _recs():
    a = Rec(0, 10, 4, due=0.5, tokens=[1.0, 1.1, 1.3, 2.4], reason="done")
    b = Rec(1, 10, 4, due=1.5, tokens=[1.9, 2.2], reason=None)
    c = Rec(2, 10, 4, due=1.8, tokens=[], reason=None)
    d = Rec(3, 10, 4, due=1.2, tokens=[1.4], reason="failed")
    e = Rec(4, 10, 4, due=2.5, tokens=[2.6], reason="done")
    return [a, b, c, d, e]


def test_window_accounting():
    recs = _recs()
    # window [1, 2): tokens at 1.0, 1.1, 1.3, 1.9, 1.4
    assert tokens_in(recs, 1.0, 2.0) == 5
    # due in [1, 2): b (0.4), c (no token: end - due), d (failed: end)
    assert ttfts(recs, 1.0, 2.0, end=3.0) == pytest.approx(
        [0.4, 1.2, 1.8])
    # later token in [1, 2): a's 1.0->1.1 and 1.1->1.3; 1.3->2.4 is out
    assert itls(recs, 1.0, 2.0) == pytest.approx([0.1, 0.2])
    assert itls(recs, 2.0, 3.0) == pytest.approx([1.1, 0.3])


def test_trace_union_gaps_and_roles():
    tr = Trace(0.0, 10.0, [("void ns::paged_decode_kernel<float>(x)",
                            1.0, 3.0),
                           ("gemm", 2.0, 4.0), ("gemm", 6.0, 7.0),
                           ("Memcpy DtoH", 9.5, 11.0),
                           ("gemm", -1.0, 0.5)])
    assert tr.busy() == [[0.0, 0.5], [1.0, 4.0], [6.0, 7.0], [9.5, 10.0]]
    assert tr.busy_s() == pytest.approx(5.0)
    assert tr.gaps() == [(0.5, 1.0), (4.0, 6.0), (7.0, 9.5)]
    assert tr.time_of(["paged_decode_kernel", "flash_decode_kernel"]) \
        == pytest.approx(2.0)
    assert short_name("void ns::paged_decode_kernel<float>(x)") \
        == "paged_decode_kernel"
    bd = breakdown(tr, lambda t: "decode step" if t < 5.5 else "wait", top=2)
    assert bd["idle_gaps"] == [["wait", 2.5], ["decode step", 2.0]]
    assert bd["device_ops"][0] == ["gemm", pytest.approx(3.5)]
