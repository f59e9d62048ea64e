"""The readers of the program's spans (``spans.py``) against small synthetic
Chrome traces, built as in test_bench_metrics.py."""

import pytest

from benchmark import spans, spec
from benchmark.harness import Run
from benchmark.tracefile import Trace

MS = 1000  # the trace's microseconds in a millisecond
JIVE = "void jive_kernel<2, 2>(int const*, int*, long long, AnemoiConsts<8>)"
SPAN_METRICS = ["bytes_pack_ms", "bytes_layout_ms", "bytes_upload_ms", "merkle_level_efficiency_pct",
                "launches_per_call.root"]


def _x(cat, name, start_ms, end_ms):
    return {"ph": "X", "cat": cat, "name": name, "ts": start_ms * MS, "dur": (end_ms - start_ms) * MS}


def _run(events, items):
    tr = Trace.from_chrome({"traceEvents": [_x("user_annotation", "bench.window", 0, 100), *events]})
    return Run("NVIDIA H100 80GB HBM3", 1.0, [(0.0, 0.05), (0.05, 0.1)], items, {}, tr)


def _bytes_run(with_spans=True):
    """Two calls of the byte pipeline: a pack, two buckets' layouts and uploads."""
    events = []
    for t in (0, 50):
        events += [_x("user_annotation", "bench.call", t, t + 50),
                   _x("user_annotation", "anemoi.bytes.hash", t, t + 48),
                   _x("cpu_op", "aten::copy_", t + 21, t + 22), _x("kernel", "sponge_kernel<2>", t + 25, t + 45)]
        if with_spans:
            events += [_x("user_annotation", "anemoi.bytes.pack", t + 1, t + 11),
                       _x("user_annotation", "anemoi.bytes.layout", t + 11, t + 15),
                       _x("user_annotation", "anemoi.bytes.upload", t + 15, t + 16),
                       _x("user_annotation", "anemoi.bytes.layout", t + 17, t + 19),
                       _x("user_annotation", "anemoi.bytes.upload", t + 19, t + 22)]
    return _run(events, {"messages": 4})


def _root_run(level_ms=((8,), (4,)), arity=2, kernels=None, with_spans=True):
    """Two calls of a root; call c's level k runs level_ms[k][c] ms of Jive
    (the first call's time where the second has none), behind a launch span
    and a copy kernel; `kernels` gives each call's count of Jive kernels."""
    m = len(level_ms)
    events = []
    for c, t in enumerate((0, 50)):
        events += [_x("user_annotation", "bench.call", t, t + 50),
                   _x("user_annotation", "anemoi.merkle.root", t, t + 49)]
        at = t + 1
        for k in range(kernels[c] if kernels else m):
            times = level_ms[min(k, m - 1)]
            ms = times[min(c, len(times) - 1)]
            if with_spans and k < m:
                events += [_x("user_annotation", "anemoi.merkle.level", at, at + 1),
                           _x("user_annotation", "anemoi.launch", at + 0.5, at + 0.75)]
            events += [_x("kernel", "elementwise_kernel<128, 2>", at + 0.1, at + 0.2),
                       _x("kernel", JIVE, at + 1, at + 1 + ms)]
            at += 1 + ms
    return _run(events, {"roots": 1, "hashes": (arity**m - 1) // (arity - 1)})


def test_byte_phases_ms_a_call():
    run = _bytes_run()
    assert spec.reader("bytes_pack_ms")(run) == pytest.approx(10)
    assert spec.reader("bytes_layout_ms")(run) == pytest.approx(6)  # 4 + 2 ms, two buckets
    assert spec.reader("bytes_upload_ms")(run) == pytest.approx(4)  # 1 + 3 ms


def test_launches_a_call():
    assert spec.reader("launches_per_call.root")(_root_run(((8,), (4,), (2,)))) == pytest.approx(3.0)


def test_level_efficiency_arity_2():
    # 3 levels of 4, 2, 1 states: level 1 at 2 ms a state, 7 hashes would take 14 ms
    assert spec.reader("merkle_level_efficiency_pct")(_root_run(((8,), (4,), (2,)))) == pytest.approx(100.0)
    # the top two levels take 6 and 5 ms: 14 of 19 ms
    assert spec.reader("merkle_level_efficiency_pct")(_root_run(((8,), (6,), (5,)))) == pytest.approx(100 * 14 / 19)
    # a mean over the calls: the second call's level 1 twice as slow a state
    value = spec.reader("merkle_level_efficiency_pct")(_root_run(((8, 16), (6,), (5,))))
    assert value == pytest.approx((100 * 14 / 19 + 100 * 28 / 27) / 2)


def test_level_efficiency_arity_4():
    # 2 levels of 4 and 1 states: 5 hashes; level 1 at 1 ms a state, the top at 3 ms
    assert spans.arity_of(5, 2) == 4 and spans.arity_of(21, 3) == 4 and spans.arity_of(2**20 - 1, 20) == 2
    assert spec.reader("merkle_level_efficiency_pct")(_root_run(((4,), (3,)), arity=4)) == pytest.approx(100 * 5 / 7)


def test_level_efficiency_none_when_levels_and_kernels_disagree():
    assert spec.reader("merkle_level_efficiency_pct")(_root_run(((8,), (4,)), kernels=(2, 3))) is None
    assert spans.arity_of(8, 3) is None and spans.arity_of(3, 1) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_no_program_spans_read_nothing(metric):
    """The parent's trace: the harness's spans and the kernels, no anemoi.* span."""
    run = _bytes_run(with_spans=False) if metric.startswith("bytes") else _root_run(with_spans=False)
    assert spec.reader(metric)(run) is None
    assert spec.reader(metric)(Run("cpu", 1.0, [(0.0, 1.0)], {"hashes": 3}, {}, None)) is None
