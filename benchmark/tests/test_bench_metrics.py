"""Each reader against a small synthetic Chrome trace and a small window."""

import pytest

from benchmark import roofline, spec
from benchmark.harness import Run
from benchmark.tracefile import Trace

MS = 1000  # the trace's microseconds in a millisecond


def _x(cat, name, start_ms, end_ms):
    return {"ph": "X", "cat": cat, "name": name, "ts": start_ms * MS, "dur": (end_ms - start_ms) * MS}


def _trace():
    return Trace.from_chrome({"traceEvents": [
        _x("user_annotation", "bench.window", 0, 100),
        _x("user_annotation", "bench.call", 0, 40),
        _x("user_annotation", "bench.call", 50, 100),
        _x("kernel", "void jive_kernel<2, 2>(int const*, int*, long long, AnemoiConsts<8>)", 5, 35),
        _x("kernel", "void jive_kernel<2, 2>(int const*, int*, long long, AnemoiConsts<8>)", 55, 95),
        _x("gpu_memcpy", "Memcpy HtoD", 36, 38),
        _x("cpu_op", "aten::copy_", 35, 39),
        _x("cpu_op", "pack", 40, 55),
        _x("gpu_user_annotation", "bench.call", 0, 40),  # the device's copy of a span: not a call
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]})


def _run(trace=None, calls=((0.0, 0.25), (0.25, 0.5), (0.5, 1.0)), work=None, device="NVIDIA H100 80GB HBM3"):
    work = work if work is not None else {"jive": roofline.Work(ops=1979e12 * 1e-3, bytes=0.0)}  # 1 ms a call
    return Run(device, 12.5, list(calls), {"hashes": 100, "roots": 1, "messages": 4}, work, trace)


def test_trace_intervals():
    tr = _trace()
    assert tr.window == pytest.approx((0.0, 0.1)) and len(tr.calls) == 2
    assert tr.busy_s() == pytest.approx(0.072)
    assert tr.window_s() == pytest.approx(0.1)
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "jive_kernel<2, 2>" and b["device_ops"][0][1] == pytest.approx(0.07)
    gaps = dict(b["idle_gaps"])
    assert gaps["pack"] == pytest.approx(0.017)  # 38 to 55 ms
    assert sum(gaps.values()) == pytest.approx(0.028)


def test_per_layer_readers():
    run = _run(_trace())
    assert spec.reader("device_idle_pct.root")(run) == pytest.approx(28.0)
    assert spec.reader("merkle_outside_jive_pct")(run) == pytest.approx(100 * (90 - 70) / 90)
    # 2 traced calls of 1 ms least time over 70 ms of Jive kernels
    assert spec.reader("jive_kernel_roofline.batch")(run) == pytest.approx(100 * 2 / 70)
    assert spec.reader("sponge_kernel_roofline")(run) is None  # no sponge work, no sponge kernel


@pytest.mark.parametrize("metric", ["device_idle_pct.batch", "merkle_outside_jive_pct", "jive_kernel_roofline.root",
                                    "sponge_kernel_roofline"])
def test_readers_without_a_trace_read_nothing(metric):
    assert spec.reader(metric)(_run()) is None


def test_roofline_readers_on_an_unknown_card_or_without_kernels():
    assert spec.reader("jive_kernel_roofline.root")(_run(_trace(), device="cpu")) is None
    tr = _trace()
    tr.device_ops = [op for op in tr.device_ops if "jive" not in op[0]]
    assert spec.reader("jive_kernel_roofline.root")(_run(tr)) is None


def test_end_to_end_readers():
    run = _run()
    assert spec.reader("hashes_per_s")(run) == pytest.approx(300)
    assert spec.reader("msgs_per_s")(run) == pytest.approx(12)
    assert spec.reader("root_ms")(run) == pytest.approx(1000 / 3)
    assert spec.reader("root_ms_p90")(run) == pytest.approx(450)  # 250, 250, 500 ms
    assert spec.reader("setup_s")(run) == 12.5
