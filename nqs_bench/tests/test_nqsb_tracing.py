"""The trace arithmetic on a synthetic trace: union, idle share (the
program's `profile_window` arithmetic), top device operations, idle gaps
named by the host op running at their start."""
import pytest

from nqs_bench import tracing


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("kernel", "k1", 0, 10), _ev("kernel", "k1", 5, 10),      # overlap: 0-15
    _ev("gpu_memcpy", "copy", 20, 5),                             # 20-25
    _ev("kernel", "k2", 40, 10),                                  # 40-50
    _ev("cpu_op", "aten::bmm", 14, 10),                           # covers 15
    _ev("cpu_op", "outer", 0, 100),
    _ev("cuda_runtime", "cudaLaunchKernel", 25, 2),                # not a host op here
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1},
]


def test_union_busy_and_idle_share():
    dev = tracing.device_events(EVENTS)
    assert tracing.merged(dev) == [(0.0, 15.0), (20.0, 25.0), (40.0, 50.0)]
    assert tracing.busy_span(dev) == (30.0, 50.0)
    assert tracing.idle_share(dev) == pytest.approx(0.4)
    assert tracing.idle_share([]) is None


def test_kernels_and_top_ops():
    dev = tracing.device_events(EVENTS)
    assert len(tracing.kernels(dev)) == 3 and len(tracing.kernels(dev, "k2")) == 1
    top = tracing.top_device_ops(dev)
    assert top[0] == ["k1", pytest.approx(20e-6)]
    assert [n for n, _ in top] == ["k1", "k2", "copy"]


def test_idle_gaps_named_by_the_innermost_host_op():
    dev = tracing.device_events(EVENTS)
    gaps = dict((n, t) for n, t in tracing.idle_gaps(EVENTS, dev))
    # 15-20 under aten::bmm (the inner op); 25-40 under "outer" alone
    assert gaps == {"aten::bmm": pytest.approx(5e-6), "outer": pytest.approx(15e-6)}


def test_idle_gaps_without_host_ops_named_by_the_op_before():
    dev = tracing.device_events([e for e in EVENTS if e["cat"] != "cpu_op"])
    gaps = dict((n, t) for n, t in tracing.idle_gaps(EVENTS[:4], dev))
    # 15-20 follows the second k1 (ends at 15), 25-40 follows the copy
    assert gaps == {"after k1": pytest.approx(5e-6), "after copy": pytest.approx(15e-6)}
