"""The program-span readers (`program_spans.py` and the five metrics that use
it) on a synthetic trace and synthetic spans: the spans' clock converted by
the file's `baseTimeNanoseconds`, idle gaps inside and outside a step,
device work matched to its launch by `correlation`, the count of traced
steps, and nothing read from an untraced run or a program without spans."""
import json
from types import SimpleNamespace

import pytest

from conftest import ROOT
from noisyquantumsimulator_tpu_torch.utils.observability import Span
from nqs_bench import harness, program_spans, tracing

BASE = 1_790_000_000_000_000_000          # baseTimeNanoseconds
READERS = ["plan_s", "first_call_s", "scan_host_ms", "scan_device_ms",
           "program_idle_share"]


def _at(us):
    return BASE + int(us * 1e3)


# spans, in the order they open (times in us on the trace's clock)
SPANS = [
    Span("nqs.plan", _at(-9e6), _at(-8.2e6), -1, -1),            # 0.8 s, set-up
    Span("nqs.step", _at(-5e6), _at(-4e6), -1, 1),              # warm-up, 1 s
    Span("nqs.scan", _at(-4.9e6), _at(-4.5e6), 1, 1),
    Span("nqs.step", _at(100), _at(200), -1, 3),                # traced step 1
    Span("nqs.scan", _at(110), _at(150), 3, 3),
    Span("nqs.step", _at(300), _at(400), -1, 5),                # traced step 2
    Span("nqs.scan", _at(310), _at(350), 5, 5),
]


def _ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


EVENTS = [
    _ev("cuda_runtime", "cudaLaunchKernel", 120, 2, 1),   # inside step 1's scan
    _ev("kernel", "scan_kernel", 130, 30, 1),              # 130-160
    _ev("cuda_runtime", "cudaLaunchKernel", 160, 2, 2),   # step 1, after its scan
    _ev("kernel", "fidelity", 170, 10, 2),                 # 170-180
    _ev("cuda_runtime", "cudaMemcpyAsync", 190, 2, 3),
    _ev("gpu_memcpy", "Memcpy DtoH", 195, 3, 3),           # 195-198
    _ev("cuda_runtime", "cudaLaunchKernel", 250, 2, 4),   # the caller's draw
    _ev("kernel", "uniform", 260, 10, 4),                  # 260-270
    _ev("cuda_driver", "cuLaunchKernel", 320, 2, 5),      # inside step 2's scan
    _ev("kernel", "scan_kernel", 330, 60, 5),              # 330-390
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 5, "id": 1},
]


def _ctx(tmp_path, steps=2, events=EVENTS):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))
    return SimpleNamespace(trace={"path": str(path), "events": events, "steps": steps,
                                  "device": tracing.device_events(events)})


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(SPANS))


def _read(name, ctx):
    return harness.metric_reader(ROOT, name).read(ctx)


def test_spans_converted_to_the_trace_clock(tmp_path, spans):
    v = program_spans.view(_ctx(tmp_path))
    assert v.steps == [pytest.approx((100, 200)), pytest.approx((300, 400))]
    assert v.scans == [pytest.approx((110, 150)), pytest.approx((310, 350))]
    assert program_spans.base_ns(str(tmp_path / "trace.json")) == BASE


def test_set_up_spans(tmp_path, spans):
    ctx = _ctx(tmp_path)
    assert _read("plan_s", ctx) == pytest.approx(0.8)
    assert _read("first_call_s", ctx) == pytest.approx(1.0)


def test_scan_host_time_per_step(tmp_path, spans):
    assert _read("scan_host_ms", _ctx(tmp_path)) == pytest.approx((40 + 40) / 2 * 1e-3)


def test_device_work_matched_to_its_launch_by_correlation(tmp_path, spans):
    v = program_spans.view(_ctx(tmp_path))
    # the kernels of launches 1 and 5 (runtime and driver calls inside the
    # scans); not the fidelity, the copy or the caller's draw
    assert program_spans.scan_device(v) == [(130, 160), (330, 390)]
    assert _read("scan_device_ms", _ctx(tmp_path)) == pytest.approx((30 + 60) / 2 * 1e-3)


def test_idle_gaps_inside_and_outside_a_step(tmp_path, spans):
    ctx = _ctx(tmp_path)
    # gaps from 160, 180 and 198 begin inside step 1 (10 + 15 + 62 us); the
    # gap from 270 begins between the steps (the caller's, 60 us); span 260 us
    assert _read("program_idle_share", ctx) == pytest.approx(100 * 87 / 260)
    assert _read("idle_share", ctx) == pytest.approx(100 * (87 + 60) / 260)


def test_the_count_of_traced_steps_is_checked(tmp_path, spans):
    for reader in READERS:
        with pytest.raises(RuntimeError, match="2 program nqs.step spans"):
            _read(reader, _ctx(tmp_path, steps=3))


def test_nothing_read_untraced_or_without_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(SPANS))
    for reader in READERS:
        assert _read(reader, SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    for reader in READERS:
        assert _read(reader, _ctx(tmp_path)) is None


def test_a_program_without_the_recorder_keeps_no_spans(monkeypatch):
    from noisyquantumsimulator_tpu_torch.utils import observability
    monkeypatch.delattr(observability, "spans")
    assert program_spans.recorded() is None
