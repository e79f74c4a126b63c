"""The port's span recorder (`utils/observability`) on the CPU: nothing kept
while no profiler records, every span kept while one does, and the gate
engine's spans where the program opens them: the process's first plan and
each entry closure's first call in any case, one nqs.step and one nqs.scan
an entry call (none inside the segment loop)."""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu_torch import bench_gate
from noisyquantumsimulator_tpu_torch.core.configs import NoiseSourceConfig
from noisyquantumsimulator_tpu_torch.gate import simulate as tsim
from noisyquantumsimulator_tpu_torch.optimize import engine
from noisyquantumsimulator_tpu_torch.optimize.apparatus import ApparatusConstraints
from noisyquantumsimulator_tpu_torch.utils import observability as tobs

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]
X0 = [10.09, 0.977, 1.242, 4.696, 0.0205]      # a smooth-JP parameter vector


@pytest.fixture(autouse=True)
def fresh():
    tobs.clear()
    yield
    tobs.clear()


@pytest.fixture(scope="module")
def problem():
    return engine.build_fixed_problem(ApparatusConstraints(), NoiseSourceConfig.full(),
                                      dtype=torch.complex64, device="cpu")


def _names():
    return [r.name for r in tobs.spans()]


def _sweep(n_steps):
    fn, scales, _ = bench_gate.build_workload(2, n_steps=n_steps, device="cpu")
    return lambda: fn(scales)


def _population(problem, n_steps):
    fn = engine.make_population_objective(problem, "smooth_jp", n_steps=n_steps)
    x = torch.tensor(np.array([X0, X0]))
    return lambda: fn(x)


def test_no_record_when_off():
    with tobs.span("nqs.step"):
        with tobs.span("nqs.scan"):
            pass
    assert tobs.spans() == []


def test_records_under_a_profiler_and_none_after():
    with torch.profiler.profile(activities=CPU):
        with tobs.span("nqs.step"):
            pass
    with tobs.span("nqs.step"):
        pass
    rec = tobs.spans()
    assert [r.name for r in rec] == ["nqs.step"] and rec[0].end_ns >= rec[0].start_ns


def test_always_records_itself_and_what_it_holds():
    with tobs.span("nqs.step", always=True):
        with tobs.span("nqs.scan"):
            pass
    with tobs.span("nqs.scan"):
        pass
    assert [(r.name, r.parent, r.step) for r in tobs.spans()] == [
        ("nqs.step", -1, 0), ("nqs.scan", 0, 0)]


def test_the_process_first_plan_is_recorded(monkeypatch):
    monkeypatch.setattr(tsim, "_planned", False)
    call = _sweep(4)                       # plans once
    assert _names() == ["nqs.plan"]
    tobs.clear()
    _sweep(4)
    call()
    call()
    assert "nqs.plan" not in _names()


@pytest.mark.parametrize("entry", ["sweep", "population"])
def test_the_first_call_is_recorded(problem, entry):
    call = _sweep(4) if entry == "sweep" else _population(problem, 4)
    tobs.clear()
    call()
    call()
    assert _names() == ["nqs.step", "nqs.scan"]


@pytest.mark.parametrize("n_steps", [3, 9])
@pytest.mark.parametrize("entry", ["sweep", "population"])
def test_one_step_and_one_scan_per_call(problem, entry, n_steps):
    call = _sweep(n_steps) if entry == "sweep" else _population(problem, n_steps)
    call()
    tobs.clear()
    with torch.profiler.profile(activities=CPU):
        call()
        call()
    rec = tobs.spans()
    assert [(r.name, r.parent, r.step) for r in rec] == [
        ("nqs.step", -1, 0), ("nqs.scan", 0, 0), ("nqs.step", -1, 2), ("nqs.scan", 2, 2)]
    for step, scan in (rec[:2], rec[2:]):
        assert step.start_ns <= scan.start_ns <= scan.end_ns <= step.end_ns
