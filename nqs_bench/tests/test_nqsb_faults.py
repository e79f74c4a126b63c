"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU at
small sizes, once sound and once for each fault a cell can have
(`nqs_bench/faults.py`: half the batch left out, an answer altered, a
stale step). A one-step window is compared whole."""
import time

import pytest

from nqs_bench import faults, harness

CELLS = ["cz3-sweep", "cz4-sweep", "cz3-optimize"]


def _run(root, cell):
    return harness.measure(root, harness.load_benchmark(root), cell, 2 ** 31 + 7,
                           0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    r = _run(small_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"setup_s", "step_ms", "step_ms_p95"}


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(small_root, cell, fault):
    entry = harness.Cell(small_root, harness.load_benchmark(small_root), cell,
                         "cpu").traffic["entry"]
    with faults.planted(entry, fault):
        r = _run(small_root, cell)
    assert not r["correct"], r["checks"]
