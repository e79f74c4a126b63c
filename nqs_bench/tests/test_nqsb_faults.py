"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU at
small sizes, once sound and once for each fault that a cell's entry names
(`FAULTS`, planted through `nqs_bench/faults.py`: half the batch left out,
an answer altered, a stale step). The cells are BENCHMARK.json's. A
one-step window is compared whole."""
import time

import pytest

from conftest import ROOT
from nqs_bench import faults, harness, traffic

BENCH = harness.load_benchmark(ROOT)
CELLS = [c["name"] for c in BENCH["workloads"]]


def _entry(cell):
    return traffic.load(ROOT, harness.find(BENCH["workloads"], cell)["traffic"])["entry"]


def _run(root, cell):
    return harness.measure(root, harness.load_benchmark(root), cell, 2 ** 31 + 7,
                           0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    r = _run(small_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")}


@pytest.mark.parametrize("cell,fault", [
    pytest.param(c, f, id=f"{c}-{f}") for c in CELLS
    for f in harness.entry_module(ROOT, _entry(c)).FAULTS])
def test_broken_run_is_not_correct(small_root, cell, fault):
    with faults.planted(_entry(cell), fault, root=small_root):
        r = _run(small_root, cell)
    assert not r["correct"], r["checks"]
