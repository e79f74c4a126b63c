"""The control, on the card at the cells' own sizes: the reference computed
in TF32 in the program's place comes out not correct, on three seeds, while
the program on the same answers is correct. Marked `cuda`."""
import pytest

from conftest import ROOT
from nqs_bench import calibrate, harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["cz3-sweep", "cz4-sweep", "cz3-optimize-8192"])
def test_control_fails_and_program_passes(cuda, name):
    cell = harness.Cell(ROOT, harness.load_benchmark(ROOT), name, "cuda")
    cell.build()
    seeds = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]
    res = calibrate.readings(cell, seeds, set(seeds), 0.5)
    for r in res.values():
        assert cell.verdict(r["program"]), r
        assert not cell.verdict(r["control"]), r
