"""BENCHMARK.json keeps the benchmark's rules, and the files it names exist."""
import copy
import json
import os

import pytest

from conftest import ROOT
from nqs_bench import harness, manifest

BENCH = harness.load_benchmark(ROOT)


def test_committed_manifest_keeps_every_rule():
    assert manifest.problems(BENCH, ROOT) == []


@pytest.mark.parametrize("breakage,what", [
    (lambda b: b["workloads"][0].update(name="has space"), "name"),
    (lambda b: b["end_to_end"][1].update(unit="ms per step"), "unit"),
    (lambda b: b["per_layer"][1].update(moves="setup_s_x"), "moves"),
    (lambda b: b["end_to_end"][1].update(bound=0.3), "bound"),
    (lambda b: b["end_to_end"][1].update(workloads=["cz3-sweep"]), "lacks"),
    (lambda b: b.update(run_seconds=52), "run_seconds"),
    (lambda b: b["configs"][0].update(reduced=["hidden_size"]), "reduced"),
    (lambda b: b["per_layer"][0].update(why="extra key"), "keys"),
])
def test_a_broken_manifest_is_refused(breakage, what):
    b = copy.deepcopy(BENCH)
    breakage(b)
    assert any(what in p for p in manifest.problems(b, ROOT))


def test_every_cell_has_its_files():
    for cell in BENCH["workloads"]:
        for sub, name in (("traffic", cell["traffic"]), ("limits", cell["name"])):
            assert os.path.isfile(os.path.join(ROOT, "nqs_bench", sub, f"{name}.json"))
        with open(os.path.join(ROOT, "nqs_bench", "traffic", f"{cell['traffic']}.json")) as f:
            entry = json.load(f)["entry"]
        assert os.path.isfile(os.path.join(ROOT, "nqs_bench", "entries", f"{entry}.py"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "nqs_bench", "metrics", f"{m['name']}.py"))


def test_each_cell_reports_what_its_layer_metrics_move():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(BENCH, cell["name"], "end_to_end")}
        layers = harness.metrics_of(BENCH, cell["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        assert all(m["moves"] in e2e for m in layers)
