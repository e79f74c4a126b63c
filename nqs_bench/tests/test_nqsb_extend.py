"""A configuration, a traffic mix and a per-layer metric are added as new
files plus BENCHMARK.json entries, with no file that is there edited: the
harness finds and reads them."""
import json
import os
import shutil
from types import SimpleNamespace

from conftest import ROOT
from nqs_bench import harness, manifest, traffic


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "nqs_bench"), os.path.join(root, "nqs_bench"),
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in _files(root)}

    nb = os.path.join(root, "nqs_bench")
    with open(os.path.join(nb, "configs", "rb87-smoothjp-3level.json")) as f:
        cfg = json.load(f)
    cfg.update(name="rb87-smoothjp-3level-n50", n_rydberg_note="a throwaway")
    with open(os.path.join(nb, "configs", "throwaway.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(nb, "traffic", "sweep-small.json"), "w") as f:
        json.dump({"entry": "sweep", "inputs": {"kind": "uniform", "count": 4,
                   "low": 0.99, "high": 1.01, "on": "device"},
                   "warmup_steps": 1, "trace_steps": 2, "check_members": 4}, f)
    with open(os.path.join(nb, "limits", "cz3-small.json"), "w") as f:
        json.dump({"fid_gap": 1.0}, f)
    with open(os.path.join(nb, "metrics", "steps_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.attempted)\n")

    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "rb87-smoothjp-3level-n50", "source": "a test",
                             "file": "nqs_bench/configs/throwaway.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "cz3-small", "config": "rb87-smoothjp-3level-n50",
                               "traffic": "sweep-small", "chips": 1, "why": "a throwaway"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "step_ms", "workloads": ["cz3-small"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    after = {p: open(p, "rb").read() for p in before}
    edited = [p for p in before if before[p] != after[p]
              and not p.endswith("BENCHMARK.json")]
    assert edited == []
    bench = harness.load_benchmark(root)
    assert manifest.problems(bench, root) == []
    cell = harness.Cell(root, bench, "cz3-small", "cpu")
    assert cell.config["name"] == "rb87-smoothjp-3level-n50"
    assert cell.traffic["inputs"]["count"] == 4 and cell.limits == {"fid_gap": 1.0}
    assert cell.entry.SETTINGS == "sweep"
    layers = [m["name"] for m in harness.metrics_of(bench, "cz3-small", "per_layer")]
    assert layers == ["steps_seen"]
    ctx = SimpleNamespace(attempted=7)
    assert harness.metric_reader(root, "steps_seen").read(ctx) == 7.0
    assert traffic.Stream(cell.traffic["inputs"], 1, "cpu").next().shape == (4,)


def _files(root):
    for d, _, files in os.walk(root):
        for f in files:
            yield os.path.join(d, f)
