"""A configuration, a traffic mix and a per-layer metric are added as new
files plus BENCHMARK.json entries, with no file that is there edited: the
harness finds and reads them. So is a cell whose entry is not a gate: its
configuration holds no gate key, its mix is seeds, and its entry brings its
own reference model, CPU-test size and faults."""
import json
import os
import shutil
import textwrap
import time
from types import SimpleNamespace

from conftest import ROOT, make_small_root
from nqs_bench import faults, harness, manifest, traffic


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


# the throwaway entry: each input is a seed, the program's answer the sum of
# squares of `draws` normals that a torch.Generator seeded with it draws
TOY_ENTRY = textwrap.dedent("""
    import sys

    import numpy as np
    import torch

    from nqs_bench import faults
    from nqs_bench.traffic import cut

    FAULTS = faults.FAULTS


    def _readout(sums):
        return sums


    def _draw(seed, draws, device):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return torch.randn(draws, generator=g, device=device)


    class Program:
        def __init__(self, config, traffic, device):
            self.draws, self.device = int(config["draws"]), device

        def step(self, seeds):
            z = torch.stack([_draw(s, self.draws, self.device) for s in seeds.tolist()])
            return _readout((z * z).sum(1)).cpu().numpy()


    def valid(out):
        return bool(np.all(np.isfinite(out)) and np.all(out > 0))


    def model(config):
        return {"draws": int(config["draws"])}


    def check(model, traffic, xs, outs, rng, device, control=False):
        seeds, got = np.concatenate(xs), np.concatenate(outs).astype(np.float64)
        pick = rng.choice(len(seeds), min(int(traffic["check_members"]), len(seeds)),
                          replace=False)
        z = np.stack([_draw(int(s), model["draws"], "cpu").double().numpy()
                      for s in seeds[pick]])
        want = (z * z).sum(1)
        return {"rel_gap": float(np.max(np.abs(got[pick] - want) / want))}


    def small(config, traffic):
        return dict(config, draws=16), cut(traffic, 6)


    def planted(fault):
        return faults.patched(sys.modules[__name__], "_readout", fault,
                              lambda res, f: f(res.clone()))
""")


def test_a_cell_that_is_no_gate_is_added_as_new_files(tmp_path):
    root = str(tmp_path / "copy")
    shutil.copytree(os.path.join(ROOT, "nqs_bench"), os.path.join(root, "nqs_bench"),
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in _files(root)}

    nb = os.path.join(root, "nqs_bench")
    config = {"name": "toy-seeded", "draws": 4096, "about": "a throwaway"}
    gate_keys = set().union(*(harness.load_json(os.path.join(ROOT, c["file"]))
                              for c in harness.load_benchmark(ROOT)["configs"]))
    assert set(config) & gate_keys == {"name", "about"}
    files = {"configs/toy-seeded.json": json.dumps(config),
             "traffic/toy-seeds.json": json.dumps(
                 {"entry": "toy_draws", "inputs": {"kind": "seeds", "count": 65536},
                  "warmup_steps": 3, "trace_steps": 5, "check_members": 256}),
             "limits/toy-cell.json": json.dumps({"rel_gap": 1e-5}),
             "entries/toy_draws.py": TOY_ENTRY,
             "metrics/seeds_per_step.py":
                 "def read(ctx):\n    return float(ctx.traffic['inputs']['count'])\n"}
    for f, text in files.items():
        with open(os.path.join(nb, f), "w") as out:
            out.write(text)
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "toy-seeded", "source": "a test", "reduced": [],
                             "file": "nqs_bench/configs/toy-seeded.json", "why": "a throwaway"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy-seeded",
                               "traffic": "toy-seeds", "chips": 1, "why": "a throwaway"})
    bench["per_layer"].append({"name": "seeds_per_step", "unit": "seeds", "better": "higher",
                               "source": "program_counter", "layer": "sampler",
                               "moves": "step_ms", "workloads": ["toy-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    assert [p for p in before if open(p, "rb").read() != before[p]
            and not p.endswith("BENCHMARK.json")] == []
    assert manifest.problems(harness.load_benchmark(root), root) == []

    small = make_small_root(str(tmp_path / "small"), src=root)
    cut = harness.Cell(small, harness.load_benchmark(small), "toy-cell", "cpu")
    assert cut.config == dict(config, draws=16)
    assert cut.traffic["inputs"] == {"kind": "seeds", "count": 6}
    assert (cut.traffic["check_members"], cut.traffic["warmup_steps"]) == (6, 1)

    def run():
        return harness.measure(small, harness.load_benchmark(small), "toy-cell",
                               2 ** 31 + 7, 0.0, False, "cpu", time.perf_counter())

    r = run()
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["checks"]["rel_gap"]["value"] < 1e-6
    assert set(r["metrics"]) == {"setup_s", "step_ms", "step_ms_p95"}
    assert cut.entry.FAULTS == faults.FAULTS
    for fault in cut.entry.FAULTS:
        with faults.planted("toy_draws", fault, root=small):
            r = run()
        assert not r["correct"], (fault, r["checks"])
    r = run()                                   # each fault left with its block
    assert r["correct"], r["checks"]


def _files(root):
    for d, _, files in os.walk(root):
        for f in files:
            yield os.path.join(d, f)
