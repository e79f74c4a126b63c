"""Fixtures of the benchmark's own tests (`python -m pytest nqs_bench/tests`):
the checkout's root on the import path, and a copy of the benchmark's files
at sizes a CPU test run holds."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

def make_small_root(dest: str, src: str = ROOT) -> str:
    """A root holding the BENCHMARK.json and the benchmark's data files of
    the checkout at `src`, each cell's configuration and mix cut by its
    entry's `small` to sizes a CPU test run holds; limits as committed."""
    from nqs_bench import harness
    for sub in ("configs", "traffic", "limits", "entries", "metrics"):
        shutil.copytree(os.path.join(src, "nqs_bench", sub),
                        os.path.join(dest, "nqs_bench", sub))
    shutil.copy(os.path.join(src, "BENCHMARK.json"), dest)
    bench = harness.load_benchmark(src)
    cut = {}
    for cell in bench["workloads"]:
        files = (harness.find(bench["configs"], cell["config"])["file"],
                 os.path.join("nqs_bench", "traffic", f"{cell['traffic']}.json"))
        config, mix = (harness.load_json(os.path.join(src, f)) for f in files)
        entry = harness.entry_module(src, mix["entry"])
        for f, data in zip(files, entry.small(config, mix)):
            if cut.setdefault(f, data) != data:
                raise ValueError(f"two cells cut {f} to different sizes")
    for f, data in cut.items():
        with open(os.path.join(dest, f), "w") as out:
            json.dump(data, out)
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return make_small_root(str(tmp_path_factory.mktemp("nqsb_small")))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
