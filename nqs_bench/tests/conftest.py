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

# the copy's sizes: rows a step and answers compared (all of a one-step
# window), per mix; segments per configuration
SMALL_TRAFFIC = {"sweep-32768": 8, "sweep-8192": 2, "population-1024": 8}
SMALL_STEPS = {3: 60, 4: 12}


def make_small_root(dest: str) -> str:
    """A root holding BENCHMARK.json and the benchmark's data files, cut to
    SMALL_TRAFFIC rows and SMALL_STEPS segments; limits as committed."""
    for sub in ("configs", "traffic", "limits", "entries", "metrics"):
        shutil.copytree(os.path.join(ROOT, "nqs_bench", sub),
                        os.path.join(dest, "nqs_bench", sub))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for name, n in SMALL_TRAFFIC.items():
        p = os.path.join(dest, "nqs_bench", "traffic", f"{name}.json")
        with open(p) as f:
            t = json.load(f)
        t["inputs"]["count"] = n
        t.update(check_members=n, warmup_steps=1, trace_steps=2)
        with open(p, "w") as f:
            json.dump(t, f)
    for p in os.scandir(os.path.join(dest, "nqs_bench", "configs")):
        with open(p.path) as f:
            c = json.load(f)
        c["n_steps"] = SMALL_STEPS[c["hilbert_space_dim"]]
        with open(p.path, "w") as f:
            json.dump(c, f)
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
