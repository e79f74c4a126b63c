"""The gate entries own what was the harness's: their reference model is
`gate_model.build` under their settings, and the small root that their
`small` cuts holds, key for key, the sizes that the CPU tests have always
run the committed cells at."""
import dataclasses
import json
import os

import numpy as np
import pytest

from conftest import ROOT, make_small_root
from nqs_bench import harness
from nqs_bench.reference import gate_model

# the CPU tests' sizes before the entries cut them: rows a step (all
# compared) by mix, segments by hilbert_space_dim
SMALL_TRAFFIC = {"sweep-32768": 8, "sweep-8192": 2, "population-8192": 8}
SMALL_STEPS = {3: 60, 4: 12}
CONFIGS = ["rb87-smoothjp-3level", "rb87-smoothjp-4level"]


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


# every configuration under each entry whose settings block it states
@pytest.mark.parametrize("entry,config", [("sweep", CONFIGS[0]), ("sweep", CONFIGS[1]),
                                          ("population", CONFIGS[0])])
def test_model_is_the_gate_model(entry, config):
    mod = harness.entry_module(ROOT, entry)
    cfg = _json(ROOT, "nqs_bench", "configs", f"{config}.json")
    got, want = mod.model(cfg), gate_model.build(cfg, mod.SETTINGS)
    assert isinstance(got, gate_model.GateModel)
    for f in dataclasses.fields(gate_model.GateModel):
        assert _equal(getattr(got, f.name), getattr(want, f.name)), f.name


def test_small_root_keeps_the_sizes_it_had(tmp_path):
    small = make_small_root(str(tmp_path))
    for mix, rows in SMALL_TRAFFIC.items():
        want = _json(ROOT, "nqs_bench", "traffic", f"{mix}.json")
        want["inputs"]["count"] = rows
        want.update(check_members=rows, warmup_steps=1, trace_steps=2)
        assert _json(small, "nqs_bench", "traffic", f"{mix}.json") == want, mix
    for config in CONFIGS:
        want = _json(ROOT, "nqs_bench", "configs", f"{config}.json")
        want["n_steps"] = SMALL_STEPS[want["hilbert_space_dim"]]
        assert _json(small, "nqs_bench", "configs", f"{config}.json") == want, config
    for sub in ("limits", "entries", "metrics"):
        for f in os.listdir(os.path.join(ROOT, "nqs_bench", sub)):
            p = os.path.join(ROOT, "nqs_bench", sub, f)
            if os.path.isfile(p):
                with open(p, "rb") as a, open(os.path.join(small, "nqs_bench", sub, f), "rb") as b:
                    assert a.read() == b.read(), f
