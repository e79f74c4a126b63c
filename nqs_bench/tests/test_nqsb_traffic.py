"""The one traffic generator: a seed fixes every step's inputs, another seed
changes them, no two steps repeat, and rows keep to the mix's ranges."""
import numpy as np
import pytest
import torch

from conftest import ROOT
from nqs_bench import traffic

MIXES = ["sweep-32768", "sweep-8192", "population-1024"]


def _steps(name, seed, n=3):
    spec = traffic.load(ROOT, name)["inputs"]
    s = traffic.Stream(spec, seed, "cpu")
    return [np.asarray(s.next(), np.float64) for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    seed = 2 ** 31 + 977
    for a, b in zip(_steps(name, seed), _steps(name, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_inputs_and_fresh_steps(name):
    a, b = _steps(name, 5), _steps(name, 6)
    assert not np.array_equal(a[0], b[0])
    assert not np.array_equal(a[0], a[1]) and not np.array_equal(a[1], a[2])


@pytest.mark.parametrize("name", MIXES)
def test_rows_keep_to_the_ranges(name):
    t = traffic.load(ROOT, name)
    spec = t["inputs"]
    x = _steps(name, 11, 1)[0]
    assert x.shape[0] == spec["count"]
    if spec["kind"] == "uniform":
        assert x.min() >= spec["low"] and x.max() <= spec["high"]
        assert x.max() - x.min() > 0.9 * (spec["high"] - spec["low"])
    else:
        b = np.asarray(spec["bounds"])
        c, r = np.asarray(spec["center"]), spec["spread"]
        lo = np.clip(c * (1 - r), b[:, 0], b[:, 1])
        hi = np.clip(c * (1 + r), b[:, 0], b[:, 1])
        assert np.all(x >= lo - 1e-12) and np.all(x <= hi + 1e-12)


def test_device_stream_is_float32_and_seeded():
    spec = {"kind": "uniform", "count": 64, "low": 0.95, "high": 1.05, "on": "device"}
    a = traffic.Stream(spec, 3, "cpu").next()
    b = traffic.Stream(spec, 3, "cpu").next()
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert float(a.min()) >= 0.95 and float(a.max()) <= 1.05
