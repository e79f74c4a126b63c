"""pscan_roofline on a synthetic trace: None without the population-scan
kernel, the share of a known duration with it, and neither K1's nor K2's
roofline counting it."""
import json
import os
from types import SimpleNamespace

import pytest

from conftest import ROOT
from nqs_bench import harness, peaks, traffic
from nqs_bench.roofline import k1, pscan

PSCAN = ("void (anonymous namespace)::population_scan_kernel<float, 3>"
         "(float const*, float const*, float const*, float const*, long long, "
         "float*, int, int, int, int, int)")


def _ctx(device, steps=2):
    with open(os.path.join(ROOT, "nqs_bench", "configs", "rb87-smoothjp-3level.json")) as f:
        config = json.load(f)
    mix = traffic.load(ROOT, "population-8192")
    return SimpleNamespace(config=config, traffic=mix, trace={
        "device": device, "steps": steps, "first": 2, "inputs": []})


def _read(name, ctx):
    return harness.metric_reader(ROOT, name).read(ctx)


def test_counts_by_hand():
    # 1024 members, S = 5, n = 81, 300 steps: the scan's 2.0e10 operations
    assert pscan.flops(1024, 5, 81, 300) == k1.flops(1024, 5, 81, 300) == pytest.approx(
        2.01553e10, rel=1e-5)
    # 2 members, S = 3, n = 4 (P = 1), 5 steps: 4 x (2 x 16 + 1 + 2 x 5 + 2 x 24)
    assert pscan.nbytes(2, 3, 4, 1, 5) == 4.0 * (32 + 1 + 10 + 48)


def test_none_without_the_kernel():
    dev = [(0.0, 500.0, "gemmSN_NN_kernel", "kernel"),
           (600.0, 700.0, "phase_scan_tc_kernel<true>", "kernel")]
    assert _read("pscan_roofline", _ctx(dev)) is None
    assert _read("pscan_roofline", SimpleNamespace(trace=None)) is None


def test_share_of_a_known_duration():
    # two traced steps, one 500 us launch each (and a memcpy, not a kernel)
    dev = [(0.0, 500.0, PSCAN, "kernel"), (500.0, 900.0, PSCAN, "memcpy"),
           (1000.0, 1500.0, PSCAN, "kernel")]
    # the mix's 8192 members
    bound = peaks.bound_s(pscan.flops(8192, 5, 81, 300),
                          pscan.nbytes(8192, 5, 81, 36, 300))
    assert bound == pytest.approx(8 * 2.01553e10 / 495e12, rel=1e-5)
    got = _read("pscan_roofline", _ctx(dev))
    assert got == pytest.approx(100.0 * bound / 500e-6)
    assert 64.0 < got < 66.4


def test_k1_and_k2_rooflines_do_not_count_it():
    ctx = _ctx([(0.0, 500.0, PSCAN, "kernel")])
    assert _read("k1_roofline", ctx) is None
    assert _read("k2_roofline", ctx) is None
