"""K3's bytes at the bb-gross cell's shapes (`roofline/k3.py`), by hand, and
the sizes its configuration states against the reference DEM it describes."""
import json
import os
from types import SimpleNamespace

import pytest

from conftest import ROOT
from nqs_bench import harness, peaks
from nqs_bench.reference.qec import bb_model
from nqs_bench.roofline import k3


def _config():
    with open(os.path.join(ROOT, "nqs_bench", "configs", "bb144-gross-r3.json")) as f:
        return json.load(f)


def test_k3_bytes_at_the_cell_shapes_by_hand():
    cfg = _config()
    # fast tier: 6 iterations -> 7 launches over 5283 edges x 65536 shots in
    # bf16: messages in and out 2 x 5283 x 65536 x 2 B, signs 288 x 65536 x 2 B
    fast = 7 * (2 * 5283 * 65536 * 2 + 288 * 65536 * 2)
    assert fast == 7 * (1_384_906_752 + 37_748_736)
    # retry: 90 iterations -> 91 launches over 65536 // 128 = 512 rows in f32
    retry = 91 * (2 * 5283 * 512 * 4 + 288 * 512 * 4)
    assert retry == 91 * 22_228_992
    assert k3.step_bytes(cfg, 65536) == fast + retry == 11_981_426_688
    assert k3.launches(cfg) == 98
    assert k3.retry_rows(65536, 128) == 512 and k3.retry_rows(512, 32) == 64
    # at 3.35 TB/s: 3.5765 ms a step, of which 0.425 ms a fast launch
    assert peaks.bound_s(0.0, k3.step_bytes(cfg, 65536)) == pytest.approx(3.57654e-3, rel=1e-5)
    assert 1_422_655_488 / peaks.BYTES_PER_S == pytest.approx(0.4247e-3, rel=1e-3)
    # K3's padded layout holds 26 x 288 = 7488 slots a shot, 1.417 x the edges
    assert cfg["dem"]["w_max"] * cfg["dem"]["n_detectors"] / cfg["dem"]["n_edges"] \
        == pytest.approx(1.4174, rel=1e-4)


def test_the_configuration_states_its_dem():
    cfg = _config()
    assert bb_model.sizes(bb_model.build(cfg)) == cfg["dem"]


def test_the_reader_divides_the_bound_by_the_k3_time():
    cfg = _config()
    reader = harness.metric_reader(ROOT, "k3_roofline")
    per_step = 98
    dev = [(i * 100.0, i * 100.0 + 90.0, "void c2v_kernel<__nv_bfloat16>(...)", "kernel")
           for i in range(2 * per_step)] + [(0.0, 5.0, "other", "kernel")]
    ctx = SimpleNamespace(config=cfg, traffic={"shots": 65536},
                          trace={"device": dev, "steps": 2})
    t = per_step * 90e-6
    want = 100.0 * k3.step_bytes(cfg, 65536) / peaks.BYTES_PER_S / t
    assert reader.read(ctx) == pytest.approx(want)
    assert reader.read(SimpleNamespace(config=cfg, traffic={}, trace=None)) is None
