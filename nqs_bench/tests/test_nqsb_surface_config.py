"""The `surface-d7-r7` configuration states what the reference builds from it:
the DEM's sizes (192 detectors, 883 merged mechanisms and matching edges),
the code's qubits, and decoder settings that the entry turns into the
program's."""
import json
import os

from conftest import ROOT
from nqs_bench import harness
from nqs_bench.reference.qec import surface_model

BENCH = harness.load_benchmark(ROOT)


def _config():
    with open(os.path.join(ROOT, harness.find(BENCH["configs"], "surface-d7-r7")["file"])) as f:
        return json.load(f)


def test_the_stated_dem_is_the_references():
    cfg = _config()
    assert cfg["dem"] == surface_model.sizes(surface_model.build(cfg))
    assert (cfg["dem"]["n_detectors"], cfg["dem"]["n_edges"]) == (192, 883)


def test_the_stated_code_and_decoder():
    cfg = _config()
    c = cfg["code"]
    assert (c["d"], cfg["rounds"], cfg["p"]) == (7, 7, 1e-3)
    assert c["data_qubits"] == c["d"] ** 2
    assert c["x_ancillas"] + c["z_ancillas"] == c["d"] ** 2 - 1
    entry = harness.entry_module(ROOT, "surface_decode")
    assert entry._stated(cfg, 131072) == {"k_light": 6, "k_heavy": 12, "chunk": 16384,
                                          "heavy_capacity": 1024, "fetch_cap": 16384}
