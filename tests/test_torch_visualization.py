"""The port's plotting helpers against the reference's: each function, fed
the same data (tensors on the port's side, numpy on the reference's), writes
a PNG byte-equal to the reference's."""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.optimize import inverse as jinv
from noisyquantumsimulator_tpu.qec.surface_code import build_layout as jlayout
from noisyquantumsimulator_tpu.utils import visualization as jvis
from noisyquantumsimulator_tpu_torch.optimize import inverse as tinv
from noisyquantumsimulator_tpu_torch.qec.surface_code import build_layout as tlayout
from noisyquantumsimulator_tpu_torch.utils import visualization as tvis

torch.set_num_threads(1)

RNG = np.random.default_rng(4)
F = 1.0 - 10.0 ** RNG.uniform(-4, -1, 30)
T = RNG.uniform(0.2, 2.0, 30)
GRID = RNG.uniform(0.9, 1.0, (5, 7))
DETS = (RNG.random((3, 24)) < 0.1).astype(np.uint8)


def _exploration(inv, protocol="smooth_jp", shift=0.0):
    ex = inv.ExplorationResult(protocol)
    for f, t in zip(F, T + shift):
        ex.add(inv.EvaluatedPoint(np.zeros(2), float(f), float(t)))
    return ex


CASES = {
    "exploration": (
        lambda vis, inv, tens: vis.plot_exploration_results(_exploration(inv), path=tens)),
    "pareto": (
        lambda vis, inv, tens: vis.plot_pareto_comparison(
            {"a": _exploration(inv, "a"), "b": _exploration(inv, "b", 0.3)}, path=tens)),
    "heatmap": (
        lambda vis, inv, tens: vis.plot_parameter_heatmap(
            *(torch.as_tensor(a) if vis is tvis else a
              for a in (np.arange(7.0), np.arange(5.0), GRID)),
            x_label="x", y_label="y", path=tens)),
    "noise": (
        lambda vis, inv, tens: vis.plot_noise_breakdown(
            {"gamma_r": 7.1e3, "gamma_bbr": 3.5e3, "gamma_phi": 0.0, "other": 2.0},
            path=tens)),
    "sweeps": (
        lambda vis, inv, tens: vis.plot_sweep_grid(
            {f"s{i}": {"values": np.arange(4.0) + i,
                       "fidelity": torch.as_tensor(F[:4]) if vis is tvis else F[:4]}
             for i in range(4)}, path=tens)),
    "scaling": (
        lambda vis, inv, tens: vis.plot_logical_error_scaling(
            {(3, 1e-3): 2e-4, (3, 2e-3): 9e-4, (5, 1e-3): 3e-5, (5, 2e-3): 4e-4},
            path=tens)),
    "layout": (
        lambda vis, inv, tens: vis.plot_surface_code_layout(
            (tlayout if vis is tvis else jlayout)(3), path=tens)),
    "syndrome": (
        lambda vis, inv, tens: vis.plot_syndrome_history(
            torch.as_tensor(DETS) if vis is tvis else DETS, d=3, rounds=5,
            shot=1, path=tens)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plot_png_byte_equal(tmp_path, name):
    ref = CASES[name](jvis, jinv, str(tmp_path / "ref.png"))
    got = CASES[name](tvis, tinv, str(tmp_path / "port.png"))
    assert got == str(tmp_path / "port.png")
    a, b = open(ref, "rb").read(), open(got, "rb").read()
    assert a[:8] == b"\x89PNG\r\n\x1a\n" and len(a) > 1000
    assert a == b
