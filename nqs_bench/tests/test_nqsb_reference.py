"""The plain reference at small sizes on the CPU, held against the port (a
test may read the port; the reference never does)."""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from conftest import ROOT
from nqs_bench import traffic
from nqs_bench.entries import population, sweep
from nqs_bench.reference import evolve, gate_model


def _config(dim):
    with open(os.path.join(ROOT, "nqs_bench", "configs",
                           f"rb87-smoothjp-{dim}level.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dim", [3, 4])
def test_gate_model_equals_the_programs_plan(dim):
    from noisyquantumsimulator_tpu_torch.core.configs import SmoothJPSimulationInputs
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_cz_gate
    m = gate_model.build(_config(dim), "sweep")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        p = plan_cz_gate(SmoothJPSimulationInputs(), hilbert_space_dim=dim, device="cpu")
    L0 = m.L_static + m.Delta_gate * m.L_det
    assert np.abs(L0 - p.L0).max() <= 1e-14 * np.abs(p.L0).max()
    assert np.abs(m.L_plus - p.Cp).max() == 0 and np.abs(m.L_minus - p.Cm).max() == 0
    phases, dt = m.base_schedule()
    np.testing.assert_allclose(phases, p.schedule.phases, rtol=0, atol=1e-15)
    assert dt == pytest.approx(p.schedule.dts[0], rel=1e-15)
    np.testing.assert_array_equal(m.rho0s, p.rho0s)


def test_population_model_equals_the_programs_fixed_problem():
    from noisyquantumsimulator_tpu_torch.optimize import engine
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import ApparatusConstraints
    m = gate_model.build(_config(3), "population")
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pr = engine.build_fixed_problem(app, app.make_full_noise(), device="cpu",
                                        dtype=torch.complex128)
    assert np.abs(m.L_static - pr.L0_bare).max() <= 1e-14 * np.abs(pr.L0_bare).max()
    assert np.abs(m.L_det - pr.Cd).max() <= 1e-15
    assert m.Omega == pr.Omega and m.Delta_e == pr.Delta_e


def test_expm_matches_scipy():
    from scipy.linalg import expm as sexpm
    A = np.random.default_rng(1).standard_normal((2, 6, 6)) * (3 + 1j)
    E = evolve.expm(torch.as_tensor(A, dtype=torch.complex128), "float64").numpy()
    for a, e in zip(A, E):
        np.testing.assert_allclose(e, sexpm(a), rtol=1e-12, atol=1e-12 * np.abs(sexpm(a)).max())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -20, 3.1415926, -2.5e-7])
    r = evolve.to_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10 and r[2] == 1.0 + 2 ** -10
    assert torch.all((r - x).abs() <= x.abs() * 2 ** -11)
    assert torch.equal(evolve.to_tf32(r), r)


def test_sweep_reference_equals_the_programs_complex128_gate():
    from noisyquantumsimulator_tpu_torch.gate.simulate import (plan_cz_gate,
                                                               run_plan)
    from noisyquantumsimulator_tpu_torch.core.configs import SmoothJPSimulationInputs
    cfg = dict(_config(3), n_steps=60)
    m = gate_model.build(cfg, "sweep")
    scales = np.array([0.97, 1.0, 1.03])
    ref = sweep.reference(m, scales, "float64", "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        p = plan_cz_gate(SmoothJPSimulationInputs(), n_steps_smooth=60, device="cpu")
    base = p.schedule
    for s, F in zip(scales, ref):
        p.schedule = base._replace(phases=s * base.phases)
        assert float(run_plan(p)[1]) == pytest.approx(F, abs=1e-11)


def test_population_reference_equals_the_programs_complex128_objective():
    from noisyquantumsimulator_tpu_torch.optimize import engine
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import ApparatusConstraints
    cfg = dict(_config(3), n_steps=60)
    m = gate_model.build(cfg, "population")
    spec = dict(traffic.load(ROOT, "population-8192")["inputs"], count=4)
    x = traffic.Stream(spec, 9, "cpu").next()
    ref = population.reference(m, x, "float64", "cpu")
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pr = engine.build_fixed_problem(app, app.make_full_noise(), device="cpu",
                                        dtype=torch.complex128)
    cost, met = engine.make_population_objective(pr, "smooth_jp", n_steps=60)(x)
    out = torch.stack([cost] + [met[k] for k in population.FIDELITIES], 1).numpy()
    gaps = population.compare(out, ref, x[:, 0] / m.Omega * 1e6)
    assert gaps["fid_gap"] < 1e-11 and gaps["cost_gap"] < 1e-10


@pytest.mark.parametrize("judged_f, judged_cost, gap", [
    (0.50005, None, 0.0),      # F within its gap of the cut: the smooth cost stands
    (0.49995, 1e6, 0.0),       # ... and so does the penalty
    (0.50005, 1e6, None),      # F above the cut with the penalty: a wrong cost
    (0.9, 1e6, None),
])
def test_cost_judged_on_the_side_of_the_cut_its_f_lies(judged_f, judged_cost, gap):
    ref = np.array([[0.0, 0.49998, 0.9, 0.9, 0.9, 0.4, 0.8]])
    t_us = np.array([0.2])
    smooth = evolve.cost(ref[:, 1], ref[:, 5], ref[:, 6], t_us, bad=np.array([False]))
    judged = ref.copy()
    judged[0, 1] = judged_f
    judged[0, 0] = smooth[0] if judged_cost is None else judged_cost
    got = population.compare(judged, ref, t_us)["cost_gap"]
    if gap is None:
        assert got > 0.9
    else:
        assert got == pytest.approx(gap, abs=1e-12)


def test_control_reads_far_above_the_program():
    """At 60 segments the TF32 control's gap is at least a hundred times
    the float64 reference's own rounding, and the gaps are as compared."""
    m = gate_model.build(dict(_config(3), n_steps=60), "sweep")
    scales = np.array([0.96, 1.02])
    ref = sweep.reference(m, scales, "float64", "cpu")
    ctl = sweep.reference(m, scales, "tf32", "cpu")
    assert np.abs(ctl - ref).max() > 1e-3


def test_sweep_interpolation_is_exact_on_polynomials_and_at_nodes():
    nodes, w = sweep.chebyshev(0.95, 1.05, 12)
    assert nodes.min() > 0.95 and nodes.max() < 1.05
    s = np.concatenate([np.linspace(0.95, 1.05, 1001), nodes[:3]])
    p = np.polynomial.Polynomial([0.97, 0.3, -2.0, 5.0, 1.0])
    got = sweep.interpolate(nodes, w, p(nodes), s, chunk=100)
    np.testing.assert_allclose(got, p(s), rtol=0, atol=1e-12)
    assert np.array_equal(got[-3:], p(nodes[:3]))


def test_sweep_check_holds_every_answer():
    """One answer off by 1e-3 among many shows in fid_gap, though the direct
    sample misses it; the interpolant is validated against direct values."""
    m = gate_model.build(dict(_config(3), n_steps=30), "sweep")
    t = {"inputs": {"low": 0.95, "high": 1.05}, "interpolation_nodes": 12,
         "check_members": 2}
    s = [np.linspace(0.951, 1.049, 40)]
    nodes, w = sweep.chebyshev(0.95, 1.05, 12)
    exact = sweep.interpolate(nodes, w, sweep.reference(m, nodes, "float64", "cpu"), s[0])
    rng = np.random.default_rng(0)
    assert sweep.check(m, t, s, [exact], rng, "cpu")["fid_gap"] < 1e-13
    off = exact.copy()
    off[17] += 1e-3
    assert sweep.check(m, t, s, [off], np.random.default_rng(0), "cpu")["fid_gap"] == \
        pytest.approx(1e-3, rel=1e-6)
