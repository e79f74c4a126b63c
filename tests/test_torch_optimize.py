"""The port's optimizer forward path (optimize/) against the JAX reference.

Both packages get the same operands: the reference's FixedProblem is built
once and handed to the port through `problem_from_numpy`. Tolerances:

  * x64 (complex128 / float64): fidelities and phases 1e-9 absolute, the
    cost 1e-9 relative. Both run the same algorithm (the reference maps a
    single-member core over the population, the port's cores are batched),
    so they differ by float64 rounding; the cost is a quadratic of the
    percentage infidelities with a 1e6 floor, hence relative.
  * float32 / complex64: the six fidelities 1e-4 absolute against the x64
    reference, members drawn near the literature parameters (the reference
    uses 3-multiply complex products and the port native ones, and each
    squaring of an expm doubles its rounding error).
  * the real core against the general per-segment path: the reference's own
    bounds (fidelity 5e-6, cost 2e-3 relative, phase 0.01 deg).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.optimize import apparatus as japp
from noisyquantumsimulator_tpu.optimize import cost as jcost
from noisyquantumsimulator_tpu.optimize import engine as jeng
from noisyquantumsimulator_tpu.physics import protocols as jproto
from noisyquantumsimulator_tpu_torch.optimize import cost as tcost
from noisyquantumsimulator_tpu_torch.optimize import de as tde
from noisyquantumsimulator_tpu_torch.optimize import engine as teng
from noisyquantumsimulator_tpu_torch.optimize import forward as tfwd
from noisyquantumsimulator_tpu_torch.optimize import sweeps as tsweeps
from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
    ApparatusConstraints, OptimizationResult)
from noisyquantumsimulator_tpu_torch.physics import protocols as tproto

torch.set_num_threads(1)

FIDELITIES = ("avg_fidelity", "f00", "f01", "f10", "f11", "cz_phase_fidelity")
PROTOCOLS = {
    "lp": (tfwd.get_lp_bounds_and_x0, {}),
    "smooth_jp": (tfwd.get_smooth_jp_bounds_and_x0, {"n_steps": 48}),
    "jp_bangbang": (lambda: tfwd.get_jp_bangbang_bounds_and_x0(5),
                    {"n_segments": 5}),
}


@pytest.fixture(scope="module")
def jax_problem():
    app = japp.ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prob = jeng.build_fixed_problem(app, app.make_full_noise())
    assert prob.L0_bare.dtype == np.complex128 and prob.g is not None
    return prob


def _population(protocol, P=4, spread=0.05, seed=0):
    """x0, then members within +-spread of it (relative), inside the bounds."""
    bounds, x0 = PROTOCOLS[protocol][0]()
    b = np.asarray(bounds, float)
    rng = np.random.default_rng(seed)
    pop = x0[None] * (1.0 + spread * rng.uniform(-1, 1, (P, len(x0))))
    pop[0] = x0
    return np.clip(pop, b[:, 0], b[:, 1])


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_population_objective_matches_reference_x64(jax_problem, protocol):
    kw = PROTOCOLS[protocol][1]
    pop = _population(protocol)
    jc, jm = jeng.make_population_objective(jax_problem, protocol, **kw)(pop)
    prob = teng.problem_from_numpy(vars(jax_problem), device="cpu",
                                   dtype=torch.complex128)
    tc, tm = teng.make_population_objective(prob, protocol, **kw)(pop)
    assert tc.shape == (4,) and tc.dtype == torch.float64
    jc = np.asarray(jc)
    assert np.all(jc < 1e6)              # real costs, not the floor
    assert np.abs(tc.numpy() - jc).max() <= 1e-9 * np.abs(jc).max()
    assert tm.keys() == jm.keys()
    for k in jm:
        assert np.abs(tm[k].numpy() - np.asarray(jm[k])).max() <= 1e-9, k


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_objective_matches_reference_x64(jax_problem, protocol):
    kw = PROTOCOLS[protocol][1]
    x = _population(protocol, seed=1)[1]
    jc, jm = jeng.make_objective(jax_problem, protocol, **kw)(x)
    prob = teng.problem_from_numpy(vars(jax_problem), device="cpu",
                                   dtype=torch.complex128)
    tc, tm = teng.make_objective(prob, protocol, **kw)(x)
    assert tc.ndim == 0
    assert abs(float(tc) - float(jc)) <= 1e-9 * abs(float(jc))
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-9, k


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_population_objective_32bit(jax_problem, protocol):
    # smooth JP at the 300 segments the optimizer runs: a shorter schedule
    # has longer steps, whose expm squares more often (6 times at 48 steps
    # against 3) and loses a bit of float32 with each squaring
    kw = {"n_steps": 300} if protocol == "smooth_jp" else PROTOCOLS[protocol][1]
    pop = _population(protocol, spread=0.02, seed=2)
    _, jm = jeng.make_population_objective(jax_problem, protocol, **kw)(pop)
    prob = teng.problem_from_numpy(vars(jax_problem), device="cpu",
                                   dtype=torch.complex64)
    assert prob.R_L0.dtype == np.float32 and prob.L0_bare.dtype == np.complex64
    tc, tm = teng.make_population_objective(prob, protocol, **kw)(pop)
    assert tc.dtype == torch.float32
    for k in FIDELITIES:
        assert np.abs(tm[k].numpy() - np.asarray(jm[k])).max() <= 1e-4, k


@pytest.mark.parametrize("protocol,params", [
    ("lp", [0.377, 4.29]),
    ("smooth_jp", [7.0, 0.3 * np.pi, 1.2, 0.4, 0.02])])
def test_real_core_matches_general(jax_problem, protocol, params):
    """The fully real phase-frame core against the general per-segment path
    (forced by dropping the generator), as the reference pins its own."""
    prob = teng.problem_from_numpy(vars(jax_problem), device="cpu",
                                   dtype=torch.complex128)
    kw = {"n_steps": 96} if protocol == "smooth_jp" else {}
    cf, mf = teng.make_objective(prob, protocol, **kw)(np.asarray(params))
    slow = teng.make_objective(dataclasses.replace(prob, g=None), protocol, **kw)
    cs, ms = slow(np.asarray(params))
    assert float(mf["avg_fidelity"]) == pytest.approx(
        float(ms["avg_fidelity"]), abs=5e-6)
    assert float(cf) == pytest.approx(float(cs), rel=2e-3, abs=1e-2)
    assert float(mf["controlled_phase_deg"]) == pytest.approx(
        float(ms["controlled_phase_deg"]), abs=0.01)


def test_bangbang_zero_length_segments(jax_problem):
    """Equal switching fractions give zero-length segments: their expm is
    the identity (no squaring), and the member costs what the reference
    says."""
    _, x0 = tfwd.get_jp_bangbang_bounds_and_x0(5)
    x = x0.copy()
    x[1:5] = [0.3, 0.3, 0.3, 0.7]
    prob = teng.problem_from_numpy(vars(jax_problem), device="cpu",
                                   dtype=torch.complex128)
    sched = teng.bangbang_schedule_from_params(torch.as_tensor(x[None]), prob, 5)
    assert int((sched.dts == 0).sum()) == 2
    jc, _ = jeng.make_objective(jax_problem, "jp_bangbang", n_segments=5)(x)
    tc, _ = teng.make_objective(prob, "jp_bangbang", n_segments=5)(x)
    assert np.isfinite(float(tc))
    assert abs(float(tc) - float(jc)) <= 1e-9 * abs(float(jc))


def test_build_fixed_problem_matches_reference(jax_problem):
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prob = teng.build_fixed_problem(app, app.make_full_noise(),
                                        dtype=torch.complex128, device="cpu")
    for k in ("L0_bare", "Cd", "Cp", "Cm", "rho0s", "R_L0", "R_Cd", "R_drive",
              "x0r", "Wr", "Wi", "cq", "g"):
        ref = np.asarray(getattr(jax_problem, k))
        got = np.asarray(getattr(prob, k))
        assert got.shape == ref.shape, k
        assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max()), k
    assert prob.repP == jax_problem.repP
    assert prob.Omega == pytest.approx(jax_problem.Omega, rel=1e-14)
    with pytest.raises(TypeError):
        teng.problem_from_numpy(vars(jax_problem), device="cpu",
                                dtype=torch.float32)


def test_spacing_population_objective_matches_reference():
    """Per-member re-planned spacing: the L0 operand is batched, one per
    member; at x64 the costs are the reference's."""
    app_j, app_t = japp.ApparatusConstraints(), ApparatusConstraints()
    pop = np.hstack([_population("smooth_jp", P=2, seed=3),
                     [[app_t.spacing_factor], [3.1]]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jobj = jeng.make_spacing_population_objective(
            app_j, app_j.make_full_noise(), "smooth_jp", n_steps=24)
        tobj = teng.make_spacing_population_objective(
            app_t, app_t.make_full_noise(), "smooth_jp", device="cpu",
            dtype=torch.complex128, n_steps=24)
        jc, _ = jobj(pop)
        tc, _ = tobj(pop)
    jc = np.asarray(jc)
    assert np.abs(tc.numpy() - jc).max() <= 1e-9 * np.abs(jc).max()
    assert tobj.base_problem.g is not None
    assert tobj.problem_for(3.1) is tobj.problem_for(3.1)      # cached


def test_spacing_objective_refuses_member_without_generator(monkeypatch):
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        obj = teng.make_spacing_population_objective(
            app, app.make_full_noise(), "smooth_jp", device="cpu",
            dtype=torch.complex128, n_steps=8)
        real_build = teng.build_fixed_problem
        monkeypatch.setattr(
            teng, "build_fixed_problem",
            lambda *a, **k: dataclasses.replace(real_build(*a, **k), g=None))
        pop = np.hstack([_population("smooth_jp", P=1), [[2.9]]])
        with pytest.raises(RuntimeError, match="not phase-frame compatible"):
            obj(pop)


def test_compute_phase_shift_xi_matches_reference():
    rng = np.random.default_rng(4)
    Omega = 2 * np.pi * 4.6e6
    Delta = rng.uniform(-0.6, 0.6, 16) * Omega
    tau = rng.uniform(3.0, 6.0, 16) / Omega
    Delta[0] = 0.0
    ref = np.asarray(jax.vmap(
        lambda d, t: jproto.compute_phase_shift_xi_jax(d, Omega, t))(
            jnp.asarray(Delta), jnp.asarray(tau)))
    got = tproto.compute_phase_shift_xi_torch(
        torch.from_numpy(Delta), Omega, torch.from_numpy(tau)).numpy()
    assert np.abs(got - ref).max() <= 1e-12
    host = np.array([tproto.compute_phase_shift_xi(d, Omega, t)
                     for d, t in zip(Delta, tau)])
    assert np.abs(got - host).max() <= 1e-12
    # the guards: no drive -> 1
    one = tproto.compute_phase_shift_xi_torch(torch.from_numpy(Delta), 0.0,
                                              torch.from_numpy(tau))
    assert torch.equal(one, torch.ones_like(one))


def test_compute_cost_arrays_matches_numpy_twin():
    rng = np.random.default_rng(5)
    avg = rng.uniform(0.4, 1.0, 32)
    f11 = rng.uniform(0.3, 1.0, 32)
    czp = rng.uniform(0.5, 1.0, 32)
    t_us = rng.uniform(0.1, 2.0, 32)
    avg[3] = np.nan
    got = tcost.compute_cost_arrays(*(torch.from_numpy(a)
                                      for a in (avg, f11, czp, t_us))).numpy()
    host = np.array([tcost.compute_cost(
        {"avg_fidelity": a, "f11": f, "cz_phase_fidelity": c}, t)
        for a, f, c, t in zip(avg, f11, czp, t_us)])
    ref = np.asarray(jcost.compute_cost_arrays(*(jnp.asarray(a)
                                                 for a in (avg, f11, czp, t_us))))
    assert np.abs(got - host).max() <= 1e-12 * np.abs(host).max()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert got[3] == 1e6 and np.all(got[avg < 0.5] == 1e6)


def test_de_propose_invariants():
    gen = torch.Generator()
    gen.manual_seed(7)
    P, D = 12, 5
    lower = torch.tensor([0.0, -1.0, 2.0, 0.0, -3.0], dtype=torch.float64)
    upper = torch.tensor([1.0, 1.0, 3.0, 0.5, 3.0], dtype=torch.float64)
    # members on a lattice, so a trial coordinate names its donors
    pop = lower + (upper - lower) * torch.rand((P, D), generator=gen,
                                               dtype=torch.float64)
    for _ in range(20):
        trial = tde._de_propose(gen, pop, lower, upper, (0.5, 1.0), 0.7)
        assert trial.shape == (P, D) and trial.dtype == torch.float64
        assert bool(((trial >= lower) & (trial <= upper)).all())
        changed = (trial != pop).any(dim=1)
        assert bool(changed.all())        # the forced coordinate
    # three distinct donors per row, none chosen twice
    gen.manual_seed(8)
    idx = torch.rand((P, P), generator=gen).argsort(dim=1)[:, :3]
    assert all(len(set(row.tolist())) == 3 for row in idx)
    # recombination 0: exactly the forced coordinate differs
    trial = tde._de_propose(gen, pop, lower - 100, upper + 100, (0.5, 1.0), 0.0)
    assert bool(((trial != pop).sum(dim=1) == 1).all())


def test_de_selection_matches_reference_rule():
    """Greedy selection, as the reference's step: a trial replaces its
    parent only when strictly better."""
    rng = np.random.default_rng(9)
    pop, trial = rng.standard_normal((2, 10, 3))
    E, tE = rng.standard_normal((2, 10))
    tE[4] = E[4]                       # a tie keeps the parent
    accept = tE < E
    ref_pop = np.where(accept[:, None], trial, pop)
    ref_E = np.where(accept, tE, E)
    got_pop, got_E = tde._de_select(*(torch.from_numpy(a)
                                      for a in (pop, E, trial, tE)))
    assert np.array_equal(got_pop.numpy(), ref_pop)
    assert np.array_equal(got_E.numpy(), ref_E)
    assert np.array_equal(got_pop.numpy()[4], pop[4])


def test_de_minimizes_quadratic():
    target = torch.tensor([1.0, -2.0], dtype=torch.float64)

    def cost_fn(pop):
        return ((torch.as_tensor(pop) - target) ** 2).sum(dim=1), {}
    res = tde.differential_evolution(cost_fn, [(-5, 5), (-5, 5)], popsize=20,
                                     maxiter=60, seed=0)
    assert res.fun < 1e-3
    assert np.allclose(res.x, [1.0, -2.0], atol=0.05)
    assert res.history[-1] <= res.history[0]
    assert bool(np.all(np.diff(res.history) <= 0))
    assert res.nfev == 20 * 61 and res.nit == 60
    again = tde.differential_evolution(cost_fn, [(-5, 5), (-5, 5)], popsize=20,
                                       maxiter=60, seed=0)
    assert np.array_equal(again.x, res.x)             # the seed decides
    init = np.array([[0.0, 0.0], [1.0, -2.0], [2.0, 2.0], [-1.0, 3.0]])
    res = tde.differential_evolution(cost_fn, [(-5, 5), (-5, 5)], maxiter=3,
                                     init_population=init)
    assert res.population.shape == (4, 2) and res.fun == 0.0


@pytest.fixture(scope="module")
def short_run():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return tfwd.optimize_cz_gate("smooth_jp", maxiter=2, popsize=4,
                                     grad_polish=False, device="cpu")


def test_optimize_cz_gate_short_run(short_run):
    res = short_run
    assert isinstance(res, OptimizationResult) and res.protocol == "smooth_jp"
    assert len(res.history) == 2
    assert res.history[1] <= res.history[0]
    assert res.n_evaluations == 4 * 3
    assert res.param_names == tfwd._PARAM_NAMES["smooth_jp"]
    assert len(res.best_params) == 5
    assert 0.5 < res.best_metrics["avg_fidelity"] <= 1.0
    # x0 is a member of the first population, so DE cannot end worse
    prob = teng.build_fixed_problem(ApparatusConstraints(),
                                    ApparatusConstraints().make_full_noise(),
                                    device="cpu")
    c0, _ = teng.make_objective(prob, "smooth_jp")(
        tfwd.get_smooth_jp_bounds_and_x0()[1])
    assert res.best_cost <= float(c0) * (1 + 1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(protocol="smooth_jp", grad_polish=True),
    dict(protocol="smooth_jp"),                      # the default polishes
    dict(protocol="grape", grad_polish=False)])
def test_gradient_paths_run(kwargs):
    """The gradient paths run: the calls that a forward-only optimizer would
    refuse with NotImplementedError return a result (at a small size)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = tfwd.optimize_cz_gate(device="cpu", maxiter=1, popsize=4,
                                    polish_steps=3, grape_steps=3,
                                    grape_n_steps=24, **kwargs)
    assert isinstance(res, OptimizationResult)
    assert np.isfinite(res.best_cost) and 0.5 < res.best_metrics["avg_fidelity"] <= 1.0
    if kwargs["protocol"] == "grape":
        assert res.protocol == "grape" and len(res.best_params) == 24
        assert res.n_evaluations == 3 and len(res.history) == 2
    else:
        # DE: 4 members, then 4 trials; the polish adds up to 3 gradients
        assert 8 < res.n_evaluations <= 11
        assert res.best_cost <= min(res.history)


def test_optimize_cz_gate_unknown_protocol():
    with pytest.raises(ValueError):
        tfwd.optimize_cz_gate("adiabatic", grad_polish=False, device="cpu")
    with pytest.raises(ValueError):
        teng.make_population_objective(None, "adiabatic")


def test_bounds_and_warm_start():
    for getter, n in ((tfwd.get_lp_bounds_and_x0, 2),
                      (tfwd.get_smooth_jp_bounds_and_x0, 5),
                      (lambda: tfwd.get_jp_bangbang_bounds_and_x0(5), 10),
                      (lambda: tfwd.get_jp_bangbang_bounds_and_x0(7), 14)):
        b, x = getter()
        assert len(b) == len(x) == n
        assert all(lo <= v <= hi for (lo, hi), v in zip(b, x))
    with pytest.raises(ValueError):
        tfwd.get_jp_bangbang_bounds_and_x0(6)
    res = OptimizationResult(
        success=True, protocol="lp", best_params=np.array([0.37, 4.3]),
        param_names=["delta_over_omega", "omega_tau"], best_cost=1.0,
        best_metrics={}, n_evaluations=10, runtime_s=1.0)
    b, x = tfwd.warm_start_bounds(res, frac=0.1,
                                  original_bounds=tfwd.get_lp_bounds_and_x0()[0])
    assert np.allclose(x, [0.37, 4.3])
    assert all(lo < v < hi for (lo, hi), v in zip(b, x))
    assert b[0][0] >= 0.20 and b[1][1] <= 5.5


def test_protocol_sweep_and_baseline():
    _, x0 = tfwd.get_lp_bounds_and_x0()
    values = [x0[1], 4.0, 4.6]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        sw = tsweeps.protocol_sweep("lp", 1, values, x0, device="cpu",
                                    dtype=torch.complex128,
                                    parameter_name="omega_tau")
        _, metrics = tfwd.run_baseline("lp", verbose=False, device="cpu")
    assert sw.parameter == "omega_tau"
    assert sw.fidelity.shape == (3,) and np.all(np.isfinite(sw.fidelity))
    assert sw.extras["cost"].shape == (3,)
    # the first value is the literature LP pulse: the sweep's batched
    # objective (which computes the phase jump xi) and the gate engine's
    # single simulation (which takes the tabulated xi) agree on it
    assert sw.fidelity[0] == pytest.approx(metrics["avg_fidelity"], abs=5e-4)


# =============================================================================
# inverse problem (optimize/inverse.py)
# =============================================================================

from noisyquantumsimulator_tpu.optimize import inverse as jinv  # noqa: E402
from noisyquantumsimulator_tpu_torch.optimize import inverse as tinv  # noqa: E402


@pytest.mark.parametrize("point", [0, 1])
def test_evaluate_hardware_matches_reference(point):
    """One hardware vector in the middle of the bounds and one drawn inside
    them: the gate the port simulates at complex128 is the reference's."""
    b = np.asarray(tinv.DEFAULT_HARDWARE_BOUNDS, float)
    x = (b[:, 0] + b[:, 1]) / 2 if point == 0 else \
        b[:, 0] + np.random.default_rng(3).random(8) * (b[:, 1] - b[:, 0])
    j = jinv._evaluate_hardware(x, "smooth_jp", japp.ApparatusConstraints(), True)
    t = tinv._evaluate_hardware(x, "smooth_jp", ApparatusConstraints(), True,
                                device="cpu", dtype=torch.complex128)
    assert j.fidelity > 0.0 and j.metrics        # a real gate, not the penalty
    assert abs(t.fidelity - j.fidelity) <= 1e-9
    assert abs(t.gate_time_us - j.gate_time_us) <= 1e-9 * j.gate_time_us
    assert np.array_equal(t.params, j.params)
    assert t.metrics.keys() == j.metrics.keys()
    for k in j.metrics:
        assert abs(t.metrics[k] - j.metrics[k]) <= 1e-9 * max(1.0, abs(j.metrics[k])), k


def test_optimize_cz_parameters_invariants():
    store = tinv.ExplorationResult(protocol="lp")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = tinv.optimize_cz_parameters("lp", maxiter=1, popsize=4, seed=5,
                                          store=store, device="cpu")
    assert isinstance(res, tinv.HardwareOptimizationResult)
    assert res.n_evaluations == 8 and len(store.points) == 8
    assert res.param_names == tinv.HARDWARE_PARAM_NAMES
    b = np.asarray(tinv.DEFAULT_HARDWARE_BOUNDS, float)
    assert np.all((res.best_params >= b[:, 0]) & (res.best_params <= b[:, 1]))
    assert res.best_fidelity == max(p.fidelity for p in store.points
                                    if np.array_equal(p.params, res.best_params))
    assert res.success == (res.best_fidelity >= res.target_fidelity)
    # the first population is the reference's (the same default_rng
    # stream), and each point keeps the vector it was evaluated at (the
    # reference's points are views of population rows that selection
    # overwrites)
    rng = np.random.default_rng(5)
    first = b[:, 0] + rng.random((4, 8)) * (b[:, 1] - b[:, 0])
    assert np.array_equal(np.stack([p.params for p in store.points[:4]]), first)


def _synthetic_points(mod):
    rng = np.random.default_rng(12)
    F = np.round(rng.uniform(0.95, 1.0, 40), 3)       # rounding makes ties
    # slower gates tend to be better, so the front holds several points
    t = np.round(0.2 + 30 * (F - 0.95) + rng.uniform(0, 0.5, 40), 1)
    return [mod.EvaluatedPoint(params=np.full(8, float(i)), fidelity=float(f),
                               gate_time_us=float(g)) for i, (f, g) in
            enumerate(zip(F, t))]


def test_pareto_front_and_best_for_target_match_reference(tmp_path):
    t = tinv.ExplorationResult(protocol="smooth_jp")
    j = jinv.ExplorationResult(protocol="smooth_jp")
    for p in _synthetic_points(tinv):
        t.add(p)
    for p in _synthetic_points(jinv):
        j.add(p)
    ids = lambda pts: [int(p.params[0]) for p in pts]  # noqa: E731
    assert ids(t.compute_pareto_front()) == ids(j.compute_pareto_front())
    assert len(t.compute_pareto_front()) > 1
    for target in (0.95, 0.98, 0.995, 1.01):
        gt, gj = t.get_best_for_target(target), j.get_best_for_target(target)
        assert (gt is None) == (gj is None)
        if gt is not None:
            assert int(gt.params[0]) == int(gj.params[0])
    path = str(tmp_path / "explore.pkl")
    t.save(path)
    back = tinv.ExplorationResult.load(path)
    assert ids(back.points) == ids(t.points) and back.protocol == "smooth_jp"
    both = tinv.combine_explorations(t, back)
    assert len(both.points) == 80 and both.protocol == "smooth_jp"
    assert tinv.HARDWARE_PARAM_NAMES == jinv.HARDWARE_PARAM_NAMES
    assert tinv.DEFAULT_HARDWARE_BOUNDS == jinv.DEFAULT_HARDWARE_BOUNDS
    app = tinv._apparatus_from_vector(
        np.asarray(tinv.DEFAULT_HARDWARE_BOUNDS)[:, 1], ApparatusConstraints())
    assert app.n_rydberg == 90 and app.laser_1_linewidth_hz == 10e3


def test_explore_parameter_space_runs_each_seed(monkeypatch):
    calls = []

    def fake(**kw):
        calls.append(kw["seed"])
        kw["store"].add(tinv.EvaluatedPoint(np.zeros(8), 0.99, 1.0))
    monkeypatch.setattr(tinv, "optimize_cz_parameters", fake)
    out = tinv.explore_parameter_space("lp", seeds=[3, 4], device="cpu")
    assert calls == [3, 4] and len(out.points) == 2 and out.protocol == "lp"


# =============================================================================
# deprecated JP shims (optimize/jp_legacy.py)
# =============================================================================

def _import_jp_legacy():
    import importlib
    from noisyquantumsimulator_tpu_torch.optimize import jp_legacy
    return importlib.reload(jp_legacy)


def test_jp_legacy_module_warns_on_import():
    with pytest.warns(DeprecationWarning, match="jp_legacy is deprecated"):
        _import_jp_legacy()


def test_jp_legacy_cost_shims_delegate(jax_problem):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        leg = _import_jp_legacy()
    _, xb = tfwd.get_jp_bangbang_bounds_and_x0(5)
    _, xs = tfwd.get_smooth_jp_bounds_and_x0()
    prob = teng.build_fixed_problem(ApparatusConstraints(),
                                    ApparatusConstraints().make_full_noise(),
                                    dtype=torch.complex128, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with pytest.warns(DeprecationWarning, match="jp_bangbang_cost"):
            cb = leg.jp_bangbang_cost(xb, device="cpu", dtype=torch.complex128)
        with pytest.warns(DeprecationWarning, match="smooth_jp_cost"):
            cs = leg.smooth_jp_cost(xs, device="cpu", dtype=torch.complex128)
        with pytest.warns(DeprecationWarning, match="evaluate_lp_baseline"):
            _, m = leg.evaluate_lp_baseline(device="cpu")
    assert cb == float(teng.make_objective(prob, "jp_bangbang", n_segments=5)(xb)[0])
    assert cs == float(teng.make_objective(prob, "smooth_jp")(xs)[0])
    assert 0.9 < m["avg_fidelity"] <= 1.0


def test_jp_legacy_optimizers_delegate():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        leg = _import_jp_legacy()
    kw = dict(maxiter=1, popsize=4, grad_polish=False, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with pytest.warns(DeprecationWarning, match="optimize_smooth_jp"):
            rs = leg.optimize_smooth_jp(**kw)
        with pytest.warns(DeprecationWarning, match="optimize_jp_bangbang"):
            rb = leg.optimize_jp_bangbang(n_segments=7, **kw)
    assert rs.protocol == "smooth_jp" and rs.n_evaluations == 8
    assert rb.protocol == "jandura_pupillo"
    assert set(rb.all_variants) == {"5-segment", "7-segment"}


def test_jp_legacy_bangbang_reference_raises_port_runs():
    """The reference's optimize_jp_bangbang passes n_segments to
    optimize_cz_gate, which has no such parameter: it always raises
    TypeError. The port's shim does not pass it on, and runs."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from noisyquantumsimulator_tpu.optimize import jp_legacy as jleg
        leg = _import_jp_legacy()
        with pytest.raises(TypeError, match="n_segments"):
            jleg.optimize_jp_bangbang(maxiter=1, popsize=4, grad_polish=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res = leg.optimize_jp_bangbang(maxiter=1, popsize=4,
                                           grad_polish=False, device="cpu")
    assert np.isfinite(res.best_cost) and res.discrete_variant in (
        "5-segment", "7-segment")
