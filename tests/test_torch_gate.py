"""The whole slice: the port's CZ gate engine and its phase-scale sweep
against the JAX reference, at complex128 / float64.

Tolerance 1e-10 on fidelities and the controlled phase: both packages run
the same exact phase-frame algorithm (the port in the real Hermitian
basis, the reference's run_plan in the complex basis; the change of basis
is exact), so they differ only by float64 rounding.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.core import configs as jcfg
from noisyquantumsimulator_tpu.gate import fidelity as jfid
from noisyquantumsimulator_tpu.gate import simulate as jsim
from noisyquantumsimulator_tpu.solver import propagator as jprop
from noisyquantumsimulator_tpu.solver import real_rep as jrr
from noisyquantumsimulator_tpu_torch import bench_gate
from noisyquantumsimulator_tpu_torch.core import configs as tcfg
from noisyquantumsimulator_tpu_torch.gate import fidelity as tfid
from noisyquantumsimulator_tpu_torch.gate import simulate as tsim

torch.set_num_threads(1)
TOL = 1e-10


@pytest.fixture(scope="module")
def smooth_jp_results():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jr = jsim.simulate_cz_gate(jcfg.SmoothJPSimulationInputs(),
                                   n_steps_smooth=60)
        tr = tsim.simulate_cz_gate(tcfg.SmoothJPSimulationInputs(),
                                   n_steps_smooth=60, device="cpu")
    return jr, tr


def test_simulate_cz_gate_matches_reference(smooth_jp_results):
    jr, tr = smooth_jp_results
    assert abs(tr.avg_fidelity - jr.avg_fidelity) <= TOL
    assert abs(tr.phase_info["controlled_phase_rad"]
               - jr.phase_info["controlled_phase_rad"]) <= TOL
    for k in jr.fidelities:
        assert abs(tr.fidelities[k] - jr.fidelities[k]) <= TOL, k
    assert tr.phase_info.keys() == jr.phase_info.keys()
    for k, v in jr.phase_info.items():
        assert abs(float(tr.phase_info[k]) - float(v)) <= 1e-8, k
    for k in jr.results:
        assert np.abs(tr.results[k] - jr.results[k]).max() <= TOL, k
    assert 0.95 < tr.avg_fidelity < 0.999


def test_bangbang_per_segment_path_matches_reference():
    """Bang-bang is not phase-frame eligible: per-segment expm (batched
    squaring over segments) + ordered product."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jr = jsim.simulate_cz_gate(jcfg.JPSimulationInputs())
        tr = tsim.simulate_cz_gate(tcfg.JPSimulationInputs(), device="cpu")
    assert abs(tr.avg_fidelity - jr.avg_fidelity) <= TOL
    assert abs(tr.phase_info["controlled_phase_rad"]
               - jr.phase_info["controlled_phase_rad"]) <= TOL


def test_plan_from_numpy_runs_reference_plan():
    """A reference plan's arrays fed to the port's run_plan give the
    reference's result (rules out the planner when a run test fails)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jp = jsim.plan_cz_gate(jcfg.SmoothJPSimulationInputs(),
                               n_steps_smooth=40)
    jf, javg, jinfo, _ = jsim.run_plan(jp)
    tp = tsim.plan_from_numpy(vars(jp), device="cpu", dtype=torch.complex128)
    assert tp.device == "cpu" and tp.dtype == torch.complex128
    tf, tavg, tinfo, _ = tsim.run_plan(tp)
    assert abs(float(tavg) - float(javg)) <= TOL
    assert abs(float(tinfo["controlled_phase_rad"])
               - float(jinfo["controlled_phase_rad"])) <= TOL
    bare = {k: getattr(jp, k) for k in ("L0", "Cp", "Cm", "rho0s", "kets")}
    bare["schedule"] = tuple(jp.schedule)
    tp2 = tsim.plan_from_numpy(bare, device="cpu")
    assert tp2.hilbert_space_dim == 3
    assert abs(float(tsim.run_plan(tp2)[1]) - float(javg)) <= TOL


def _jax_sweep(plan, scales):
    """The reference's real-engine sweep (bench.py build_workload,
    engine="real") composed from its functions, at float64."""
    g = jsim.plan_phase_frame(plan)
    D = plan.rho0s.shape[-1]
    rep = jrr.build_real_rep(g, D)
    Ub = jprop.uniform_base_propagator(
        jnp.asarray(plan.L0), jnp.asarray(plan.Cp), jnp.asarray(plan.Cm),
        float(plan.schedule.amps[0]), float(plan.schedule.dts[0]),
        max_squarings=jsim.plan_squaring_bound(plan))
    Wr, Wi = jnp.asarray(rep.Wr), jnp.asarray(rep.Wi)
    U_real = jrr.real_propagator_device(Ub, Wr, Wi)
    x0 = jrr.to_real_coords(jnp.asarray(plan.rho0s), Wr, Wi)
    out = jrr.evolve_real_phased_many(
        U_real, jnp.asarray(rep.cq),
        jnp.asarray(scales)[:, None] * jnp.asarray(plan.schedule.phases)[None],
        x0, D, rep.P)
    rhos = jrr.from_real_coords(out, Wr, Wi)
    return np.asarray(jax.vmap(
        lambda r: jfid.compute_cz_fidelity(r, plan.kets)[1])(rhos))


@pytest.mark.parametrize("dim", [3, 4])
def test_bench_sweep_matches_reference(dim):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        step, scales, plan = bench_gate.build_workload(
            6, n_steps=30, dtype=torch.complex128, dim=dim, device="cpu")
    got = step(scales).numpy()
    ref = _jax_sweep(plan, scales.numpy())
    assert got.shape == (6,)
    assert np.abs(got - ref).max() <= TOL
    # scale 1.0 reproduces the single-gate engine
    one = step(torch.ones(1, dtype=torch.float64)).item()
    assert abs(one - float(tsim.run_plan(plan)[1])) <= TOL


def test_fidelity_functions_match_reference():
    rng = np.random.default_rng(31)
    D = 9
    A = rng.standard_normal((3, 5, D, D)) + 1j * rng.standard_normal((3, 5, D, D))
    rhos = A @ np.conj(np.swapaxes(A, -1, -2))
    rhos /= np.trace(rhos, axis1=-2, axis2=-1)[..., None, None]
    from noisyquantumsimulator_tpu.ops.hilbert import HS3, two_atom_kets
    kets = two_atom_kets(HS3)
    jf, javg, jinfo = jax.vmap(lambda r: jfid.compute_cz_fidelity(r, kets))(
        jnp.asarray(rhos))
    tf, tavg, tinfo = tfid.compute_cz_fidelity(torch.from_numpy(rhos), kets)
    assert np.abs(tavg.numpy() - np.asarray(javg)).max() <= 1e-12
    for k in jinfo:
        assert np.abs(tinfo[k].numpy().astype(float)
                      - np.asarray(jinfo[k]).astype(float)).max() <= 1e-12, k
    ket = rng.standard_normal(D) + 1j * rng.standard_normal(D)
    ref = np.asarray(jfid.state_fidelity(jnp.asarray(rhos), jnp.asarray(ket)))
    got = tfid.state_fidelity(torch.from_numpy(rhos), torch.from_numpy(ket))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    ref = np.asarray(jfid.mixed_state_fidelity(jnp.asarray(rhos[0, :4]),
                                               jnp.asarray(rhos[1, :4])))
    got = tfid.mixed_state_fidelity(torch.from_numpy(rhos[0, :4]),
                                    torch.from_numpy(rhos[1, :4])).numpy()
    assert np.abs(got - ref).max() <= 1e-10


def test_complex_phase_frame_path_matches_reference():
    """The complex-basis phase-frame scan (propagator.evolve_rhos_phased*)
    against the reference on the smooth-JP plan's own U_base."""
    from noisyquantumsimulator_tpu_torch.solver import propagator as tprop
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = jsim.plan_cz_gate(jcfg.SmoothJPSimulationInputs(),
                                 n_steps_smooth=20)
    g = jsim.plan_phase_frame(plan)
    ms = jsim.plan_squaring_bound(plan)
    amp, dt = float(plan.schedule.amps[0]), float(plan.schedule.dts[0])
    jUb = jprop.uniform_base_propagator(
        jnp.asarray(plan.L0), jnp.asarray(plan.Cp), jnp.asarray(plan.Cm),
        amp, dt, max_squarings=ms)
    tUb = tprop.uniform_base_propagator(
        *(torch.from_numpy(a) for a in (plan.L0, plan.Cp, plan.Cm)), amp, dt,
        max_squarings=ms)
    assert np.abs(tUb.numpy() - np.asarray(jUb)).max() <= 1e-12
    ph = np.asarray(plan.schedule.phases)
    phases_bn = np.stack([ph, 1.02 * ph])
    ref = np.asarray(jprop.evolve_rhos_phased_many(
        jUb, jnp.asarray(g), jnp.asarray(phases_bn), jnp.asarray(plan.rho0s)))
    got = tprop.evolve_rhos_phased_many(tUb, g, phases_bn,
                                        torch.from_numpy(plan.rho0s)).numpy()
    assert np.abs(got - ref).max() <= TOL
    one = tprop.evolve_rhos_phased(tUb, g, ph, torch.from_numpy(plan.rho0s))
    assert np.abs(one.numpy() - ref[0]).max() <= TOL


def _device_defaults():
    """Every public entry point of the port that takes a device, with the
    default it falls back to when the caller names none."""
    import dataclasses
    import inspect
    from noisyquantumsimulator_tpu_torch import (bench, bench_bb, diagnose_bb,
                                                 validate_bangbang)
    from noisyquantumsimulator_tpu_torch.optimize import engine, forward, sweeps
    from noisyquantumsimulator_tpu_torch.qec import dem_decoder, fast_sampler, ldpc
    fns = {"plan_cz_gate": tsim.plan_cz_gate,
           "plan_from_numpy": tsim.plan_from_numpy,
           "simulate_cz_gate": tsim.simulate_cz_gate,
           "build_workload": bench_gate.build_workload,
           "build_bb_workload": bench_bb.build_bb_workload,
           "DemBPDecoder": dem_decoder.DemBPDecoder,
           "decoder_from_numpy": dem_decoder.decoder_from_numpy,
           "run_bb_memory": ldpc.run_bb_memory,
           "run_bb_circuit_memory": ldpc.run_bb_circuit_memory,
           "build_fast_sampler": fast_sampler.build_fast_sampler,
           "sample_circuit_fast": fast_sampler.sample_circuit_fast,
           "build_fixed_problem": engine.build_fixed_problem,
           "problem_from_numpy": engine.problem_from_numpy,
           "make_spacing_population_objective":
               engine.make_spacing_population_objective,
           "optimize_cz_gate": forward.optimize_cz_gate,
           "run_baseline": forward.run_baseline,
           "protocol_sweep": sweeps.protocol_sweep,
           "hardware_sweep": sweeps.hardware_sweep,
           "standard_research_sweeps": sweeps.standard_research_sweeps,
           "bench.main": bench.main, "bench.main_bb": bench.main_bb,
           "bench.main_all": bench.main_all,
           "bench.measure_parity": bench.measure_parity,
           "validate_bangbang.run": validate_bangbang.run,
           "diagnose_bb.sweep": diagnose_bb.sweep}
    out = {k: inspect.signature(f).parameters["device"].default
           for k, f in fns.items()}
    for cls in (tsim.GatePlan, ldpc.BPDecoder, engine.FixedProblem):
        field, = (f for f in dataclasses.fields(cls) if f.name == "device")
        out[cls.__name__] = field.default
    return out


@pytest.mark.parametrize("name", [
    "plan_cz_gate", "plan_from_numpy", "simulate_cz_gate", "build_workload",
    "build_bb_workload", "DemBPDecoder", "decoder_from_numpy", "run_bb_memory",
    "run_bb_circuit_memory", "build_fast_sampler", "sample_circuit_fast",
    "GatePlan", "BPDecoder", "build_fixed_problem", "problem_from_numpy",
    "make_spacing_population_objective", "optimize_cz_gate", "run_baseline",
    "protocol_sweep", "hardware_sweep", "standard_research_sweeps",
    "FixedProblem", "bench.main", "bench.main_bb", "bench.main_all",
    "bench.measure_parity", "validate_bangbang.run", "diagnose_bb.sweep"])
def test_entry_points_default_to_the_card(name):
    """The port's entry points run on the card unless the caller asks for
    the CPU (checked without a card: only the declared default)."""
    assert _device_defaults()[name] == "cuda"
