"""Batched protocol-parameter objective engine.

Counterpart of the reference's `optimize/engine.py`, the replacement for the
original DE objective loop (optimize_cz_gate.py:1081-1114, ~1200 sequential
simulate_CZ_gate calls per run): an ENTIRE population of protocol parameter
vectors is evaluated in one batched device call. The reference maps a
single-member core over the population; here the cores are written batched
over a leading population axis.

Key structure: for a fixed apparatus the Liouvillian pieces
(L0_bare, Cd, Cp, Cm) are constant; protocol parameters only build a
Schedule (amps, phases, dts, dets). See ops/lindblad.superop_basis.

Two cores:
  * uniform-(amp, dt, det) protocols (LP, smooth JP, free phases) with a
    phase-frame generator run FULLY REAL (solver/real_rep.py): one real
    matrix exponential per member, i.e. one batched expm over (P, n, n),
    then the per-member phase scan;
  * everything else (bang-bang) runs the general per-segment path: one
    batched expm over (P * n_seg, n, n) and one ordered product. Bang-bang's
    expm is Pade-13 at every dtype: a segment is a fifth of the gate (1-norm
    600-2500), and at complex64 the expm's rounding, doubled by each
    squaring, is the objective's largest error; Pade-13 at its
    single-precision theta takes 2-3 fewer squarings than Taylor-16 and holds
    the 1e-4 fidelity tier against complex128, which Taylor-16 misses.
Every expm ends in the masked squaring chain, kernel K2 on the card.

The constants go to the device once, when an objective is made. The
population objectives run under torch.no_grad and record no graph.
`make_value_and_grad` runs the same core on a population of one with
autograd on, for the gradient polish and GRAPE: its gradient flows through
the schedule builders, the expm (K2 as a torch.autograd.Function,
ops/expm_cuda.py) and the scan or the ordered product into every protocol
parameter.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..core.configs import SmoothJPSimulationInputs
from ..gate.fidelity import compute_cz_fidelity
from ..gate.simulate import plan_cz_gate
from ..ops.expm import expm
from ..physics.protocols import compute_phase_shift_xi_torch
from ..solver.propagator import Schedule, evolve_rhos, real_dtype
from ..solver.real_rep import evolve_real_phased, from_real_coords
from ..utils.observability import span
from .apparatus import ApparatusConstraints
from .cost import compute_cost_arrays


@dataclass
class FixedProblem:
    """Constant arrays for one apparatus + noise setting (host numpy), and
    where and in what precision its objectives compute (`device`, complex
    `dtype`; the device transfer happens when an objective is made)."""
    L0_bare: np.ndarray    # Liouvillian WITHOUT the -Delta|r><r| term
    Cd: np.ndarray         # detuning channel (multiply by +Delta)
    Cp: np.ndarray
    Cm: np.ndarray
    rho0s: np.ndarray
    kets: Dict[str, np.ndarray]
    Omega: float
    V: float
    Delta_e: float
    V_over_Omega: float
    g: Optional[np.ndarray] = None  # phase-frame generator (ops/phase_frame)
    # real Hermitian-basis operands (solver/real_rep.py): present whenever
    # g is — the uniform fast core then runs FULLY REAL (real expm + one
    # real product per segment)
    R_L0: Optional[np.ndarray] = None      # Re(W L0_bare W^dagger)
    R_Cd: Optional[np.ndarray] = None      # Re(W Cd W^dagger)
    R_drive: Optional[np.ndarray] = None   # Re(W (Cp + Cm) W^dagger)
    x0r: Optional[np.ndarray] = None       # real coords of rho0s (S, D^2)
    Wr: Optional[np.ndarray] = None
    Wi: Optional[np.ndarray] = None
    cq: Optional[np.ndarray] = None        # (P,) pair charges
    repP: int = 0                          # pair count
    device: Union[str, torch.device] = "cuda"
    dtype: torch.dtype = torch.complex64


_COMPLEX_FIELDS = ("L0_bare", "Cd", "Cp", "Cm", "rho0s")
_REAL_FIELDS = ("R_L0", "R_Cd", "R_drive", "x0r", "Wr", "Wi", "cq")


def _numpy_dtypes(dtype: torch.dtype):
    """(complex, real) numpy dtypes of a complex torch dtype."""
    if dtype == torch.complex64:
        return np.complex64, np.float32
    if dtype == torch.complex128:
        return np.complex128, np.float64
    raise TypeError(f"dtype must be torch.complex64 or torch.complex128, "
                    f"got {dtype}")


def build_fixed_problem(apparatus: ApparatusConstraints,
                        noise_cfg, include_noise: bool = True,
                        dtype: torch.dtype = torch.complex64,
                        device: Union[str, torch.device] = "cuda"
                        ) -> FixedProblem:
    """Plan once with Delta=0 in L0; detuning is applied per-segment via Cd.
    The plan is host work; `device` and `dtype` are where the problem's
    objectives will compute."""
    from ..ops.hilbert import HS3, sym_two_atom
    from ..ops.lindblad import hamiltonian_superop_linear
    from ..ops.phase_frame import phase_frame_generator
    ndt, rdt = _numpy_dtypes(dtype)

    si = SmoothJPSimulationInputs(excitation=apparatus.make_excitation_config(),
                                  noise=noise_cfg)
    plan = plan_cz_gate(si, include_noise=include_noise, device=device,
                        dtype=dtype, **apparatus.sim_kwargs())
    # remove the planned smooth-JP detuning from L0 -> L0_bare
    Cd = hamiltonian_superop_linear(-sym_two_atom(HS3.projectors["r"]))
    L0_bare = plan.L0 - plan.Delta * Cd
    # phase-frame generator validated against L0_bare + Cd (the detuning
    # channel is diagonal, so a uniform per-schedule detuning keeps the
    # one-expm factorization exact); None -> general per-segment path
    g = phase_frame_generator(L0_bare + Cd, plan.Cp, plan.Cm, HS3)
    real_fields = {}
    if g is not None:
        # real Hermitian-basis operands (f64 host transform; Liouvillian
        # generators are Hermiticity-preserving, asserted inside)
        from ..solver.real_rep import build_real_rep, real_propagator_host
        D = plan.rho0s.shape[-1]
        rep = build_real_rep(g, D)
        vec = plan.rho0s.reshape(plan.rho0s.shape[0], D * D)
        x0r = (vec.real @ rep.Wr.T - vec.imag @ rep.Wi.T)
        real_fields = dict(
            R_L0=real_propagator_host(L0_bare, rep).astype(rdt),
            R_Cd=real_propagator_host(Cd, rep).astype(rdt),
            R_drive=real_propagator_host(plan.Cp + plan.Cm,
                                         rep).astype(rdt),
            x0r=x0r.astype(rdt),
            Wr=rep.Wr.astype(rdt), Wi=rep.Wi.astype(rdt),
            cq=rep.cq.astype(rdt), repP=rep.P,
        )
    return FixedProblem(
        L0_bare=np.asarray(L0_bare, ndt),
        Cd=np.asarray(Cd, ndt),
        Cp=np.asarray(plan.Cp, ndt),
        Cm=np.asarray(plan.Cm, ndt),
        rho0s=np.asarray(plan.rho0s, ndt),
        kets=plan.kets,
        Omega=plan.Omega, V=plan.V, Delta_e=float(si.excitation.Delta_e),
        V_over_Omega=plan.V_over_Omega,
        g=g, device=device, dtype=dtype,
        **real_fields,
    )


def problem_from_numpy(fields: Dict,
                       device: Union[str, torch.device] = "cuda",
                       dtype: torch.dtype = torch.complex64) -> FixedProblem:
    """A FixedProblem whose objectives compute on `device` in complex
    `dtype`, from bare arrays.

    fields: a mapping with the FixedProblem fields, e.g. ``vars(problem)``
    of the reference package's FixedProblem, so both packages evaluate the
    same operands. Arrays are cast to `dtype`'s precision."""
    ndt, rdt = _numpy_dtypes(dtype)
    names = {f.name for f in dataclasses.fields(FixedProblem)}
    kw = {k: v for k, v in fields.items() if k in names}
    for k in _COMPLEX_FIELDS:
        kw[k] = np.asarray(fields[k], ndt)
    for k in _REAL_FIELDS:
        if kw.get(k) is not None:
            kw[k] = np.asarray(kw[k], rdt)
    if kw.get("g") is not None:
        kw["g"] = np.asarray(kw["g"])
    kw["kets"] = {k: np.asarray(v) for k, v in fields["kets"].items()}
    for k in ("Omega", "V", "Delta_e", "V_over_Omega"):
        kw[k] = float(fields[k])
    kw["repP"] = int(kw.get("repP", 0))
    kw["device"], kw["dtype"] = device, dtype
    return FixedProblem(**kw)


def _cost_and_metrics(rhos, kets, gate_time_us):
    """rhos (..., 5, D, D), gate_time_us (...) -> cost (...), metrics of
    (...) tensors."""
    fids, avg, phase_info = compute_cz_fidelity(rhos, kets)
    cost = compute_cost_arrays(avg, fids["11"],
                               phase_info["cz_phase_fidelity"], gate_time_us)
    metrics = {
        "avg_fidelity": avg, "f00": fids["00"], "f01": fids["01"],
        "f10": fids["10"], "f11": fids["11"],
        "cz_phase_fidelity": phase_info["cz_phase_fidelity"],
        "controlled_phase_deg": phase_info["controlled_phase_deg"],
        "phase_error_deg": phase_info["phase_error_from_pi_deg"],
        "gate_time_us": gate_time_us,
    }
    return cost, metrics


def _evaluate_arrays(schedule: Schedule, L0_bare, Cd, Cp, Cm, rho0s, kets,
                     expm_method: str = "auto"):
    """General per-segment core for a population of schedules (arrays
    (P, n_seg)): one batched expm over (P * n_seg, D^2, D^2) and one
    ordered product. L0_bare is (D^2, D^2) or (P, D^2, D^2)."""
    rhos = evolve_rhos(L0_bare, Cp, Cm, schedule, rho0s, Cd=Cd,
                       expm_method=expm_method)
    return _cost_and_metrics(rhos, kets, schedule.dts.sum(dim=-1) * 1e6)


def _evaluate_uniform_real(phases, dt, det, cq, R_L0, R_Cd, R_drive,
                           x0r, Wr, Wi, kets, P):
    """The uniform fast core run FULLY REAL (solver/real_rep.py) for a
    population: phases (M, n_seg), dt and det (M,). The Liouvillian pieces
    arrive pre-transformed to the Hermitian operator basis, so the expm is
    ONE batched real matrix exponential over (M, n, n) and the segment scan
    is one real batched product per step. Exact same physics — the basis
    change is unitary and the tests pin this core to the general
    per-segment path. R_L0 is (n, n) or (M, n, n)."""
    A = (R_L0 + det[:, None, None] * R_Cd + R_drive) * dt[:, None, None]
    Ur = expm(A)
    n = x0r.shape[-1]
    D = int(round(np.sqrt(n)))
    x = evolve_real_phased(Ur, cq, phases, x0r, D, P)
    rhos = from_real_coords(x, Wr, Wi)
    return _cost_and_metrics(rhos, kets, phases.shape[-1] * dt * 1e6)


# =============================================================================
# schedules from parameter vectors: params is (..., n_params), any leading
# batch axes (a population is (P, n_params)); tensors stay on their device
# =============================================================================

def lp_schedule_from_params(params, problem: FixedProblem):
    """params = [delta_over_omega, omega_tau].
    (optimize_cz_gate.py:339-352 _build_lp_inputs). Delegates the
    parameter decode to lp_uniform_from_params so the fast (phase-frame)
    and general paths can never diverge."""
    phases, dt, Delta = lp_uniform_from_params(params, problem)
    return _uniform_schedule(phases, dt, Delta)


def _uniform_schedule(phases, dt, Delta) -> Schedule:
    ones = torch.ones_like(phases)
    return Schedule(ones, phases, ones * dt[..., None], ones * Delta[..., None])


def smooth_jp_schedule_from_params(params, problem: FixedProblem,
                                   n_steps: int = 300):
    """params = [omega_tau, A, omega_mod_ratio, phi_offset, delta_over_omega].
    (optimize_cz_gate.py:518-543). Delegates the decode (incl. the
    dark-state sign rule) to smooth_jp_uniform_from_params — one source
    of truth for both evaluation paths."""
    phases, dt, Delta = smooth_jp_uniform_from_params(params, problem,
                                                      n_steps=n_steps)
    return _uniform_schedule(phases, dt, Delta)


def bangbang_schedule_from_params(params, problem: FixedProblem,
                                  n_segments: int = 5):
    """Fractional parameterisation, ordering guaranteed by sorting:
    params = [omega_tau, f_1..f_{N-1}, phi_0..phi_{N-1}].
    (optimize_cz_gate.py:365-400 _build_jp_bangbang_inputs). Equal
    fractions give zero-length segments, whose propagator is the identity."""
    ot = params[..., :1]
    n_switch = n_segments - 1
    fracs = torch.sort(params[..., 1:1 + n_switch], dim=-1).values
    phases = params[..., 1 + n_switch:1 + n_switch + n_segments]
    bounds = torch.cat([torch.zeros_like(ot), fracs * ot, ot], dim=-1)
    dts = torch.clamp(bounds[..., 1:] - bounds[..., :-1], min=0.0) / problem.Omega
    return Schedule(torch.ones_like(phases), phases, dts,
                    torch.zeros_like(phases))


def lp_uniform_from_params(params, problem: FixedProblem):
    """(phases, dt, det) for the phase-frame fast core (LP square)."""
    dow, ot = params[..., 0], params[..., 1]
    Omega = problem.Omega
    Delta = dow * Omega
    tau = ot / Omega
    xi_phase = torch.angle(compute_phase_shift_xi_torch(Delta, Omega, tau))
    phases = torch.stack([torch.zeros_like(xi_phase), xi_phase], dim=-1)
    return phases, tau, Delta


def smooth_jp_uniform_from_params(params, problem: FixedProblem,
                                  n_steps: int = 300):
    """(phases, dt, det) for the phase-frame fast core (smooth JP)."""
    ot, A, omr, phi0, dow_mag = (params[..., i] for i in range(5))
    Omega = problem.Omega
    sign = -1.0 if problem.Delta_e > 0 else 1.0
    Delta = sign * torch.abs(dow_mag) * Omega
    dt = ot / Omega / n_steps
    k = torch.arange(n_steps, dtype=params.dtype, device=params.device)
    t_mid = (k + 0.5) * dt[..., None]
    phases = A[..., None] * torch.cos(omr[..., None] * Omega * t_mid
                                      - phi0[..., None])
    return phases, dt, Delta


def free_phases_uniform_from_params(params, problem: FixedProblem, *,
                                    omega_tau: float,
                                    delta_over_omega: float):
    """(phases, dt, det) with EVERY per-segment phase a free parameter
    (piecewise-constant phase modulation at fixed Omega, gate time and
    detuning).

    omega_tau / delta_over_omega are REQUIRED: the phases are only
    meaningful at the gate time and detuning the pulse was built for, so
    silently evaluating at literature defaults would return plausible but
    wrong fidelities.

    params = the (..., n_steps) phase vectors themselves."""
    sign = -1.0 if problem.Delta_e > 0 else 1.0
    lead = params[..., 0]
    Delta = torch.full_like(lead, sign * abs(delta_over_omega) * problem.Omega)
    dt = torch.full_like(lead, omega_tau / problem.Omega / params.shape[-1])
    return params, dt, Delta


def free_phases_schedule_from_params(params, problem: FixedProblem, *,
                                     omega_tau: float,
                                     delta_over_omega: float):
    phases, dt, Delta = free_phases_uniform_from_params(
        params, problem, omega_tau=omega_tau,
        delta_over_omega=delta_over_omega)
    return _uniform_schedule(phases, dt, Delta)


SCHEDULE_BUILDERS: Dict[str, Callable] = {
    "levine_pichler": lp_schedule_from_params,
    "lp": lp_schedule_from_params,
    "smooth_jp": smooth_jp_schedule_from_params,
    "jandura_pupillo": bangbang_schedule_from_params,
    "jp_bangbang": bangbang_schedule_from_params,
    "free_phases": free_phases_schedule_from_params,
    "grape": free_phases_schedule_from_params,
}

# protocols whose schedules are uniform in (amp, dt, det): eligible for the
# one-expm phase-frame core whenever problem.g exists
UNIFORM_BUILDERS: Dict[str, Callable] = {
    "levine_pichler": lp_uniform_from_params,
    "lp": lp_uniform_from_params,
    "smooth_jp": smooth_jp_uniform_from_params,
    "free_phases": free_phases_uniform_from_params,
    "grape": free_phases_uniform_from_params,
}


def _uses_real_core(problem: FixedProblem, key: str) -> bool:
    return key in UNIFORM_BUILDERS and problem.g is not None


def _make_eval_core(problem: FixedProblem, key: str, builder_kwargs: dict,
                    device, dtype: torch.dtype):
    """core(params (P, n_params), L0=None) -> (cost (P,), metrics) with the
    constant operands already on `device` in `dtype`'s precision. Picks the
    real phase-frame core when the protocol's schedule is uniform and the
    generator exists; the general per-segment path otherwise. `L0`
    replaces the problem's own L0 operand (R_L0 or L0_bare) by one per
    member, (P, n, n): the only operand that depends on the spacing."""
    rdt = real_dtype(dtype)

    def put(a, dt):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    kets = {k: put(v, dtype) for k, v in problem.kets.items()}
    if _uses_real_core(problem, key):
        ubuilder = UNIFORM_BUILDERS[key]
        P = problem.repP
        cq, R_L0, R_Cd, R_drive, x0r, Wr, Wi = (
            put(getattr(problem, f), rdt)
            for f in ("cq", "R_L0", "R_Cd", "R_drive", "x0r", "Wr", "Wi"))

        def core(params, L0=None):
            phases, dt, det = ubuilder(params, problem, **builder_kwargs)
            return _evaluate_uniform_real(
                phases, dt, det, cq, R_L0 if L0 is None else L0, R_Cd,
                R_drive, x0r, Wr, Wi, kets, P)

        return core

    builder = SCHEDULE_BUILDERS[key]
    L0_bare, Cd, Cp, Cm, rho0s = (put(getattr(problem, f), dtype)
                                  for f in _COMPLEX_FIELDS)
    method = "pade13" if builder is bangbang_schedule_from_params else "auto"

    def core(params, L0=None):
        sched = builder(params, problem, **builder_kwargs)
        return _evaluate_arrays(sched, L0_bare if L0 is None else L0, Cd, Cp,
                                Cm, rho0s, kets, expm_method=method)

    return core


def _check_protocol(protocol: str) -> str:
    key = protocol.lower().replace("-", "_")
    if key not in SCHEDULE_BUILDERS:
        raise ValueError(f"Unknown protocol for optimization: {protocol}")
    return key


def _where(problem: FixedProblem, device, dtype):
    device = torch.device(problem.device if device is None else device)
    return device, problem.dtype if dtype is None else dtype


def _params_on(params, device, dtype: torch.dtype):
    return torch.as_tensor(np.asarray(params) if not torch.is_tensor(params)
                           else params).to(device=device,
                                           dtype=real_dtype(dtype))


def make_objective(problem: FixedProblem, protocol: str, device=None,
                   dtype: Optional[torch.dtype] = None,
                   **builder_kwargs) -> Callable:
    """Returns cost_fn(params)->(cost, metrics), scalars as 0-d tensors on
    the device: the population objective on a population of one. `device`
    and `dtype` default to the problem's."""
    pop = make_population_objective(problem, protocol, device=device,
                                    dtype=dtype, **builder_kwargs)
    device, dtype = _where(problem, device, dtype)

    def objective(params):
        cost, metrics = pop(_params_on(params, device, dtype)[None])
        return cost[0], {k: v[0] for k, v in metrics.items()}

    return objective


def make_value_and_grad(problem: FixedProblem, protocol: str, device=None,
                        dtype: Optional[torch.dtype] = None,
                        **builder_kwargs) -> Callable:
    """cost_and_grad(params) -> (cost, dcost/dparams): a 0-d tensor and an
    (n_params,) tensor on the device, in the real dtype of `dtype` (default:
    the problem's). The core is the population objective's, on a population
    of one; the gradient comes from torch.autograd.grad, so nothing is left
    on the constants or on the caller's tensors."""
    key = _check_protocol(protocol)
    device, dtype = _where(problem, device, dtype)
    core = _make_eval_core(problem, key, builder_kwargs, device, dtype)

    def call(params):
        x = _params_on(params, device, dtype).detach().requires_grad_(True)
        with torch.enable_grad():
            cost = core(x[None])[0][0]
            (grad,) = torch.autograd.grad(cost, x)
        return cost.detach(), grad

    return call


def make_population_objective(problem: FixedProblem, protocol: str,
                              device=None,
                              dtype: Optional[torch.dtype] = None,
                              **builder_kwargs) -> Callable:
    """Whole-population evaluation: (P, D) params -> (P,) costs, dict of (P,)
    metrics, tensors on the device — ONE batched evaluation per DE
    generation. The constant operands move to `device` (default: the
    problem's) once, here; a call moves only the parameters."""
    key = _check_protocol(protocol)
    device, dtype = _where(problem, device, dtype)
    core = _make_eval_core(problem, key, builder_kwargs, device, dtype)
    first = True

    def call(population):
        # the span nqs.step; the first call is recorded in any case
        nonlocal first
        with span("nqs.step", always=first), torch.no_grad():
            first = False
            return core(_params_on(population, device, dtype))

    return call


def make_spacing_population_objective(apparatus: ApparatusConstraints,
                                      noise_cfg, protocol: str,
                                      include_noise: bool = True,
                                      device: Union[str, torch.device] = "cuda",
                                      dtype: torch.dtype = torch.complex64,
                                      **builder_kwargs) -> Callable:
    """Population objective with spacing_factor as the LAST parameter
    dimension (reference: optimize_cz_gate.py:1043-1051).

    Spacing changes the blockade V *and every trap-dependent noise rate*,
    so each member's Liouvillian is re-planned host-side for its spacing
    (cached by rounded value, mirroring the reference's 4-decimal cache
    keys) — exact physics parity, not just the coherent V(R) scaling.
    All members still evaluate in ONE batched device call: only the L0
    operand is per member (Cp/Cm/Cd/rho0s/Omega are spacing-independent),
    stacked on the host and moved in one copy."""
    key = _check_protocol(protocol)
    dev = torch.device(device)

    # LRU-capped: DE proposes continuous spacings, so hits are rare and an
    # unbounded cache would grow by ~popsize problems per generation
    _cache: "OrderedDict[float, FixedProblem]" = OrderedDict()
    _CACHE_CAP = 256

    def problem_for(sf: float) -> FixedProblem:
        k = round(float(sf), 4)
        if k in _cache:
            _cache.move_to_end(k)
            return _cache[k]
        app = dataclasses.replace(apparatus, spacing_factor=k)
        prob = build_fixed_problem(app, noise_cfg, include_noise=include_noise,
                                   dtype=dtype, device=device)
        _cache[k] = prob
        if len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
        return prob

    p0 = problem_for(apparatus.spacing_factor)
    core = _make_eval_core(p0, key, builder_kwargs, dev, dtype)
    uses_phase_frame = _uses_real_core(p0, key)

    def call(population):
        population = np.asarray(population.cpu() if torch.is_tensor(population)
                                else population)
        prot_params = population[:, :-1]
        sfs = population[:, -1]
        probs = [problem_for(sf) for sf in sfs]
        if uses_phase_frame:
            # the fast core assumes the phase-frame factorization;
            # build_fixed_problem re-verifies the generator per re-planned
            # spacing (exact host-side support check) — refuse to run a
            # member whose physics stopped being phase-covariant rather
            # than silently evaluate it wrong
            for sf, pr in zip(sfs, probs):
                if pr.g is None:
                    raise RuntimeError(
                        f"spacing_factor={float(sf):.4f}: re-planned "
                        "Liouvillian is not phase-frame compatible; "
                        "rebuild the objective with a non-uniform protocol")
        L0s = torch.from_numpy(np.stack(
            [pr.R_L0 if uses_phase_frame else pr.L0_bare for pr in probs]))
        if dev.type == "cuda":
            # pinned, so the copy does not wait for the device to drain
            L0s = L0s.pin_memory().to(dev, non_blocking=True)
        with torch.no_grad():
            return core(_params_on(prot_params, dev, dtype), L0s)

    call.problem_for = problem_for
    call.base_problem = p0
    return call


__all__ = ["FixedProblem", "build_fixed_problem", "problem_from_numpy",
           "make_objective", "make_value_and_grad", "make_population_objective",
           "make_spacing_population_objective",
           "lp_schedule_from_params", "smooth_jp_schedule_from_params",
           "free_phases_schedule_from_params",
           "free_phases_uniform_from_params",
           "bangbang_schedule_from_params"]
