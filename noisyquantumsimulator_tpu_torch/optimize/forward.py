"""Forward CZ optimization: best protocol parameters for a fixed apparatus.

Counterpart of the reference's `optimize/forward.py`, the rebuild of the
original forward optimizer (optimize_cz_gate.py:786-1496 `optimize_cz_gate`,
`run_baseline`, CLI `main`): differential evolution evaluates whole
populations in one batched device call (optimize/de.py) instead of ~1200
serial gate sims. By default a gradient polish (`make_value_and_grad`,
gradients through the matrix exponential) refines the DE optimum, and
protocol="grape" descends every per-segment phase with Adam.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.configs import (JPSimulationInputs, LPSimulationInputs,
                            SmoothJPSimulationInputs)
from ..physics import protocols as proto
from ..gate.simulate import simulate_cz_gate
from ..solver.propagator import real_dtype
from .apparatus import ApparatusConstraints, OptimizationResult
from .cost import extract_metrics
from .de import differential_evolution
from .engine import (build_fixed_problem, make_objective,
                     make_population_objective,
                     make_spacing_population_objective, make_value_and_grad,
                     smooth_jp_uniform_from_params)

Device = Union[str, torch.device]


# =============================================================================
# bounds / starting points (optimize_cz_gate.py:544-645)
# =============================================================================

def get_lp_bounds_and_x0() -> Tuple[list, np.ndarray]:
    bounds = [(0.20, 0.50), (3.5, 5.5)]
    x0 = np.array([proto.LP_DELTA_OVER_OMEGA_DEFAULT,
                   proto.LP_OMEGA_TAU_DEFAULT])
    return bounds, x0


def get_jp_bangbang_bounds_and_x0(n_segments: int = 5) -> Tuple[list, np.ndarray]:
    frac_bounds = (0.01, 0.99)
    phase_bounds = (-np.pi, np.pi)
    if n_segments == 5:
        ot0 = proto.JP_OMEGA_TAU_VALIDATED
        f0 = [t / ot0 for t in proto.JP_SWITCHING_TIMES_VALIDATED]
        bounds = [(5.0, 40.0)] + [frac_bounds] * 4 + [phase_bounds] * 5
        x0 = np.array([ot0, *f0, *proto.JP_PHASES_VALIDATED])
    elif n_segments == 7:
        ot0 = 7.0
        f0 = [t / ot0 for t in proto.JP_SWITCHING_TIMES_DEFAULT]
        bounds = [(3.0, 30.0)] + [frac_bounds] * 6 + [phase_bounds] * 7
        x0 = np.array([ot0, *f0, *proto.JP_PHASES_DEFAULT])
    else:
        raise ValueError(f"Unsupported n_segments: {n_segments}. Use 5 or 7.")
    return bounds, x0


def get_smooth_jp_bounds_and_x0() -> Tuple[list, np.ndarray]:
    bounds = [(5.0, 25.0), (0.05 * np.pi, 1.0 * np.pi), (0.5, 3.0),
              (0.0, 2 * np.pi), (0.001, 0.10)]
    x0 = np.array([proto.SMOOTH_JP_PARAMS["omega_tau"],
                   proto.SMOOTH_JP_PARAMS["A"],
                   proto.SMOOTH_JP_PARAMS["omega_mod_ratio"],
                   proto.SMOOTH_JP_PARAMS["phi_offset"],
                   abs(proto.SMOOTH_JP_PARAMS["delta_over_omega"])])
    return bounds, x0


def warm_start_bounds(opt_result: OptimizationResult, frac: float = 0.20,
                      original_bounds: Optional[list] = None
                      ) -> Tuple[list, np.ndarray]:
    """Tight bounds around a previous optimum. (optimize_cz_gate.py:646-710)"""
    x0 = np.array(opt_result.best_params, dtype=float).copy()
    bounds = []
    for i, (name, val) in enumerate(zip(opt_result.param_names, x0)):
        if "phi" in name:
            lo, hi = val - frac * np.pi, val + frac * np.pi
        elif "frac" in name:
            lo, hi = max(0.01, val - frac), min(0.99, val + frac)
        else:
            d = max(abs(val) * frac, 0.01)
            lo, hi = val - d, val + d
        if original_bounds is not None and i < len(original_bounds):
            lo = max(lo, original_bounds[i][0])
            hi = min(hi, original_bounds[i][1])
        if lo >= hi:
            lo = hi - 0.01
        bounds.append((lo, hi))
    return bounds, x0


_PARAM_NAMES = {
    "lp": ["delta_over_omega", "omega_tau"],
    "smooth_jp": ["omega_tau", "A", "omega_mod_ratio", "phi_offset",
                  "delta_over_omega"],
}


def _bb_param_names(n_segments: int) -> List[str]:
    return (["omega_tau"]
            + [f"frac_{i}" for i in range(1, n_segments)]
            + [f"phi_{i}" for i in range(n_segments)])


# =============================================================================
# main entry point
# =============================================================================

def optimize_cz_gate(
    protocol: str,
    apparatus: Optional[ApparatusConstraints] = None,
    include_noise: bool = True,
    maxiter: int = 80,
    popsize: int = 15,
    seed: int = 42,
    bounds: Optional[list] = None,
    x0: Optional[np.ndarray] = None,
    grad_polish: bool = True,
    polish_steps: int = 60,
    polish_lr: float = 0.02,
    co_optimize_spacing: bool = False,
    spacing_bounds: Optional[Tuple[float, float]] = None,
    strategy: str = "standard",
    verbose: bool = False,
    grape_steps: int = 400,
    grape_lr: float = 2e-3,
    grape_n_steps: int = 300,
    device: Device = "cuda",
    dtype: torch.dtype = torch.complex64,
) -> OptimizationResult:
    """Optimize protocol parameters under a fixed apparatus.
    (optimize_cz_gate.py:786-1330)

    protocol: "lp" | "smooth_jp" | "jp_bangbang" | "grape"
    For bang-bang, both 5- and 7-segment variants are tried and the best is
    kept (optimize_cz_gate.py:905).

    grad_polish (default on): after DE, up to `polish_steps` normalised
    gradient steps from the DE optimum (`make_value_and_grad`), each kept
    only when it lowers the cost; a rejected step halves the step size.

    protocol="grape" skips DE entirely: every per-segment phase
    (grape_n_steps of them) is a free parameter and Adam descends the same
    cost through the differentiable solver, starting from the literature
    smooth-JP pulse (or from `x0`, a phase vector of that length).

    device / dtype: where and in what complex precision the objectives and
    gradients compute (the host plan is numpy either way).

    co_optimize_spacing appends spacing_factor as an extra DE dimension
    (optimize_cz_gate.py:1043-1051): each member's Liouvillian is
    re-planned for its spacing (full trap-noise pipeline), batched into
    one device call per generation.

    strategy="two_phase" (smooth-JP only, optimize_cz_gate.py:1179-1244):
    phase 1 optimizes omega_tau (+ spacing) alone at literature defaults,
    phase 2 fine-tunes all parameters with omega_tau bounds tightened to
    +-30% around the phase-1 optimum.
    """
    p = protocol.lower().replace("-", "_")
    if apparatus is None:
        apparatus = ApparatusConstraints()
    noise_cfg = (apparatus.make_full_noise() if include_noise
                 else apparatus.make_noiseless())
    problem = build_fixed_problem(apparatus, noise_cfg,
                                  include_noise=include_noise, dtype=dtype,
                                  device=device)
    opt_kwargs = dict(maxiter=maxiter, popsize=popsize, seed=seed,
                      grad_polish=grad_polish, polish_steps=polish_steps,
                      polish_lr=polish_lr, verbose=verbose,
                      apparatus=apparatus, noise_cfg=noise_cfg,
                      include_noise=include_noise,
                      co_optimize_spacing=co_optimize_spacing,
                      spacing_bounds=spacing_bounds, strategy=strategy,
                      device=device, dtype=dtype)

    t0 = time.time()
    if p in ("jp_bangbang", "jandura_pupillo", "jp"):
        variants = {}
        for n_seg in (5, 7):
            b, x = ((bounds, x0) if bounds is not None
                    else get_jp_bangbang_bounds_and_x0(n_seg))
            res = _optimize_single(problem, "jandura_pupillo",
                                   dict(n_segments=n_seg), b, x,
                                   **opt_kwargs)
            variants[f"{n_seg}-segment"] = res
        best_key = min(variants, key=lambda k: variants[k]["cost"])
        best = variants[best_key]
        names = _bb_param_names(5 if best_key.startswith("5") else 7)
        if co_optimize_spacing:
            names = names + ["spacing_factor"]
        result = OptimizationResult(
            success=best["metrics"]["avg_fidelity"] > 0.9,
            protocol="jandura_pupillo", best_params=best["x"],
            param_names=names, best_cost=best["cost"],
            best_metrics=best["metrics"], n_evaluations=best["nfev"],
            runtime_s=time.time() - t0, discrete_variant=best_key,
            all_variants={k: {kk: vv for kk, vv in v.items() if kk != "x"}
                          for k, v in variants.items()},
            history=list(best["history"]))
        return result

    if p in ("grape", "free_phases"):
        # x0, if given, is the initial phase vector itself (warm start
        # from a previous GRAPE result); bounds do not apply to Adam
        if bounds is not None:
            raise ValueError("protocol='grape' is unconstrained Adam; "
                             "bounds are not supported")
        return _optimize_grape(problem, t0=t0, iters=grape_steps,
                               lr=grape_lr, n_steps=grape_n_steps,
                               init_phases=x0, verbose=verbose,
                               device=device, dtype=dtype)

    if p in ("lp", "levine_pichler", "two_pulse"):
        key, names = "levine_pichler", _PARAM_NAMES["lp"]
        b, x = get_lp_bounds_and_x0()
    elif p in ("smooth_jp", "dark_state"):
        key, names = "smooth_jp", _PARAM_NAMES["smooth_jp"]
        b, x = get_smooth_jp_bounds_and_x0()
    else:
        raise ValueError(f"Unknown protocol: {protocol}")

    if bounds is not None:
        b = bounds
    if x0 is not None:
        x = np.asarray(x0)

    best = _optimize_single(problem, key, {}, b, x, **opt_kwargs)
    if co_optimize_spacing:
        names = list(names) + ["spacing_factor"]
    return OptimizationResult(
        success=best["metrics"]["avg_fidelity"] > 0.9, protocol=key,
        best_params=best["x"], param_names=names, best_cost=best["cost"],
        best_metrics=best["metrics"], n_evaluations=best["nfev"],
        runtime_s=time.time() - t0, history=list(best["history"]))


def grape_adam(phases: torch.Tensor, lr: float) -> torch.optim.Adam:
    """GRAPE's optimizer over the leaf tensor `phases`: the update of
    optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8 outside the square root)."""
    return torch.optim.Adam([phases], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _optimize_grape(problem, t0, iters: int = 400, lr: float = 2e-3,
                    n_steps: int = 300, init_phases=None,
                    verbose: bool = False, device: Device = "cuda",
                    dtype: torch.dtype = torch.complex64
                    ) -> OptimizationResult:
    """GRAPE mode: Adam over ALL per-segment phases through the
    differentiable solver (engine.free_phases_uniform_from_params),
    initialized from the literature smooth-JP pulse (or `init_phases`,
    a warm-start phase vector of length n_steps). The cost is recorded
    every 25 steps and at the last one."""
    _, xs = get_smooth_jp_bounds_and_x0()
    rdt = real_dtype(dtype)
    if init_phases is not None:
        phases0 = torch.as_tensor(np.asarray(init_phases, dtype=float))
        if phases0.shape != (n_steps,):
            raise ValueError(f"init_phases must have shape ({n_steps},); "
                             f"got {tuple(phases0.shape)}")
    else:
        phases0, _, _ = smooth_jp_uniform_from_params(
            torch.as_tensor(xs), problem, n_steps=n_steps)
    ot, dow = float(xs[0]), float(xs[4])
    kw = dict(omega_tau=ot, delta_over_omega=dow)
    vg = make_value_and_grad(problem, "grape", device=device, dtype=dtype, **kw)
    obj = make_objective(problem, "grape", device=device, dtype=dtype, **kw)
    ph = phases0.to(device=device, dtype=rdt).clone().requires_grad_(True)
    opt = grape_adam(ph, lr)
    history = []
    for it in range(iters):
        cost, grad = vg(ph.detach())
        ph.grad = grad
        opt.step()
        if it % 25 == 0 or it == iters - 1:
            history.append(float(cost))
            if verbose:
                print(f"    grape iter {it:4d}  cost {float(cost):10.4f}")
    ph = ph.detach()
    cost, metrics = obj(ph)
    metrics = {k: float(v) for k, v in metrics.items()}
    return OptimizationResult(
        success=metrics["avg_fidelity"] > 0.9, protocol="grape",
        best_params=ph.cpu().numpy(),
        param_names=[f"phi_{i}" for i in range(n_steps)],
        best_cost=float(cost), best_metrics=metrics, n_evaluations=iters,
        runtime_s=time.time() - t0, history=history)


def _polish(problem, protocol_key, builder_kwargs, bounds, x, cost, steps,
            lr, device, dtype):
    """Gradient polish from x (cost `cost`): a step of length lr * scale in
    the direction of the scale-weighted gradient (scale = hi - lo), clipped
    to the bounds and kept only when the cost drops; a rejected step halves
    lr, and the polish stops when lr falls below 1e-5. Returns (best x
    (host numpy), its cost, gradient evaluations)."""
    obj = make_objective(problem, protocol_key, device=device, dtype=dtype,
                         **builder_kwargs)
    grad_fn = make_value_and_grad(problem, protocol_key, device=device,
                                  dtype=dtype, **builder_kwargs)
    rdt = real_dtype(dtype)
    lo, hi = (torch.tensor([b[i] for b in bounds], dtype=rdt, device=device)
              for i in (0, 1))
    scale = hi - lo
    x = torch.as_tensor(np.asarray(x, dtype=float)).to(device=device, dtype=rdt)
    best_x, best_c = x, cost
    nfev = 0
    for _ in range(steps):
        _, g = grad_fn(x)
        nfev += 1
        g = g * scale                       # scale-aware step
        step = lr * scale * g / (torch.linalg.norm(g) + 1e-30)
        x_new = torch.clamp(x - step, lo, hi)
        c_new = float(obj(x_new)[0])
        if c_new < best_c:
            best_x, best_c = x_new, c_new
            x = x_new
        else:
            lr *= 0.5
            if lr < 1e-5:
                break
    return best_x.cpu().double().numpy(), best_c, nfev


def _optimize_single(problem, protocol_key, builder_kwargs, bounds, x0,
                     maxiter, popsize, seed, grad_polish, polish_steps,
                     polish_lr, verbose, apparatus=None, noise_cfg=None,
                     include_noise=True, co_optimize_spacing=False,
                     spacing_bounds=None, strategy="standard",
                     device: Device = "cuda",
                     dtype: torch.dtype = torch.complex64) -> Dict:
    bounds = list(bounds)
    x0 = np.asarray(x0, dtype=float)
    if co_optimize_spacing:
        sb = spacing_bounds or (1.5, 5.0)
        bounds = bounds + [tuple(sb)]
        x0 = np.append(x0, apparatus.spacing_factor)
        pop_obj = make_spacing_population_objective(
            apparatus, noise_cfg, protocol_key,
            include_noise=include_noise, device=device, dtype=dtype,
            **builder_kwargs)
    else:
        pop_obj = make_population_objective(problem, protocol_key,
                                            device=device, dtype=dtype,
                                            **builder_kwargs)

    def cost_only(pop):
        c, m = pop_obj(pop)
        return c, m

    nfev = 0
    history = []

    # two-phase strategy (reference optimize_cz_gate.py:1179-1244):
    # coarse 1-D (or 2-D with spacing) sweep of omega_tau, then tighten
    if strategy == "two_phase" and protocol_key == "smooth_jp":
        n_fixed = 4  # A, omega_mod_ratio, phi_offset, delta_over_omega
        fixed = x0[1:1 + n_fixed]

        def phase1_obj(pop1):
            # pop1 columns: [omega_tau] or [omega_tau, spacing_factor]
            pop1 = np.asarray(pop1)
            P = pop1.shape[0]
            full = np.concatenate(
                [pop1[:, :1], np.broadcast_to(fixed, (P, n_fixed))] +
                ([pop1[:, 1:2]] if co_optimize_spacing else []),
                axis=1)
            return cost_only(full)

        p1_bounds = [bounds[0]] + ([bounds[-1]] if co_optimize_spacing
                                   else [])
        p1_x0 = np.array([x0[0]] + ([x0[-1]] if co_optimize_spacing
                                    else []))
        de1 = differential_evolution(phase1_obj, p1_bounds, x0=p1_x0,
                                     popsize=10,
                                     maxiter=max(20, maxiter // 4),
                                     seed=seed)
        nfev += de1.nfev
        ot_best = float(de1.x[0])
        x0 = x0.copy()
        x0[0] = ot_best
        if co_optimize_spacing:
            x0[-1] = float(de1.x[1])
        bounds[0] = (max(bounds[0][0], ot_best * 0.7),
                     min(bounds[0][1], ot_best * 1.3))
        if verbose:
            print(f"    two-phase: phase-1 omega_tau={ot_best:.3f} "
                  f"cost={de1.fun:.4f}; phase-2 bounds={bounds[0]}")

    de = differential_evolution(cost_only, bounds, x0=x0, popsize=popsize,
                                maxiter=maxiter, seed=seed)
    x_best, cost_best = de.x, de.fun
    nfev += de.nfev
    history += list(de.history)

    if grad_polish:
        # with spacing co-optimization the polish runs on the protocol
        # sub-vector at the best member's (re-planned) spacing
        if co_optimize_spacing:
            polish_problem = pop_obj.problem_for(float(x_best[-1]))
            polish_bounds, x_pol = bounds[:-1], x_best[:-1]
        else:
            polish_problem, polish_bounds, x_pol = problem, bounds, x_best
        best_x, best_c, n_grad = _polish(
            polish_problem, protocol_key, builder_kwargs, polish_bounds,
            x_pol, float(cost_best), polish_steps, polish_lr, device, dtype)
        nfev += n_grad
        if best_c < cost_best:
            if co_optimize_spacing:
                best_x = np.append(best_x, x_best[-1])
            x_best, cost_best = best_x, float(best_c)
            history.append(cost_best)

    _, metrics = pop_obj(np.asarray(x_best)[None])
    metrics = {k: float(v[0]) for k, v in metrics.items()}
    if verbose:
        print(f"  [{protocol_key}{builder_kwargs or ''}] cost={cost_best:.4f} "
              f"F={metrics['avg_fidelity']:.6f} nfev={nfev}")
    return {"x": np.asarray(x_best), "cost": float(cost_best),
            "metrics": metrics, "nfev": nfev, "history": history}


# =============================================================================
# baseline runner (optimize_cz_gate.py:1331-1413)
# =============================================================================

def run_baseline(protocol: str = "lp",
                 apparatus: Optional[ApparatusConstraints] = None,
                 include_noise: bool = True, verbose: bool = True,
                 device: Device = "cuda",
                 dtype: torch.dtype = torch.complex128):
    """One default-parameter gate sim + metric printout."""
    if apparatus is None:
        apparatus = ApparatusConstraints()
    exc = apparatus.make_excitation_config()
    noise = (apparatus.make_full_noise() if include_noise
             else apparatus.make_noiseless())
    p = protocol.lower()
    if p in ("lp", "levine_pichler"):
        si = LPSimulationInputs(excitation=exc, noise=noise)
    elif p in ("smooth_jp", "dark_state"):
        si = SmoothJPSimulationInputs(excitation=exc, noise=noise)
    else:
        si = JPSimulationInputs(excitation=exc, noise=noise)
    result = simulate_cz_gate(si, device=device, dtype=dtype,
                              include_noise=include_noise,
                              **apparatus.sim_kwargs())
    metrics = extract_metrics(result)
    if verbose:
        print(f"Baseline {protocol}: F={metrics['avg_fidelity']:.6f} "
              f"F11={metrics['f11']:.6f} "
              f"phase_err={metrics['phase_error_deg']:.2f} deg "
              f"t={metrics['gate_time_us']:.3f} us "
              f"V/Omega={metrics['V_over_Omega']:.1f} "
              f"Omega/2pi={metrics['Omega_MHz']:.2f} MHz")
    return result, metrics


def main(argv=None):
    """CLI mirror of optimize_cz_gate.py:1414."""
    import argparse
    ap = argparse.ArgumentParser(description="Optimize a Rydberg CZ gate")
    ap.add_argument("--protocol", default="smooth_jp",
                    choices=["lp", "smooth_jp", "jp_bangbang"])
    ap.add_argument("--noise", action="store_true", default=True)
    ap.add_argument("--no-noise", dest="noise", action="store_false")
    ap.add_argument("--maxiter", type=int, default=80)
    ap.add_argument("--popsize", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="where the population objective computes: cuda "
                         "(default) or cpu")
    ap.add_argument("--x64", action="store_true",
                    help="complex128 / float64 instead of complex64 / float32")
    args = ap.parse_args(argv)

    res = optimize_cz_gate(args.protocol, include_noise=args.noise,
                           maxiter=args.maxiter, popsize=args.popsize,
                           verbose=True, device=args.device,
                           dtype=torch.complex128 if args.x64
                           else torch.complex64)
    print(res)
    return res


__all__ = ["optimize_cz_gate", "run_baseline", "main",
           "get_lp_bounds_and_x0", "get_jp_bangbang_bounds_and_x0",
           "get_smooth_jp_bounds_and_x0", "warm_start_bounds"]


if __name__ == "__main__":
    main()
