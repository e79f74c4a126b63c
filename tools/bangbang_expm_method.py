#!/usr/bin/env python3
"""The bang-bang objective's expm: Taylor-16 against Pade-13, and where its
complex64 error comes from.

    python3 tools/bangbang_expm_method.py

Run from the root of the repository on an NVIDIA GPU. The bang-bang
objective (5 segments, complex64, the default apparatus with full noise)
takes Pade-13 (`optimize/engine._evaluate_arrays`) at its single-precision
theta (11.25). Here its expm is switched in turns (T, P64, P32, P32, P64, T)
between Taylor-16, Pade-13 at the 64-bit theta (5.37) and Pade-13 at the
32-bit theta, on the same inputs. For each turn: the population objective at
P = 1024 (median ms of 5 calls after a warm-up, evaluations/s), value-and-grad
at x0 (median ms of 5, K2 launches per call) and the largest fidelity error
of 8 members against the complex128 per-segment path.

Then the error terms, for 6 populations of 8 members (the first is phase
10's of chip_smoke.py): the objective at complex128 from operands and
parameters rounded to 32 bits (inputs), at complex64 with the expm at
complex128 (inputs, ordered product, fidelities), and at complex64 with the
expm's polynomial or its squaring chain alone at complex64. Last, the card's
name and power limit.
"""
from __future__ import annotations

import statistics
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.chip_common import SEED, population_near  # noqa: E402
from noisyquantumsimulator_tpu_torch.bench import card  # noqa: E402

FIDS = ("avg_fidelity", "f00", "f01", "f10", "f11", "cz_phase_fidelity")


def _median_ms(fn, n=5):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _dF(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in FIDS)


def _split_expm(poly_dtype, chain_dtype):
    """expm (Pade-13 at the operand's theta) with its polynomial computed in
    `poly_dtype` and its squaring chain in `chain_dtype`."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops import expm as texpm
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring

    def expm(A, max_squarings=None, method="auto"):
        D = A.shape[-1]
        As, s = texpm._scale(A, texpm._theta("pade13", A.dtype), max_squarings)
        As = As.to(poly_dtype)
        I = torch.eye(D, dtype=poly_dtype, device=A.device).expand(As.shape)
        R = texpm._pade13(As, I).reshape(-1, D, D).to(chain_dtype).contiguous()
        R = fused_masked_squaring(R, s.reshape(-1), max_squarings)
        return R.reshape(A.shape).to(A.dtype)

    return expm


def _error_terms(problem, x0, bounds):
    import torch
    from noisyquantumsimulator_tpu_torch.optimize import engine
    from noisyquantumsimulator_tpu_torch.solver import propagator
    c64, c128 = torch.complex64, torch.complex128
    real = propagator.expm

    def run(pop, dtype, rounded, expm=None):
        f = lambda a: (torch.as_tensor(np.asarray(a), device="cuda")
                       .to(c64 if rounded else c128).to(dtype))
        L0, Cd, Cp, Cm, r0 = (f(getattr(problem, k))
                              for k in ("L0_bare", "Cd", "Cp", "Cm", "rho0s"))
        kets = {k: f(v) for k, v in problem.kets.items()}
        p = torch.as_tensor(pop, device="cuda")
        sched = engine.SCHEDULE_BUILDERS["jp_bangbang"](
            p.float() if rounded else p, problem, n_segments=5)
        if expm is not None:
            propagator.expm = expm
        try:
            with torch.no_grad():
                rhos = propagator.evolve_rhos(L0, Cp, Cm, sched, r0, Cd=Cd,
                                              expm_method="pade13")
                return engine._cost_and_metrics(rhos, kets,
                                                 sched.dts.sum(-1) * 1e6)[1]
        finally:
            propagator.expm = real

    rows = []
    for k in range(6):
        rng = np.random.default_rng(SEED + 10 + k)
        pop = population_near(x0, bounds, 1024 if k == 0 else 8, 0.02, rng)[:8]
        ref = run(pop, c128, False)
        rows.append({
            "inputs": _dF(run(pop, c128, True), ref),
            "inputs, product, fidelities": _dF(
                run(pop, c64, True, _split_expm(c128, c128)), ref),
            "polynomial alone": _dF(run(pop, c64, True, _split_expm(c64, c128)), ref),
            "squaring chain alone": _dF(
                run(pop, c64, True, _split_expm(c128, c64)), ref),
            "all (the objective)": _dF(run(pop, c64, True), ref)})
        print(f"[error terms, population {k + 1} of 6] max|dF| against complex128: "
              + ", ".join(f"{n} {v:.3e}" for n, v in rows[-1].items()), flush=True)
    print("[error terms] largest over the 6 populations: " + ", ".join(
        f"{n} {max(r[n] for r in rows):.3e}" for n in rows[0]), flush=True)


def main() -> int:
    import torch
    from noisyquantumsimulator_tpu_torch.ops import expm as texpm
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    from noisyquantumsimulator_tpu_torch.optimize import engine, forward
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
        ApparatusConstraints)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = engine.build_fixed_problem(app, app.make_full_noise())
    bounds, x0 = forward.get_jp_bangbang_bounds_and_x0(5)
    pop = population_near(x0, bounds, 1024, 0.02, np.random.default_rng(SEED + 10))
    pop_dev = torch.as_tensor(pop, device="cuda")
    x0_dev = torch.as_tensor(x0, device="cuda")
    c128 = torch.complex128
    put = lambda a: torch.as_tensor(np.asarray(a), device="cuda").to(c128)
    with torch.no_grad():
        sched = engine.SCHEDULE_BUILDERS["jp_bangbang"](pop_dev[:8], problem,
                                                         n_segments=5)
        _, ref_m = engine._evaluate_arrays(
            sched, put(problem.L0_bare), put(problem.Cd), put(problem.Cp),
            put(problem.Cm), put(problem.rho0s),
            {k: put(v) for k, v in problem.kets.items()})
    real = engine.evolve_rhos
    single = texpm._THETA13_SINGLE
    turns = {"T": ("taylor16", single), "P64": ("pade13", texpm._THETA13),
             "P32": ("pade13", single)}
    for turn in ("T", "P64", "P32", "P32", "P64", "T"):
        method, theta = turns[turn]
        engine.evolve_rhos = lambda *a, expm_method=None, **k: real(
            *a, expm_method=method, **k)
        texpm._THETA13_SINGLE = theta
        try:
            obj = engine.make_population_objective(problem, "jp_bangbang",
                                                   device="cuda", n_segments=5)
            vg = engine.make_value_and_grad(problem, "jp_bangbang", device="cuda",
                                            n_segments=5)
            pop_ms = _median_ms(lambda: obj(pop_dev))
            fused_masked_squaring.launches = 0
            vg_ms = _median_ms(lambda: float(vg(x0_dev)[0]))
            vg_launches = fused_masked_squaring.launches / 6
            _, m = obj(pop_dev)
            dF = _dF({k: m[k][:8] for k in FIDS}, ref_m)
        finally:
            engine.evolve_rhos = real
            texpm._THETA13_SINGLE = single
        print(f"[bang-bang {turn}: {method}, theta "
              f"{theta if method == 'pade13' else texpm._THETA16:.4f}] population "
              f"objective P = 1024: {pop_ms:.3f} ms a call, "
              f"{1024 / pop_ms * 1e3:.1f} evaluations/s; value_and_grad "
              f"{vg_ms:.3f} ms a call, K2 launches per call {vg_launches:g}; max|dF| "
              f"of 8 members against complex128 {dF:.3e}", flush=True)
    _error_terms(problem, x0, bounds)
    print(*card(), sep=", ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
