"""The gate engine's batched phase-scale sweep (the headline workload).

Counterpart of the reference's `bench.py` `build_workload`: one "sim" is a
full noisy smooth-JP CZ gate simulation (n_steps segments of a D^2-dim
Lindblad evolution of the four basis states plus |++>). A sweep of `batch`
sims shares one base propagator. engine="real" (the default):

  1. U_base = exp((L0 + C+ + C-) dt)            one expm (kernel K2 squares)
  2. U_real = Re(W U_base W^dagger)              real Hermitian basis
  3. the n_steps phase-frame scan of every sim  kernel K1
  4. the CZ fidelity of every sim               batched torch ops

engine="complex" keeps step 1 and runs the phase-frame scan on the complex
coordinates (`solver.propagator.evolve_rhos_phased_many`, torch ops), then
step 4.

This module builds the sweep and has no timing code of its own; callers
time `step` (`bench.main` and chip_smoke.py do).
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from .core.configs import SmoothJPSimulationInputs
from .gate.fidelity import compute_cz_fidelity
from .gate.simulate import (GatePlan, plan_cz_gate, plan_phase_frame,
                            plan_squaring_bound)
from .solver.propagator import (evolve_rhos_phased_many, real_dtype,
                                uniform_base_propagator)
from .solver.real_rep import (build_real_rep, evolve_real_phased_many,
                              from_real_coords, real_propagator_device,
                              to_real_coords)
from .utils.observability import span


def build_workload(batch: int, n_steps: int = 300,
                   dtype: torch.dtype = torch.complex64, dim: int = 3,
                   device: Union[str, torch.device] = "cuda",
                   prec: str = "highest", engine: str = "real",
                   ) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                              torch.Tensor, GatePlan]:
    """(step, scales, plan): step(scales) -> (B,) average CZ fidelities of
    the smooth-JP gate with its phase modulation scaled by each entry of
    `scales`; `scales` is the default sweep of `batch` factors in
    [0.95, 1.05].

    prec: the reference's matmul precision; the port runs every float32
    product in full FP32 (TF32 is off, see the package's __init__), so only
    "highest" is accepted. engine: "real" (kernels K2 and K1) or "complex"
    (K2, then the complex phase-frame scan)."""
    if prec != "highest":
        raise ValueError(
            f"prec={prec!r}: the port pins full FP32 products (TF32 off), "
            "the reference's 'highest'; its reduced-precision passes "
            "('high', 'default') are not ported")
    if engine not in ("real", "complex"):
        raise ValueError(f"engine must be 'real' or 'complex', got {engine!r}")
    dev = torch.device(device)
    rdt = real_dtype(dtype)
    plan = plan_cz_gate(SmoothJPSimulationInputs(), n_steps_smooth=n_steps,
                        hilbert_space_dim=dim, device=dev, dtype=dtype)
    g = plan_phase_frame(plan)
    if g is None:
        raise ValueError("smooth-JP plan must be phase-frame eligible")
    ms = plan_squaring_bound(plan)
    amp0 = float(np.asarray(plan.schedule.amps)[0])
    dt0 = float(np.asarray(plan.schedule.dts)[0])
    D = dim * dim
    rep = build_real_rep(g, D)

    def cput(a):
        return torch.as_tensor(np.asarray(a, np.complex128), device=dev).to(dtype)

    def rput(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(rdt)

    L0, Cp, Cm, rho0s = (cput(a) for a in (plan.L0, plan.Cp, plan.Cm,
                                            plan.rho0s))
    Wr, Wi, cq, phases = (rput(a) for a in (rep.Wr, rep.Wi, rep.cq,
                                            plan.schedule.phases))
    kets = {k: cput(v) for k, v in plan.kets.items()}
    scales = torch.linspace(0.95, 1.05, batch, dtype=torch.float64,
                            device=dev).to(rdt)

    if engine == "complex":
        g_dev = rput(g)

        def step_complex(scales: torch.Tensor) -> torch.Tensor:
            Ub = uniform_base_propagator(L0, Cp, Cm, amp0, dt0,
                                         max_squarings=ms)
            rhos = evolve_rhos_phased_many(Ub, g_dev, scales[:, None] * phases,
                                           rho0s)
            return compute_cz_fidelity(rhos, kets)[1]

        return step_complex, scales, plan

    first = True

    def step(scales: torch.Tensor) -> torch.Tensor:
        # the span nqs.step; the first call (the kernel library's load, the
        # first device calls) is recorded in any case
        nonlocal first
        with span("nqs.step", always=first):
            first = False
            Ub = uniform_base_propagator(L0, Cp, Cm, amp0, dt0, max_squarings=ms)
            U_real = real_propagator_device(Ub, Wr, Wi)
            x0 = to_real_coords(rho0s, Wr, Wi)
            out = evolve_real_phased_many(U_real, cq, scales[:, None] * phases,
                                          x0, D, rep.P)
            _, avg, _ = compute_cz_fidelity(from_real_coords(out, Wr, Wi), kets)
            return avg

    return step, scales, plan


__all__ = ["build_workload"]
