"""The gate engine's batched phase-scale sweep (the headline workload).

Counterpart of the reference's `bench.py` `build_workload(engine="real")`:
one "sim" is a full noisy smooth-JP CZ gate simulation (n_steps segments of
a D^2-dim Lindblad evolution of the four basis states plus |++>). A sweep of
`batch` sims shares one base propagator:

  1. U_base = exp((L0 + C+ + C-) dt)            one expm (kernel K2 squares)
  2. U_real = Re(W U_base W^dagger)              real Hermitian basis
  3. the n_steps phase-frame scan of every sim  kernel K1
  4. the CZ fidelity of every sim               batched torch ops

This module builds the sweep and has no timing code of its own; callers
time `step` (chip_smoke.py does).
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from .core.configs import SmoothJPSimulationInputs
from .gate.fidelity import compute_cz_fidelity
from .gate.simulate import (GatePlan, plan_cz_gate, plan_phase_frame,
                            plan_squaring_bound)
from .solver.propagator import real_dtype, uniform_base_propagator
from .solver.real_rep import (build_real_rep, evolve_real_phased_many,
                              from_real_coords, real_propagator_device,
                              to_real_coords)


def build_workload(batch: int, n_steps: int = 300,
                   dtype: torch.dtype = torch.complex64, dim: int = 3,
                   device: Union[str, torch.device] = "cpu",
                   ) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                              torch.Tensor, GatePlan]:
    """(step, scales, plan): step(scales) -> (B,) average CZ fidelities of
    the smooth-JP gate with its phase modulation scaled by each entry of
    `scales`; `scales` is the default sweep of `batch` factors in
    [0.95, 1.05]."""
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

    def step(scales: torch.Tensor) -> torch.Tensor:
        Ub = uniform_base_propagator(L0, Cp, Cm, amp0, dt0, max_squarings=ms)
        U_real = real_propagator_device(Ub, Wr, Wi)
        x0 = to_real_coords(rho0s, Wr, Wi)
        out = evolve_real_phased_many(U_real, cq, scales[:, None] * phases,
                                      x0, D, rep.P)
        _, avg, _ = compute_cz_fidelity(from_real_coords(out, Wr, Wi), kets)
        return avg

    return step, scales, plan


__all__ = ["build_workload"]
