"""What `chip_smoke.py` and the scripts under `tools/` share on the card: the
seed, the H100's peaks, the gate plan at the bench's settings, the phase
scan's inputs built on the host, CUDA-event timing and a population around
a start vector.

    from tools.chip_common import SEED, cuda_ms, gate_plan

Run from the root of the repository (the scripts under `tools/` put it on
`sys.path`). Imports nothing of JAX; torch is imported inside the functions
that use the card.
"""
from __future__ import annotations

import warnings

import numpy as np

SEED = 20261016
# H100 SXM dense peaks (NVIDIA's data sheet, 700 W): FP32 outside the tensor
# cores, FP64 and TF32 on them (cuBLAS runs 64-bit products on the FP64
# tensor cores; a 3xTF32 product costs three), device memory.
PEAK_FP32 = 67e12
PEAK_FP64 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# INT32 operations: 64 INT32 lanes a streaming multiprocessor, 132 of them,
# at the 1.98 GHz boost clock
PEAK_INT32 = 132 * 64 * 1.98e9


def gate_plan(dim, n_steps=300):
    """plan_cz_gate of the default smooth-JP inputs at `dim` levels."""
    from noisyquantumsimulator_tpu_torch.core.configs import (
        SmoothJPSimulationInputs)
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_cz_gate
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return plan_cz_gate(SmoothJPSimulationInputs(), hilbert_space_dim=dim,
                            n_steps_smooth=n_steps)


def host_scan_inputs(plan):
    """U_real, cq, phases, x0 in float64 numpy, built on the host with
    scipy (independent of both kernels)."""
    from scipy.linalg import expm as sexpm
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_phase_frame
    from noisyquantumsimulator_tpu_torch.solver.real_rep import build_real_rep
    g = plan_phase_frame(plan)
    D = plan.rho0s.shape[-1]
    rep = build_real_rep(g, D)
    W = rep.Wr + 1j * rep.Wi
    Ub = sexpm((plan.L0 + plan.Cp + plan.Cm) * plan.schedule.dts[0])
    U_real = (W @ Ub @ W.conj().T).real
    x0 = (plan.rho0s.reshape(len(plan.rho0s), D * D) @ W.T).real
    return U_real, rep.cq, np.asarray(plan.schedule.phases), x0, D, rep.P


def cuda_ms(fn, reps):
    """Mean ms of `reps` calls of fn between two CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def population_near(x0, bounds, P, spread, rng):
    """P members: x0 itself, then x0 scaled coordinate-wise by factors in
    1 +- spread, clipped to the bounds."""
    b = np.asarray(bounds, float)
    pop = x0[None] * (1.0 + spread * rng.uniform(-1.0, 1.0, (P, len(x0))))
    pop[0] = x0
    return np.clip(pop, b[:, 0], b[:, 1])
