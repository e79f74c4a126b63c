"""Lindblad master-equation propagators (PyTorch).

Counterpart of the reference's `solver/propagator.py`:

    1. A pulse schedule is a set of segments (amp_k, phase_k, dt_k).
    2. Each segment Liouvillian is the linear combination
           Lmat_k = L0 + amp_k e^{+i phase_k} C+ + amp_k e^{-i phase_k} C-
       (ops/lindblad.drive_decomposition) — one broadcast add.
    3. All segment propagators exp(Lmat_k dt_k) come from ONE batched expm.
    4. The ordered product is contracted in log2(n) batched matmuls.

For uniform-(amp, dt) schedules the phase-frame identity
(ops/phase_frame.py) replaces step 3-4 by one expm (`uniform_base_propagator`)
and a scan of shared-weight matvecs (`evolve_rhos_phased*`).

Operator tensors (L0, C+, C-, rho0s, U) carry their device and dtype. A
schedule is host data (numpy), moved to the operators' device here, or
tensors already there; its arrays may carry a leading population axis
(P, n), and L0 one too, so a population of schedules is ONE batched expm
over (P * n, D^2, D^2) and one ordered product.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.expm import chained_product, expm


class Schedule(NamedTuple):
    """Pure-array pulse schedule: host numpy, or tensors on the operators'
    device. Every array is (n,), or (P, n) for a population of schedules.

    amps   : drive amplitude scale per segment (1.0 = full Omega)
    phases : drive phase per segment [rad]
    dts    : segment durations [s]
    dets   : or None — extra per-segment detuning [rad/s] applied via
             the Cd channel
    """
    amps: np.ndarray
    phases: np.ndarray
    dts: np.ndarray
    dets: Optional[np.ndarray] = None


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype matching a complex (or real) dtype."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def _host(x, like: torch.Tensor) -> torch.Tensor:
    """Host array (or tensor) -> real tensor on like's device."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           dtype=real_dtype(like.dtype), device=like.device)


def segment_liouvillians(L0, Cp, Cm, schedule: Schedule, Cd=None):
    """Stack of per-segment Liouvillian*dt matrices, shape (n, D^2, D^2);
    (P, n, D^2, D^2) for a population of schedules (arrays (P, n)), where
    L0 may be (P, D^2, D^2), one per member."""
    a = _host(schedule.amps, Cp)
    ph = _host(schedule.phases, Cp)
    dt = _host(schedule.dts, Cp)
    ep = (a * torch.exp(1j * ph)).to(Cp.dtype)
    Ls = (L0.unsqueeze(-3) + ep[..., None, None] * Cp
          + ep.conj()[..., None, None] * Cm)
    if schedule.dets is not None and Cd is not None:
        Ls = Ls + _host(schedule.dets, Cp)[..., None, None] * Cd
    return Ls * dt[..., None, None]


def total_propagator(L0, Cp, Cm, schedule: Schedule, Cd=None,
                     max_squarings: Optional[int] = None,
                     expm_method: str = "auto"):
    """exp(L_n dt_n) ... exp(L_1 dt_1) as one (D^2, D^2) matrix, or
    (P, D^2, D^2) for a population of schedules."""
    A = segment_liouvillians(L0, Cp, Cm, schedule, Cd)
    U = expm(A, max_squarings=max_squarings, method=expm_method)
    return chained_product(U.movedim(-3, 0))


def evolve_rhos(L0, Cp, Cm, schedule: Schedule, rho0s, Cd=None,
                max_squarings: Optional[int] = None,
                expm_method: str = "auto"):
    """Evolve a batch of density matrices through the schedule.
    rho0s: (B, D, D) -> (B, D, D); (P, B, D, D) for a population of
    schedules, every member from the same rho0s."""
    B, D, _ = rho0s.shape
    U = total_propagator(L0, Cp, Cm, schedule, Cd,
                         max_squarings=max_squarings, expm_method=expm_method)
    out = rho0s.reshape(B, D * D) @ U.transpose(-1, -2)
    return out.reshape(*U.shape[:-2], B, D, D)


# --------------------------------------------------------------------------
# phase-frame fast path (ops/phase_frame.py): uniform-(amp, dt) schedules
# --------------------------------------------------------------------------

def uniform_base_propagator(L0, Cp, Cm, amp: float, dt: float,
                            max_squarings: Optional[int] = None,
                            expm_method: str = "auto"):
    """U_base = exp((L0 + amp (C+ + C-)) dt): the single segment propagator
    every phase-rotated segment of a uniform schedule shares."""
    A = (L0 + amp * (Cp + Cm)) * dt
    return expm(A, max_squarings=max_squarings, method=expm_method)


def evolve_rhos_phased(U_base, g, phases, rho0s):
    """Phase-frame evolution of a batch of density matrices through one
    uniform schedule, as a scan of shared-weight matvecs:

        v <- U_base @ (e^{i (phi_{k-1} - phi_k) g} * v)

    g: (D^2,) integer-valued generator; phases: (n,); rho0s: (B, D, D)."""
    return evolve_rhos_phased_many(U_base, g, _host(phases, U_base)[None],
                                   rho0s)[0]


def evolve_rhos_phased_many(U_base, g, phases_bn, rho0s):
    """evolve_rhos_phased for a batch of schedules sharing one U_base.

    phases_bn: (B, n) per-sim phase schedules; rho0s: (S, D, D) initial
    states shared by every sim. Returns (B, S, D, D): one
    (B*S, D^2) @ (D^2, D^2) shared-weight matmul per segment."""
    S, D, _ = rho0s.shape
    g = _host(g, U_base)
    ph = _host(phases_bn, U_base)
    B = ph.shape[0]
    dphi = torch.cat([torch.zeros_like(ph[:, :1]), ph[:, :-1] - ph[:, 1:]],
                     dim=1)
    v = (rho0s.reshape(1, S, D * D)
         * torch.exp(-1j * ph[:, 0, None, None] * g)).to(U_base.dtype)
    UbT = U_base.T
    for k in range(ph.shape[1]):
        v = v * torch.exp(1j * dphi[:, k, None, None] * g).to(U_base.dtype)
        v = (v.reshape(B * S, D * D) @ UbT).reshape(B, S, D * D)
    v = v * torch.exp(1j * ph[:, -1, None, None] * g).to(U_base.dtype)
    return v.reshape(B, S, D, D)


def total_propagator_phased(U_base, g, phases):
    """exp(L(phi_n) dt) ... exp(L(phi_1) dt) from ONE base propagator, by
    the identity exp(L(phi) dt) = S(phi) U_base S(-phi) with
    S(phi) = diag(e^{i phi g}) (ops/phase_frame.py). The product telescopes
    into column-rescaled copies of U_base:

        U_tot = S(phi_n) [ W_n @ ... @ W_1 ] S(-phi_1),
        W_1   = U_base,
        W_k   = U_base @ diag(e^{i (phi_{k-1} - phi_k) g})   (k >= 2)

    contracted as the reference's tree, every node kept as ``U_base @ X``:
    level 0 is elementwise, W_o @ W_e = U_base @ (U_base * outer(d_o, d_e));
    level k takes one shared-weight product X_b @ U_base for the whole level
    and one batched product per pair, (U_base X_b)(U_base X_a) =
    U_base @ ((X_b @ U_base) @ X_a).

    U_base: (D^2, D^2) complex; g: (D^2,) integer-valued generator;
    phases: (n,)."""
    dtype = U_base.dtype
    D2 = U_base.shape[-1]
    g = _host(g, U_base)
    ph = _host(phases, U_base)
    dphi = torch.cat([torch.zeros_like(ph[:1]), ph[:-1] - ph[1:]])
    d = torch.exp(1j * dphi[:, None] * g[None, :]).to(dtype)      # (n, D^2)
    n = d.shape[0]
    if n == 1:
        core = U_base * d[0][None, :]
    else:
        half = n // 2
        de, do = d[0:2 * half:2], d[1:2 * half:2]
        X = U_base[None] * (do[:, :, None] * de[:, None, :])       # (half, D2, D2)
        if n % 2 == 1:
            # odd leaf W_n = U_base @ diag(d_n): X = diag(d_n)
            X = torch.cat([X, torch.diag(d[-1])[None]])
        m = X.shape[0]
        while m > 1:
            h = m // 2
            Xe, Xo = X[0:2 * h:2], X[1:2 * h:2]
            T = (Xo.reshape(h * D2, D2) @ U_base).reshape(h, D2, D2)
            prod = T @ Xe
            X = torch.cat([prod, X[-1:]]) if m % 2 == 1 else prod
            m = X.shape[0]
        core = U_base @ X[0]
    row = torch.exp(1j * ph[-1] * g).to(dtype)
    col = torch.exp(-1j * ph[0] * g).to(dtype)
    return row[:, None] * core * col[None, :]


def evolve_rhos_trajectory(L0, Cp, Cm, schedule: Schedule, rho0s, Cd=None):
    """Like evolve_rhos, but returns every intermediate state,
    (n + 1, B, D, D): one batched expm of the n segments, then a sequential
    loop of (B, D^2) @ (D^2, D^2) products that keeps each state."""
    B, D, _ = rho0s.shape
    U = expm(segment_liouvillians(L0, Cp, Cm, schedule, Cd))
    v = rho0s.reshape(B, D * D)
    traj = [v]
    for Uk in U:
        v = v @ Uk.T
        traj.append(v)
    return torch.stack(traj).reshape(len(traj), B, D, D)


# --------------------------------------------------------------------------
# schedule builders: tensor functions, differentiable in the protocol
# parameters. Parameters may be tensors (their dtype and device carry over)
# or host numbers (float64 CPU tensors).
# --------------------------------------------------------------------------

def _param(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    if like is None:
        return torch.as_tensor(np.asarray(x, dtype=np.float64))
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=like.dtype, device=like.device)


def lp_square_schedule(xi_phase, tau_single, n_pulses: int = 2) -> Schedule:
    """Two square pulses; the second carries the LP phase jump xi. Exact:
    one segment per pulse."""
    xi = _param(xi_phase)
    tau = _param(tau_single, xi)
    return Schedule(_ones(2, xi), torch.stack([torch.zeros_like(xi), xi]),
                    tau * _ones(2, xi))


def smooth_jp_schedule(A, omega_mod, phi_offset, tau_total,
                       n_steps: int = 300) -> Schedule:
    """Midpoint-sampled sinusoidal phase modulation
    phi(t) = A cos(omega_mod t - phi_offset); the delta0 t slope is a static
    detuning in L0, as in the reference."""
    A = _param(A)
    dt = _param(tau_total, A) / n_steps
    k = torch.arange(n_steps, dtype=A.dtype, device=A.device)
    t_mid = (k + 0.5) * dt
    phases = A * torch.cos(_param(omega_mod, A) * t_mid - _param(phi_offset, A))
    return Schedule(_ones(n_steps, A), phases, dt * _ones(n_steps, A))


def bangbang_schedule(switching_times, phases, omega_tau, Omega,
                      max_segments: Optional[int] = None) -> Schedule:
    """Piecewise-constant phases; boundaries [0, t_1..t_{N-1}, omega_tau]
    in dimensionless Omega t, converted to seconds. Exact: one segment per
    phase. Zero- or negative-length segments get dt = 0 (exp(0) = I), the
    reference's skip of segments below 1e-18 s without dynamic shapes."""
    st = _param(switching_times)
    ph = _param(phases, st)
    bounds = torch.cat([torch.zeros_like(st[:1]), st,
                        _param(omega_tau, st).to(st.dtype).reshape(1)])
    dts = torch.clamp(bounds[1:] - bounds[:-1], min=0.0) / Omega
    return Schedule(_ones(ph.shape[0], st), ph, dts)


def shaped_lp_schedule(envelope_fn, xi_phase, tau_single,
                       n_steps: int = 500) -> Schedule:
    """Two shaped pulses with a midpoint-sampled envelope; the second pulse
    carries the xi phase. envelope_fn(t_mid) -> amplitude scale."""
    xi = _param(xi_phase)
    dt = _param(tau_single, xi) / n_steps
    t_mid = (torch.arange(n_steps, dtype=xi.dtype, device=xi.device) + 0.5) * dt
    env = envelope_fn(t_mid)
    return Schedule(torch.cat([env, env]),
                    torch.cat([torch.zeros_like(t_mid), _ones(n_steps, xi) * xi]),
                    dt * _ones(2 * n_steps, xi))


def concat_schedules(*schedules: Schedule) -> Schedule:
    return Schedule(torch.cat([_param(s.amps) for s in schedules]),
                    torch.cat([_param(s.phases) for s in schedules]),
                    torch.cat([_param(s.dts) for s in schedules]))


__all__ = ["Schedule", "real_dtype", "segment_liouvillians",
           "total_propagator", "evolve_rhos", "evolve_rhos_trajectory",
           "uniform_base_propagator", "total_propagator_phased",
           "evolve_rhos_phased", "evolve_rhos_phased_many",
           "lp_square_schedule", "smooth_jp_schedule", "bangbang_schedule",
           "shaped_lp_schedule", "concat_schedules"]
