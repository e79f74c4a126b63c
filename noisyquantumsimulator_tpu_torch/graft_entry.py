"""Entry points: one forward step on the card, and the multi-device dry run.

Counterpart of the reference's `__graft_entry__.py` (an entry-point file at
the repository's root, outside the reference package):

entry(device)            -> (forward, args): the forward step of the flagship
                            model, the 32-segment noisy smooth-JP CZ gate
                            (evolve_rhos, then compute_cz_fidelity); its expm
                            ends in kernel K2 on the card.
dryrun_multichip(n)      -> over an n-rank mesh ("sweep", "shots"): one
                            sharded sweep step (each rank its sweep points and
                            shot blocks, one all_gather), the sharded QEC Monte
                            Carlo (surface-code sampler and the BB-LDPC
                            decode, counts all_reduced) and two generations
                            of sharded DE. Every rank of an initialized
                            process group calls it.

The reference re-runs its dry run on a virtual CPU mesh when the process
has fewer devices than asked for; here fewer ranks than asked for raise
(`parallel.mesh.make_mesh`), so the dry run never hides the device.

    python -m noisyquantumsimulator_tpu_torch.graft_entry   (one rank a card)
"""
from __future__ import annotations

import warnings
from typing import Dict, Union

import numpy as np
import torch
import torch.distributed as dist

from .core.constants import TWO_PI
from .gate.fidelity import compute_cz_fidelity
from .ops.hilbert import HS3, kets_to_density, two_atom_kets
from .ops.lindblad import (build_all_noise_operators, drive_decomposition,
                           static_hamiltonian)
from .parallel.bb_mc import rank_generator, run_bb_memory_sharded
from .parallel.mesh import launch, local_rows, make_mesh
from .solver.propagator import Schedule, evolve_rhos


def build_small_problem(n_steps: int = 32, dtype: torch.dtype = torch.complex64):
    """The reference's small problem, host numpy: L0, C+, C- of the noisy
    3-level two-atom model at V / Omega = 200, the smooth-JP phases at
    `n_steps` midpoints, the segment lengths, the 5 initial states and the
    kets."""
    Om = TWO_PI * 4.6e6
    V = 200.0 * Om
    H0 = static_hamiltonian(HS3, 0.0205 * Om, V)
    c_ops, _ = build_all_noise_operators(
        hs=HS3, gamma_r=7.1e3, gamma_bbr=3.5e3, gamma_phi_laser=3e3,
        gamma_phi_thermal=2e3, gamma_scatter_intermediate=1.5e3,
        gamma_loss_background=1e3)
    L0, Cp, Cm = drive_decomposition(HS3, Om, H0, c_ops)
    kets = two_atom_kets(HS3)
    rho0s = np.stack([kets_to_density(kets[k])
                      for k in ("00", "01", "10", "11", "++")])
    tau = 10.09 / Om
    dt = tau / n_steps
    t_mid = (np.arange(n_steps) + 0.5) * dt
    phases = 0.311 * np.pi * np.cos(1.242 * Om * t_mid - 4.696)
    ndt = np.complex64 if dtype == torch.complex64 else np.complex128
    rdt = np.float32 if ndt == np.complex64 else np.float64
    return (L0.astype(ndt), Cp.astype(ndt), Cm.astype(ndt), phases.astype(rdt),
            np.full(n_steps, dt, dtype=rdt), rho0s.astype(ndt), kets)


def _kets_on(kets, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in kets.items()}


def entry(device: Union[str, torch.device] = "cuda"):
    """(forward, args): forward(*args) is the average CZ fidelity of the
    32-segment problem, a 0-d tensor on `device`."""
    L0, Cp, Cm, phases, dts, rho0s, kets = build_small_problem()
    kets = _kets_on(kets, device)

    def forward(L0, Cp, Cm, phases, dts, rho0s):
        sched = Schedule(torch.ones_like(phases), phases, dts)
        rhos = evolve_rhos(L0, Cp, Cm, sched, rho0s)
        return compute_cz_fidelity(rhos, kets)[1]

    args = tuple(torch.as_tensor(a, device=device)
                 for a in (L0, Cp, Cm, phases, dts, rho0s))
    return forward, args


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def sweep_step(mesh, device, n_steps: int = 16) -> Dict:
    """The sharded sweep step: 2 sweep points (phase scales in
    linspace(0.9, 1.1, SWEEP)) per "sweep" rank, each run on the 5-state
    batch once per "shots" block. A rank evolves its points and blocks in
    ONE evolve_rhos call (a population of schedules); one all_gather
    assembles the (SWEEP, SHOTS) fidelity grid on every rank."""
    n_sweep, n_shot = mesh.shape
    L0, Cp, Cm, phases0, dts, rho0s, kets = build_small_problem(n_steps)
    SWEEP, SHOTS = 2 * n_sweep, n_shot
    scales = np.linspace(0.9, 1.1, SWEEP)
    mine = local_rows(scales, mesh, "sweep")
    blocks = local_rows(np.broadcast_to(rho0s[None], (SHOTS,) + rho0s.shape),
                        mesh, "shots")
    put = lambda a: torch.as_tensor(np.array(a), device=device)
    sched = Schedule(np.ones((len(mine), n_steps)), mine[:, None] * phases0,
                     np.tile(dts, (len(mine), 1)))
    rhos = evolve_rhos(put(L0), put(Cp), put(Cm), sched,
                       put(blocks.reshape((-1,) + rho0s.shape[1:])))
    rhos = rhos.reshape(len(mine), len(blocks), *rho0s.shape)
    F = compute_cz_fidelity(rhos, _kets_on(kets, device))[1]   # (pts, blocks)
    parts = [torch.empty_like(F) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, F)
    grid = torch.empty((SWEEP, SHOTS), dtype=F.dtype, device=F.device)
    ranks = mesh.mesh.reshape(n_sweep, n_shot)
    k_pt, k_blk = F.shape
    for a in range(n_sweep):
        for b in range(n_shot):
            grid[a * k_pt:(a + 1) * k_pt, b * k_blk:(b + 1) * k_blk] = \
                parts[int(ranks[a, b])]
    per_point = grid.mean(dim=1)
    return {"scales": scales, "per_point": per_point.cpu().numpy(),
            "mean_F": float(per_point.mean()), "sweep": SWEEP,
            "shot_blocks": SHOTS}


def dryrun_multichip(n_devices: int,
                     device: Union[str, torch.device] = "cuda") -> Dict:
    """The full sharded dry run over an n-rank mesh; every rank of an
    initialized process group of n ranks calls it. Raises when the group
    has fewer ranks (or none). Returns the step's results."""
    mesh = make_mesh(n_devices, axis_names=("sweep", "shots"))
    r = sweep_step(mesh, device)
    mf = r["mean_F"]
    _check(0.0 < mf <= 1.0 + 1e-6, f"unphysical mean fidelity {mf}")
    if dist.get_rank() == 0:
        print(f"[dryrun_multichip] mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"sweep={r['sweep']} shot_blocks={r['shot_blocks']} mean_F={mf:.6f}",
              flush=True)
    r["qec"] = _dryrun_qec_sharded(mesh, n_devices, device)
    r["de"] = _dryrun_de_sharded(n_devices, device)
    return r


def _dryrun_qec_sharded(mesh, n_devices: int, device) -> Dict:
    """Sharded QEC Monte Carlo: every rank samples its shot block of the
    d = 3 surface-code memory circuit from its own generator; the detector
    and logical counts are summed in one int64 all_reduce. Then the BB-LDPC
    sample + BP decode (run_bb_memory_sharded)."""
    from .qec.fast_sampler import build_fast_sampler
    from .qec.surface_code import memory_z_circuit
    circuit = memory_z_circuit(3, rounds=2, p=2e-3)
    shots_per_dev = 256
    shots = shots_per_dev * n_devices
    sampler = build_fast_sampler(circuit, shots_per_dev, device)
    out = sampler(rank_generator(7, n_devices, dist.get_rank(), device))
    stats = torch.cat([out["detectors"].sum(dtype=torch.int64)[None],
                       out["observables"].sum(dim=0, dtype=torch.int64)])
    dist.all_reduce(stats)
    stats = stats.cpu().numpy()
    df = float(stats[0]) / (shots * circuit.n_detectors)
    obs_rate = stats[1:] / shots
    _check(0.0 < df < 0.5, f"unphysical detector fraction {df}")
    bb = run_bb_memory_sharded(p=5e-3, shots_per_device=256, mesh=mesh,
                               n_iters=30, seed=11, device=device)
    _check(0.0 <= bb["p_logical_shot"] < 0.5,
           f"unphysical BB p_L {bb['p_logical_shot']}")
    if dist.get_rank() == 0:
        print(f"[dryrun_multichip] qec: {shots} shots over {n_devices} ranks "
              f"(all_reduce over {tuple(mesh.mesh_dim_names)}), "
              f"detector_fraction={df:.4f}, obs_rate={obs_rate.round(4).tolist()}",
              flush=True)
        print(f"[dryrun_multichip] bb-ldpc: {bb['code']} {bb['shots']} shots on "
              f"{bb['n_devices']} ranks, p_L={bb['p_logical_shot']:.5f}, "
              f"bp_conv={bb['bp_converged_frac']:.4f}", flush=True)
    return {"detector_fraction": df, "obs_rate": obs_rate, "bb": bb}


def _dryrun_de_sharded(n_devices: int, device) -> Dict:
    """Two generations of DE with the population sharded over a "pop" mesh."""
    from .optimize.apparatus import ApparatusConstraints
    from .optimize.de import differential_evolution
    from .optimize.engine import build_fixed_problem
    from .optimize.forward import get_smooth_jp_bounds_and_x0
    from .parallel.de_sharded import make_population_objective_sharded
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = build_fixed_problem(app, app.make_full_noise(), device=device)
    mesh = make_mesh(n_devices, axis_names=("pop",))
    obj = make_population_objective_sharded(problem, "smooth_jp", mesh=mesh)
    bounds, x0 = get_smooth_jp_bounds_and_x0()
    r = differential_evolution(obj, bounds, x0=x0, popsize=n_devices, maxiter=2)
    f = float(obj(r.x[None])[1]["avg_fidelity"][0])
    _check(0.0 < f <= 1.0 + 1e-6, f"unphysical fidelity {f}")
    if dist.get_rank() == 0:
        print(f"[dryrun_multichip] sharded-DE: pop={max(n_devices, 4)} over "
              f"{n_devices} ranks, 2 generations, best cost={r.fun:.3f}, "
              f"F={f:.6f}", flush=True)
    return {"best_cost": r.fun, "F": f, "history": r.history}


if __name__ == "__main__":
    fn, args = entry()
    print("entry() forward:", float(fn(*args)))
    n = torch.cuda.device_count()
    launch(dryrun_multichip, n, args=(n,))
