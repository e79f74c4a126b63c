"""Multi-device scaling study: the same sharded programs over world sizes
1, 2, 4 and 8.

Counterpart of `examples/multichip_scaling.py`, on `torch.distributed`:
each world size runs as its own group (`parallel/mesh.launch`: gloo ranks on
the CPU, one NCCL rank a card), with a one-axis "shots" mesh, and checks
the weak-scaling contract (per-rank work constant, only counts crossing
the group) and that the reduced statistics do not depend on the world size:

  1. the surface-code detector Monte Carlo (d = 5, 5 rounds, p = 2e-3):
     every rank samples its own block from a generator seeded from
     `SeedSequence(3).spawn(world)[rank]`, then one int64 `all_reduce` of
     (detectors fired, observable flips);
  2. the BB-LDPC sample + BP decode Monte Carlo
     (`parallel/bb_mc.run_bb_memory_sharded`, p = 5e-3, 30 iterations,
     seed 5).

A world size needs that many ranks: on the card, one card a rank, so a host
with one card runs world size 1 only (the JSON's `note` says which ran);
asking for more ranks than there are cards raises. Ranks on one host
share its cores, so on the CPU the throughput column is no scaling signal.

    python -m noisyquantumsimulator_tpu_torch.studies.multichip_scaling
    python -m noisyquantumsimulator_tpu_torch.studies.multichip_scaling \\
        --sizes 1,2 --device cpu --out /tmp/scaling.json

Writes `studies_out/multichip_scaling.json` (or `--out`) with the script's
keys.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..bench import _device
from ..parallel.bb_mc import rank_generator, run_bb_memory_sharded
from ..parallel.mesh import launch, make_mesh
from ..qec.fast_sampler import build_fast_sampler
from ..qec.surface_code import memory_z_circuit
from . import add_common_args, out_path, stamp, write_json

NAME = "multichip_scaling"
SIZES = (1, 2, 4, 8)
REPS = 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_surface_mc(mesh, shots_per_dev: int = 8192, d: int = 5,
                   rounds: int = 5, p: float = 2e-3, device="cuda") -> dict:
    """The sharded surface-code sampling Monte Carlo on this rank; every
    rank of the group calls it. `rank_counts` is this rank's own
    (detectors fired, observable flips) before the reduction."""
    world, rank = dist.get_world_size(), dist.get_rank()
    circuit = memory_z_circuit(d, rounds, p=p)
    sampler = build_fast_sampler(circuit, shots_per_dev, device)

    def step():
        out = sampler(rank_generator(3, world, rank, device))
        local = torch.stack([out["detectors"].sum(dtype=torch.int64),
                             out["observables"][:, 0].sum(dtype=torch.int64)])
        total = local.clone()
        dist.all_reduce(total)
        return local.cpu(), total.cpu()

    step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(REPS):
        local, total = step()
    dt = time.perf_counter() - t0
    n_fire, n_obs = (int(x) for x in total)
    shots = shots_per_dev * world
    return {
        "n_devices": world,
        "shots_total": shots,
        "detector_fraction": n_fire / (shots * circuit.n_detectors),
        "obs_rate": n_obs / shots,
        "shots_per_sec": shots * REPS / dt,
        "n_detectors_fired": n_fire,
        "n_obs_flips": n_obs,
        "rank_counts": [int(x) for x in local],
    }


def rank_body(shots_per_dev: int, bb_shots: int, device) -> dict:
    """One world size on this rank: both Monte Carlos over a "shots"
    mesh spanning the group."""
    mesh = make_mesh(dist.get_world_size(), axis_names=("shots",))
    s = run_surface_mc(mesh, shots_per_dev, device=device)
    _sync(device)
    t0 = time.perf_counter()
    b = run_bb_memory_sharded(p=5e-3, shots_per_device=bb_shots, mesh=mesh,
                              n_iters=30, seed=5, device=device)
    _sync(device)
    b["seconds"] = time.perf_counter() - t0
    b["mesh_axes"] = list(b["mesh_axes"])
    return {"surface": s, "bb": b}


def default_sizes(dev: torch.device) -> tuple:
    """(1, 2, 4, 8), on the card only up to the cards visible."""
    if dev.type == "cuda":
        return tuple(n for n in SIZES if n <= torch.cuda.device_count())
    return SIZES


def run(sizes: Optional[Sequence[int]] = None, device="cuda",
        shots_per_dev: int = 8192, bb_shots: int = 2048) -> dict:
    """Every world size in `sizes` (default `default_sizes`), each a group
    of its own. Raises when the detector fraction varies by 15% or more
    across sizes or a BB p_L reaches 0.5."""
    dev = _device(device)
    sizes = tuple(sizes or default_sizes(dev))
    ncores = os.cpu_count() or 1
    results = {"surface_mc": [], "bb_ldpc_mc": [], "platform": dev.type}
    for n in sizes:
        ranks = launch(rank_body, n, args=(shots_per_dev, bb_shots, dev.type),
                       device=dev.type)
        s, b = ranks[0]["surface"], ranks[0]["bb"]
        s["rank_counts"] = [r["surface"]["rank_counts"] for r in ranks]
        if dev.type == "cpu" and n > ncores:
            note = (f"{n} ranks on {ncores} core(s): host oversubscription, "
                    "not a scaling signal")
            for row in (s, b):
                row.update(oversubscribed=True, note=note)
        results["surface_mc"].append(s)
        results["bb_ldpc_mc"].append(b)
        print(f"{n:>5} | {s['shots_per_sec']:>15.0f} "
              f"{s['detector_fraction']:>9.5f} | {b['shots']:>8d} "
              f"{b['p_logical_shot']:>9.5f} {b['bp_converged_frac']:>8.4f}",
              flush=True)

    # the physics must not depend on how the shots are sharded
    dfs = [s["detector_fraction"] for s in results["surface_mc"]]
    if max(dfs) - min(dfs) >= 0.15 * max(dfs):
        raise RuntimeError(f"detector fraction varies with world size: {dfs}")
    pls = [b["p_logical_shot"] for b in results["bb_ldpc_mc"]]
    if max(pls) >= 0.5:
        raise RuntimeError(f"unphysical BB p_L: {pls}")
    if dev.type == "cuda":
        results["note"] = (
            f"world sizes {list(sizes)} of {list(SIZES)}: one NCCL rank a "
            f"card, {torch.cuda.device_count()} card(s) visible")
    else:
        results["note"] = (f"world sizes {list(sizes)}: gloo ranks on one "
                           "host's CPU; timings validate the program "
                           "structure, not speedup")
    results.update(stamp(dev))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default=None,
                    help="comma-separated world sizes (default 1,2,4,8; on "
                         "the card up to the cards visible)")
    add_common_args(ap)
    a = ap.parse_args(argv)
    sizes = tuple(int(x) for x in a.sizes.split(",")) if a.sizes else None
    print(f"{'n_dev':>5} | {'surface shots/s':>15} {'det_frac':>9} | "
          f"{'bb shots':>8} {'p_L':>9} {'bp_conv':>8}")
    out = run(sizes=sizes, device=a.device)
    print(f"wrote {write_json(out_path(NAME, a.out), out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
