"""Mesh-sharded DE population evaluation.

Counterpart of the reference's `parallel/de_sharded.py`. optimize/engine.py
already evaluates a whole DE generation in one batched call; this module
splits that call's member axis over the mesh, so a population spreads
across cards with no change to the optimizer: the returned callable is a
drop-in population objective for optimize/de.differential_evolution, which
every rank runs alike (the same seed, the same gathered costs).

A call pads the population to a multiple of the mesh size by repeating its
first member (as the reference does), evaluates this rank's rows with the
port's population-objective core (K2's resident route, then the per-member
scan: one K2 launch a call), gathers every rank's costs and metrics in ONE
all_gather, and slices the padding off.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..optimize.engine import (FixedProblem, _check_protocol, _make_eval_core,
                               _params_on, _where)
from .mesh import local_rows, make_mesh


def _metric_structure():
    """The metric keys of the engine's cores, in the order they are
    gathered."""
    return ("avg_fidelity", "f00", "f01", "f10", "f11",
            "cz_phase_fidelity", "controlled_phase_deg",
            "phase_error_deg", "gate_time_us")


def make_population_objective_sharded(problem: FixedProblem, protocol: str,
                                      mesh=None, axis: Optional[str] = None,
                                      **builder_kwargs) -> Callable:
    """Population objective with the member axis split over the mesh axis
    `axis` (default: the mesh's first). (P, D) params -> (P,) costs and a
    dict of (P,) metrics, every rank holding all of them, on the problem's
    device. Every rank calls it with the same
    population."""
    if mesh is None:
        mesh = make_mesh(axis_names=("pop",))
    axis = axis or mesh.mesh_dim_names[0]
    n_dev = mesh.size(list(mesh.mesh_dim_names).index(axis))
    key = _check_protocol(protocol)
    device, dtype = _where(problem, None, None)
    core = _make_eval_core(problem, key, builder_kwargs, device, dtype)
    names = _metric_structure()

    def call(population):
        pop = _params_on(population, device, dtype)
        P = pop.shape[0]
        pad = (-P) % n_dev
        if pad:
            pop = torch.cat([pop, pop[:1].expand(pad, -1)])
        with torch.no_grad():
            cost, metrics = core(local_rows(pop, mesh, axis))
        mine = torch.stack([cost] + [metrics[k].to(cost.dtype) for k in names])
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        # ranks along other mesh axes hold the same rows: keep one copy of
        # each block, in the axis' order
        coords = _axis_coords(mesh, axis)
        blocks = [parts[r] for r in coords]
        out = torch.cat(blocks, dim=1)[:, :P]
        return out[0], dict(zip(names, out[1:]))

    call.mesh = mesh
    return call


def _axis_coords(mesh, axis: str):
    """For each index along `axis`, the global rank that holds that block
    and agrees with this rank on every other axis."""
    dim = list(mesh.mesh_dim_names).index(axis)
    me = mesh.get_coordinate()
    ranks = mesh.mesh
    out = []
    for i in range(mesh.size(dim)):
        c = list(me)
        c[dim] = i
        out.append(int(ranks[tuple(c)]))
    return out


__all__ = ["make_population_objective_sharded"]
