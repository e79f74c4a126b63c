"""Rank bodies for the spawned gloo ranks of tests/test_torch_parallel.py.

torch.multiprocessing.spawn starts every rank from a fresh import of the
function's module, so what the ranks run lives here, in a module that
imports no JAX. It holds no test.
"""
import numpy as np
import torch
import torch.distributed as dist

from noisyquantumsimulator_tpu_torch.graft_entry import dryrun_multichip
from noisyquantumsimulator_tpu_torch.optimize.engine import (
    make_population_objective)
from noisyquantumsimulator_tpu_torch.parallel import (
    bb_mc, local_rows, make_mesh, make_population_objective_sharded,
    run_bb_memory_sharded)


def _np(cost, metrics):
    return cost.numpy(), {k: v.numpy() for k, v in metrics.items()}


def four_rank_checks(problem, pop, builder_kw, Hx, Hz, errors, bb_p, bb_iters,
                     stat_kw):
    """Every check the CPU tests make over one 4-rank group: the sharded
    population objective and the unsharded one on the same members, the BB
    rank body on this rank's rows of `errors` (counts all_reduced), the
    dry run, and one sharded BB Monte Carlo for the statistical test."""
    out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
    mesh = make_mesh(axis_names=("pop",))
    obj = make_population_objective_sharded(problem, "smooth_jp", mesh=mesh,
                                            **builder_kw)
    out["sharded"] = _np(*obj(pop))
    out["unsharded"] = _np(*make_population_objective(problem, "smooth_jp",
                                                      **builder_kw)(pop))
    t = bb_mc.bb_tables(Hx, Hz, bb_p, bb_iters, "cpu")
    body = bb_mc.rank_body(local_rows(torch.as_tensor(errors), mesh), t)
    counts = bb_mc.rank_counts(body)
    out["bb_rank_counts"] = counts.clone().numpy()
    dist.all_reduce(counts)
    out["bb_counts"] = counts.numpy()
    out["bb_belief"] = body["belief"].numpy()
    out["dryrun"] = dryrun_multichip(4, device="cpu")
    out["bb_stat"] = run_bb_memory_sharded(Hx, Hz, device="cpu", **stat_kw)
    return out
