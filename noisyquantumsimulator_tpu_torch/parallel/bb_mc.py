"""Sharded BB-LDPC Monte Carlo: sample + BP-decode + one all_reduce.

Counterpart of the reference's `parallel/bb_mc.py`, the code-capacity
X-memory Monte Carlo of a bivariate-bicycle code over a mesh: every rank
draws its own iid X-error shots, computes their syndromes, runs min-sum BP
on the Tanner graph (the port's dense `qec.ldpc._bp_batch`, as the
reference's is XLA), checks the residual syndromes and logical flips, and
the failure counts are summed over the whole mesh.

Differences from the reference, each on purpose:
  * A rank's errors come from a torch.Generator seeded from
    `SeedSequence(seed).spawn(world)[rank]`: independent streams, one per
    rank, whatever the world size.
  * Syndrome and residual products are float32 products of 0/1 operands,
    then mod 2 (exact: a row sum stays far below 2^24). The reference
    multiplies int32 matrices, which CUDA's matmul does not take.
  * The three counts cross in ONE all_reduce of an int64 (3,) tensor. The
    reference's three float32 psums are exact only below 2^24.
  * A rank's body (`rank_body`) is a function of its error tensor, so a
    test can feed it fixed errors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..qec.ldpc import _bp_batch, css_n_k, logical_operators, small_bb_code
from .mesh import make_mesh


@dataclass
class BBTables:
    """A code's operands on one device: Hz and the Z logicals as float32
    0/1 matrices, Hz's mask, the prior LLR and the BP iteration count."""
    Hz: torch.Tensor
    mask: torch.Tensor
    Lz: torch.Tensor
    llr0: float
    n_iters: int


def bb_tables(Hx: np.ndarray, Hz: np.ndarray, p: float, n_iters: int = 50,
              device: Union[str, torch.device] = "cuda") -> BBTables:
    if not 0.0 < p < 1.0:
        raise ValueError(f"error probability p must be in (0, 1), got {p}")
    Hz = np.asarray(Hz, np.uint8)
    Lz = logical_operators(np.asarray(Hx, np.uint8), Hz)
    if not len(Lz):
        Lz = np.zeros((1, Hz.shape[1]), np.uint8)
    put = lambda a, dt: torch.as_tensor(a, device=device).to(dt)
    return BBTables(Hz=put(Hz, torch.float32), mask=put(Hz, torch.bool),
                    Lz=put(Lz, torch.float32), llr0=float(np.log((1 - p) / p)),
                    n_iters=int(n_iters))


def rank_body(errors: torch.Tensor, t: BBTables) -> Dict[str, torch.Tensor]:
    """One rank's shots: errors (T, n) 0/1 -> per shot `fail` and
    `converged` (T,) bool, the syndromes (T, m) float32 and BP's final
    beliefs (T, n)."""
    e = errors.to(torch.float32)
    syn = (e @ t.Hz.T) % 2
    est, belief = _bp_batch(syn, H=t.Hz, mask=t.mask, llr0=t.llr0,
                            n_iters=t.n_iters, scale=0.75)
    residual = (e != est.to(torch.float32)).to(torch.float32)
    converged = ~((residual @ t.Hz.T) % 2).bool().any(dim=1)
    fail = ((residual @ t.Lz.T) % 2).bool().any(dim=1) | ~converged
    return {"fail": fail, "converged": converged, "syndrome": syn,
            "belief": belief}


def rank_counts(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(failures, converged shots, syndrome weight) of one rank's body, an
    int64 (3,) tensor on its device."""
    return torch.stack([out["fail"].sum(), out["converged"].sum(),
                        out["syndrome"].sum().to(torch.int64)])


def rank_generator(seed: int, world: int, rank: int,
                   device: Union[str, torch.device]) -> torch.Generator:
    """The rank's generator, seeded from SeedSequence(seed).spawn(world)[rank]."""
    child = np.random.SeedSequence(seed).spawn(world)[rank]
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(child.generate_state(1, np.uint64)[0]))
    return gen


def run_bb_memory_sharded(
    Hx: Optional[np.ndarray] = None,
    Hz: Optional[np.ndarray] = None,
    p: float = 1e-2,
    shots_per_device: int = 4096,
    n_iters: int = 50,
    mesh=None,
    n_devices: Optional[int] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """Code-capacity X-memory Monte Carlo of a BB code over the mesh (every
    rank calls it). Returns the global statistics: logical failure rate, BP
    convergence fraction, mean syndrome weight, the total shot count, and
    the counts behind them."""
    if Hx is None or Hz is None:
        Hx, Hz = small_bb_code()
    n, k = css_n_k(Hx, Hz)
    if mesh is None:
        mesh = make_mesh(n_devices)
    world, rank = dist.get_world_size(), dist.get_rank()
    t = bb_tables(Hx, Hz, p, n_iters, device)
    gen = rank_generator(seed, world, rank, device)
    errors = torch.rand((shots_per_device, t.Hz.shape[1]), generator=gen,
                        device=device) < p
    counts = rank_counts(rank_body(errors, t))
    dist.all_reduce(counts)
    n_fail, n_conv, syn_w = (int(c) for c in counts.cpu())
    total = shots_per_device * world
    return {
        "code": f"[[{n},{k}]]", "p": p,
        "shots": total, "n_devices": world,
        "p_logical_shot": n_fail / total,
        "bp_converged_frac": n_conv / total,
        "syndrome_weight_mean": syn_w / (total * t.Hz.shape[0]),
        "n_fail": n_fail, "n_converged": n_conv, "syndrome_weight": syn_w,
        "mesh_axes": tuple(mesh.mesh_dim_names),
    }


__all__ = ["run_bb_memory_sharded", "rank_body", "rank_counts", "bb_tables",
           "rank_generator", "BBTables"]
