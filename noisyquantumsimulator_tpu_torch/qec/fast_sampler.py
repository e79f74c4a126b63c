"""One-matmul stabilizer sampler: circuit-exact detector sampling.

Counterpart of the reference's `qec/fast_sampler.py`. Frame propagation is
linear over GF(2):

    detectors = (sum over fault sites e of  bit_e * signature_e)  mod 2

so the whole circuit collapses, at build time and on the host, into a
fault-site -> detector signature matrix F (n_sites x n_detectors). On the
device one sample is then

    1. draw the per-site fault bits E (uniforms + compares),
    2. detectors = (E @ F) & 1, one product per block of sites.

The bit statistics are circuit-exact, not a DEM approximation: correlated
bits of a depolarizing channel (e.g. the X and Z flips of a Y outcome) come
from the same uniform draw. The products run in float32 on 0/1 operands:
with TF32 off (the package's policy) every partial sum is an integer below
2^24 and exact, so the parity is exact too. (cuBLAS has no integer GEMM
behind torch.matmul, and a bfloat16 product would round sums above 256.)

Reset frame-randomization bits (z-plane, p = 1/2) provably cancel in every
detector and observable, so they are never sampled: build_fast_sampler
checks that their signatures are zero instead.

Randomness comes from an explicit torch.Generator on the sampler's device.
The reference draws with jax.random, another stream, so the two packages
agree in distribution, not bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.observability import span
from .circuits import Circuit, detector_matrix, observable_matrix
from .dem import _propagate_faults

_EXACT_F32 = 1 << 24      # float32 holds every integer below this exactly


def build_fast_sampler(circuit: Circuit, shots: int,
                       device: Union[str, torch.device] = "cuda"):
    """Compile `circuit` into a single-matmul detector sampler on `device`.

    Returns sample(generator) -> {"detectors": (shots, n_det) uint8,
                                  "observables": (shots, n_obs) uint8,
                                  "heralds": (shots, n_erase) uint8},
    tensors on `device`; `generator` is a torch.Generator on that device.
    The returned function also carries the host build products:
    `faults` (the fault sites, in the form dem._propagate_faults takes),
    `meas_flip_rows` ((site row, record index) of measurement flips),
    `Fd` / `Fo` (the site -> detector / observable signature matrices,
    int8, rows in site order) and `erasure_meta`.
    """
    dev = torch.device(device)
    faults: List[Tuple] = []          # for _propagate_faults
    meas_flip_rows: List[Tuple[int, int]] = []  # (site row, record index)

    bern_p: List[float] = []
    dep1_p: List[float] = []
    dep2_p: List[float] = []          # uniform 15-outcome channels
    pair_cum: List[np.ndarray] = []   # general PAULI_CHANNEL_2 tables
    erase_p: List[float] = []

    # site rows are appended in group-block order; remember each block's rows
    rows_bern: List[int] = []
    rows_dep1_x: List[int] = []
    rows_dep1_z: List[int] = []
    rows_dep2: List[Tuple[int, int, int, int]] = []   # (xa, za, xb, zb)
    rows_pair: List[Tuple[int, int, int, int]] = []   # (xa, za, xb, zb)
    rows_erase_x: List[int] = []
    rows_erase_z: List[int] = []

    def new_site(ii: int, xq: Optional[int], zq: Optional[int]) -> int:
        row = len(faults)
        faults.append((ii, {xq: 1} if xq is not None else {},
                       {zq: 1} if zq is not None else {}))
        return row

    # measurement-record index per instruction
    rec_of_instr: Dict[int, int] = {}
    mc = 0
    for ii, ins in enumerate(circuit.instructions):
        if ins.name in ("M", "MR"):
            rec_of_instr[ii] = mc
            mc += len(ins.targets)

    for ii, ins in enumerate(circuit.instructions):
        name, t, p = ins.name, ins.targets, (ins.arg or 0.0)
        if name == "X_ERROR" and p > 0:
            for q in np.atleast_1d(t):
                rows_bern.append(new_site(ii, int(q), None))
                bern_p.append(p)
        elif name == "Z_ERROR" and p > 0:
            for q in np.atleast_1d(t):
                rows_bern.append(new_site(ii, None, int(q)))
                bern_p.append(p)
        elif name in ("M", "MR") and p > 0:
            for k, q in enumerate(np.atleast_1d(t)):
                row = new_site(ii, None, None)  # no Pauli propagation
                meas_flip_rows.append((row, rec_of_instr[ii] + k))
                rows_bern.append(row)
                bern_p.append(p)
        elif name == "DEPOLARIZE1" and p > 0:
            for q in np.atleast_1d(t):
                rows_dep1_x.append(new_site(ii, int(q), None))
                rows_dep1_z.append(new_site(ii, None, int(q)))
                dep1_p.append(p)
        elif name == "DEPOLARIZE2" and p > 0:
            for qa, qb in t:
                rows_dep2.append((new_site(ii, int(qa), None),
                                  new_site(ii, None, int(qa)),
                                  new_site(ii, int(qb), None),
                                  new_site(ii, None, int(qb))))
                dep2_p.append(p)
        elif name == "PAULI_CHANNEL_2":
            probs = np.asarray(ins.probs, dtype=np.float64)
            if probs[1:].sum() <= 0:
                continue
            for qa, qb in t:
                rows_pair.append((new_site(ii, int(qa), None),
                                  new_site(ii, None, int(qa)),
                                  new_site(ii, int(qb), None),
                                  new_site(ii, None, int(qb))))
                pair_cum.append(probs[1:].cumsum())
        elif name == "ERASE" and p > 0:
            for q in np.atleast_1d(t):
                rows_erase_x.append(new_site(ii, int(q), None))
                rows_erase_z.append(new_site(ii, None, int(q)))
                erase_p.append(p)

    n_sites = len(faults)
    if n_sites >= _EXACT_F32:
        raise ValueError(f"{n_sites} fault sites: float32 parity sums would "
                         "no longer be exact")
    Dmat = detector_matrix(circuit)
    Omat = observable_matrix(circuit)
    n_det, n_obs = Dmat.shape[0], Omat.shape[0]

    # reset-gauge sites (z-plane after every R/MR): must cancel in every
    # detector/observable for the one-matmul form to be exact. Verify.
    gauge_faults = []
    for ii, ins in enumerate(circuit.instructions):
        if ins.name in ("R", "MR"):
            for q in np.atleast_1d(ins.targets):
                gauge_faults.append((ii, {}, {int(q): 1}))
    if gauge_faults:
        gm = _propagate_faults(circuit, gauge_faults)
        gd = (gm.astype(np.int64) @ Dmat.T.astype(np.int64)) % 2
        go = (gm.astype(np.int64) @ Omat.T.astype(np.int64)) % 2
        if gd.any() or go.any():
            raise ValueError(
                "Circuit has non-deterministic detectors/observables "
                "(reset gauge reaches them); use a per-gate frame sampler")

    if n_sites:
        meas = _propagate_faults(circuit, faults)
        for row, rec in meas_flip_rows:
            meas[row, rec] ^= 1
        Fd = ((meas.astype(np.int64) @ Dmat.T.astype(np.int64)) % 2
              ).astype(np.int8)
        Fo = ((meas.astype(np.int64) @ Omat.T.astype(np.int64)) % 2
              ).astype(np.int8)
    else:
        Fd = np.zeros((0, n_det), np.int8)
        Fo = np.zeros((0, n_obs), np.int8)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # device constants: float32 thresholds and 0/1 signature matrices
    bern_t, dep1_t, dep2_t, erase_t = (put(a) for a in
                                       (bern_p, dep1_p, dep2_p, erase_p))
    pair_cum_t = put(np.asarray(pair_cum, np.float32).reshape(-1, 15))
    rows = {
        "bern": np.asarray(rows_bern, np.int64),
        "d1x": np.asarray(rows_dep1_x, np.int64),
        "d1z": np.asarray(rows_dep1_z, np.int64),
        "d2": np.asarray(rows_dep2, np.int64).reshape(-1, 4),
        "pair": np.asarray(rows_pair, np.int64).reshape(-1, 4),
        "erx": np.asarray(rows_erase_x, np.int64),
        "erz": np.asarray(rows_erase_z, np.int64),
    }
    # sites were appended in circuit order interleaved across groups:
    # reorder F rows into the order sample() emits its bit blocks
    order = np.concatenate([
        rows["bern"],
        rows["d1x"], rows["d1z"],
        rows["d2"][:, 0], rows["d2"][:, 1],
        rows["d2"][:, 2], rows["d2"][:, 3],
        rows["pair"][:, 0], rows["pair"][:, 1],
        rows["pair"][:, 2], rows["pair"][:, 3],
        rows["erx"], rows["erz"],
    ]) if n_sites else np.zeros(0, np.int64)

    nb, n1 = len(bern_p), len(dep1_p)
    nd2, n2, ne = len(dep2_p), len(pair_cum), len(erase_p)

    # per-block F segments: one product per bit block, accumulated, so the
    # concatenated (shots, n_sites) fault matrix is never materialized
    seg_sizes = [nb, n1, n1, nd2, nd2, nd2, nd2, n2, n2, n2, n2, ne, ne]
    splits = np.cumsum(seg_sizes)[:-1]
    Fd_segs = [put(a) for a in np.split(Fd[order], splits) if a.shape[0]]
    Fo_segs = [put(a) for a in np.split(Fo[order], splits) if a.shape[0]]

    def _pair_bits(idx, blocks):
        pa, pb = idx // 4, idx % 4
        blocks.append((pa == 1) | (pa == 2))                    # xa
        blocks.append((pa == 2) | (pa == 3))                    # za
        blocks.append((pb == 1) | (pb == 2))                    # xb
        blocks.append((pb == 2) | (pb == 3))                    # zb

    # erasure metadata for heralded decoding: detector/observable
    # signatures of each erase site's x- and z-fault (host numpy)
    erasure_meta = {
        "x_det": Fd[rows["erx"]], "z_det": Fd[rows["erz"]],
        "x_obs": Fo[rows["erx"]], "z_obs": Fo[rows["erz"]],
    }

    def uniform(gen, *shape):
        return torch.rand(shape, generator=gen, device=dev)

    def sample(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("nqs.sample"):
            return _sample(generator)

    def _sample(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        blocks = []
        if nb:
            blocks.append(uniform(generator, shots, nb) < bern_t)
        if n1:
            u = uniform(generator, shots, n1)
            blocks.append(u < 2.0 * dep1_t / 3.0)                    # x bits
            blocks.append((u >= dep1_t / 3.0) & (u < dep1_t))        # z bits
        if nd2:
            # uniform 15-outcome depolarizing pair channels: index map
            u = uniform(generator, shots, nd2)
            hit = u < dep2_t
            idx = torch.floor(u / dep2_t.clamp_min(1e-30) * 15.0
                              ).to(torch.int32) + 1
            _pair_bits(torch.where(hit, idx.clamp_max(15), 0), blocks)
        if n2:
            # general two-qubit Pauli channels: cumulative table lookup
            u = uniform(generator, shots, n2, 1)
            idx = (u >= pair_cum_t[None]).sum(dim=-1, dtype=torch.int32)
            hit = u[..., 0] < pair_cum_t[:, -1]
            _pair_bits(torch.where(hit, idx + 1, 0), blocks)
        heralds = torch.zeros((shots, ne), dtype=torch.uint8, device=dev)
        if ne:
            u = uniform(generator, shots, ne)
            bits = torch.randint(0, 2, (shots, ne, 2), generator=generator,
                                 device=dev, dtype=torch.uint8)
            hit = u < erase_t
            heralds = hit.to(torch.uint8)   # erasures announce themselves
            blocks.append(hit & (bits[..., 0] > 0))
            blocks.append(hit & (bits[..., 1] > 0))
        dets = torch.zeros((shots, n_det), dtype=torch.float32, device=dev)
        obs = torch.zeros((shots, n_obs), dtype=torch.float32, device=dev)
        for b, Fd_s, Fo_s in zip(blocks, Fd_segs, Fo_segs):
            eb = b.to(torch.float32)
            dets += eb @ Fd_s
            obs += eb @ Fo_s
        return {"detectors": (dets.to(torch.int32) & 1).to(torch.uint8),
                "observables": (obs.to(torch.int32) & 1).to(torch.uint8),
                "heralds": heralds}

    sample.faults = faults
    sample.meas_flip_rows = meas_flip_rows
    sample.Fd = Fd
    sample.Fo = Fo
    sample.erasure_meta = erasure_meta
    return sample


def sample_circuit_fast(circuit: Circuit, shots: int, seed: int = 0,
                        device: Union[str, torch.device] = "cuda") -> Dict:
    """One sample of `shots` shots from a generator seeded with `seed`, as
    host numpy arrays."""
    fn = build_fast_sampler(circuit, shots, device)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return {k: v.cpu().numpy() for k, v in fn(gen).items()}


__all__ = ["build_fast_sampler", "sample_circuit_fast"]
