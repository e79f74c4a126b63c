"""Circuit-exact stabilizer sampler: one fault draw a site, signatures XORed.

Counterpart of the reference's `qec/fast_sampler.py`. Frame propagation is
linear over GF(2):

    detectors = (sum over fault sites e of  bit_e * signature_e)  mod 2

so the whole circuit collapses, at build time and on the host, into a
fault-site -> detector signature matrix F (n_sites x n_detectors). A sample
then draws one uniform per noisy site and shot, compares it with the site's
float32 thresholds and adds the signatures of the bits it sets.

The bit statistics are circuit-exact, not a DEM approximation: correlated
bits of a depolarizing channel (e.g. the X and Z flips of a Y outcome) come
from the same uniform draw.

Two routes compute a sample from the same draw table (`_draw_table`):

  * CUDA tensors: one kernel launch (`sampler_cuda.walk`, `csrc/fast_sampler.cu`).
    One thread walks a shot's draws, drawn with Philox4x32-10 keyed from the
    caller's generator on the card, and XORs the rare hits' signatures into
    the shot's bitset; the uint8 rows are written once.
  * any other device: the op route, the kernel's plain twin. It draws with
    torch.rand / torch.randint, compares, and multiplies each 0/1 bit block
    by its rows of F in float32: with TF32 off (the package's policy) every
    partial sum is an integer below 2^24 and exact, so the parity is exact
    too.

Fed the same uniforms (`sample.draws`, `sampler_cuda.walk(..., draws=)`) the
two routes agree bit for bit; from a generator they draw different streams,
as CUDA and CPU generators always did.

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
from . import sampler_cuda

_EXACT_F32 = 1 << 24      # float32 holds every integer below this exactly


def build_fast_sampler(circuit: Circuit, shots: int,
                       device: Union[str, torch.device] = "cuda"):
    """Compile `circuit` into a detector sampler on `device`.

    Returns sample(generator) -> {"detectors": (shots, n_det) uint8,
                                  "observables": (shots, n_obs) uint8,
                                  "heralds": (shots, n_erase) uint8},
    tensors on `device`; `generator` is a torch.Generator on that device.
    On a CUDA device a call is one kernel launch; elsewhere the op route.
    The returned function also carries the host build products:
    `faults` (the fault sites, in the form dem._propagate_faults takes),
    `meas_flip_rows` ((site row, record index) of measurement flips),
    `Fd` / `Fo` (the site -> detector / observable signature matrices,
    int8, rows in site order), `erasure_meta`, the draw table (`table`,
    `order`, and `device_table` on a CUDA device), and the op route's two
    halves: `draws(generator)` -> (u, ebits) and `op_route(u, ebits)`.
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
    # detector/observable for the sampled signatures to be exact. Verify.
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

    rows = {
        "bern": np.asarray(rows_bern, np.int64),
        "d1x": np.asarray(rows_dep1_x, np.int64),
        "d1z": np.asarray(rows_dep1_z, np.int64),
        "d2": np.asarray(rows_dep2, np.int64).reshape(-1, 4),
        "pair": np.asarray(rows_pair, np.int64).reshape(-1, 4),
        "erx": np.asarray(rows_erase_x, np.int64),
        "erz": np.asarray(rows_erase_z, np.int64),
    }
    order, table = _draw_table(bern_p, dep1_p, dep2_p, pair_cum, erase_p,
                               rows, Fd, Fo)
    nb, n1, nd2, n2, ne = table["counts"]
    cols = np.cumsum([0, nb, n1, nd2, n2, ne])     # each kind's draw columns

    # erasure metadata for heralded decoding: detector/observable
    # signatures of each erase site's x- and z-fault (host numpy)
    erasure_meta = {
        "x_det": Fd[rows["erx"]], "z_det": Fd[rows["erz"]],
        "x_obs": Fo[rows["erx"]], "z_obs": Fo[rows["erz"]],
    }
    device_table = sampler_cuda.tables(table, dev) if dev.type == "cuda" else None

    def draws(generator: torch.Generator):
        """The op route's draws: u (shots, n_draws) float32 uniforms in the
        table's order and the erasures' Pauli bits (shots, n_erase, 2)
        uint8, drawn from `generator` one block of uniforms a kind, in the
        table's order, then the bits."""
        us = [torch.rand((shots, n), generator=generator, device=dev)
              for n in (nb, n1, nd2, n2, ne) if n]
        ebits = (torch.randint(0, 2, (shots, ne, 2), generator=generator,
                               device=dev, dtype=torch.uint8) if ne else
                 torch.zeros((shots, 0, 2), dtype=torch.uint8, device=dev))
        u = (torch.cat(us, dim=1) if us else
             torch.zeros((shots, 0), dtype=torch.float32, device=dev))
        return u, ebits

    consts: Dict[torch.device, tuple] = {}

    def op_route(u: torch.Tensor, ebits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The plain twin of the kernel: compares of the given draws with
        the table's float32 thresholds, then one 0/1 float32 product of each
        bit block with its rows of the signature matrices (exact: every
        partial sum is an integer below 2^24)."""
        d = u.device
        if d not in consts:
            t = table["rec"].view(np.float32)
            consts[d] = (torch.as_tensor(t[:, 1], device=d),
                         torch.as_tensor(t[:, 2], device=d),
                         torch.as_tensor(t[:, 3], device=d),
                         torch.as_tensor(table["cum"], device=d),
                         torch.as_tensor(Fd[order], dtype=torch.float32, device=d),
                         torch.as_tensor(Fo[order], dtype=torch.float32, device=d))
        thr, thr_a, thr_b, cum_t, Fd_t, Fo_t = consts[d]
        blocks = []                    # the fault bits, in `order`'s blocks

        def pair_bits(idx):
            pa, pb = idx // 4, idx % 4
            blocks.append((pa == 1) | (pa == 2))                    # xa
            blocks.append((pa == 2) | (pa == 3))                    # za
            blocks.append((pb == 1) | (pb == 2))                    # xb
            blocks.append((pb == 2) | (pb == 3))                    # zb

        def kind(k):                   # the draws of kind k: columns, thresholds
            c = slice(cols[k], cols[k + 1])
            return u[:, c], thr[c]

        if nb:
            ub, p = kind(0)
            blocks.append(ub < p)
        if n1:
            ub, p = kind(1)
            c = slice(cols[1], cols[2])
            blocks.append(ub < thr_a[c])                            # x: u < 2p/3
            blocks.append((ub >= thr_b[c]) & (ub < p))              # z: p/3 <= u < p
        if nd2:
            # uniform 15-outcome depolarizing pair channels: index map
            ub, p = kind(2)
            idx = torch.floor(ub / p.clamp_min(1e-30) * 15.0).to(torch.int32) + 1
            pair_bits(torch.where(ub < p, idx.clamp_max(15), 0))
        if n2:
            # general two-qubit Pauli channels: cumulative table lookup
            ub, p = kind(3)
            idx = (ub[..., None] >= cum_t[None]).sum(dim=-1, dtype=torch.int32)
            pair_bits(torch.where(ub < p, idx + 1, 0))
        heralds = torch.zeros((shots, ne), dtype=torch.uint8, device=d)
        if ne:
            ub, p = kind(4)
            hit = ub < p
            heralds = hit.to(torch.uint8)   # erasures announce themselves
            blocks.append(hit & (ebits[..., 0] > 0))
            blocks.append(hit & (ebits[..., 1] > 0))
        dets = torch.zeros((shots, n_det), dtype=torch.float32, device=d)
        obs = torch.zeros((shots, n_obs), dtype=torch.float32, device=d)
        r = 0
        for b in blocks:
            eb = b.to(torch.float32)
            dets += eb @ Fd_t[r:r + b.shape[1]]
            obs += eb @ Fo_t[r:r + b.shape[1]]
            r += b.shape[1]
        return {"detectors": (dets.to(torch.int32) & 1).to(torch.uint8),
                "observables": (obs.to(torch.int32) & 1).to(torch.uint8),
                "heralds": heralds}

    def sample(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        with span("nqs.sample"):
            if device_table is not None:
                d, o, h = sampler_cuda.walk(device_table, shots, generator=generator)
                return {"detectors": d, "observables": o, "heralds": h}
            return op_route(*draws(generator))

    sample.faults = faults
    sample.meas_flip_rows = meas_flip_rows
    sample.Fd = Fd
    sample.Fo = Fo
    sample.erasure_meta = erasure_meta
    sample.order = order
    sample.table = table
    sample.device_table = device_table
    sample.draws = draws
    sample.op_route = op_route
    return sample


def _draw_table(bern_p, dep1_p, dep2_p, pair_cum, erase_p, rows, Fd, Fo):
    """The fault sites as the kernel walks them: (order, table).

    One entry a uniform draw, in the op route's draw order: the Bernoulli
    sites, DEPOLARIZE1, DEPOLARIZE2, PAULI_CHANNEL_2, ERASE. `order` lists
    the site rows of the fault bits in the op route's block order (all x
    bits of DEPOLARIZE1, then all z bits; the four bits xa, za, xb, zb of
    the pair channels block by block; the erasures' x, then z bits), so a
    draw of kind k whose first bit is b0 has its bits at b0 + j * stride[k].
    The table holds

      rec (n_draws, 4) int32      kind | b0 << 3; then float32 bits of t, a, b:
                                  t the hit threshold (no bit below it is
                                  set once u >= t); DEPOLARIZE1: a = 2p/3
                                  (x), b = p/3 (z from it up to t = p);
                                  PAULI_CHANNEL_2: a is the draw's row of
                                  `cum`; ERASE: a is the erasure's index
      cum (n_pair, 15) float32    PAULI_CHANNEL_2's cumulative tables
      sig_ptr, sig_col int32      CSR signature of each fault bit (a row of
                                  [Fd | Fo][order]): its detector columns,
                                  then n_det + its observables
      strides (5,) int32          the bit stride of each kind
      counts                      the draws of each kind

    The float32 thresholds are computed here, once, and both routes compare
    with them: 2p/3 as (2 * p32) / 3 and p/3 as p32 / 3 in float32 division
    on the host, so the kernel and its twin agree to the last bit.
    """
    f32 = np.float32
    counts = tuple(len(a) for a in (bern_p, dep1_p, dep2_p, pair_cum, erase_p))
    nb, n1, nd2, n2, ne = counts
    kind = np.repeat(np.arange(5, dtype=np.int64), counts)
    strides = np.array([1, n1, nd2, n2, ne], np.int64)
    first = np.cumsum([0, nb, 2 * n1, 4 * nd2, 4 * n2])      # each kind's bit block
    b0 = first[kind] + np.concatenate([np.arange(n, dtype=np.int64) for n in counts])
    p = np.concatenate([np.asarray(a, np.float64) for a in (bern_p, dep1_p, dep2_p)]
                       + [np.zeros(n2), np.asarray(erase_p, np.float64)]).astype(f32)
    cum = np.asarray(pair_cum, np.float64).reshape(-1, 15).astype(f32)
    t = p.copy()
    t[kind == 3] = cum[:, -1]
    a = np.zeros(len(kind), f32)
    b = np.zeros(len(kind), f32)
    d1 = kind == 1
    a[d1] = f32(2.0) * p[d1] / f32(3.0)
    b[d1] = p[d1] / f32(3.0)
    ia = np.zeros(len(kind), np.int32)
    ia[kind == 3] = np.arange(n2)
    ia[kind == 4] = np.arange(ne)
    rec = np.zeros((len(kind), 4), np.int32)
    rec[:, 0] = kind | (b0 << 3)
    rec[:, 1] = t.view(np.int32)
    rec[:, 2] = np.where((kind == 3) | (kind == 4), ia, a.view(np.int32))
    rec[:, 3] = b.view(np.int32)
    order = np.concatenate([
        rows["bern"],
        rows["d1x"], rows["d1z"],
        rows["d2"][:, 0], rows["d2"][:, 1], rows["d2"][:, 2], rows["d2"][:, 3],
        rows["pair"][:, 0], rows["pair"][:, 1], rows["pair"][:, 2], rows["pair"][:, 3],
        rows["erx"], rows["erz"],
    ]).astype(np.int64)
    r, c = np.nonzero(np.concatenate([Fd[order], Fo[order]], axis=1))
    sig_ptr = np.zeros(len(order) + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=len(order)), out=sig_ptr[1:])
    return order, {"rec": rec, "cum": cum, "sig_ptr": sig_ptr.astype(np.int32),
                   "sig_col": c.astype(np.int32), "strides": strides.astype(np.int32),
                   "counts": counts, "n_det": Fd.shape[1], "n_obs": Fo.shape[1],
                   "n_erase": ne}


def sample_circuit_fast(circuit: Circuit, shots: int, seed: int = 0,
                        device: Union[str, torch.device] = "cuda") -> Dict:
    """One sample of `shots` shots from a generator seeded with `seed`, as
    host numpy arrays."""
    fn = build_fast_sampler(circuit, shots, device)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return {k: v.cpu().numpy() for k, v in fn(gen).items()}


__all__ = ["build_fast_sampler", "sample_circuit_fast"]
