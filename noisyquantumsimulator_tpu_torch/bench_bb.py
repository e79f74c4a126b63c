"""The BB-LDPC circuit-level memory workload: sample + tiered BP + OSD-0.

Counterpart of the reference's `bench.py` `main_bb` (`--bb`): the
[[144, 12, 12]] gross code under `rounds` rounds of circuit-level noise at
rate p. One end-to-end rep on the device is

  1. sample `shots` shots of detectors and observables (fast_sampler)
  2. tiered DEM-BP (DemBPDecoder.tiered): `fast_iters` bf16 min-sum on every
     shot, then a damped float32 90-iteration retry on the compacted
     non-converged tail; kernel K3 runs every check-node update
  3. score the predictions against the observables, count failures among
     the converged shots, and compact the still-unconverged residue
     (detectors, beliefs, observables) into `cap` rows

and on the host, native OSD-0 on that residue (`osd_host`). `e2e` makes no
host synchronisation, so callers can queue several reps before reading any
(as `main_bb` does, letting host OSD overlap device work).

`step` is one rep read back at once, shot by shot, with OSD-0 on the card:
e2e, one read of the residue's row count, OSD-0 of those rows
(`qec/osd_cuda.osd0`, one kernel launch; the host C++ twin for CPU tensors)
with their predictions written over the shots' on the device, then one copy
back of every shot's predicted observable flips, the tier that decided it
and the reliability of its beliefs, and the rep's failure count, put
together in one host array (`answers`). It is the span nqs.step, around
nqs.sample, nqs.decode and nqs.osd (`utils/observability`).

This module builds the workload and has no timing code of its own; callers
time it (chip_smoke.py does).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from .qec.dem_decoder import DemBPDecoder
from .qec.fast_sampler import build_fast_sampler
from .qec.ldpc import bb_memory_circuit, css_n_k, gross_code
from .qec.native import osd0_batch_native
from .qec.osd_cuda import osd0, tables as osd0_tables
from .utils.observability import span


@dataclass
class BBWorkload:
    e2e: Callable            # e2e(generator) -> (fails, n_bad, dets, beliefs, obs)
    osd_host: Callable       # osd_host(n_bad, dets, beliefs, obs) -> failures
    step: Callable           # step(generator) -> (shots + 1, 3) int32 (`answers`)
    decoder: DemBPDecoder
    circuit: object
    sampler: Callable
    n: int                   # code length
    k: int                   # logical qubits (observables)
    cap: int                 # residue rows that reach OSD-0 per rep
    fast_iters: int
    decoder_label: str


def build_bb_workload(rounds: int = 3, p: float = 1e-3, shots: int = 65536,
                      fast_iters: int = 6,
                      device: Union[str, torch.device] = "cuda",
                      Hx: Optional[np.ndarray] = None,
                      Hz: Optional[np.ndarray] = None) -> BBWorkload:
    """The `main_bb` workload on `device` (default code: the gross code).

    Decoder settings are `main_bb`'s: at p <= 1.5e-3 the lean budgets
    (fast_iters bf16 iterations, retry capacity shots // 128, residue cap
    shots // 64); above it at least 8 fast iterations, retry capacity
    shots // 32 and residue cap shots // 16."""
    dev = torch.device(device)
    if Hx is None or Hz is None:
        Hx, Hz = gross_code()
    n, k = css_n_k(Hx, Hz)
    circuit = bb_memory_circuit(Hx, Hz, rounds, p)
    sampler = build_fast_sampler(circuit, shots, dev)
    lean = p <= 1.5e-3
    eff_iters = fast_iters if lean else max(fast_iters, 8)
    dec = DemBPDecoder(circuit, n_iters=60, kernel="slots",
                       fast_iters=eff_iters, fast_dtype=torch.bfloat16,
                       retry_damping=0.5, retry_iters=90,
                       retry_cap_divisor=128 if lean else 32, device=dev)
    bits = torch.arange(k, dtype=torch.int32, device=dev)
    cap = min(shots, max(shots // (64 if lean else 16), 32))
    obs_cols = np.stack([(dec.obs_mask >> b) & 1 for b in range(k)],
                        axis=1)                               # (n_var, k)
    osd_tab = osd0_tables(dec.H, dec.obs_mask, k, dev)

    def rep(generator: torch.Generator):
        o = sampler(generator)
        pred, bad, beliefs, missed = dec.tiered(o["detectors"].to(torch.float32))
        obs = o["observables"].to(torch.int32)                # (S, k)
        pb = (pred[:, None] >> bits[None, :]) & 1
        fail = (pb != obs).any(dim=1)
        # converged shots are final; non-converged ones ship to host OSD.
        # topk sorts, so the n_bad flagged shots come first
        _, idx = torch.topk(bad.to(torch.int32), cap)
        return ((fail & ~bad).sum(), bad.sum(),
                o["detectors"].index_select(0, idx),
                beliefs.index_select(0, idx), obs.index_select(0, idx)), \
            (pred, bad, missed, beliefs, idx)

    def e2e(generator: torch.Generator):
        return rep(generator)[0]

    def check_cap(n_bad: int) -> None:
        if n_bad > cap:
            raise RuntimeError(f"residue cap {cap} < non-converged {n_bad}: "
                               "the failure count would be short")

    def osd_bits(n_bad: int, dets_r, bel_r) -> np.ndarray:
        """(n_bad, k) predicted observable flips of the residue rows by OSD-0."""
        check_cap(n_bad)
        if n_bad == 0:
            return np.zeros((0, k), np.int64)
        dets_h = dets_r[:n_bad].cpu().numpy()
        bel_h = bel_r[:n_bad].cpu().numpy()
        est = osd0_batch_native(dec.H, dets_h, bel_h)
        return (est.astype(np.int64) @ obs_cols) & 1

    def osd_host(n_bad: int, dets_r, bel_r, obs_r) -> int:
        """OSD-0 the residue rows; returns the failures among them."""
        if n_bad == 0:
            return 0
        pb = osd_bits(n_bad, dets_r, bel_r)
        obs_h = obs_r[:n_bad].cpu().numpy()
        return int((pb != obs_h).any(axis=1).sum())

    first = True

    def step(generator: torch.Generator) -> np.ndarray:
        # the span nqs.step; the first call (the libraries' load, the first
        # device calls) is recorded in any case
        nonlocal first
        with span("nqs.step", always=first):
            first = False
            (fails, n_bad, dets_r, bel_r, obs_r), (pred, bad, missed, beliefs, idx) = \
                rep(generator)
            tier = missed.to(torch.int32) + bad.to(torch.int32)
            rel = torch.linalg.vector_norm(beliefs, float("-inf"), dim=1)
            rel = torch.round(rel * RELIABILITY_UNITS).clamp(max=2.0 ** 30).to(torch.int32)
            nb = int(n_bad)
            check_cap(nb)
            with span("nqs.osd") as s:
                s.note(nb)
                if nb:
                    _, pb, osd_fail = osd0(osd_tab, dets_r[:nb], bel_r[:nb], obs_r[:nb])
                    pred = pred.index_copy(0, idx[:nb], pb.to(pred.dtype))
                    fails = fails + osd_fail.sum()
            flat = torch.cat([torch.stack([pred, tier, rel], dim=1).flatten(),
                              fails.view(1).to(torch.int32)]).cpu().numpy()
            return answers(flat[:-1].reshape(-1, 3), int(flat[-1]), k)

    label = (f"tiered slot-BP (min-sum {eff_iters} iters bf16 + damped "
             "min-sum 90-iter retry) + OSD-0 of the non-converged residue "
             "(on the card in step; C++ on the host after e2e)")
    return BBWorkload(e2e=e2e, osd_host=osd_host, step=step, decoder=dec,
                      circuit=circuit, sampler=sampler, n=n, k=k, cap=cap,
                      fast_iters=eff_iters, decoder_label=label)


# the reliability of a shot's beliefs (the least |belief| over its
# mechanisms, a log-likelihood ratio) is given in units of 1 / RELIABILITY_UNITS
RELIABILITY_UNITS = 1024


def answers(shots: np.ndarray, n_fail: int, k: int) -> np.ndarray:
    """A step's answers as one (S + 1, 3) int32 host array. Row i < S is
    shot i: its predicted observable flips (bit b is observable b), the
    tier that decided it (0: the fast BP tier, 1: the retry, 2: OSD-0) and
    the reliability of the beliefs it was decided from (the fast tier's
    where that tier decided it). The last row is (the step's failures, k,
    0)."""
    return np.concatenate([shots.astype(np.int32),
                           np.array([[n_fail, k, 0]], np.int32)])


__all__ = ["BBWorkload", "build_bb_workload", "answers", "RELIABILITY_UNITS"]
