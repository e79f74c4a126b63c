"""BP+OSD decoding on the detector error model: circuit-level qLDPC.

Counterpart of the reference's `qec/dem_decoder.py`. Circuit-level decoding
of codes that are not matchable (BB-LDPC): the merged DEM is a Tanner graph
(variables are the elementary fault mechanisms with their circuit-derived
priors, checks are the detectors), decoded by batched min-sum BP with
per-variable priors and a host OSD-0 on the shots BP leaves unconverged.
Predicted observable flips come from the estimated mechanism set's
observable masks.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.observability import span
from .dem import build_dem
from .ldpc import _bp_edges, _bp_slots, build_slot_tables, slot_tables_on
from .native import osd0_batch_native


def dem_arrays(circuit, min_prob: float = 1e-12
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H (n_det, n_mech) uint8, obs_mask (n_mech,) int64, probs (n_mech,))
    of the circuit's merged DEM, keeping mechanisms above `min_prob`."""
    dem = build_dem(circuit).merged()
    mechs = [m for m in dem.mechanisms if m.probability > min_prob]
    if not mechs:
        raise ValueError("circuit has no fault mechanisms to decode")
    H = np.zeros((circuit.n_detectors, len(mechs)), dtype=np.uint8)
    obs = np.zeros(len(mechs), dtype=np.int64)
    probs = np.zeros(len(mechs))
    for j, m in enumerate(mechs):
        H[list(m.detectors), j] = 1
        obs[j] = m.observables
        probs[j] = m.probability
    return H, obs, probs


class DemBPDecoder:
    """decode_batch(detectors) -> per-observable flip bitmask (S,).

    kernel: "slots" (default) runs min-sum in the dense check-slot layout
    (ldpc._bp_slots, check-node update in kernel K3 on CUDA), "edges" the
    per-edge segment-reduction form (ldpc._bp_edges; identical message
    schedule).

    fast_iters > 0 enables convergence TIERING: every shot runs a
    fast_iters BP first; only shots whose residual syndrome is nonzero are
    top-k-compacted and re-run with the full retry depth. fast_dtype sets
    the fast tier's message precision only; bfloat16 halves its memory
    traffic. A fast-tier result is kept only where score()'s exact
    residual-syndrome check passes, so lower precision can only push a
    shot into the float32 retry tier, never emit an invalid correction.

    The retry tier runs DAMPED min-sum (retry_damping, slots kernel only):
    plain min-sum oscillates on the DEM's short cycles, and the damped
    retry converges far more of the tail, so the host OSD-0 residue nearly
    vanishes. Its capacity is min(S, max(S // retry_cap_divisor, 64))
    rows; tail shots beyond it stay flagged and go to OSD.

    All device work runs on `device`; the decoder's constants are built
    there once, at construction. `decoder_from_numpy` builds one from host
    arrays (`_arrays`) instead of a circuit."""

    def __init__(self, circuit, n_iters: int = 60, scale: float = 0.75,
                 min_prob: float = 1e-12, kernel: str = "slots",
                 fast_iters: int = 0, fast_dtype=torch.float32,
                 retry_damping: float = 0.5,
                 retry_iters: Optional[int] = None,
                 retry_cap_divisor: int = 32,
                 device: Union[str, torch.device] = "cuda",
                 _arrays: Optional[Tuple] = None):
        H, obs, probs = (_arrays if _arrays is not None
                         else dem_arrays(circuit, min_prob))
        self.device = dev = torch.device(device)
        self.H = np.asarray(H, np.uint8)
        self.obs_mask = np.asarray(obs, np.int64)
        self.probs = np.asarray(probs, np.float64)
        self.n_det, self.n_mech = self.H.shape
        self.retry_cap_divisor = int(retry_cap_divisor)
        self.scale, self.fast_iters, self.fast_dtype = float(scale), int(fast_iters), fast_dtype
        self.retry_damping = float(retry_damping)
        self.retry_iters = int(retry_iters or n_iters + n_iters // 2)
        if fast_iters >= n_iters:
            raise ValueError("fast_iters must be below n_iters")
        llr = np.log((1.0 - self.probs) / self.probs)
        chk_idx, var_idx = np.nonzero(self.H)
        llr_t = torch.as_tensor(llr.astype(np.float32), device=dev)

        if kernel == "slots":
            tables = slot_tables_on(
                build_slot_tables(chk_idx.astype(np.int64),
                                  var_idx.astype(np.int64),
                                  self.n_det, self.n_mech), dev)
        elif kernel == "edges":
            chk_t = torch.as_tensor(chk_idx.astype(np.int64), device=dev)
            var_t = torch.as_tensor(var_idx.astype(np.int64), device=dev)
        else:
            raise ValueError(f"unknown BP kernel {kernel!r}")

        def make_bp(iters, dtype=torch.float32, damping=0.0):
            if kernel == "slots":
                return partial(_bp_slots, llr_var=llr_t, tables=tables,
                               n_chk=self.n_det, n_var=self.n_mech,
                               n_iters=iters, scale=scale, dtype=dtype,
                               damping=damping)
            if dtype != torch.float32:
                raise ValueError("fast_dtype requires kernel='slots'")
            # the edge kernel has no damped variant; the retry runs
            # undamped full-depth BP there
            return partial(_bp_edges, chk=chk_t, var=var_t, llr_var=llr_t,
                           n_chk=self.n_det, n_var=self.n_mech,
                           n_iters=iters, scale=scale)

        self._bp = make_bp(n_iters)
        if kernel == "slots" and retry_damping > 0.0:
            self._bp_retry = make_bp(self.retry_iters, damping=retry_damping)
        else:
            self._bp_retry = self._bp
        self._bp_fast = make_bp(fast_iters, dtype=fast_dtype) \
            if fast_iters else None

        # residual syndromes and observable flips stay on the device, as
        # float32 products of 0/1 operands: exact integer sums (<= n_mech,
        # far below 2^24) with TF32 off, so the parity is exact
        n_bits = max(1, int(self.obs_mask.max()).bit_length())
        if n_bits > 31:
            raise ValueError(
                f"{n_bits} observable bits exceed the int32 bitmask this "
                "decoder packs predictions into; split the observables")
        self.n_bits = n_bits
        obs_cols = np.stack([(self.obs_mask >> b) & 1 for b in range(n_bits)],
                            axis=1)                             # (n_var, B)
        self._Ht = torch.as_tensor(self.H.T.astype(np.float32), device=dev)
        self._obs_cols = torch.as_tensor(obs_cols.astype(np.float32),
                                         device=dev)
        self._bit_w = torch.as_tensor(
            (1 << np.arange(n_bits)).astype(np.int32), device=dev)
        self.last_decode_seconds = 0.0

    def score(self, est: torch.Tensor, dets_f: torch.Tensor):
        """(pred (S,) int32 observable bitmask, bad (S,) bool: the estimate
        does not reproduce the syndrome) of a hard estimate (S, n_var)."""
        est_f = est.to(torch.float32)
        synd = (est_f @ self._Ht).to(torch.int32) & 1
        bad = (synd != dets_f.to(torch.int32)).any(dim=1)
        ob = (est_f @ self._obs_cols).to(torch.int32) & 1
        pred = (ob * self._bit_w[None, :]).sum(dim=1, dtype=torch.int32)
        return pred, bad

    def _full(self, dets_f: torch.Tensor):
        """dets_f (S, n_det) float32 on the decoder's device -> (pred (S,)
        int32, bad (S,) bool, beliefs (S, n_var) float32), all on the
        device, with no host synchronisation."""
        return self.tiered(dets_f)[:3]

    def tiered(self, dets_f: torch.Tensor):
        """`_full`'s (pred, bad, beliefs), then missed (S,) bool: the shots
        whose first BP pass left the syndrome unmatched (the fast tier's, or
        the only pass's without tiering). The span nqs.decode."""
        with span("nqs.decode"):
            return self._tiers(dets_f)

    def _tiers(self, dets_f: torch.Tensor):
        if self._bp_fast is None:
            est, beliefs = self._bp(dets_f)
            pred, bad = self.score(est, dets_f)
            return pred, bad, beliefs, bad
        est, beliefs = self._bp_fast(dets_f)
        pred, missed = self.score(est, dets_f)
        S = dets_f.shape[0]
        cap = min(S, max(S // self.retry_cap_divisor, 64))
        _, idx = torch.topk(missed.to(torch.int32), cap)
        sub = dets_f.index_select(0, idx)
        est2, bel2 = self._bp_retry(sub)
        pred2, bad2 = self.score(est2, sub)
        retry = missed.index_select(0, idx)
        pred = pred.index_copy(0, idx, torch.where(
            retry, pred2, pred.index_select(0, idx)))
        bad = missed.index_copy(0, idx, retry & bad2)
        beliefs = beliefs.index_copy(0, idx, torch.where(
            retry[:, None], bel2, beliefs.index_select(0, idx)))
        return pred, bad, beliefs, missed

    def decode_batch(self, detectors, osd: bool = True) -> np.ndarray:
        """detectors (S, n_det) 0/1 -> predicted observable bitmask (S,)
        int64; shots BP leaves unconverged go through native OSD-0."""
        t0 = time.perf_counter()
        dets = np.asarray(detectors, dtype=np.uint8)
        pred, bad, beliefs = self._full(
            torch.as_tensor(dets, device=self.device).to(torch.float32))
        pred = pred.cpu().numpy().astype(np.int64)
        bad_idx = np.nonzero(bad.cpu().numpy())[0]
        if osd and bad_idx.size:
            # slice the bad rows on the device before fetching them
            sel = torch.as_tensor(bad_idx, device=self.device)
            beliefs_bad = beliefs.index_select(0, sel).cpu().numpy()
            est_bad = osd0_batch_native(self.H, dets[bad_idx], beliefs_bad)
            for bit in range(self.n_bits):
                col = ((self.obs_mask >> bit) & 1).astype(np.int64)
                pred[bad_idx] &= ~(1 << bit)
                pred[bad_idx] |= ((est_bad.astype(np.int64) @ col) & 1) << bit
        self.last_decode_seconds = time.perf_counter() - t0
        return pred


def decoder_from_numpy(H: np.ndarray, obs_mask: np.ndarray, probs: np.ndarray,
                       device: Union[str, torch.device] = "cuda",
                       **decoder_kw) -> DemBPDecoder:
    """A DemBPDecoder built from host arrays instead of a circuit: H
    (n_det, n_mech) 0/1, obs_mask (n_mech,) observable bitmasks, probs
    (n_mech,) priors (e.g. another decoder's `.H`, `.obs_mask`, `.probs`).
    `decoder_kw` are DemBPDecoder's options other than the circuit and
    `min_prob`."""
    return DemBPDecoder(None, device=device, _arrays=(H, obs_mask, probs),
                        **decoder_kw)


__all__ = ["DemBPDecoder", "decoder_from_numpy", "dem_arrays"]
