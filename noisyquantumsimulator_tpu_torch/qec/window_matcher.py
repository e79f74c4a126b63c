"""Sliding-window exact matching on the device, at any distance.

Counterpart of the reference's `qec/window_matcher.py`. The bitmask DP
(exact_matcher.py) is exponential in a shot's defect count, which grows
with d^2 * rounds; this decoder windows in time on top of the DP's
matching extraction (`ExactMatcher.match_device`):

  window w covers rounds [w*C, w*C + W); its defects (plus defects carried
  from earlier windows) are matched exactly by the K-budget DP; pairs lying
  entirely before the commit boundary (w+1)*C are committed to the running
  observable parity; pairs touching the buffer are deferred (the
  pre-boundary endpoint is carried into the next window, the buffer
  endpoint reappears there). The final window commits everything.

Defects beyond a shot's budget in a window are deferred to the next window
(lowest indices are decoded first); in the final window they are lost, and
the per-shot `ovf` flag records every window that went over its budget.

Tiers, as in the reference: k_light > 0 traces every (shot, window) with a
K = k_light DP and re-traces the `heavy_capacity` shots with the most
defects by the full DP; greedy_fallback > max_defects adds a greedy tier
for windows above the DP budget. Both selections take the rows with the
most defects, ties to the lower index (`lax.top_k`'s order), from a stable
sort.
"""
from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from .decoders import MatchingGraph, _greedy_match_batch, stable_top_rows
from .exact_matcher import (ExactMatcher, _Escalating, _decode_host_flagged,
                            _edges_of)


class WindowMatcher:
    """Sliding-window exact matcher over round-labeled detectors; the
    reference's `WindowMatcherTPU`.

    det_round: (n_detectors,) int array, the time label of each detector
    (memory circuits: `surface_code.memory_detector_rounds`). Boundary-time
    (final data measurement) detectors carry the last label."""

    def __init__(self, n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                 obs: np.ndarray, det_round: np.ndarray,
                 window_rounds: int = 5, commit_rounds: int = 2,
                 max_defects: int = 12, chunk: int = 4096,
                 k_light: int = 0, heavy_capacity: int = 0,
                 greedy_fallback: int = 0, greedy_capacity: int = 0,
                 device: Union[str, torch.device] = "cuda",
                 graph: Optional[MatchingGraph] = None):
        if not 1 <= commit_rounds < window_rounds:
            raise ValueError("need 1 <= commit_rounds < window_rounds "
                             "(the overlap buffer is their difference; "
                             "commit_rounds is the window stride)")
        det_round = np.asarray(det_round, np.int32)
        if det_round.shape != (n_detectors,):
            raise ValueError("det_round must label every detector")
        if k_light >= max_defects:
            raise ValueError("k_light must be below max_defects")
        graph = graph if graph is not None else MatchingGraph.from_edges(
            n_detectors, edges, probs, obs)
        self.matcher = ExactMatcher(n_detectors, edges, probs, obs,
                                    max_defects=max_defects, chunk=chunk,
                                    device=device, graph=graph)
        self.device = dev = self.matcher.device
        self.max_defects = K = max_defects
        self.k_light = KL = k_light
        self.chunk = chunk
        self.n_detectors = n_detectors
        if KL:
            self.light = ExactMatcher(n_detectors, edges, probs, obs,
                                      max_defects=KL, chunk=chunk,
                                      device=dev, graph=graph)
            C_heavy = heavy_capacity or min(chunk, max(chunk // 4, 64))
            if not 1 <= C_heavy <= chunk:
                raise ValueError(f"heavy_capacity must be in [1, {chunk}]")
            self.heavy_capacity = C_heavy
        self.greedy_fallback = MG = greedy_fallback
        if MG:
            if MG <= max_defects:
                raise ValueError("greedy_fallback must exceed max_defects")
            C_greedy = greedy_capacity or min(chunk, max(chunk // 16, 64))
            if not 1 <= C_greedy <= chunk:
                raise ValueError(f"greedy_capacity must be in [1, {chunk}]")
            self.greedy_capacity = C_greedy
        self.Kg = min(MG, n_detectors) if MG else 0     # greedy's slot width
        # one output width for every tier, never below the exact tier's K
        self.MW = max(K, self.Kg) if MG else K
        n_rounds = int(det_round.max()) + 1
        R_END = n_rounds + 2       # commit-everything sentinel

        windows = []
        s = 0
        while True:
            lo, hi = s, s + window_rounds
            last = hi >= n_rounds
            ce = R_END if last else s + commit_rounds
            mask = torch.as_tensor((det_round >= lo) & (det_round < hi),
                                   device=dev)
            before = torch.as_tensor(det_round < ce, device=dev)
            windows.append((mask, ce, before))
            if last:
                break
            s += commit_rounds
        self.windows = windows
        self.n_windows = len(windows)
        self._dist, self._par = self.matcher._dist, self.matcher._par
        self._ptbl = self._par.reshape(-1).to(torch.int32)
        self._rd_ext = torch.as_tensor(
            np.append(det_round, 1 << 30).astype(np.int64), device=dev)

    def _to_width(self, match, det_idx, from_k):
        """A tier's (match, det_idx) in the MW-wide slot layout (slot order
        is lowest detector first in every tier, so only the boundary marker
        and the padding change)."""
        MW = self.MW
        if from_k == MW:
            return match, det_idx
        rows = match.shape[0]
        m = torch.where(match == from_k, MW, match)
        m = torch.cat([m, m.new_full((rows, MW - from_k), -1)], dim=1)
        d = torch.cat([det_idx, det_idx.new_full((rows, MW - from_k),
                                                 self.n_detectors)], dim=1)
        return m, d

    def _window_match(self, active, nd_act):
        """(match, det_idx, keff): the traced matching of `active` and each
        shot's effective defect budget this window."""
        S = active.shape[0]
        K, KL = self.max_defects, self.k_light
        if not KL:
            _, mD, dD = self.matcher.match_device(active)
            match, det_idx = self._to_width(mD, dD, K)
            keff = torch.full((S,), K, dtype=torch.int32, device=self.device)
        else:
            _, mL, dL = self.light.match_device(active)
            match, det_idx = self._to_width(mL, dL, KL)
            hidx = stable_top_rows(nd_act, min(self.heavy_capacity, S))
            _, mH, dH = self.matcher.match_device(active.index_select(0, hidx))
            mH, dH = self._to_width(mH, dH, K)
            is_heavy = nd_act.index_select(0, hidx) > KL
            match = match.index_copy(0, hidx, torch.where(
                is_heavy[:, None], mH, match.index_select(0, hidx)))
            det_idx = det_idx.index_copy(0, hidx, torch.where(
                is_heavy[:, None], dH, det_idx.index_select(0, hidx)))
            served = torch.zeros(S, dtype=torch.bool, device=self.device
                                 ).index_copy(0, hidx, is_heavy)
            keff = torch.where(served, K, KL).to(torch.int32)
        if self.greedy_fallback:
            gidx = stable_top_rows(nd_act, min(self.greedy_capacity, S))
            mG, dG = _greedy_match_batch(active.index_select(0, gidx),
                                         self._dist, self._par,
                                         self.greedy_fallback)
            mG, dG = self._to_width(mG, dG, self.Kg)
            is_over = nd_act.index_select(0, gidx) > K
            match = match.index_copy(0, gidx, torch.where(
                is_over[:, None], mG, match.index_select(0, gidx)))
            det_idx = det_idx.index_copy(0, gidx, torch.where(
                is_over[:, None], dG, det_idx.index_select(0, gidx)))
            served = torch.zeros(S, dtype=torch.bool, device=self.device
                                 ).index_copy(0, gidx, is_over)
            keff = torch.where(served, self.Kg, keff).to(torch.int32)
        return match, det_idx, keff

    def decode_device_with_overflow(self, dets: torch.Tensor):
        """(S, n_det) on the device -> (pred (S,) int32, ovf (S,) bool): ovf
        flags shots where any window (with the real carry dynamics) went
        over its defect budget. No host sync."""
        S, n_det = dets.shape
        dev = self.device
        MW = self.MW
        dets = dets.to(torch.uint8)
        carry = torch.zeros_like(dets)
        par = torch.zeros(S, dtype=torch.int32, device=dev)
        ovf = torch.zeros(S, dtype=torch.bool, device=dev)
        ks = torch.arange(MW, device=dev)
        NW = n_det + 1
        for mask, ce, before in self.windows:
            active = torch.where(mask[None, :], dets, 0) | carry
            bits = active.to(torch.int32)
            rank = torch.cumsum(bits, dim=1) * bits
            nd_act = bits.sum(dim=1)
            match, det_idx, keff = self._window_match(active, nd_act)
            ovf = ovf | (nd_act > keff)
            # defects past the shot's budget are not decoded this window
            # (the DP keeps the lowest indices, the earliest rounds); those
            # in commit rounds are deferred explicitly, or they would vanish
            dropped = (rank > keff[:, None]) & before[None, :]
            di = det_idx.to(torch.int64)
            rd = self._rd_ext[di]                                   # (S, MW)
            m64 = match.to(torch.int64)
            is_pair = (m64 >= 0) & (m64 < MW)
            dj = torch.gather(di, 1, m64.clamp(0, MW - 1))
            rj = self._rd_ext[dj]
            commit_bnd = (m64 == MW) & (rd < ce)
            first = is_pair & (ks[None, :] < m64)
            commit_pair = first & (rd < ce) & (rj < ce)
            pb = self._ptbl[di * NW + n_det]
            pp = self._ptbl[di.clamp(max=n_det - 1) * NW
                            + dj.clamp(max=n_det - 1)]
            contrib = (torch.where(commit_bnd, pb, 0)
                       + torch.where(commit_pair, pp, 0))
            par = par ^ (contrib.sum(dim=1) & 1).to(torch.int32)
            # deferred pairs: carry the pre-boundary endpoint; the buffer
            # endpoint reappears through the next window's mask. A count
            # scatter into a trash column n_det for the slots not carried
            defer = first & ~commit_pair
            c_i = defer & (rd < ce) & (di < n_det)
            c_j = defer & (rj < ce) & (dj < n_det)
            keep = torch.zeros((S, n_det + 1), dtype=torch.int32, device=dev)
            keep.scatter_add_(1, torch.where(c_i, di, n_det),
                              c_i.to(torch.int32))
            keep.scatter_add_(1, torch.where(c_j, dj, n_det),
                              c_j.to(torch.int32))
            carry = ((keep[:, :n_det] > 0) | dropped).to(torch.uint8)
        return par, ovf

    def decode_device(self, dets: torch.Tensor) -> torch.Tensor:
        return self.decode_device_with_overflow(dets)[0]

    def decode_batch(self, detectors) -> np.ndarray:
        t0 = time.perf_counter()
        pred, ovf = _decode_host_flagged(self.decode_device_with_overflow,
                                         detectors, self.chunk, self.device)
        self.last_overflow_fraction = float(ovf.mean()) if ovf.size else 0.0
        self.last_decode_seconds = time.perf_counter() - t0
        return pred

    def overflow_fraction(self, detectors) -> float:
        """Fraction of shots where any window (carried defects included)
        went over the K defect budget, with the real carry dynamics."""
        ovf = _decode_host_flagged(self.decode_device_with_overflow,
                                   detectors, self.chunk, self.device)[1]
        return float(ovf.mean()) if ovf.size else 0.0


class EscalatingWindowMatcher(_Escalating):
    """Sliding-window device decoding + native host re-decode of flagged
    shots: the device matcher (no greedy tier) decodes every shot and flags
    shots where any window went over the exact DP budget; those are
    re-decoded whole by the native C++ exact cluster decoder."""

    def __init__(self, n_detectors: int, edges: np.ndarray,
                 probs: np.ndarray, obs: np.ndarray, det_round: np.ndarray,
                 window_rounds: int = 5, commit_rounds: int = 2,
                 max_defects: int = 12, chunk: int = 4096,
                 k_light: int = 6, heavy_capacity: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        from .native import NativeMatchingDecoder
        self.native = NativeMatchingDecoder(n_detectors, edges, probs, obs)
        self.window = self.device_stage = WindowMatcher(
            n_detectors, edges, probs, obs, det_round,
            window_rounds=window_rounds, commit_rounds=commit_rounds,
            max_defects=max_defects, chunk=chunk, k_light=k_light,
            heavy_capacity=heavy_capacity, device=device)
        self.chunk = chunk
        self.max_defects = max_defects
        self.device = self.window.device
        self.last_flagged_fraction = 0.0


def window_matcher_for_circuit(circuit, det_round: np.ndarray,
                               window_rounds: int = 5, commit_rounds: int = 2,
                               max_defects: int = 12, chunk: int = 4096,
                               k_light: int = 0, heavy_capacity: int = 0,
                               greedy_fallback: int = 0,
                               greedy_capacity: int = 0,
                               device: Union[str, torch.device] = "cuda"
                               ) -> WindowMatcher:
    edges, probs, obs = _edges_of(circuit)
    return WindowMatcher(circuit.n_detectors, edges, probs, obs, det_round,
                         window_rounds=window_rounds,
                         commit_rounds=commit_rounds,
                         max_defects=max_defects, chunk=chunk,
                         k_light=k_light, heavy_capacity=heavy_capacity,
                         greedy_fallback=greedy_fallback,
                         greedy_capacity=greedy_capacity, device=device)


def escalating_matcher_for_circuit(circuit, det_round: np.ndarray,
                                   window_rounds: int = 5,
                                   commit_rounds: int = 2,
                                   max_defects: int = 12, chunk: int = 4096,
                                   k_light: int = 6, heavy_capacity: int = 0,
                                   device: Union[str, torch.device] = "cuda"
                                   ) -> EscalatingWindowMatcher:
    edges, probs, obs = _edges_of(circuit)
    return EscalatingWindowMatcher(
        circuit.n_detectors, edges, probs, obs, det_round,
        window_rounds=window_rounds, commit_rounds=commit_rounds,
        max_defects=max_defects, chunk=chunk, k_light=k_light,
        heavy_capacity=heavy_capacity, device=device)


__all__ = ["WindowMatcher", "EscalatingWindowMatcher",
           "window_matcher_for_circuit", "escalating_matcher_for_circuit"]
