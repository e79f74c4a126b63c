"""Exact MWPM at any distance by cluster decomposition on the device.

Counterpart of the reference's `qec/cluster_matcher.py`. A defect pair
(i, j) with D(i, j) >= D(i, B) + D(j, B) never appears in a minimum matching
(two boundary matches are at least as cheap), so the connected components
under the strict adjacency D(i, j) < D(i, B) + D(j, B) match independently
and their minimum matchings compose to a global minimum: the theorem the
native C++ decoder uses. Below threshold the components are tiny, so
per-component exact DPs with small budgets decode whole shots exactly.

Device pipeline, one chunk of shots at a time:
  1. each shot's first MD defects into slots, lowest detector index first
     (a stable sort), empty slots on the boundary node;
  2. adjacency and path parity of every slot pair, gathered from host
     tables (the adjacency computed on the host in float64 with the native
     decoder's strict rule);
  3. the component root of each slot (the smallest slot index it reaches)
     from an exact boolean closure: repeated float32 products of 0/1
     matrices (counts <= MD, exact with TF32 off);
  4. size-1 components: boundary parity; size-2: pair parity;
  5. components of size 3+ routed by size class to K-budget bitmask DPs
     (exact_matcher._dp_from_tables), each row's (K, K) weight and parity
     tables gathered from the float32 distances directly;
  6. per-component parities XOR-ed back into each shot's parity.

A shot the device cannot certify exact raises its `ovf` flag: more than MD
defects, a component above every tier, more size-3+ components than the
per-shot candidate slots, or a size class past its row capacity. A starved
capacity flags the shot and never truncates it. Flagged shots are
re-decoded whole by the native C++ decoder (EscalatingClusterMatcher).

Selections keep `lax.top_k`'s order (the most first, ties to the lower
index) through stable sorts, so the rows served, and so the flags, are the
reference's. Not ported (TPU workarounds): `_trunc_split3`'s bf16 planes of
the distances and the bf16 one-hot passes; a gather of the float32
distances gives the values the planes reconstruct.
"""
from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from .decoders import MatchingGraph, defect_slots
from .exact_matcher import (_Escalating, _LevelTables, _decode_host_flagged,
                            _dp_from_tables, _edges_of, _slot_tables)


def _closure_root(adj: torch.Tensor, valid: torch.Tensor, MD: int
                  ) -> torch.Tensor:
    """Each slot's component root, the minimum slot index it reaches.

    adj (S, MD, MD) bool, valid (S, MD) bool -> root (S, MD) int64 (MD for
    empty slots). Transitive closure by repeated squaring of the 0/1
    reachability matrix as float32 products: every sum is an integer count
    <= MD, exact in float32 with TF32 off, so `> 0` is exact."""
    eye = torch.eye(MD, dtype=torch.bool, device=adj.device)
    R = (adj | eye).to(torch.float32)
    for _ in range(max(1, int(np.ceil(np.log2(MD))))):
        R = (torch.bmm(R, R) > 0).to(torch.float32)
    ks = torch.arange(MD, device=adj.device)
    reach_idx = torch.where((R > 0) & valid[:, None, :], ks, MD)
    root = reach_idx.min(dim=2).values
    return torch.where(valid, root, MD)


def _first_rows(flags: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the first k entries of `lax.top_k(flags, k)` along the
    last axis: the set ones in index order, then the unset ones in index
    order (a stable sort of -flags)."""
    return torch.sort(-flags.to(torch.int8), dim=-1, stable=True).indices[..., :k]


class ClusterMatcher:
    """Exact cluster-decomposition MWPM decoder on the device; the
    reference's `ClusterMatcherTPU`.

    decode_device_with_overflow(dets) -> (parity (S,) int32, ovf (S,) bool).
    ovf-flagged shots carry a best-effort parity (their in-budget
    components are still decoded exactly) and are to be escalated;
    EscalatingClusterMatcher does that with the native decoder."""

    def __init__(self, n_detectors: int, edges: np.ndarray,
                 probs: np.ndarray, obs: np.ndarray,
                 max_slots: int = 32, tiers=None, chunk: int = 4096,
                 small_rows_per_shot: Optional[float] = None,
                 big_rows_per_shot: Optional[float] = None,
                 cand_per_shot: int = 8,
                 device: Union[str, torch.device] = "cuda",
                 graph: Optional[MatchingGraph] = None):
        """tiers: ((lo, hi, K, rows_per_shot), ...) size-class DP routing;
        components of size lo..hi (hi <= K) go to a K-budget DP with a
        per-chunk row capacity of ceil(rows_per_shot * chunk) (at least 64,
        at most chunk * max_slots). cand_per_shot bounds the size-3+
        components one shot may send to the DPs (more flag the shot)."""
        if tiers is None:
            tiers = ((3, 6, 6, small_rows_per_shot or 0.8),
                     (7, 8, 8, (big_rows_per_shot or 0.5) * 0.5),
                     (9, 12, 12, (big_rows_per_shot or 0.5) * 0.5))
        for lo, hi, K, _rps in tiers:
            if not 2 < lo <= hi <= K <= 16:
                raise ValueError(f"bad tier ({lo},{hi},{K}): need "
                                 "2 < lo <= hi <= K <= 16 (the bitmask "
                                 "DP is exponential in K)")
        self.tiers = tiers = tuple(tiers)
        self.cand_per_shot = cand_per_shot
        k_big = max(t[2] for t in tiers)
        if max_slots < k_big:
            raise ValueError("max_slots must be >= the largest tier K")
        self.graph = graph if graph is not None else MatchingGraph.from_edges(
            n_detectors, edges, probs, obs)
        self.n_detectors = N = n_detectors
        self.chunk = chunk
        self.max_slots = MD = max_slots
        self.k_big = k_big
        self.device = dev = torch.device(device)

        dist_np = self.graph.dist.astype(np.float32)
        # unreachable pairs: a finite sentinel, as in the native tables
        dist_np[~np.isfinite(dist_np)] = np.float32(1e18)
        # host float64 adjacency with the native decoder's strict rule:
        # adj[m, n] = D(m, n) < D(m, B) + D(n, B); diagonal cleared, the
        # boundary row and column are false on their own
        D64 = self.graph.dist.astype(np.float64)
        D64[~np.isfinite(D64)] = 1e18
        db64 = D64[:, N]
        adj_np = D64 < (db64[:, None] + db64[None, :])
        np.fill_diagonal(adj_np, False)
        self._dist = torch.as_tensor(dist_np, device=dev)
        self._par = torch.as_tensor(self.graph.parity.astype(np.uint8),
                                    device=dev)
        self._adj = torch.as_tensor(adj_np, device=dev)
        self._tiers = [(lo, hi, K, _LevelTables(K, dev),
                        max(64, min(int(np.ceil(rps * chunk)), chunk * MD)))
                       for lo, hi, K, rps in tiers]
        self.tier_capacities = {(lo, hi): cap
                                for lo, hi, _, _, cap in self._tiers}

    def _component_rows(self, sel, det_idx, member, size, lo, hi, K, tabs):
        """Solve the component rows at flat (S * MD) positions `sel` with the
        K-budget DP. Returns (row parity (cap,) int32, 0 where the row is
        not of this size class; row shot id (cap,); row in class (cap,))."""
        MD, N = self.max_slots, self.n_detectors
        s_id = sel // MD
        r_id = sel % MD
        mem = member[s_id, r_id]                                 # (cap, MD)
        sz = size[s_id, r_id]
        ok = (sz >= lo) & (sz <= hi)
        # member slots into K DP slots in slot order; the rest on the
        # boundary node (free, parity 0)
        msl = _first_rows(mem, K)                                # (cap, K)
        filled = torch.gather(mem, 1, msl)
        mdet = torch.where(filled, torch.gather(det_idx[s_id], 1, msl), N)
        rp, _ = _dp_from_tables(*_slot_tables(mdet, self._dist, self._par),
                                tabs)
        return torch.where(ok, rp, 0), s_id, ok

    def decode_device_with_overflow(self, dets: torch.Tensor):
        """(S, n_det) on the device -> (parity (S,) int32, ovf (S,) bool),
        no host sync."""
        S = dets.shape[0]
        MD, N = self.max_slots, self.n_detectors
        dev = self.device
        nd = dets.to(torch.int32).sum(dim=1)
        det_idx, valid = defect_slots(dets, MD)                  # (S, MD)
        ext = torch.cat([det_idx, det_idx.new_full((S, 1), N)], dim=1)
        pair = ext[:, :, None] * (N + 1) + ext[:, None, :]       # (S, MD+1, .)
        adj = self._adj.reshape(-1)[pair[:, :MD, :MD]]
        PP = self._par.reshape(-1)[pair].to(torch.int32)
        root = _closure_root(adj, valid, MD)
        ks = torch.arange(MD, device=dev)
        # member[s, r, k]: slot k belongs to the component rooted at slot r
        member = (root[:, None, :] == ks[None, :, None]) & valid[:, None, :]
        size = member.sum(dim=2)                                 # (S, MD)
        # size is nonzero only on root slots: singletons take their boundary
        # parity, pairs the root's path parity to its partner (PP's diagonal
        # is 0)
        p1 = torch.where(size == 1, PP[:, :MD, MD], 0).sum(dim=1)
        pr2 = (member * PP[:, :MD, :MD]).sum(dim=2)
        p2 = torch.where(size == 2, pr2, 0).sum(dim=1)
        parity = ((p1 + p2) & 1).to(torch.int32)
        # candidates: each shot's first R size-3+ roots, in slot order
        is_dp = size >= 3
        R = min(self.cand_per_shot, MD)
        cslot = _first_rows(is_dp, R)                            # (S, R)
        cval = torch.gather(is_dp, 1, cslot)
        csize = torch.gather(size, 1, cslot)
        flat_cand = (torch.arange(S, device=dev)[:, None] * MD
                     + cslot).reshape(S * R)
        dp_par = torch.zeros(S, dtype=torch.int32, device=dev)
        starved = torch.zeros(S, dtype=torch.bool, device=dev)
        covered = size <= 2
        for lo, hi, K, tabs, cap in self._tiers:
            in_tier = (size >= lo) & (size <= hi)
            covered = covered | in_tier
            in_tier_c = cval & (csize >= lo) & (csize <= hi)
            sel = flat_cand[_first_rows(in_tier_c.reshape(S * R),
                                        min(cap, S * R))]
            rp, sid, ok = self._component_rows(sel, det_idx, member, size,
                                               lo, hi, K, tabs)
            dp_par.index_add_(0, sid, rp & 1)
            served = torch.zeros(S, dtype=torch.int32, device=dev)
            served.index_add_(0, sid, ok.to(torch.int32))
            starved = starved | (served < in_tier.sum(dim=1))
        parity = parity ^ (dp_par & 1)
        ovf = (nd > MD) | ((size > 0) & ~covered).any(dim=1) | starved
        return parity, ovf

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
        """Fraction of shots the device could not certify exact (these need
        escalation)."""
        ovf = _decode_host_flagged(self.decode_device_with_overflow,
                                   detectors, self.chunk, self.device)[1]
        return float(ovf.mean()) if ovf.size else 0.0


class EscalatingClusterMatcher(_Escalating):
    """ClusterMatcher + native host re-decode of flagged shots: true MWPM at
    any distance, with a host tail of ~1e-3 of the shots below threshold."""

    def __init__(self, n_detectors: int, edges: np.ndarray,
                 probs: np.ndarray, obs: np.ndarray, chunk: int = 4096,
                 device: Union[str, torch.device] = "cuda", **kw):
        from .native import NativeMatchingDecoder
        self.native = NativeMatchingDecoder(n_detectors, edges, probs, obs)
        self.cluster = self.device_stage = ClusterMatcher(
            n_detectors, edges, probs, obs, chunk=chunk, device=device, **kw)
        self.chunk = chunk
        self.device = self.cluster.device
        self.last_flagged_fraction = 0.0


def default_tiers(n_detectors: int):
    """Occupancy-sized tier routing, the reference's: the d <= 9
    memory-circuit class (n_det <= 512), the d = 11 class (capacities
    scaled by n_det / 720) and d >= 13 (by n_det / 1176)."""
    if n_detectors <= 512:
        return ((3, 6, 6, 0.8), (7, 8, 8, 0.12), (9, 12, 12, 0.08))
    if n_detectors <= 900:
        r = max(1.0, n_detectors / 720.0)
        return ((3, 6, 6, 0.9 * r), (7, 8, 8, 0.2 * r),
                (9, 10, 10, 0.16 * r), (11, 12, 12, 0.12 * r))
    r = max(1.0, n_detectors / 1176.0)
    return ((3, 6, 6, 1.0 * r), (7, 8, 8, 0.25 * r),
            (9, 10, 10, 0.21 * r), (11, 12, 12, 0.19 * r))


def cluster_matcher_for_circuit(circuit, chunk: Optional[int] = None,
                                escalating: bool = False,
                                device: Union[str, torch.device] = "cuda",
                                **kw):
    edges, probs, obs = _edges_of(circuit)
    if chunk is None:
        chunk = 4096
    kw.setdefault("tiers", default_tiers(circuit.n_detectors))
    kw.setdefault("max_slots", 24)
    cls = EscalatingClusterMatcher if escalating else ClusterMatcher
    return cls(circuit.n_detectors, edges, probs, obs, chunk=chunk,
               device=device, **kw)


__all__ = ["ClusterMatcher", "EscalatingClusterMatcher",
           "cluster_matcher_for_circuit", "default_tiers"]
