"""Matching decoders: the APSP matching graph, batched greedy, host union-find.

Counterpart of the reference's `qec/decoders.py`.

  MatchingGraph    all-pairs shortest paths and the observable parity along
                   each shortest path on the weighted space-time detector
                   graph (host numpy, copied), shared by every matcher
  MatchingDecoder  greedy pairing of each shot's defects on the device,
                   batched over (shots, K) defect slots in torch ops: no
                   loop over shots (the reference vmaps a per-row function)
  UnionFindDecoder host greedy over the full pair set (copied)

Slot order is the reference's: each shot's defects, lowest detector index
first, from a stable sort of the negated bits (`jnp.argsort(-bits,
stable=True)` there, `torch.sort(..., stable=True)` here). Ties in the
greedy's pair choice go to the first flat (i, j) index, as `jnp.argmin`'s
do, and to the first available slot for a lone defect.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

# =============================================================================
# graph preprocessing (host, once per circuit)
# =============================================================================


def _floyd_warshall_with_parity(n_nodes: int, edges: np.ndarray,
                                weights: np.ndarray, obs: np.ndarray
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs shortest paths and the observable parity along the
    shortest path. Boundary is node index n_nodes-1."""
    INF = 1e18
    D = np.full((n_nodes, n_nodes), INF)
    P = np.zeros((n_nodes, n_nodes), dtype=np.int32)
    np.fill_diagonal(D, 0.0)
    for (a, b), w, om in zip(edges, weights, obs):
        a = n_nodes - 1 if a < 0 else a
        b = n_nodes - 1 if b < 0 else b
        if w < D[a, b]:
            D[a, b] = D[b, a] = w
            P[a, b] = P[b, a] = om
    for k in range(n_nodes):
        alt = D[:, k, None] + D[None, k, :]
        better = alt < D
        if better.any():
            palt = P[:, k, None] ^ P[None, k, :]
            D = np.where(better, alt, D)
            P = np.where(better, palt, P)
    return D, P


@dataclass
class MatchingGraph:
    n_detectors: int
    dist: np.ndarray      # (n+1, n+1) incl boundary node at index n
    parity: np.ndarray    # (n+1, n+1) observable parity of shortest path

    @staticmethod
    def from_edges(n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                   obs: np.ndarray) -> "MatchingGraph":
        w = np.log((1.0 - probs) / np.maximum(probs, 1e-15))
        w = np.maximum(w, 1e-3)
        D, P = _floyd_warshall_with_parity(n_detectors + 1, edges, w, obs)
        return MatchingGraph(n_detectors, D, P)

    def tables_on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dist float32, parity uint8) on `device`, both (n+1, n+1). The
        device matchers work at float32, as the reference's do."""
        return (torch.as_tensor(self.dist.astype(np.float32), device=device),
                torch.as_tensor(self.parity.astype(np.uint8), device=device))


# =============================================================================
# defect slots
# =============================================================================


def defect_slots(dets: torch.Tensor, K: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shot's first K defects, lowest detector index first.

    dets (S, n_det) 0/1 -> (nodes (S, K) int64: the detector index of each
    slot, n_det (the boundary node) for an empty slot; valid (S, K) bool).
    Shots with more than K defects keep their K lowest-index ones."""
    S, n_det = dets.shape
    bits = dets.to(torch.int8)
    order = torch.sort(-bits, dim=1, stable=True).indices[:, :K]
    valid = torch.gather(bits, 1, order) > 0
    nodes = torch.where(valid, order, n_det)
    if K > n_det:      # more slots than detectors: the rest stay empty
        pad = K - n_det
        nodes = torch.cat([nodes, nodes.new_full((S, pad), n_det)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((S, pad))], dim=1)
    return nodes, valid


def stable_top_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the 1-D integer tensor x, ties
    to the lower index: `lax.top_k`'s order, from a stable sort of -x
    (`torch.topk` does not promise it)."""
    return torch.sort(-x.to(torch.int64), stable=True).indices[:k]


# =============================================================================
# batched greedy matching on the device
# =============================================================================


def _greedy_match_batch(dets: torch.Tensor, dist: torch.Tensor,
                        parity: torch.Tensor, max_defects: int):
    """The greedy matching of every shot, batched over defect slots.

    dets (S, n_det) 0/1 on the device; dist (n+1, n+1) float32; parity
    unused here (kept for the reference's signature). Returns (match (S, K)
    int32, det_idx (S, K) int32): per defect slot (lowest detector index
    first) the matched slot, K for a boundary match, -1 for unused slots;
    det_idx carries each slot's detector index (n_det when unused). Pairs
    taken "via boundary" decompose into two boundary matches.

    K rounds; each matches the closest available pair (the first flat (i, j)
    of the minimum), or sends a lone defect to the boundary."""
    S, n_det = dets.shape
    K = min(max_defects, n_det)
    B = n_det
    dev = dets.device
    nodes, valid = defect_slots(dets, K)
    N1 = dist.shape[0]
    dflat = dist.reshape(-1)
    Dm = dflat[nodes[:, :, None] * N1 + nodes[:, None, :]]         # (S, K, K)
    Db = dflat[nodes * N1 + B]                                      # (S, K)
    via_bnd = Db[:, :, None] + Db[:, None, :]
    use_direct = Dm <= via_bnd
    Deff = torch.where(use_direct, Dm, via_bnd)
    big = torch.tensor(1e17, dtype=dist.dtype, device=dev)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    rows = torch.arange(S, device=dev)

    used = torch.zeros((S, K), dtype=torch.bool, device=dev)
    match = torch.full((S, K), -1, dtype=torch.int32, device=dev)
    kK = torch.tensor(K, dtype=torch.int32, device=dev)
    for _ in range(K):
        avail = ~used & valid
        pair_ok = avail[:, :, None] & avail[:, None, :] & ~eye
        Mp = torch.where(pair_ok, Deff, big).reshape(S, K * K)
        pflat = torch.argmin(Mp, dim=1)
        i, j = pflat // K, pflat % K
        have_pair = Mp[rows, pflat] < big
        lone = avail.sum(dim=1) == 1
        bi = torch.argmax(avail.to(torch.int8), dim=1)
        direct = use_direct.reshape(S, K * K)[rows, pflat]
        mi = torch.where(direct, j.to(torch.int32), kK)
        mj = torch.where(direct, i.to(torch.int32), kK)
        new = match.clone()
        new[rows, i] = mi
        new[rows, j] = mj
        lone_m = match.clone()
        lone_m[rows, bi] = kK
        match = torch.where(have_pair[:, None], new,
                            torch.where(lone[:, None], lone_m, match))
        nu = used.clone()
        nu[rows, i] = True
        nu[rows, j] = True
        lu = used.clone()
        lu[rows, bi] = True
        used = torch.where(have_pair[:, None], nu,
                           torch.where(lone[:, None], lu, used))
    return match, nodes.to(torch.int32)


def _greedy_decode_batch(dets: torch.Tensor, dist: torch.Tensor,
                         parity: torch.Tensor, max_defects: int
                         ) -> torch.Tensor:
    """dets (S, n_det) -> logical flip parity (S,) int32: the XOR of the
    path parities of the greedy matching (_greedy_match_batch)."""
    S, n_det = dets.shape
    K = min(max_defects, n_det)
    match, det_idx = _greedy_match_batch(dets, dist, parity, max_defects)
    ks = torch.arange(K, dtype=torch.int32, device=dets.device)
    is_bnd = match == K
    first = (match >= 0) & (match < K) & (ks[None, :] < match)
    dj = torch.gather(det_idx, 1, match.clamp(0, K - 1).to(torch.int64))
    N1 = parity.shape[0]
    pflat = parity.reshape(-1).to(torch.int32)
    di = det_idx.to(torch.int64)
    pb = pflat[di * N1 + n_det]
    pp = pflat[di * N1 + dj.to(torch.int64)]
    contrib = torch.where(is_bnd, pb, 0) + torch.where(first, pp, 0)
    return (contrib.sum(dim=1) & 1).to(torch.int32)


class MatchingDecoder:
    """Batched greedy matching on the space-time detector graph."""

    CHUNK = 65536     # shots a device call: bounds the (S, K, K) tables

    def __init__(self, n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                 obs: np.ndarray, max_defects: int = 32,
                 device: Union[str, torch.device] = "cuda"):
        self.graph = MatchingGraph.from_edges(n_detectors, edges, probs, obs)
        self.max_defects = max_defects
        self.device = torch.device(device)
        self._dist, self._par = self.graph.tables_on(self.device)

    def decode_device(self, dets: torch.Tensor) -> torch.Tensor:
        """(S, n_det) on the device -> (S,) int32, no host sync."""
        return _greedy_decode_batch(dets, self._dist, self._par,
                                    self.max_defects)

    def decode_batch(self, detectors) -> np.ndarray:
        """detectors (S, n_det) -> predicted logical-flip bitmask (S,)
        int64 (bit 0: the primary observable)."""
        t0 = time.perf_counter()
        dets = np.asarray(detectors, dtype=np.uint8)
        out = [self.decode_device(torch.as_tensor(dets[s:s + self.CHUNK],
                                                  device=self.device)).cpu()
               for s in range(0, dets.shape[0], self.CHUNK)]
        res = (torch.cat(out).numpy().astype(np.int64) if out
               else np.zeros(0, np.int64))
        self.last_decode_seconds = time.perf_counter() - t0
        return res


# =============================================================================
# host union-find (accuracy reference)
# =============================================================================


class UnionFindDecoder:
    """Host greedy over the full pair set, closest pairs first, on the
    shortest-path tables (the reference's accuracy reference)."""

    def __init__(self, n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                 obs: np.ndarray):
        self.n = n_detectors
        g = MatchingGraph.from_edges(n_detectors, edges, probs, obs)
        self.dist, self.parity = g.dist, g.parity

    def decode_batch(self, detectors: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        S = detectors.shape[0]
        out = np.zeros(S, dtype=np.int64)
        B = self.n
        for s in range(S):
            defects = np.nonzero(detectors[s])[0].tolist()
            par = 0
            # exact greedy over full pair set (host): closest pairs first
            while defects:
                if len(defects) == 1:
                    par ^= int(self.parity[defects[0], B])
                    break
                sub = np.array(defects)
                Dm = self.dist[np.ix_(sub, sub)]
                bd = self.dist[sub, B]
                via = bd[:, None] + bd[None, :]
                Deff = np.minimum(Dm, via)
                np.fill_diagonal(Deff, np.inf)
                i, j = np.unravel_index(np.argmin(Deff), Deff.shape)
                if Dm[i, j] <= via[i, j]:
                    par ^= int(self.parity[sub[i], sub[j]])
                else:
                    par ^= int(self.parity[sub[i], B]
                               ^ self.parity[sub[j], B])
                for k in sorted((int(i), int(j)), reverse=True):
                    defects.pop(k)
            out[s] = par
        self.last_decode_seconds = time.perf_counter() - t0
        return out


def decoder_for_circuit(circuit, kind: str = "matching",
                        max_defects: int = 32,
                        device: Union[str, torch.device] = "cuda"):
    """Build a decoder from a Circuit via its detector error model. The
    native kinds raise when the C++ library cannot be built."""
    from .dem import build_dem, dem_to_edges
    dem = build_dem(circuit)
    edges, probs, obs = dem_to_edges(dem)
    if kind in ("matching", "greedy", "mwpm"):
        return MatchingDecoder(circuit.n_detectors, edges, probs, obs,
                               max_defects=max_defects, device=device)
    if kind in ("uf", "union_find"):
        return UnionFindDecoder(circuit.n_detectors, edges, probs, obs)
    if kind in ("native", "exact", "native_mwpm"):
        from .native import NativeMatchingDecoder
        return NativeMatchingDecoder(circuit.n_detectors, edges, probs, obs)
    raise ValueError(f"Unknown decoder kind: {kind}")


__all__ = ["MatchingGraph", "MatchingDecoder", "UnionFindDecoder",
           "decoder_for_circuit", "defect_slots", "stable_top_rows"]
