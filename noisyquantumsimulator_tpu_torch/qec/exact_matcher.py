"""Exact minimum-weight perfect matching on the device (bitmask DP).

Counterpart of the reference's `qec/exact_matcher.py`. For each shot's
defect slots (lowest detector index first, up to K):

  dp[S] = min cost of matching the defect subset S, with
  dp[S] = min( dp[S \\ {i}] + w(i, boundary),
               min_{j in S, j > i} dp[S \\ {i,j}] + w(i, j) )
  for i = lowest set bit of S.

Subsets are processed in K + 1 popcount levels: every mask of level k
depends only on levels k-1 (boundary move) and k-2 (pair move), so each
level is a few batched row gathers and a min over all masks of that
popcount and all shots at once. The dp arrays are level-major, (L_k, R)
with the R shots minor, so every gather moves R contiguous values (the
reference's gather form, `_dp_from_tables_gather`). Observable parities ride
along as 0/1 bytes, combined by XOR.

Bit-identity with the reference. Each dp value is the float32 sum of
exactly two float32 values (a dp entry and a slot weight), so this gather
form equals the reference's one-hot HIGHEST-precision matmul form bit for
bit. Its tie rules are kept: among pair moves the first minimizer in
ascending j wins (`first_min_parity`), and the boundary move wins ties with
it (`cost_b <= cbest`). A mask of popcount k has exactly k - 1 pair moves;
the reference pads every level to K - 1 columns of cost 1e18 and parity 0,
so levels below K clamp the pair minimum at 1e18 the same way.

Not ported (TPU workarounds): the one-hot selection matrices
(`_build_level_tables`, `_sel`, `_fused_level_tables`) and the padding of
the last chunk to one compiled shape (`_chunked_decode`). Chunking stays:
it bounds the level arrays' memory.

Shots with more than K defects keep only their K lowest-index defects (the
reference's overflow rule); `overflow_fraction` counts them.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .decoders import (MatchingGraph, _greedy_decode_batch, defect_slots,
                       stable_top_rows)

_BIG = 1e18    # the reference's float32 sentinel for absent pair moves


@functools.lru_cache(maxsize=None)
def _build_level_indices(K: int) -> List[Dict[str, np.ndarray]]:
    """Host index tables of the DP's transitions, per level k = 1..K (masks
    ascending within each popcount level, the reference's order):

      idx_bnd : (L,)      position of m ^ lowbit(m) in level k-1
      sel_bi  : (L,)      i = lowbit(m): the row of Wb^T
      idx_pair: (L, k-1)  position of m ^ {i, j} in level k-2, j ascending
      sel_ij  : (L, k-1)  i*K + j: the row of Wm^T

    Unpadded: the reference's `_build_level_indices` pads the pair columns
    to K - 1 with a validity mask; its valid columns are these."""
    by_pop = [[] for _ in range(K + 1)]
    for m in range(1 << K):
        by_pop[bin(m).count("1")].append(m)
    pos = [{m: i for i, m in enumerate(level)} for level in by_pop]
    tables = []
    for k in range(1, K + 1):
        masks = by_pop[k]
        L = len(masks)
        idx_bnd = np.zeros(L, np.int64)
        sel_bi = np.zeros(L, np.int64)
        idx_pair = np.zeros((L, k - 1), np.int64)
        sel_ij = np.zeros((L, k - 1), np.int64)
        for li, m in enumerate(masks):
            i = (m & -m).bit_length() - 1
            idx_bnd[li] = pos[k - 1][m ^ (1 << i)]
            sel_bi[li] = i
            col = 0
            for j in range(i + 1, K):
                if m >> j & 1:
                    idx_pair[li, col] = pos[k - 2][m ^ (1 << i) ^ (1 << j)]
                    sel_ij[li, col] = i * K + j
                    col += 1
        tables.append(dict(idx_bnd=idx_bnd, sel_bi=sel_bi, idx_pair=idx_pair,
                           sel_ij=sel_ij, size=L))
    return tables


@functools.lru_cache(maxsize=None)
def _mask_tables(K: int):
    """Masks grouped by popcount (ascending within each level) and the
    lowest-set-bit index of every K-bit mask, for the backtrace."""
    by_pop = [[] for _ in range(K + 1)]
    for m in range(1 << K):
        by_pop[bin(m).count("1")].append(m)
    lowbit = np.zeros(1 << K, np.int64)
    for m in range(1, 1 << K):
        lowbit[m] = (m & -m).bit_length() - 1
    return [np.asarray(b, np.int64) for b in by_pop], lowbit


class _LevelTables:
    """`_build_level_indices(K)` as tensors on one device (built once)."""

    def __init__(self, K: int, device):
        self.K = K
        self.levels = [
            {key: (torch.as_tensor(v, device=device) if key != "size" else v)
             for key, v in t.items()}
            for t in _build_level_indices(K)]
        by_pop, lowbit = _mask_tables(K)
        self.by_pop = [torch.as_tensor(b, device=device) for b in by_pop]
        self.lowbit = torch.as_tensor(lowbit, device=device)


def _slot_tables(nodes: torch.Tensor, dist: torch.Tensor,
                 parity: torch.Tensor):
    """Slot weight / parity tables in the DP's level-major layout.

    nodes (R, K) int64 detector index per slot (the boundary node n_det for
    an absent slot: dist[B, B] = 0, parity 0, so absent slots are free and
    parity-neutral). Returns WmT (K*K, R) float32 with row i*K + j =
    dist[node_i, node_j], PmT (K*K, R) uint8, WbT (K, R), PbT (K, R): direct
    gathers of the float32 distances and of the parities."""
    N1 = dist.shape[0]
    nT = nodes.t()                                           # (K, R)
    K = nT.shape[0]
    pair = (nT[:, None, :] * N1 + nT[None, :, :]).reshape(K * K, -1)
    bnd = nT * N1 + (N1 - 1)
    dflat, pflat = dist.reshape(-1), parity.reshape(-1)
    return dflat[pair], pflat[pair], dflat[bnd], pflat[bnd]


def _dp_from_tables(WmT: torch.Tensor, PmT: torch.Tensor, WbT: torch.Tensor,
                    PbT: torch.Tensor, tabs: _LevelTables,
                    keep_costs: bool = False):
    """The bitmask-DP level loop on level-major slot tables.

    WmT/PmT (K*K, R), WbT/PbT (K, R) as `_slot_tables` gives them. Returns
    the (R,) int32 matching observable parity and the (R,) matching weight
    (the last level's dp cost), and with keep_costs the list of every
    level's dp costs (L_k, R) for the backtrace."""
    K = tabs.K
    R = WmT.shape[1]
    dev = WmT.device
    # made on the device: a host scalar copied there would sync the stream
    big = torch.full((), _BIG, dtype=WmT.dtype, device=dev)
    zero8 = torch.zeros((), dtype=torch.uint8, device=dev)
    dpc2 = dpp2 = None
    dpc1 = torch.zeros((1, R), dtype=WmT.dtype, device=dev)
    dpp1 = torch.zeros((1, R), dtype=torch.uint8, device=dev)
    costs = [dpc1]
    for k in range(1, K + 1):
        t = tabs.levels[k - 1]
        L = t["size"]
        ib, si = t["idx_bnd"], t["sel_bi"]
        cost_b = dpc1.index_select(0, ib) + WbT.index_select(0, si)   # (L, R)
        par_b = dpp1.index_select(0, ib) ^ PbT.index_select(0, si)
        if k >= 2:
            ip, sij = t["idx_pair"], t["sel_ij"]                       # (L, W)
            W = k - 1
            cost_p = (dpc2.index_select(0, ip.reshape(-1))
                      + WmT.index_select(0, sij.reshape(-1))).view(L, W, R)
            cbest, arg = cost_p.min(dim=1)          # first minimizer in j
            del cost_p
            # the parity of the chosen pair move only, not of every column
            pbest = (torch.gather(dpp2, 0, torch.gather(ip, 1, arg))
                     ^ torch.gather(PmT, 0, torch.gather(sij, 1, arg)))
            if k < K:
                # the reference's padded columns: cost 1e18, parity 0, after
                # the valid ones, so they win only below the valid minimum
                pad = big < cbest
                cbest = torch.where(pad, big, cbest)
                pbest = torch.where(pad, zero8, pbest)
            use_b = cost_b <= cbest
            dpc = torch.where(use_b, cost_b, cbest)
            dpp = torch.where(use_b, par_b, pbest)
        else:
            dpc, dpp = cost_b, par_b
        dpc2, dpp2, dpc1, dpp1 = dpc1, dpp1, dpc, dpp
        if keep_costs:
            costs.append(dpc)
    par = dpp1[0].to(torch.int32)                  # level K: one mask
    return (par, dpc1[0], costs) if keep_costs else (par, dpc1[0])


def _dp_decode(dets: torch.Tensor, dist: torch.Tensor, parity: torch.Tensor,
               tabs: _LevelTables):
    """dets (S, n_det) 0/1 -> (exact matching observable parity (S,) int32,
    its weight (S,))."""
    nodes, _ = defect_slots(dets, tabs.K)
    return _dp_from_tables(*_slot_tables(nodes, dist, parity), tabs)


def _dp_decode_trace(dets: torch.Tensor, dist: torch.Tensor,
                     parity: torch.Tensor, tabs: _LevelTables):
    """Like _dp_decode but also extracts the matching by a DP backtrace.

    Returns (pred (S,) int32, bit-identical to _dp_decode; match (S, K)
    int32: per defect slot the matched slot, K for a boundary match, -1 for
    unused slots; det_idx (S, K) int32: the detector index behind each slot,
    n_det for unused slots).

    The forward pass keeps every level's costs in a (2^K, S) subset-cost
    table; K backtrace steps replay the forward tie rule (boundary on <=,
    first minimizer in ascending j) with per-shot gathers. Each candidate is
    recomputed as table[m'] + w, the same float32 sums the forward levels
    made, so the traced matching is the one whose parity the forward pass
    returned. The backtrace's parity is the reference's: the XOR of the
    chosen moves' parities over the first min(n_defects, K) slots."""
    K = tabs.K
    S = dets.shape[0]
    dev = dets.device
    nodes, _ = defect_slots(dets, K)
    WmT, PmT, WbT, PbT = _slot_tables(nodes, dist, parity)
    _, _, costs = _dp_from_tables(WmT, PmT, WbT, PbT, tabs, keep_costs=True)
    big = torch.tensor(_BIG, dtype=dist.dtype, device=dev)
    flat = torch.full((1 << K, S), _BIG, dtype=dist.dtype, device=dev)
    for k in range(K + 1):
        flat.index_copy_(0, tabs.by_pop[k], costs[k])
    del costs

    Wm = WmT.t().reshape(S, K, K)
    Pm = PmT.t().reshape(S, K, K)
    Wb, Pb = WbT.t(), PbT.t()
    rows = torch.arange(S, device=dev)
    js = torch.arange(K, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    nd = dets.to(torch.int32).sum(dim=1).clamp(0, K).to(torch.int64)
    mask = (one << nd) - 1                                         # (S,)
    match = torch.full((S, K), -1, dtype=torch.int32, device=dev)
    par = torch.zeros(S, dtype=torch.int32, device=dev)
    kK = torch.tensor(K, dtype=torch.int32, device=dev)
    for _ in range(K):
        active = mask > 0
        i = tabs.lowbit[mask]                                      # (S,)
        m1 = mask ^ (one << i)
        cost_b = flat[m1, rows] + Wb[rows, i]
        mj = m1[:, None] ^ (one << js)[None, :]                    # (S, K)
        valid = (js[None, :] > i[:, None]) & (((mask[:, None] >> js) & 1) == 1)
        Wi = Wm[rows, i]                                           # (S, K)
        cost_p = torch.gather(flat.t(), 1, mj) + Wi
        cost_p = torch.where(valid, cost_p, big)
        cbest, jstar = cost_p.min(dim=1)
        use_b = cost_b <= cbest
        p_pair = Pm[rows, i, jstar]
        p_bnd = Pb[rows, i]
        dpar = torch.where(use_b, p_bnd, p_pair).to(torch.int32)
        par = par ^ (dpar & active.to(torch.int32))
        tgt_i = torch.where(use_b, kK, jstar.to(torch.int32))
        oh_i = js[None, :] == i[:, None]
        oh_j = js[None, :] == jstar[:, None]
        match = torch.where(active[:, None] & oh_i, tgt_i[:, None], match)
        match = torch.where((active & ~use_b)[:, None] & oh_j,
                            i[:, None].to(torch.int32), match)
        newmask = torch.where(use_b, m1, m1 ^ (one << jstar))
        mask = torch.where(active, newmask, mask)
    return par, match, nodes.to(torch.int32)


def _chunks(dets, chunk: int, device):
    """Host or device detector rows -> device uint8 chunks of <= chunk
    rows (the last one shorter: nothing is padded)."""
    if not isinstance(dets, torch.Tensor):
        dets = torch.as_tensor(np.array(dets, dtype=np.uint8))   # writable copy
    for s0 in range(0, dets.shape[0], chunk):
        yield dets[s0:s0 + chunk].to(device=device, dtype=torch.uint8)


def _decode_host(fn, detectors, chunk: int, device) -> np.ndarray:
    outs = [fn(c) for c in _chunks(detectors, chunk, device)]
    if not outs:
        return np.zeros(0, np.int64)
    return torch.cat(outs).cpu().numpy().astype(np.int64)


def _decode_host_flagged(fn, detectors, chunk: int, device):
    """Host rows through a device stage fn(rows) -> (pred, flags), chunk by
    chunk, every chunk queued before the first is read: (pred (S,) int64,
    flags (S,) bool) as numpy."""
    outs = [fn(c) for c in _chunks(detectors, chunk, device)]
    if not outs:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    return (torch.cat([p for p, _ in outs]).cpu().numpy().astype(np.int64),
            torch.cat([f for _, f in outs]).cpu().numpy())


class _Escalating:
    """A device matcher's flagged shots re-decoded whole on the host by the
    native exact decoder (`self.native`, `self.device_stage`)."""

    def decode_device_with_overflow(self, dets):
        """The device stage; callers escalate the flagged shots through
        `decode_flagged_host`."""
        return self.device_stage.decode_device_with_overflow(dets)

    def decode_flagged_host(self, dets_flagged: np.ndarray) -> np.ndarray:
        """The host stage: exact cluster decode of the flagged shots."""
        return self.native.decode_batch_ex(
            dets_flagged, mode=0)["pred"].astype(np.int64) & 1

    def decode_batch(self, detectors) -> np.ndarray:
        t0 = time.perf_counter()
        dets = np.asarray(detectors, dtype=np.uint8)
        preds, flags = _decode_host_flagged(self.decode_device_with_overflow,
                                            dets, self.chunk, self.device)
        idx = np.nonzero(flags)[0]
        if idx.size:
            preds[idx] = self.decode_flagged_host(dets[idx])
        self.last_flagged_fraction = idx.size / max(len(preds), 1)
        self.last_decode_seconds = time.perf_counter() - t0
        return preds

    def overflow_fraction(self, detectors) -> float:
        """Fraction of shots escalated to the host decoder (decoded exactly,
        not truncated)."""
        return self.device_stage.overflow_fraction(detectors)


def _edges_of(circuit):
    from .dem import build_dem, dem_to_edges
    return dem_to_edges(build_dem(circuit))


class ExactMatcher:
    """Device-exact MWPM decoder (<= K defects) over the same APSP tables as
    MatchingDecoder and the native C++ decoder; the reference's
    `ExactMatcherTPU`."""

    def __init__(self, n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                 obs: np.ndarray, max_defects: int = 12, chunk: int = 8192,
                 device: Union[str, torch.device] = "cuda",
                 graph: Optional[MatchingGraph] = None):
        if max_defects > 16:
            raise ValueError("bitmask DP is exponential in max_defects; "
                             "use <= 16 (default 12)")
        self.graph = graph if graph is not None else MatchingGraph.from_edges(
            n_detectors, edges, probs, obs)
        self.n_detectors = n_detectors
        self.max_defects = max_defects
        self.chunk = chunk
        self.device = torch.device(device)
        self._dist, self._par = self.graph.tables_on(self.device)
        self._tabs = _LevelTables(max_defects, self.device)

    def decode_device(self, dets: torch.Tensor) -> torch.Tensor:
        """(S, n_det) on the device -> (S,) int32, no host sync."""
        return self.decode_device_weighted(dets)[0]

    def decode_device_weighted(self, dets: torch.Tensor):
        """(S, n_det) on the device -> (pred (S,) int32, the matching's
        weight (S,) float32), no host sync."""
        return _dp_decode(dets, self._dist, self._par, self._tabs)

    def match_device(self, dets: torch.Tensor):
        """Matching extraction: (S, n_det) on the device -> (pred (S,) int32,
        match (S, K) int32 slot pairing with K meaning boundary and -1
        unused, det_idx (S, K) int32 detector index per slot, n_det for
        unused). pred is bit-identical to decode_device."""
        return _dp_decode_trace(dets, self._dist, self._par, self._tabs)

    def decode_batch(self, detectors) -> np.ndarray:
        """detectors (S, n_det) -> predicted logical flip (S,) int64, chunk
        by chunk."""
        t0 = time.perf_counter()
        out = _decode_host(self.decode_device, detectors, self.chunk,
                           self.device)
        self.last_decode_seconds = time.perf_counter() - t0
        return out

    def overflow_fraction(self, detectors) -> float:
        """Fraction of shots whose defect count exceeds max_defects (those
        decode with only their first K defects)."""
        counts = np.asarray(detectors).sum(axis=1)
        return float(np.mean(counts > self.max_defects))


class HybridMatcher:
    """Exact DP for shots within the defect budget, batched greedy for the
    overflow, both on the device, one decision per shot; the reference's
    `HybridMatcherTPU`."""

    def __init__(self, n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                 obs: np.ndarray, max_defects: int = 12,
                 greedy_defects: int = 32, chunk: int = 8192,
                 device: Union[str, torch.device] = "cuda"):
        self.exact = ExactMatcher(n_detectors, edges, probs, obs,
                                  max_defects=max_defects, chunk=chunk,
                                  device=device)
        self.max_defects = max_defects
        self.greedy_defects = greedy_defects
        self.chunk = chunk
        self.device = self.exact.device

    def decode_device(self, dets: torch.Tensor) -> torch.Tensor:
        nd = dets.to(torch.int32).sum(dim=1)
        p_exact = self.exact.decode_device(dets)
        p_greedy = _greedy_decode_batch(dets, self.exact._dist,
                                        self.exact._par, self.greedy_defects)
        return torch.where(nd <= self.max_defects, p_exact, p_greedy)

    def decode_batch(self, detectors) -> np.ndarray:
        t0 = time.perf_counter()
        out = _decode_host(self.decode_device, detectors, self.chunk,
                           self.device)
        self.last_decode_seconds = time.perf_counter() - t0
        return out


class TieredMatcher:
    """Exact matching with per-shot cost tiering; the reference's
    `TieredMatcherTPU`. A cheap K_light DP decodes every shot of a chunk;
    the `heavy_capacity` shots with the most defects (ties to the lower
    index, `lax.top_k`'s order, from a stable sort) are re-decoded by the
    full K_heavy DP, and its result stands for those of them holding more
    than K_light defects.

    Shots with more than K_heavy defects, and heavy shots past the chunk's
    capacity, keep the truncated-defect rule; `overflow_fraction` counts
    both, and `decode_device_tiered` marks them not exact."""

    def __init__(self, n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                 obs: np.ndarray, k_light: int = 6, k_heavy: int = 12,
                 chunk: int = 8192, heavy_capacity: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        if heavy_capacity is None:
            C = min(chunk, max(chunk // 8, 64))
        else:
            C = heavy_capacity
        if not 1 <= C <= chunk:
            raise ValueError(f"heavy_capacity must be in [1, chunk={chunk}]"
                             f"; got {C} (a chunk holds no more rows)")
        graph = MatchingGraph.from_edges(n_detectors, edges, probs, obs)
        self.light = ExactMatcher(n_detectors, edges, probs, obs,
                                  max_defects=k_light, chunk=chunk,
                                  device=device, graph=graph)
        self.heavy = ExactMatcher(n_detectors, edges, probs, obs,
                                  max_defects=k_heavy, chunk=C, device=device,
                                  graph=graph)
        self.graph = graph
        self.k_light = k_light
        self.max_defects = k_heavy
        self.chunk = chunk
        self.heavy_capacity = C
        self.device = self.light.device

    def _served(self, nd: torch.Tensor):
        """(hidx: the rows that the K_heavy DP re-decodes, the
        `heavy_capacity` heaviest of each block of `chunk` rows (the last
        block may be shorter); exact (S,) bool: the rows decoded with all
        their defects) from the defect counts nd (S,). The full blocks are
        ranked by one stable sort, row by row."""
        S, C = nd.shape[0], self.chunk
        full = S - S % C
        parts = []
        if full:
            order = torch.sort(-nd[:full].to(torch.int64).view(-1, C), dim=1,
                               stable=True).indices[:, :self.heavy_capacity]
            starts = torch.arange(0, full, C, device=nd.device)
            parts.append((order + starts[:, None]).reshape(-1))
        if full < S:
            parts.append(full + stable_top_rows(
                nd[full:], min(self.heavy_capacity, S - full)))
        hidx = torch.cat(parts) if len(parts) > 1 else parts[0]
        exact = (nd <= self.k_light).index_copy(
            0, hidx, nd.index_select(0, hidx) <= self.max_defects)
        return hidx, exact

    def decode_device_tiered(self, dets: torch.Tensor):
        """(S, n_det) on the device -> (pred (S,) int32, tier (S,) int32: 1
        where the K_heavy DP decided the shot, else 0; weight (S,) float32:
        the matching weight of the DP that decided it; exact (S,) bool: the
        shot was decoded with all its defects), no host sync. Each block of
        `chunk` rows is a chunk of its own (its heavy rows chosen among its
        rows), and each DP runs once over the rows of all the blocks."""
        nd = dets.to(torch.int32).sum(dim=1)
        p, w = self.light.decode_device_weighted(dets)
        hidx, exact = self._served(nd)
        p_heavy, w_heavy = self.heavy.decode_device_weighted(
            dets.index_select(0, hidx))
        is_heavy = nd.index_select(0, hidx) > self.k_light
        pred = p.index_copy(0, hidx, torch.where(is_heavy, p_heavy,
                                                 p.index_select(0, hidx)))
        weight = w.index_copy(0, hidx, torch.where(is_heavy, w_heavy,
                                                   w.index_select(0, hidx)))
        tier = torch.zeros_like(pred).index_copy(0, hidx,
                                                 is_heavy.to(torch.int32))
        return pred, tier, weight, exact

    def decode_device(self, dets: torch.Tensor) -> torch.Tensor:
        """(S, n_det) on the device -> (S,) int32, chunk by chunk, no host
        sync."""
        return self.decode_device_tiered(dets)[0]

    def decode_batch(self, detectors) -> np.ndarray:
        t0 = time.perf_counter()
        out = _decode_host(self.decode_device, detectors, self.chunk,
                           self.device)
        self.last_decode_seconds = time.perf_counter() - t0
        return out

    def exact_rows(self, dets: torch.Tensor) -> torch.Tensor:
        """(S,) bool on the device: the shots decoded with all their defects
        (at most K_light, or a heavy shot the chunk's capacity served with
        at most K_heavy), chunk by chunk as decode_device selects them."""
        return self._served(dets.to(torch.int32).sum(dim=1))[1]

    def overflow_fraction(self, detectors) -> float:
        """Shots decoded with a truncated defect set: more than K_heavy
        defects, or heavy shots past the per-chunk capacity."""
        dets = torch.as_tensor(np.array(detectors, dtype=np.uint8))
        if dets.shape[0] == 0:
            return 0.0
        return float((~self.exact_rows(dets)).to(torch.float64).mean())


def exact_matcher_for_circuit(circuit, max_defects: int = 12,
                              chunk: int = 8192, hybrid: bool = False,
                              device: Union[str, torch.device] = "cuda"):
    edges, probs, obs = _edges_of(circuit)
    cls = HybridMatcher if hybrid else ExactMatcher
    return cls(circuit.n_detectors, edges, probs, obs,
               max_defects=max_defects, chunk=chunk, device=device)


def tiered_matcher_for_circuit(circuit, k_light: int = 6, k_heavy: int = 12,
                               chunk: int = 8192,
                               heavy_capacity: Optional[int] = None,
                               device: Union[str, torch.device] = "cuda"):
    edges, probs, obs = _edges_of(circuit)
    return TieredMatcher(circuit.n_detectors, edges, probs, obs,
                         k_light=k_light, k_heavy=k_heavy, chunk=chunk,
                         heavy_capacity=heavy_capacity, device=device)


__all__ = ["ExactMatcher", "HybridMatcher", "TieredMatcher",
           "exact_matcher_for_circuit", "tiered_matcher_for_circuit"]
