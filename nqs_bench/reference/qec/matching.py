"""Exact minimum-weight matching of each logical class, plain numpy.

`class_weights(dist, dets)` gives, for every shot, W0 and W1: the least
weight of a matching of the shot's defects (each defect to another defect or
to the boundary, along the least path of either parity, `surface_model.
least_paths`) whose observable parity is 0 and 1. A decoder that is exact
predicts a class of least weight, and its matching weighs min(W0, W1).

The subset DP keeps both parities: for a set S of defects and its lowest
defect i,

    dp[c][S] = min( dp[c ^ q][S - {i}] + w_q(i, boundary),
                    min_{j in S, j > i} dp[c ^ q][S - {i, j}] + w_q(i, j) )

over q in {0, 1}, from dp[0][{}] = 0, dp[1][{}] = inf. The sets are taken by
popcount, each level one numpy operation a (partner, parity) pair over all
its sets and all the shots that have as many defects. Shots are grouped by
their defect count; a shot with more than BATCHED defects runs alone (2^n
sets of it), and one with more than MAX_DEFECTS is refused. Departures from
the textbook DP: the vectorisation alone. No kernel, no cache of shots, no
pruning."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .surface_model import rounded

BATCHED = 12
MAX_DEFECTS = 22
# the sets a batch of shots holds at most (2^n x rows)
BATCH_SETS = 1 << 22


def _levels(n: int):
    """For each popcount k = 1..n: (masks (L,), lowest set bit (L,))."""
    masks = np.arange(1 << n, dtype=np.int64)
    pop = np.zeros(1 << n, np.int64)
    for b in range(n):
        pop += (masks >> b) & 1
    low = np.zeros(1 << n, np.int64)
    for b in range(n - 1, -1, -1):
        low = np.where((masks >> b) & 1, b, low)
    return [(masks[pop == k], low[pop == k]) for k in range(1, n + 1)]


def _group(dist: np.ndarray, nodes: np.ndarray, boundary: int,
           rounding: Optional[torch.dtype]) -> np.ndarray:
    """(R, 2) class weights of R shots of n defects each, nodes (R, n)."""
    R, n = nodes.shape
    dp = np.full((2, 1 << n, R), np.inf)
    dp[0, 0] = 0.0
    if n == 0:
        return dp[:, 0].T.copy()
    pair = dist[:, nodes[:, :, None], nodes[:, None, :]]      # (2, R, n, n)
    bnd = dist[:, nodes, boundary]                           # (2, R, n)
    for masks, i in _levels(n):
        best = np.full((2, len(masks), R), np.inf)
        rest = masks ^ (1 << i)
        moves = [(rest, bnd[:, :, i].transpose(0, 2, 1), slice(None))]
        for j in range(n):
            sel = (((masks >> j) & 1) == 1) & (j > i)
            if sel.any():
                moves.append((rest[sel] ^ (1 << j),
                              pair[:, :, i[sel], j].transpose(0, 2, 1), sel))
        for prev, w, sel in moves:
            for c in (0, 1):
                for q in (0, 1):
                    cand = rounded(dp[c ^ q, prev] + w[q], rounding)
                    best[c, sel] = np.minimum(best[c, sel], cand)
        dp[:, masks] = best
    return dp[:, (1 << n) - 1].T.copy()


def class_weights(dist: np.ndarray, dets: np.ndarray,
                  rounding: Optional[torch.dtype] = None) -> np.ndarray:
    """(S, 2) float64: [s, c] the least weight of a matching of shot s's
    defects whose observable parity is c (inf where there is none). dist is
    `least_paths`' (2, n_det + 1, n_det + 1), the boundary last; dets (S,
    n_det) 0/1. With `rounding`, every sum is rounded to it."""
    dets = np.asarray(dets) != 0
    S, n_det = dets.shape
    counts = dets.sum(axis=1)
    if S and counts.max() > MAX_DEFECTS:
        raise ValueError(f"a shot has {counts.max()} defects; the exact DP stops "
                         f"at {MAX_DEFECTS}")
    out = np.empty((S, 2))
    for n in np.unique(counts):
        rows = np.nonzero(counts == n)[0]
        nodes = np.nonzero(dets[rows])[1].reshape(len(rows), n)
        step = 1 if n > BATCHED else max(1, BATCH_SETS >> n)
        for a in range(0, len(rows), step):
            out[rows[a:a + step]] = _group(dist, nodes[a:a + step], n_det, rounding)
    return out
