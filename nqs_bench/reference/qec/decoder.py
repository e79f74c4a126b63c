"""A plain decoder of a DEM: flooding normalized min-sum BP, a damped retry,
OSD-0. PyTorch (float32) for BP, numpy for OSD-0; nothing of the program.

BP on the Tanner graph of H (checks: detectors; variables: mechanisms, prior
LLR log((1 - p) / p)). One iteration updates every message at once:

  check -> variable   r_e = scale * (1 - 2 s_c) * prod_{e' != e} sign(q_e')
                            * min_{e' != e} |q_e'|      (sign(0) = +1)
  variable -> check   q_e = llr_v + sum_{e' at v, e' != e} r_e'

starting from q_e = llr_v. After `iters` variable updates, one more check
update gives the beliefs llr_v + sum_e r_e, and the hard decision is
belief < 0. Damping g blends each new q with the last, q <- (1 - g) q_new + g q.

`decode` runs the configuration's tiers:
  1. `fast_iters` undamped iterations on every shot;
  2. the shots whose hard decision misses the syndrome run again from
     scratch, damped by `retry_damping`, for up to `retry_iters` iterations,
     each shot stopping at the first iteration whose hard decision (its
     beliefs after one more check update) matches;
  3. OSD-0 (`osd0`) on the shots that still miss, from their last beliefs.
Each shot's reliability is the least |belief| of the beliefs it was decided
from: a soft output that the precision of the messages moves where the hard
decisions rarely differ.
Where it departs from the program: the program's first tier is bfloat16, this
one float32 throughout; the program's retry runs every iteration on a fixed
capacity of rows (the rest go to OSD-0), this one stops each shot at its first
match and takes every shot that misses.

`rounding`, for the control only, rounds every message (q and r) to a
narrower type, such as torch.float8_e4m3fn.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 16384            # shots a BP pass holds at once
FP8_MAX = 448.0          # the largest finite float8_e4m3fn


class Graph:
    """The Tanner graph of H on `device`: edges in row-major order of H;
    each check's edges, and each variable's, padded to the largest degree
    with the index E (a zero message)."""

    def __init__(self, H: np.ndarray, probs: np.ndarray, device):
        chk, var = np.nonzero(H)
        self.m, self.n = H.shape
        self.E = len(chk)
        t = dict(device=device)
        self.var = torch.as_tensor(var, **t)
        self.slots = torch.as_tensor(_padded(chk, self.m, self.E), **t)      # (m, w)
        self.pad = self.slots == self.E
        order = np.argsort(var, kind="stable")
        self.vslots = torch.as_tensor(_padded(var[order], self.n, self.E, order), **t)
        self.llr = torch.as_tensor(np.log((1.0 - probs) / probs), dtype=torch.float32, **t)
        self.Ht = torch.as_tensor(H.T, dtype=torch.float32, **t)


def _padded(owner: np.ndarray, rows: int, E: int, edges=None) -> np.ndarray:
    """(rows, max degree) of the edges of each row (`edges`, sorted by
    their `owner`), padded with E."""
    edges = np.arange(len(owner)) if edges is None else edges
    deg = np.bincount(owner, minlength=rows)
    out = np.full((rows, int(deg.max())), E, np.int64)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    for i in range(rows):
        out[i, :deg[i]] = edges[start[i]:start[i] + deg[i]]
    return out


def _round(x: torch.Tensor, rounding) -> torch.Tensor:
    if rounding is None:
        return x
    return x.clamp(-FP8_MAX, FP8_MAX).to(rounding).to(torch.float32)


def _zero_padded(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.zeros((x.shape[0], 1), device=x.device)], dim=1)


def _check_update(g: Graph, q: torch.Tensor, sgn_syn: torch.Tensor, scale: float,
                  rounding) -> torch.Tensor:
    """r (S, E) from q (S, E); sgn_syn (S, m) = 1 - 2 s."""
    qp = _zero_padded(q)[:, g.slots]                                  # (S, m, w)
    mag = torch.where(g.pad, torch.inf, qp.abs())
    neg = (qp < 0) & ~g.pad
    sign = sgn_syn * (1.0 - 2.0 * (neg.sum(dim=2) % 2).float())      # (S, m)
    m1, at = mag.min(dim=2)
    m2 = mag.scatter(2, at[:, :, None], torch.inf).min(dim=2).values
    own = torch.zeros_like(neg).scatter_(2, at[:, :, None], True)
    ext = torch.where(own, m2[:, :, None], m1[:, :, None])
    r = scale * sign[:, :, None] * (1.0 - 2.0 * neg.float()) * ext
    # the unpadded slots in row-major order are the edges in order
    return _round(r[:, ~g.pad], rounding)


def _beliefs(g: Graph, r: torch.Tensor) -> torch.Tensor:
    return g.llr + _zero_padded(r)[:, g.vslots].sum(dim=2)


def _matches(g: Graph, belief: torch.Tensor, syn: torch.Tensor) -> torch.Tensor:
    hard = (belief < 0).float()
    return (((hard @ g.Ht).to(torch.int64) & 1) == syn.to(torch.int64)).all(dim=1)


def bp(g: Graph, syn: torch.Tensor, iters: int, scale: float, damping: float = 0.0,
       stop: bool = False, rounding=None):
    """(beliefs (S, n), matched (S,) bool) of syn (S, m) 0/1 float32 after
    `iters` variable updates; with `stop`, each shot's beliefs are those of
    the first pass whose hard decision matches its syndrome."""
    sgn_syn = 1.0 - 2.0 * syn
    q = _round(g.llr[g.var].expand(syn.shape[0], g.E), rounding)
    best = None
    done = torch.zeros(syn.shape[0], dtype=torch.bool, device=syn.device)
    for it in range(iters + 1):
        r = _check_update(g, q, sgn_syn, scale, rounding)
        belief = _beliefs(g, r)
        if stop or it == iters:
            if best is None:
                best = belief
            else:
                best = torch.where(done[:, None], best, belief)
            done = done | _matches(g, belief, syn)
            if stop and bool(done.all()):
                break
        if it < iters:
            q_new = _round(belief[:, g.var] - r, rounding)
            q = q_new if not damping else _round((1.0 - damping) * q_new + damping * q, rounding)
    return best, done


def osd0(H: np.ndarray, syn: np.ndarray, belief: np.ndarray) -> np.ndarray:
    """OSD-0 of one shot: the columns of H visited in ascending belief (ties
    by index), each taken as a pivot where it is independent of those before
    it; the solution of H e = syn supported on the pivot columns."""
    order = np.argsort(belief, kind="stable")
    A = np.concatenate([H[:, order], syn[:, None]], axis=1).astype(bool)
    m, n = H.shape
    pivots, r = [], 0
    for c in range(n):
        if r == m:
            break
        hit = np.nonzero(A[r:, c])[0]
        if hit.size == 0:
            continue
        p = r + hit[0]
        A[[r, p]] = A[[p, r]]
        rows = np.nonzero(A[:, c])[0]
        rows = rows[rows != r]
        A[rows] ^= A[r]
        pivots.append(c)
        r += 1
    e = np.zeros(n, np.uint8)
    for i, c in enumerate(pivots):
        e[order[c]] = A[i, n]
    return e


def _chunked(g: Graph, syn: torch.Tensor, *args, **kw):
    """`bp` over the shots of syn, CHUNK at a time."""
    out = [bp(g, syn[i:i + CHUNK], *args, **kw) for i in range(0, syn.shape[0], CHUNK)]
    return torch.cat([b for b, _ in out]), torch.cat([d for _, d in out])


def corrections(model, dets: torch.Tensor, device, rounding=None):
    """(corrections (S, n_mech) uint8, tier (S,) int64, reliability (S,)
    float32), all on `device`: each shot's estimated mechanisms, from its
    detectors (S, n_det) 0/1 under the configuration's decoder settings; the
    tier that decided it (0: the first BP tier, 1: the retry, 2: OSD-0);
    and the reliability of the beliefs it was decided from, their least
    |belief|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = model.config["decoder"]
    scale = float(st["scale"])
    g = Graph(model.H, model.probs, device)
    syn = dets.to(device=device, dtype=torch.float32)
    bel, ok = _chunked(g, syn, int(st["fast_iters"]), scale, rounding=rounding)
    hard = (bel < 0).to(torch.uint8)
    tier = (~ok).to(torch.int64)
    miss = torch.nonzero(~ok)[:, 0]
    if len(miss):
        s = syn[miss]
        bel_m, ok = _chunked(g, s, int(st["retry_iters"]), scale, float(st["retry_damping"]),
                             stop=True, rounding=rounding)
        bel[miss] = bel_m
        hard[miss] = (bel_m < 0).to(torch.uint8)
        rest = torch.nonzero(~ok)[:, 0]
        if len(rest):
            tier[miss[rest]] = 2
            s_h = s[rest].to(torch.uint8).cpu().numpy()
            b_h = bel_m[rest].cpu().numpy()
            est = np.stack([osd0(model.H, s_h[j], b_h[j]) for j in range(len(rest))])
            hard[miss[rest]] = torch.as_tensor(est, device=device)
    return hard, tier, bel.abs().amin(dim=1)


def flips(model, hard: torch.Tensor) -> np.ndarray:
    """(S,) int64: the observable flips of corrections (S, n_mech), packed
    (bit b: observable b)."""
    obs = torch.as_tensor(model.obs.T, dtype=torch.float32, device=hard.device)
    bits = ((hard.float() @ obs).to(torch.int64) & 1).cpu().numpy()
    return (bits << np.arange(model.k)).sum(axis=1)


def decode(model, dets: torch.Tensor, device, rounding=None):
    """(pred, tier, reliability) on the host, (S,) each: each shot's
    predicted observable flips, packed (bit b: observable b), and
    `corrections`' tier and reliability."""
    hard, tier, rel = corrections(model, dets, device, rounding)
    return flips(model, hard), tier.cpu().numpy(), rel.cpu().numpy().astype(np.float64)
