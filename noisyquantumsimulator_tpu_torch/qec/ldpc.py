"""Quantum LDPC codes: bivariate-bicycle (BB) construction + BP decoding.

Counterpart of the reference's `qec/ldpc.py`. The code construction,
`_osd0`, `build_slot_tables` and `bb_memory_circuit` are host numpy, copied
unchanged. The BP decoders are torch functions on tensors: every shot's
message passing runs in lockstep on the tensors' device.

Bivariate bicycle codes (Bravyi et al., Nature 627, 778 (2024), public
construction): on the group Z_l x Z_m with cyclic shift matrices
x = S_l (x) I_m, y = I_l (x) S_m, pick polynomials

    A = x^a1 + y^a2 + y^a3      B = y^b1 + x^b2 + x^b3

then Hx = [A | B], Hz = [B^T | A^T] is a CSS code on n = 2 l m qubits.
The [[144, 12, 12]] "gross code" uses l=12, m=6,
A = x^3 + y + y^2, B = y^3 + x + x^2.

The slot-layout min-sum (`_bp_slots`) runs its check-node update through
kernel K3 (`bp_cuda.c2v`) and its variable-node update through
`bp_cuda.v2c` on CUDA tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import bp_cuda


# =============================================================================
# construction
# =============================================================================

def _shift(n: int, k: int) -> np.ndarray:
    return np.roll(np.eye(n, dtype=np.uint8), k, axis=1)


def bb_code(l: int, m: int, a_powers: Tuple[int, int, int],
            b_powers: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Bivariate bicycle parity checks (Hx, Hz), each (l*m, 2*l*m) uint8.

    a_powers = (a1, a2, a3): A = x^a1 + y^a2 + y^a3
    b_powers = (b1, b2, b3): B = y^b1 + x^b2 + x^b3
    """
    Il, Im = np.eye(l, dtype=np.uint8), np.eye(m, dtype=np.uint8)
    x = np.kron(_shift(l, 1), Im)
    y = np.kron(Il, _shift(m, 1))

    def mpow(M, k):
        out = np.eye(l * m, dtype=np.uint8)
        for _ in range(k % (l * m)):
            out = (out @ M) % 2
        return out

    A = (mpow(x, a_powers[0]) ^ mpow(y, a_powers[1]) ^ mpow(y, a_powers[2]))
    B = (mpow(y, b_powers[0]) ^ mpow(x, b_powers[1]) ^ mpow(x, b_powers[2]))
    Hx = np.concatenate([A, B], axis=1) % 2
    Hz = np.concatenate([B.T, A.T], axis=1) % 2
    return Hx.astype(np.uint8), Hz.astype(np.uint8)


def gross_code() -> Tuple[np.ndarray, np.ndarray]:
    """The [[144, 12, 12]] bivariate bicycle code."""
    return bb_code(12, 6, (3, 1, 2), (3, 1, 2))


def small_bb_code() -> Tuple[np.ndarray, np.ndarray]:
    """[[72, 12, 6]] BB code (l=6, m=6, A=x^3+y+y^2, B=y^3+x+x^2)."""
    return bb_code(6, 6, (3, 1, 2), (3, 1, 2))


def css_n_k(Hx: np.ndarray, Hz: np.ndarray) -> Tuple[int, int]:
    """(n, k) from parity-check ranks over GF(2)."""
    def rank2(M):
        M = M.copy() % 2
        r = 0
        rows, cols = M.shape
        for c in range(cols):
            piv = None
            for i in range(r, rows):
                if M[i, c]:
                    piv = i
                    break
            if piv is None:
                continue
            M[[r, piv]] = M[[piv, r]]
            for i in range(rows):
                if i != r and M[i, c]:
                    M[i] ^= M[r]
            r += 1
        return r
    n = Hx.shape[1]
    k = n - rank2(Hx) - rank2(Hz)
    return n, k


def check_css(Hx: np.ndarray, Hz: np.ndarray) -> bool:
    """CSS condition Hx Hz^T = 0 (mod 2)."""
    return not np.any((Hx.astype(int) @ Hz.T.astype(int)) % 2)


def logical_operators(Hx: np.ndarray, Hz: np.ndarray) -> np.ndarray:
    """Z-type logical operators: basis of ker(Hx) / rowspace(Hz).
    Returns (k, n) uint8."""
    n = Hx.shape[1]

    def row_reduce(M):
        M = M.copy() % 2
        pivots = []
        r = 0
        for c in range(M.shape[1]):
            piv = next((i for i in range(r, M.shape[0]) if M[i, c]), None)
            if piv is None:
                continue
            M[[r, piv]] = M[[piv, r]]
            for i in range(M.shape[0]):
                if i != r and M[i, c]:
                    M[i] ^= M[r]
            pivots.append(c)
            r += 1
        return M[:r], pivots

    # kernel of Hx
    R, piv = row_reduce(Hx)
    free = [c for c in range(n) if c not in piv]
    kernel = []
    for f in free:
        v = np.zeros(n, dtype=np.uint8)
        v[f] = 1
        for r_i, c in enumerate(piv):
            if R[r_i, f]:
                v[c] = 1
        kernel.append(v)
    kernel = np.array(kernel, dtype=np.uint8)
    # quotient by rowspace(Hz): keep kernel vectors independent of Hz rows
    Rz, _ = row_reduce(Hz)
    basis = list(Rz)
    logicals = []
    for v in kernel:
        aug = np.array(basis + [v], dtype=np.uint8)
        r_before = row_reduce(np.array(basis, dtype=np.uint8))[0].shape[0] \
            if basis else 0
        r_after = row_reduce(aug)[0].shape[0]
        if r_after > r_before:
            basis.append(v)
            logicals.append(v)
    return np.array(logicals, dtype=np.uint8)


# =============================================================================
# min-sum BP decoder (vectorized over shots)
# =============================================================================

@dataclass
class BPDecoder:
    """Min-sum belief propagation on the Tanner graph of H, batched over
    shots on `device`."""
    H: np.ndarray
    error_prob: float = 1e-3
    n_iters: int = 30
    scale: float = 0.75     # normalized min-sum damping
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        H = np.asarray(self.H, dtype=np.uint8)
        self.m, self.n = H.shape
        self.device = torch.device(self.device)
        self._H = torch.as_tensor(H.astype(np.float32), device=self.device)
        self._Hmask = torch.as_tensor(H.astype(bool), device=self.device)
        self._llr0 = float(np.log((1 - self.error_prob) / self.error_prob))

    def _fn(self, syn: torch.Tensor):
        return _bp_batch(syn, self._H, self._Hmask, self._llr0, self.n_iters,
                         self.scale)

    def decode_batch(self, syndromes) -> np.ndarray:
        """syndromes (S, m) uint8 -> estimated error (S, n) uint8."""
        e, _ = self._decode_with_beliefs(syndromes)
        return e

    def decode_batch_osd(self, syndromes) -> np.ndarray:
        """BP + OSD-0 fallback (the standard qLDPC combination): shots whose
        BP estimate does not reproduce the syndrome are re-decoded by
        ordered-statistics: pick an information set of the most-suspect
        columns (ranked by BP beliefs) and solve H e = s exactly."""
        syndromes = np.asarray(syndromes, dtype=np.uint8)
        est, beliefs = self._decode_with_beliefs(syndromes)
        resid = (syndromes ^ (est @ self.H.T % 2).astype(np.uint8))
        bad = np.nonzero(resid.any(axis=1))[0]
        H = np.asarray(self.H, dtype=np.uint8)
        for s_i in bad:
            est[s_i] = _osd0(H, syndromes[s_i], beliefs[s_i])
        return est

    def _decode_with_beliefs(self, syndromes):
        syn = torch.as_tensor(np.asarray(syndromes, dtype=np.float32),
                              device=self.device)
        e, b = self._fn(syn)
        return e.cpu().numpy().astype(np.uint8), b.cpu().numpy()


def _osd0(H: np.ndarray, s: np.ndarray, belief: np.ndarray) -> np.ndarray:
    """Order columns by reliability (ascending belief = most suspect first),
    Gaussian-eliminate [H | s] over GF(2) restricted to that order, back-
    substitute a solution supported on the selected pivot columns.

    Rows are bit-packed into uint64 words: eliminations are whole-row
    XORs on (m, W) word arrays instead of per-byte loops (~50x faster on
    the DEM-sized systems where OSD is the BP fallback hot path)."""
    m, n = H.shape
    order = np.argsort(belief, kind="stable")   # most suspect first;
    # stable tie-break matches the C++ osd0_batch (a<b on equal beliefs)
    bits = np.concatenate([H[:, order], s[:, None]],
                          axis=1).astype(np.uint64)
    W = (n + 1 + 63) // 64
    A = np.zeros((m, W), np.uint64)
    for w in range(W):
        seg = bits[:, w * 64:(w + 1) * 64]
        shifts = np.arange(seg.shape[1], dtype=np.uint64)
        A[:, w] = np.bitwise_or.reduce(seg << shifts[None, :], axis=1)
    one = np.uint64(1)
    pivots = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        w, b = divmod(c, 64)
        b = np.uint64(b)
        nz = np.nonzero((A[r:, w] >> b) & one)[0]
        if nz.size == 0:
            continue
        piv = r + int(nz[0])
        if piv != r:
            A[[r, piv]] = A[[piv, r]]
        hit = ((A[:, w] >> b) & one).astype(bool)
        hit[r] = False
        A[hit] ^= A[r]
        pivots.append(c)
        r += 1
    sw, sb = divmod(n, 64)
    sb = np.uint64(sb)
    e_perm = np.zeros(n, dtype=np.uint8)
    for r_i, c in enumerate(pivots):
        e_perm[c] = np.uint8((A[r_i, sw] >> sb) & one)
    e = np.zeros(n, dtype=np.uint8)
    e[order] = e_perm
    return e


def _dense_c2v(msg_v2c, mask, sgn_syn, scale):
    """Check-to-variable messages of the dense (S, m, n) form."""
    n = msg_v2c.shape[2]
    sgn = torch.where(mask[None], torch.sign(msg_v2c), 1.0)
    # an exactly-zero message must not zero the whole check product
    sgn = torch.where(sgn == 0, 1.0, sgn)
    full_sgn = torch.prod(sgn, dim=2, keepdim=True) * sgn_syn[:, :, None]
    mag = torch.where(mask[None], msg_v2c.abs(), math.inf)
    min1 = mag.amin(dim=2, keepdim=True)
    # extrinsic min: exclude exactly ONE argmin entry (ties must see each
    # other's value, not the second-distinct minimum)
    is_min = torch.nn.functional.one_hot(mag.argmin(dim=2), n).bool()
    min2 = torch.where(is_min, math.inf, mag).amin(dim=2, keepdim=True)
    ext_min = torch.where(is_min, min2, min1)
    ext_sgn = full_sgn / sgn
    return torch.where(mask[None], scale * ext_sgn * ext_min, 0.0)


def _bp_batch(syn, H, mask, llr0, n_iters, scale):
    """Normalized min-sum over (S, m, n) message tensors."""
    S = syn.shape[0]
    m, n = H.shape
    sgn_syn = 1.0 - 2.0 * syn                       # (S, m) in {+1,-1}
    msg_v2c = torch.where(mask, llr0, 0.0).to(syn.dtype).expand(S, m, n)
    for _ in range(n_iters):
        msg_c2v = _dense_c2v(msg_v2c, mask, sgn_syn, scale)
        total = llr0 + msg_c2v.sum(dim=1, keepdim=True)      # (S, 1, n)
        msg_v2c = torch.where(mask[None], total - msg_c2v, 0.0)
    # final check->variable pass and total beliefs
    msg_c2v = _dense_c2v(msg_v2c, mask, sgn_syn, scale)
    belief = llr0 + msg_c2v.sum(dim=1)              # (S, n)
    return (belief < 0).to(torch.uint8), belief


# =============================================================================
# code-capacity memory experiment for BB codes
# =============================================================================

@dataclass
class LDPCMemoryResult:
    n: int
    k: int
    p: float
    shots: int
    p_logical_shot: float
    syndrome_weight_mean: float
    decoder_converged_frac: float


def run_bb_memory(Hx: Optional[np.ndarray] = None,
                  Hz: Optional[np.ndarray] = None,
                  p: float = 1e-2, shots: int = 2000, seed: int = 0,
                  n_iters: int = 50,
                  device: Union[str, torch.device] = "cuda"
                  ) -> LDPCMemoryResult:
    """Code-capacity X-error memory test of a BB code:
    sample iid X errors (host numpy, from `seed`), decode with BP on Hz
    (Z checks see X errors) on `device`, count logical failures against the
    Z-type logical operators."""
    if Hx is None or Hz is None:
        Hx, Hz = small_bb_code()
    n, k = css_n_k(Hx, Hz)
    Lz = logical_operators(Hx, Hz)
    # X errors are detected by Hz; logical failure iff the residual
    # anticommutes with a Z-logical: parity Lz . e
    rng = np.random.default_rng(seed)
    errors = (rng.random((shots, Hx.shape[1])) < p).astype(np.uint8)
    syndromes = (errors @ Hz.T) % 2

    dec = BPDecoder(Hz, error_prob=p, n_iters=n_iters, device=device)
    est = dec.decode_batch_osd(syndromes)
    residual = errors ^ est
    # converged = residual has zero syndrome
    resid_syn = (residual @ Hz.T) % 2
    converged = ~resid_syn.any(axis=1)
    flips = (residual @ Lz.T) % 2 if len(Lz) else np.zeros((shots, 1))
    fail = (flips.any(axis=1)) | (~converged)
    return LDPCMemoryResult(
        n=n, k=k, p=p, shots=shots,
        p_logical_shot=float(fail.mean()),
        syndrome_weight_mean=float(syndromes.mean()),
        decoder_converged_frac=float(converged.mean()))


# =============================================================================
# sparse (edge-list) min-sum BP — for DEM graphs with thousands of
# variables, where the dense (S, m, n) message tensor would not fit
# =============================================================================

def _bp_edges(syn, chk, var, llr_var, n_chk, n_var, n_iters, scale):
    """Edge-list normalized min-sum.

    syn (S, n_chk) float32 in {0,1}; chk/var (E,) int64 endpoint indices;
    llr_var (n_var,) priors. Messages live per edge: (S, E) tensors only.
    Returns (hard (S, n_var) uint8, beliefs (S, n_var))."""
    S = syn.shape[0]
    E = chk.shape[0]
    dt = syn.dtype
    sgn_syn = 1.0 - 2.0 * syn                       # (S, n_chk)
    idx = chk[None].expand(S, E)
    msg_vc = llr_var[var][None].expand(S, E)

    def seg(reduce, src, init):
        out = torch.full((S, n_chk), init, dtype=dt, device=syn.device)
        return out.scatter_reduce(1, idx, src, reduce, include_self=True)

    def c2v(msg_vc):
        sgn = torch.sign(msg_vc)
        sgn = torch.where(sgn == 0, 1.0, sgn)
        mag = msg_vc.abs()
        # per-check sign product and two-smallest magnitudes
        prod = seg("prod", sgn, 1.0)
        m1 = seg("amin", mag, math.inf)
        is1 = mag == m1[:, chk]
        cnt = seg("sum", is1.to(dt), 0.0)
        m2 = seg("amin", torch.where(is1, math.inf, mag), math.inf)
        ext_min = torch.where(is1 & (cnt[:, chk] == 1.0), m2[:, chk],
                              m1[:, chk])
        ext_sgn = (prod * sgn_syn)[:, chk] / sgn
        return scale * ext_sgn * ext_min            # msg_cv (S, E)

    def v2c(msg_cv):
        tot = torch.zeros((S, n_var), dtype=dt, device=syn.device)
        total = llr_var[None, :] + tot.index_add(1, var, msg_cv)
        return total[:, var] - msg_cv, total

    for _ in range(n_iters):
        msg_vc, _ = v2c(c2v(msg_vc))
    _, belief = v2c(c2v(msg_vc))
    return (belief < 0).to(torch.uint8), belief


def build_slot_tables(chk: np.ndarray, var: np.ndarray, n_chk: int,
                      n_var: int) -> Dict[str, np.ndarray]:
    """Host precompute for _bp_slots: dense slot layouts of the Tanner
    edge list, SLOT-MAJOR for the shots-last kernel.

    Check layout: edge e sits at flat position slot * n_chk + c, so a
    (Ec, S) message tensor reshapes to (w_max, n_chk, S) by splitting its
    MAJOR axis — layout-preserving on TPU, and the per-check reduction
    runs over axis 0 with the shot axis untouched in the lanes. Padding
    positions point to a sentinel. Var layout: (n_var, d_max) of flat
    check-layout positions. Returns int32 index tables + pad masks."""
    E = chk.shape[0]
    deg_c = np.bincount(chk, minlength=n_chk)
    deg_v = np.bincount(var, minlength=n_var)
    w_max = int(deg_c.max()) if E else 1
    d_max = int(deg_v.max()) if E else 1
    Ec = n_chk * w_max
    # slot of each edge within its check / its variable
    slot_c = np.zeros(E, np.int64)
    slot_v = np.zeros(E, np.int64)
    cnt_c = np.zeros(n_chk, np.int64)
    cnt_v = np.zeros(n_var, np.int64)
    for e in range(E):
        slot_c[e] = cnt_c[chk[e]]
        cnt_c[chk[e]] += 1
        slot_v[e] = cnt_v[var[e]]
        cnt_v[var[e]] += 1
    pos_c = slot_c * n_chk + chk                     # flat check-layout pos
    pad_c = np.ones(Ec, bool)
    pad_c[pos_c] = False
    var_of_cpos = np.zeros(Ec, np.int64)             # variable behind a pos
    var_of_cpos[pos_c] = var
    # var layout: (n_var, d_max) of check-layout positions; padding points
    # at position Ec (a sentinel slot appended by the kernel with value 0)
    cpos_of_vslot = np.full((n_var, d_max), Ec, np.int64)
    cpos_of_vslot[var, slot_v] = pos_c
    return dict(w_max=w_max, d_max=d_max, Ec=Ec,
                pad_c=pad_c, var_of_cpos=var_of_cpos.astype(np.int32),
                cpos_of_vslot=cpos_of_vslot.astype(np.int32))


def slot_tables_on(tables: Dict, device) -> Dict:
    """`build_slot_tables`'s index tables as tensors on `device` (int64
    indices, bool pad mask). Build once, outside any timed loop: turning
    the numpy tables into device tensors is a host->device copy."""
    device = torch.device(device)
    out = {k: tables[k] for k in ("w_max", "d_max", "Ec")}
    out["pad_c"] = torch.as_tensor(tables["pad_c"], device=device)
    out["var_of_cpos"] = torch.as_tensor(
        tables["var_of_cpos"].astype(np.int64), device=device)
    out["cpos_of_vslot"] = torch.as_tensor(
        tables["cpos_of_vslot"].astype(np.int64).reshape(-1), device=device)
    return out


def _bp_slots(syn, llr_var, tables, n_chk, n_var, n_iters, scale,
              dtype=torch.float32, damping: float = 0.0):
    """Normalized min-sum BP in dense check-slot layout.

    Same message schedule and per-check min1/min2 extrinsic rule as
    _bp_edges, but messages live SHOTS-LAST in a dense (w_max * n_chk, S)
    tensor: the per-check reduction is over the major axis of a trivial
    (w_max, n_chk, S) reshape, and the two layout changes per iteration
    are static row gathers of contiguous S-long rows. The check-node update
    is kernel K3 (`bp_cuda.c2v`), the variable-node update and the beliefs
    the kernel `bp_cuda.v2c`, on CUDA tensors; their plain twins on CPU
    tensors. The variable side updates the messages in place.

    syn (S, n_chk) float32 in {0,1}; llr_var (n_var,) priors; `tables`
    from build_slot_tables (numpy, converted here) or slot_tables_on
    (already on syn's device). Returns (hard (S, n_var) uint8, beliefs
    (S, n_var) float32) — same contract as _bp_edges.

    dtype=bfloat16 halves the message bandwidth (BP is memory-bound).
    Callers that keep a bf16 result only after an EXACT residual-syndrome
    check (DemBPDecoder's tiering does) lose no correctness guarantee,
    only the occasional extra retry.

    damping > 0 blends each new variable->check message with the previous
    iterate, msg <- (1-g)*new + g*old ("min-sum with memory"): plain
    min-sum oscillates on the short cycles of a circuit-level DEM Tanner
    graph, and the memory term breaks the oscillation. Costs one extra
    read of the messages per iteration; meant for the small compacted
    retry tier.
    """
    S = syn.shape[0]
    if not isinstance(tables["pad_c"], torch.Tensor):
        tables = slot_tables_on(tables, syn.device)
    elif tables["pad_c"].device != syn.device:
        raise ValueError(f"slot tables on {tables['pad_c'].device}, syndromes "
                         f"on {syn.device}")
    w_max, Ec = tables["w_max"], tables["Ec"]
    llr_var = llr_var.to(dtype)
    sgn_syn = (1.0 - 2.0 * syn.T).to(dtype).contiguous()       # (n_chk, S)
    # padding slots of the check layout hold +big from here on: the
    # variable side never writes them
    llr_pos = torch.where(tables["pad_c"], bp_cuda.BIG,
                          llr_var[tables["var_of_cpos"]])
    msg_vc = llr_pos[:, None].expand(Ec, S).contiguous()

    def c2v(msg_vc):
        m3 = msg_vc.view(w_max, n_chk, S)
        return bp_cuda.c2v(m3, sgn_syn, scale).view(Ec, S)

    for _ in range(n_iters):
        bp_cuda.v2c(c2v(msg_vc), llr_var, tables, msg_vc, damping)
    belief = bp_cuda.v2c(c2v(msg_vc), llr_var, tables).T
    return (belief < 0).to(torch.uint8), belief.float()


# =============================================================================
# circuit-level BB memory (syndrome-extraction circuits + DEM-BP decoding)
# =============================================================================

def bb_memory_circuit(Hx: Optional[np.ndarray] = None,
                      Hz: Optional[np.ndarray] = None,
                      rounds: int = 3, p: float = 1e-3,
                      p_meas: Optional[float] = None) -> "Circuit":
    """Circuit-level memory-Z experiment for a CSS/BB code.

    Data qubits 0..n-1, one ancilla per Z check. Every round: reset
    ancillas, CX(data -> ancilla) over each check's (non-local) support
    with two-qubit depolarizing noise per gate, measure+reset ancillas
    with flip noise; detectors compare consecutive rounds. Final
    transversal Z measurement closes the boundary detectors; observables
    are the Z-logical operators.

    Non-locality is free in the Circuit IR — the movement cost of these
    long-range CXs is priced separately by ldpc_layout.plan_bb_extraction.
    """
    from .circuits import Circuit

    if Hx is None or Hz is None:
        Hx, Hz = small_bb_code()
    Hx = np.asarray(Hx, np.uint8)
    Hz = np.asarray(Hz, np.uint8)
    p_meas = p if p_meas is None else p_meas
    n = Hz.shape[1]
    mz = Hz.shape[0]
    anc = list(range(n, n + mz))
    supports = [np.nonzero(Hz[c])[0] for c in range(mz)]
    max_w = max(len(s) for s in supports)

    c = Circuit(n_qubits=n + mz)
    for r in range(rounds):
        # CX layers: leg k of every check fires together (the movement
        # planner's wave structure); noise on every gate
        for k in range(max_w):
            pairs = [(int(supports[ch][k]), anc[ch])
                     for ch in range(mz) if len(supports[ch]) > k]
            flat = np.asarray(pairs, dtype=np.int32)
            c.append("CX", flat)
            if p > 0:
                c.append("DEPOLARIZE2", flat, arg=p)
        if p > 0:
            c.append("DEPOLARIZE1", list(range(n)), arg=p / 10)
        c.append("MR", anc, arg=p_meas)
        for kk in range(mz):
            if r == 0:
                c.detector([-mz + kk])
            else:
                c.detector([-mz + kk, -2 * mz + kk])

    c.append("M", list(range(n)), arg=p_meas)
    for ch in range(mz):
        recs = [-n - mz + ch]
        recs += [-n + int(q) for q in supports[ch]]
        c.detector(recs)

    Lz = logical_operators(Hx, Hz)
    for oi, lz in enumerate(Lz):
        c.observable_include(oi, [-n + int(q)
                                  for q in np.nonzero(lz)[0]])
    return c


def run_bb_circuit_memory(Hx: Optional[np.ndarray] = None,
                          Hz: Optional[np.ndarray] = None,
                          rounds: int = 3, p: float = 1e-3,
                          shots: int = 20000, seed: int = 0,
                          n_iters: int = 60,
                          device: Union[str, torch.device] = "cuda") -> Dict:
    """Full circuit-level BB memory: fast-sampler shots + DEM-BP decoding
    on `device`, host OSD-0 (native) on the non-converged shots.

    The logical failure counts a shot iff ANY of the k logical observables
    is mispredicted."""
    from .dem_decoder import DemBPDecoder
    from .fast_sampler import build_fast_sampler

    if Hx is None or Hz is None:
        Hx, Hz = small_bb_code()
    device = torch.device(device)
    circuit = bb_memory_circuit(Hx, Hz, rounds, p)
    sampler = build_fast_sampler(circuit, shots, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = sampler(gen)
    dets = out["detectors"].cpu().numpy()
    obs = out["observables"].cpu().numpy()

    dec = DemBPDecoder(circuit, n_iters=n_iters, device=device)
    pred = dec.decode_batch(dets)
    k = obs.shape[1]
    fail = np.zeros(shots, dtype=bool)
    for bit in range(k):
        fail |= (((pred >> bit) & 1) != obs[:, bit])
    n, kk = css_n_k(Hx, Hz)
    return {
        "code": f"[[{n},{kk}]]", "rounds": rounds, "p": p, "shots": shots,
        "p_logical_shot": float(fail.mean()),
        "detector_fraction": float(dets.mean()),
        "n_mechanisms": dec.n_mech,
        "decode_seconds": dec.last_decode_seconds,
    }


__all__ = ["bb_code", "gross_code", "small_bb_code", "css_n_k", "check_css",
           "logical_operators", "BPDecoder", "LDPCMemoryResult",
           "run_bb_memory", "build_slot_tables", "slot_tables_on",
           "bb_memory_circuit", "run_bb_circuit_memory"]
