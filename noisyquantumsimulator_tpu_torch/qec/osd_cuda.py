"""OSD-0 of BP's unconverged shots on the card, one CUDA block a shot, with
its twin.

Replaces no Pallas kernel: the reference runs OSD-0 on the host
(`ldpc._osd0`, the C++ `osd0_batch` of `native/uf_decoder.cpp`). Contract,
with H (m, n) the DEM's check matrix and k observables: dets (S, m) uint8,
beliefs (S, n) float32 and obs (S, k) int32 of S shots give

  est (S, n) uint8   OSD-0's estimate, bit for bit `osd0_batch_native`'s
  pred (S,) int64    the estimate's observable flips, bit b observable b
  fail (S,) bool     pred differs from the shot's observables

A CUDA tensor runs the kernel (`csrc/osd0.cu`), one launch a call (counted in
`osd0.launches`); a CPU tensor runs the twin, the host C++ OSD-0
(`native.osd0_batch_native`, held bit-equal to `ldpc._osd0` by the tests).
Any other device, a dtype, shape or layout the kernel does not take, or an H
whose block does not fit in shared memory raises; nothing falls back from
the kernel to the twin.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .._kernels import MAX_SMEM_BYTES
from .native import osd0_batch_native


def gf2_rank(H: np.ndarray) -> int:
    """The rank of the 0/1 matrix H over GF(2)."""
    A = np.packbits(np.asarray(H, np.uint8) & 1, axis=1)
    r = 0
    for c in range(A.shape[1] * 8):
        if r == A.shape[0]:
            break
        col = (A[:, c >> 3] >> (7 - (c & 7))) & 1
        nz = np.flatnonzero(col[r:])
        if nz.size == 0:
            continue
        p = r + int(nz[0])
        A[[r, p]] = A[[p, r]]
        col[[r, p]] = col[[p, r]]
        col[r] = 0
        A[col.astype(bool)] ^= A[r]
        r += 1
    return r


def tables(H: np.ndarray, obs_mask: np.ndarray, k: int, device) -> dict:
    """OSD-0's constants for H (m, n) 0/1 and the columns' observable
    bitmasks obs_mask (n,), of which the low k bits count: H as the twin
    takes it, H packed by rows into (m, ceil((n + 1) / 64)) words on
    `device` (bit c & 63 of word c >> 6 is H[r, c]), obs_mask there, and
    rank(H) over GF(2), at which the kernel's column walk stops."""
    H = np.ascontiguousarray(np.asarray(H) & 1, dtype=np.uint8)
    m, n = H.shape
    if not 0 <= k < 64:
        raise ValueError(f"osd0: k = {k} observables outside 0..63")
    W = (n + 64) // 64
    bits = np.zeros((m, 64 * W), np.uint8)
    bits[:, :n] = H
    packed = np.packbits(bits, axis=1, bitorder="little").view("<u8").astype(np.int64)
    dev = torch.device(device)
    return {"H": H, "m": m, "n": n, "k": int(k), "rank": gf2_rank(H),
            "Hp": torch.as_tensor(packed, device=dev),
            "obs_mask": torch.as_tensor(np.asarray(obs_mask, np.int64), device=dev)}


def _osd0_plain(tab: dict, dets: torch.Tensor, beliefs: torch.Tensor,
                obs: torch.Tensor):
    """The twin: the host C++ OSD-0, then the estimate's observable flips."""
    est = osd0_batch_native(tab["H"], dets.numpy(), beliefs.numpy())
    k = tab["k"]
    cols = (tab["obs_mask"].numpy()[:, None] >> np.arange(k)) & 1
    bits = (est.astype(np.int64) @ cols) & 1
    pred = (bits << np.arange(k)).sum(axis=1)
    fail = (bits != (obs.numpy() != 0)).any(axis=1)
    return (torch.from_numpy(est), torch.from_numpy(pred.astype(np.int64)),
            torch.from_numpy(fail))


def osd0(tab: dict, dets: torch.Tensor, beliefs: torch.Tensor, obs: torch.Tensor):
    """OSD-0 of S shots under `tables(...)`'s constants: dets (S, m) uint8,
    beliefs (S, n) float32, obs (S, k) int32, on one device -> (est (S, n)
    uint8, pred (S,) int64, fail (S,) bool) there.

    CUDA tensors: one kernel launch (counted in `osd0.launches`). CPU
    tensors: the twin."""
    m, n, k = tab["m"], tab["n"], tab["k"]
    S = dets.shape[0] if dets.ndim == 2 else -1
    if dets.shape != (S, m) or beliefs.shape != (S, n) or obs.shape != (S, k):
        raise ValueError(f"osd0: dets {tuple(dets.shape)}, beliefs "
                         f"{tuple(beliefs.shape)}, obs {tuple(obs.shape)} do not "
                         f"match H ({m}, {n}) and k = {k}")
    if (dets.dtype, beliefs.dtype, obs.dtype) != (torch.uint8, torch.float32, torch.int32):
        raise TypeError(f"osd0: dtypes {dets.dtype}, {beliefs.dtype}, {obs.dtype}; "
                        "takes uint8, float32, int32")
    devices = {dets.device, beliefs.device, obs.device, tab["Hp"].device}
    if len(devices) != 1:
        raise ValueError(f"osd0: operands and tables on several devices {devices}")
    if dets.device.type == "cpu":
        return _osd0_plain(tab, dets, beliefs, obs)
    if dets.device.type != "cuda":
        raise ValueError(f"osd0: unsupported device {dets.device}")
    if not all(t.is_contiguous() for t in (dets, beliefs, obs)):
        raise ValueError("osd0: dets, beliefs and obs must be contiguous")
    lib = _kernels.load()
    smem = lib.nqs_osd0_smem_bytes(m, n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"osd0: H ({m}, {n}) needs {smem} B of shared memory a "
                         f"block, above the card's {MAX_SMEM_BYTES}")
    est = torch.empty((S, n), dtype=torch.uint8, device=dets.device)
    pred = torch.empty(S, dtype=torch.int64, device=dets.device)
    fail = torch.empty(S, dtype=torch.bool, device=dets.device)
    if S == 0:
        return est, pred, fail
    with torch.cuda.device(dets.device):
        rc = lib.nqs_osd0(_kernels.ptr(tab["Hp"]), _kernels.ptr(tab["obs_mask"]),
                          _kernels.ptr(dets), _kernels.ptr(beliefs), _kernels.ptr(obs),
                          _kernels.ptr(est), _kernels.ptr(pred), _kernels.ptr(fail),
                          m, n, tab["rank"], k, S, _kernels.stream_handle(dets.device))
        _kernels.check(lib, rc, "OSD-0 kernel")
    osd0.launches += 1
    return est, pred, fail


osd0.launches = 0

__all__ = ["osd0", "tables", "gf2_rank", "MAX_SMEM_BYTES"]
